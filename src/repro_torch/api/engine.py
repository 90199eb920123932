"""The ``Engine`` protocol and the algorithm registry (PyTorch port of
``repro/api/engine.py``).

An *engine* owns the passes of one optimizer family and is driven by
:class:`repro_torch.api.Solver` through a fixed seam:

  * ``init_state(cap)`` builds the optimizer state on the problem's device;
  * ``outer_iteration(state, perm, perms, clock, ttl=..., key=...)``
    enqueues one outer iteration without reading the device and returns
    ``(state, clock, stats)`` (``key``, the iteration's seed, only for
    engines whose capabilities declare ``needs_key``);
  * ``continue_passes(state, perms, clock)`` enqueues an overflow batch of
    approximate passes (multipass engines only);
  * ``read_stats(stats)`` is the iteration's one host sync;
  * ``evaluate(state)`` returns ``(primal, dual, primal_avg)``, called by
    the solver off the clock;
  * ``extract(state)`` returns the final ``(w, w_avg)``;
  * ``capabilities`` is an :class:`EngineCapabilities` and ``ledger`` a
    :class:`repro_torch.core.selection.SyncLedger` the solver reads sync
    and dispatch counts from.

Engines are looked up by name.  :func:`register_engine` binds ``name ->
(factory, capabilities)``, and every config error is raised from
:func:`validate_config` as a typed
:class:`~repro_torch.api.errors.UnsupportedConfigError`, derived from the
declared capabilities.  The built-in engines
(:mod:`repro_torch.api.engines`) register on first registry access;
third-party engines call :func:`register_engine` from their own module and
are then drivable as ``RunConfig(algo=<their name>)``.

A name the reference registers that the port does not run yet raises
"not yet ported"; any other unknown name raises "unknown algorithm".  The
port's ``RunConfig`` has no ``mesh`` or ``tau`` yet, so their checks run
only where a config carries the field; the capability fields that govern
them are carried as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import (Any, Callable, Dict, List, Optional, Protocol, Tuple,
                    runtime_checkable)

from .config import RunConfig
from .errors import UnsupportedConfigError


@dataclass(frozen=True)
class EngineCapabilities:
    """What an engine supports: the contract :func:`validate_config`
    checks a :class:`~repro_torch.api.config.RunConfig` against.

    Attributes:
      multipass:  slope-ruled batches of approximate passes (the MP-BCFW
                  family): the solver drives the multi-pass control loop
                  with overflow continuation; other engines get the
                  one-program-per-iteration loop.
      needs_perm: one block permutation per outer iteration, drawn from
                  the solver's seeded stream.
      supports_gram: the engine threads the Sec-3.5 Gram cache.
      supports_mesh: the engine runs on a ``RunConfig.mesh``.
      supports_averaging: the engine keeps the Sec-3.6 averaging tracks
                  (and can report ``primal_avg`` at the averaged iterate).
      uses_tau:   consumes ``RunConfig.tau``; ``requires_tau`` makes it
                  mandatory; ``tau_requires_mesh`` admits it only with a
                  mesh.
      mesh_optional: one program without a mesh, the mesh path with one.
      policy_capable: accepts ``RunConfig.policies``.
      needs_key:  consumes a per-iteration seed (the reference's PRNG key).
      async_oracle: pipelines the exact oracle with the cache passes as
                  two programs per iteration (<= 2 dispatches + 1 host
                  sync), with the oracle-overlap accounting on its ledger.
      policies:   default policy-bundle names, or None.
      note:       context appended to capability-mismatch errors.
      collectives_per_pass, collectives_setup: collectives per approximate
                  pass and per program on a mesh (None: undeclared).
      host_callbacks: host callbacks allowed inside the programs.
      accum_dtype: dtype of the dual accumulators.
    """

    multipass: bool = False
    needs_perm: bool = True
    supports_gram: bool = False
    supports_mesh: bool = False
    supports_averaging: bool = False
    uses_tau: bool = False
    requires_tau: bool = False
    tau_requires_mesh: bool = False
    mesh_optional: bool = False
    policy_capable: bool = False
    needs_key: bool = False
    async_oracle: bool = False
    policies: Optional[Tuple[str, ...]] = None
    collectives_per_pass: Optional[int] = None
    collectives_setup: Optional[int] = None
    host_callbacks: int = 0
    accum_dtype: str = "float32"
    note: str = ""


@runtime_checkable
class Engine(Protocol):
    """Structural protocol every registered engine implements."""

    capabilities: EngineCapabilities
    # A repro_torch.core.selection.SyncLedger.
    ledger: Any

    def init_state(self, cap: int) -> Any: ...

    def outer_iteration(self, state: Any, perm, perms, clock, *,
                        ttl: int, key: Any = None
                        ) -> Tuple[Any, Any, Any]: ...

    def continue_passes(self, state: Any, perms,
                        clock) -> Tuple[Any, Any, Any]: ...

    def read_stats(self, stats: Any) -> Any: ...

    def evaluate(self, state: Any) -> Tuple[float, float, float]: ...

    def extract(self, state: Any) -> Tuple[Any, Any]: ...


EngineFactory = Callable[[Any, RunConfig], Engine]


@dataclass(frozen=True)
class EngineEntry:
    name: str
    factory: EngineFactory
    capabilities: EngineCapabilities


_REGISTRY: Dict[str, EngineEntry] = {}
_BUILTINS_LOADED = False

# The names the reference registers that the port does not run yet
# (repro/api/engines.py): looking one up says so.  The port runs them all.
NOT_YET_PORTED: Tuple[str, ...] = ()

# Hooks called with every EngineEntry as it registers; raising vetoes it.
RegistrationHook = Callable[[EngineEntry], None]
_REG_HOOKS: List[RegistrationHook] = []


def add_registration_hook(hook: RegistrationHook, *,
                          retroactive: bool = True) -> None:
    """Install ``hook(entry)`` to run on every engine registration; with
    ``retroactive`` also over the entries already registered (builtins
    included).  Hooks raise to reject a registration."""
    _REG_HOOKS.append(hook)
    if retroactive:
        _ensure_builtins()
        for entry in list(_REGISTRY.values()):
            hook(entry)


def remove_registration_hook(hook: RegistrationHook) -> None:
    """Uninstall a registration hook (no-op if absent)."""
    try:
        _REG_HOOKS.remove(hook)
    except ValueError:
        pass


def _validate_capabilities(name: str, caps: EngineCapabilities) -> None:
    """Reject malformed contract budgets at the registration site."""
    for fld in ("collectives_per_pass", "collectives_setup"):
        v = getattr(caps, fld)
        if v is not None and (not isinstance(v, int) or v < 0):
            raise ValueError(
                f"engine {name!r}: {fld} must be None or a non-negative "
                f"int, got {v!r}")
    if not isinstance(caps.host_callbacks, int) or caps.host_callbacks < 0:
        raise ValueError(
            f"engine {name!r}: host_callbacks must be a non-negative int, "
            f"got {caps.host_callbacks!r}")
    if not caps.accum_dtype or not isinstance(caps.accum_dtype, str):
        raise ValueError(
            f"engine {name!r}: accum_dtype must be a dtype name, got "
            f"{caps.accum_dtype!r}")


def _ensure_builtins() -> None:
    """Import the built-in engine module once (it registers itself)."""
    global _BUILTINS_LOADED
    if not _BUILTINS_LOADED:
        from . import engines  # noqa: F401  (registration side effect)
        _BUILTINS_LOADED = True   # only after success: a failed import
        #                           surfaces again, not an empty registry


def register_engine(name: str, factory: EngineFactory,
                    capabilities: Optional[EngineCapabilities] = None,
                    *, overwrite: bool = False) -> None:
    """Bind ``name`` to an engine factory ``(problem, cfg) -> Engine``: the
    name is then accepted as ``RunConfig.algo`` by the Solver.  The
    builtins load first, so registering over one trips the duplicate
    guard here unless ``overwrite``."""
    if not name or not isinstance(name, str):
        raise ValueError(f"engine name must be a non-empty str, got {name!r}")
    _ensure_builtins()
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"engine {name!r} already registered "
                         "(pass overwrite=True to replace)")
    entry = EngineEntry(name=name, factory=factory,
                        capabilities=capabilities or EngineCapabilities())
    _validate_capabilities(name, entry.capabilities)
    for hook in list(_REG_HOOKS):
        hook(entry)   # raising here vetoes the registration
    _REGISTRY[name] = entry


def unregister_engine(name: str) -> None:
    """Remove a registered engine (primarily for tests)."""
    _REGISTRY.pop(name, None)


def engine_entry(name: str) -> EngineEntry:
    _ensure_builtins()
    entry = _REGISTRY.get(name)
    if entry is None:
        if name in NOT_YET_PORTED:
            raise UnsupportedConfigError(
                f"algorithm {name!r} is not yet ported to repro_torch; "
                f"registered: {algorithms()}")
        raise UnsupportedConfigError(
            f"unknown algorithm {name!r}; registered: {algorithms()}")
    return entry


def algorithms() -> Tuple[str, ...]:
    """All registered algorithm names, in registration order."""
    _ensure_builtins()
    return tuple(_REGISTRY)


def capabilities_of(name: str) -> EngineCapabilities:
    return engine_entry(name).capabilities


def _names_with(pred) -> Tuple[str, ...]:
    return tuple(n for n, e in _REGISTRY.items() if pred(e.capabilities))


def validate_config(entry: EngineEntry, cfg: RunConfig) -> None:
    """Capability check: every invalid (engine, config) pair raises the
    same typed error from here."""
    caps = entry.capabilities
    mesh = getattr(cfg, "mesh", None)
    tau = getattr(cfg, "tau", None)
    if cfg.approx_batch < 1:
        # A zero-pass batch reports more=True forever, which would spin
        # the overflow loop.
        raise UnsupportedConfigError(
            "approx_batch must be >= 1 (use max_approx_passes=0 to "
            "disable approximate passes)")
    if mesh is not None and not caps.supports_mesh:
        mesh_algos = _names_with(lambda c: c.supports_mesh)
        detail = f"  {caps.note}" if caps.note else ""
        raise UnsupportedConfigError(
            f"RunConfig.mesh is only consumed by {mesh_algos}; "
            f"{entry.name!r} runs single-device.{detail}")
    if tau is not None and not caps.uses_tau:
        tau_algos = _names_with(lambda c: c.uses_tau)
        raise UnsupportedConfigError(
            f"RunConfig.tau (tau-nice chunk size) is only consumed by "
            f"{tau_algos}, which run on a mesh; {entry.name!r} does not "
            "take tau.  Set RunConfig.mesh and pick a mesh engine, or "
            "drop tau.")
    if tau is not None and caps.tau_requires_mesh and mesh is None:
        raise UnsupportedConfigError(
            f"{entry.name!r} only consumes RunConfig.tau on a mesh (it "
            "resolves to the sharded engine when RunConfig.mesh is set); "
            "set RunConfig.mesh, or drop tau for the single-device path.")
    if caps.requires_tau and tau is None:
        raise UnsupportedConfigError(
            f"{entry.name!r} requires RunConfig.tau (the tau-nice chunk "
            "size); use mpbcfw-shard for the default tau=#shards")
    if cfg.gap_tol is not None and cfg.gap_tol < 0.0:
        raise UnsupportedConfigError(
            f"gap_tol must be >= 0, got {cfg.gap_tol}")
    if caps.multipass and cfg.ttl < 1:
        raise UnsupportedConfigError(
            f"ttl must be >= 1 for {entry.name!r} (planes must survive "
            f"at least the iteration that inserted them), got {cfg.ttl}")
    if cfg.policies is not None:
        if not caps.policy_capable:
            policy_algos = _names_with(lambda c: c.policy_capable)
            raise UnsupportedConfigError(
                f"RunConfig.policies is only consumed by {policy_algos}; "
                f"{entry.name!r} predates the policy layer.")
        from ..policy import make_bundle
        # Names, kinds and parameter ranges, at Solver construction (the
        # engine's factory builds the bundle again with the real n; n=1
        # here only changes a fractional budget's rounding).
        make_bundle(cfg.policies, cfg, 1)

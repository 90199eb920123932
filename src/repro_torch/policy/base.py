"""Policy protocols, the bundle, and the named-policy registry (PyTorch
port of ``repro/policy/base.py``).

A policy is a **frozen, hashable dataclass** whose fields are its
parameters and whose methods are device functions over the cache and the
slope clock.  The reference passes a bundle to its fused programs as a
static jit argument; here an engine holds its bundle and calls its
members while it enqueues an iteration, so a bundle adds no host read.

Three decision points, three protocols:

  * :class:`SamplingPolicy` -- which blocks the exact pass visits (and in
    what order): ``schedule(cache, perm, key) -> (k,)`` block ids, the
    host permutation or an int64 tensor on the cache's device.
  * :class:`EvictionPolicy` -- which cached planes survive the start of
    an outer iteration: ``evict(cache, it) -> cache``, in place.
  * :class:`OraclePolicy` -- when to keep trusting the cache over the
    exact oracle: ``continue_fn(f0, t0, f, t, f_new, t_new) -> () bool``,
    evaluated on the device between the gated approximate passes.

Policies declare what they need from the engine: ``needs_gap`` (the
cache must carry the per-block duality-gap vector,
``CacheLayout(track_gap=True)``) and ``needs_key`` (the engine must pass
a fresh seed into every outer iteration).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import (Any, Callable, Dict, Optional, Protocol, Sequence,
                    Tuple, runtime_checkable)

import torch


@runtime_checkable
class SamplingPolicy(Protocol):
    """Chooses the exact pass's block visit schedule."""

    name: str
    needs_gap: bool
    needs_key: bool

    def schedule(self, cache, perm, key: Optional[int]):
        """The block ids the exact pass visits, in order.  ``perm`` is the
        solver's uniform host permutation (the fallback schedule); ``key``
        is the iteration's seed, or None when the policy declared
        ``needs_key=False``."""
        ...


@runtime_checkable
class EvictionPolicy(Protocol):
    """Decides which cached planes survive the start of an iteration."""

    name: str
    needs_gap: bool

    def evict(self, cache, it: int):
        """Clear stale planes' validity in place; returns ``cache``."""
        ...


@runtime_checkable
class OraclePolicy(Protocol):
    """Decides when to stop approximate passes and recall the oracle."""

    name: str

    def continue_fn(self, f0, t0, f, t, f_new, t_new) -> torch.Tensor:
        """() bool device flag: True to run another approximate pass.
        Same signature as
        :func:`repro_torch.core.selection.slope_continue_t`."""
        ...


@dataclass(frozen=True)
class PolicyBundle:
    """One sampling + one eviction + one oracle policy.

    Frozen and hashable (all member policies are frozen dataclasses), as
    in the reference, where a bundle is a static jit argument.
    """

    sampling: Any
    eviction: Any
    oracle: Any

    @property
    def names(self) -> Tuple[str, str, str]:
        return (self.sampling.name, self.eviction.name, self.oracle.name)

    @property
    def needs_gap(self) -> bool:
        """Does any member policy require the cache's gap vector?"""
        return bool(self.sampling.needs_gap or self.eviction.needs_gap)

    @property
    def needs_key(self) -> bool:
        """Does the sampler require a per-iteration seed?"""
        return bool(self.sampling.needs_key)


# --------------------------------------------------------------------------
# Named-policy registry.  Factories build a policy instance from the run
# configuration plus the problem size (samplers need ``n`` to resolve
# fractional budgets to a block count).

_KINDS = ("sampling", "eviction", "oracle")
_REGISTRY: Dict[str, Tuple[str, Callable[[Any, int], Any]]] = {}


def _unsupported(msg: str) -> Exception:
    from ..api.errors import UnsupportedConfigError
    return UnsupportedConfigError(msg)


def register_policy(name: str, kind: str,
                    factory: Callable[[Any, int], Any], *,
                    overwrite: bool = False) -> None:
    """Register ``factory(cfg, n) -> policy`` under ``name``.

    ``kind`` is one of ``sampling`` / ``eviction`` / ``oracle``; a bundle
    is assembled from exactly one name of each kind.
    """
    if kind not in _KINDS:
        raise ValueError(f"unknown policy kind {kind!r}; expected one of "
                         f"{_KINDS}")
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"policy {name!r} already registered "
                         "(pass overwrite=True to replace)")
    _REGISTRY[name] = (kind, factory)


def policy_kind(name: str) -> str:
    """The registered kind of ``name`` (raises ``UnsupportedConfigError``
    on unknown names)."""
    if name not in _REGISTRY:
        raise _unsupported(
            f"unknown policy {name!r}; registered: {policy_names()}")
    return _REGISTRY[name][0]


def policy_names(kind: Optional[str] = None) -> Tuple[str, ...]:
    """All registered policy names (optionally of one ``kind``)."""
    return tuple(sorted(n for n, (k, _) in _REGISTRY.items()
                        if kind is None or k == kind))


def make_bundle(names: Sequence[str], cfg, n: int) -> PolicyBundle:
    """Assemble a :class:`PolicyBundle` from registry ``names``.

    ``names`` must contain exactly one sampling, one eviction, and one
    oracle policy (any order).  Parameter validation lives in the
    factories, so an out-of-range ``cfg`` raises the same typed
    ``UnsupportedConfigError`` as an unknown name, at Solver
    construction, never mid-run.
    """
    by_kind: Dict[str, Any] = {}
    for name in names:
        kind = policy_kind(name)
        if kind in by_kind:
            raise _unsupported(
                f"policy bundle {tuple(names)!r} names two {kind} "
                "policies; exactly one of each kind is required")
        by_kind[kind] = _REGISTRY[name][1](cfg, n)
    missing = [k for k in _KINDS if k not in by_kind]
    if missing:
        raise _unsupported(
            f"policy bundle {tuple(names)!r} is missing a "
            f"{'/'.join(missing)} policy; registered: "
            f"{ {k: policy_names(k) for k in missing} }")
    return PolicyBundle(sampling=by_kind["sampling"],
                        eviction=by_kind["eviction"],
                        oracle=by_kind["oracle"])


#: The bundle equivalent to the pre-policy engines: uniform visit order,
#: TTL+LRU eviction, the paper's slope rule.  An engine with it runs
#: bit for bit what it runs with no bundle at all.
DEFAULT_POLICIES: Tuple[str, ...] = ("uniform", "ttl-lru", "slope")

#: The ``mpbcfw-gap`` bundle: gumbel-top-k gap-proportional sampling,
#: gap-aware TTL eviction, slope rule.
GAP_POLICIES: Tuple[str, ...] = ("gap-topk", "gap-ttl", "slope")

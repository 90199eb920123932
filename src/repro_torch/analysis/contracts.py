"""Layer 1: program contracts, counted on one run of each program (PyTorch
port of ``repro/analysis/contracts.py``).

The reference traces every engine's fused programs to jaxprs and counts
primitives without running anything.  Torch has no traced program, so the
port runs each engine's dispatches once on a canonical tiny problem and
counts what they dispatched, with a
:class:`~torch.utils._python_dispatch.TorchDispatchMode`
(:class:`DispatchCounter`):

  * collectives: ``c10d`` ops (``dist.all_reduce`` is
    ``c10d.allreduce_``), split into *setup* (once per program) and
    *per-pass* by the shard engine's own sections
    (:meth:`repro_torch.shard.telemetry.CollectiveTrace.count`), and
    cross-checked against the counted ops and ``DataMesh.issued`` as
    ``setup + passes * per_pass`` (every queued pass issues its
    all-reduce, gated or not);
  * host syncs: ops that read a value on the host or wait on a
    data-dependent shape (``aten._local_scalar_dense`` for ``.item()`` /
    ``float()`` / ``bool()`` of a tensor, ``nonzero``, ``masked_select``,
    boolean indexing, ...).  A sync inside a kernel's plain version
    (:mod:`repro_torch.kernels.ref`, :func:`repro_torch.core.mpbcfw
    .eager_pass`) stands for the kernel's read on the device and is
    counted apart (``cpu_only_syncs``, with the CPU-only input checks of
    :data:`CPU_ONLY_CHECKS`);
  * ``float64`` outputs, and the dtypes of the state and the stats.

Where each is counted: the dispatch mode runs on either device.  On CUDA
every dispatch also runs under ``torch.cuda.set_sync_debug_mode("error")``,
which raises on every host sync the card would take, blocking copies from
pageable memory included.  A replay of a captured CUDA graph passes the
dispatcher by, so its ops are seen only while the graph is captured (an
engine's first pass); the card's sync-debug run covers the replays.

The counts are held against the budgets each engine declares on its
:class:`~repro_torch.api.engine.EngineCapabilities` (rules J001-J007),
each registered serving engine's decode round against J008, and the two
async engines' pipelines against J009.  The ``mesh_optional`` engines
(``mpbcfw-gram``, ``mpbcfw-gap``) run without and with a world-size-1
:class:`~repro_torch.launch.mesh.DataMesh`; without one, every budget is
0.

Differences to the reference: the port's ``gap_sampled`` is a host int
(:class:`repro_torch.core.types.ObsMetrics`), not a () int32 array, so
J007 holds it to being present in the stats read; and the tau engine's
canonical run takes tau = 2 (four chunks of the tiny problem), not 1, so
that its tau-nice epoch runs rather than the sequential pass.
"""
from __future__ import annotations

import contextlib
import sys
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..core.oracles.chain import resolve_device
from .findings import Finding

#: Ops that wait for the device before they return (on CUDA): a value read
#: on the host, or an output whose shape depends on the data.
SYNC_OPS = ("aten::_local_scalar_dense", "aten::is_nonzero", "aten::equal",
            "aten::nonzero", "aten::masked_select", "aten::_unique2",
            "aten::unique_dim", "aten::unique_consecutive",
            "aten::repeat_interleave")
# Ops that sync when an index is a boolean mask (a nonzero underneath).
_MASK_INDEX_OPS = ("aten::index", "aten::index_put_", "aten::index_put")
#: Op namespaces of torch.distributed's collectives.
COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")
#: torch functions that check their input with a host read on the CPU
#: only (a device assert on CUDA): ``one_hot`` reads its labels' min and
#: max.  Syncs inside them are not the card's.
CPU_ONLY_CHECKS = (torch.nn.functional.one_hot,)
_F64 = (torch.float64, torch.complex128)
_SYNC_ERROR = "synchroniz"      # set_sync_debug_mode("error")'s message
_PACKAGE = Path(__file__).resolve().parents[1]


def _plain_code():
    """Code objects and the file of the kernels' plain versions."""
    from ..core import mpbcfw
    from ..kernels import ref
    return {mpbcfw.eager_pass.__code__}, str(Path(ref.__file__).resolve())


@dataclass
class ProgramFacts:
    """What one run of a program dispatched."""

    setup_collectives: int = 0
    pass_collectives: int = 0
    host_syncs: int = 0
    f64_values: int = 0
    ops: int = 0
    #: collective ops counted by the dispatcher (setup + every queued
    #: pass's)
    collectives: int = 0
    #: host syncs the card does not take (not findings): inside a kernel's
    #: plain version, or a CPU-only input check (:data:`CPU_ONLY_CHECKS`)
    cpu_only_syncs: int = 0
    #: op name -> count of the counted syncs, collectives and f64 outputs
    detail: Dict[str, int] = field(default_factory=dict)

    def note(self, key: str) -> None:
        self.detail[key] = self.detail.get(key, 0) + 1


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _storage(t: torch.Tensor) -> Optional[Tuple[str, int]]:
    s = t.untyped_storage()
    return (str(t.device), s.data_ptr()) if s.nbytes() else None


class _CpuOnlyChecks(TorchFunctionMode):
    """Marks the spans of :data:`CPU_ONLY_CHECKS` calls for a counter."""

    def __init__(self, counter: "DispatchCounter"):
        super().__init__()
        self.counter = counter

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in CPU_ONLY_CHECKS:
            return func(*args, **kwargs)
        self.counter._cpu_checks += 1
        try:
            return func(*args, **kwargs)
        finally:
            self.counter._cpu_checks -= 1


class DispatchCounter(TorchDispatchMode):
    """Counts what the torch code run under it dispatches.

    ``facts`` totals the current run; :meth:`program` marks the span of a
    named program (the async engines' ``async_oracle`` and
    ``async_cache``), whose ops are also counted apart, in
    ``programs[name]``, with ``entries[name]`` spans per run.  While a
    span is open, the storages each program writes and reads are tracked,
    and a program that reads what another wrote since :meth:`reset` is a
    read-after-write ``hazard``.  The tensors written are held until the
    next :meth:`reset`, so no address is reused in between."""

    def __init__(self):
        super().__init__()
        self._plain_codes, self._plain_file = _plain_code()
        self._functions = _CpuOnlyChecks(self)
        self._cpu_checks = 0
        self.reset()

    def __enter__(self):
        self._functions.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._functions.__exit__(*exc)

    def reset(self) -> None:
        """Start a new run: clear the counts, spans and tracked writes."""
        self.facts = ProgramFacts()
        self.programs: Dict[str, ProgramFacts] = {}
        self.entries: Dict[str, int] = {}
        self.hazards: List[str] = []
        self._stack: List[str] = []
        self._writes: Dict[str, Dict[Tuple[str, int], str]] = {}
        self._held: List[torch.Tensor] = []

    @contextlib.contextmanager
    def program(self, name: str):
        """The span of program ``name`` (the engines' ``program`` hook)."""
        self.entries[name] = self.entries.get(name, 0) + 1
        self.programs.setdefault(name, ProgramFacts())
        self._stack.append(name)
        try:
            yield
        finally:
            self._stack.pop()

    def _in_plain_version(self) -> bool:
        f = sys._getframe(2)
        while f is not None:
            code = f.f_code
            if (code in self._plain_codes
                    or code.co_filename == self._plain_file):
                return True
            f = f.f_back
        return False

    def _is_sync(self, name: str, args) -> bool:
        if name in SYNC_OPS:
            return True
        if name in _MASK_INDEX_OPS and len(args) > 1:
            return any(t.dtype in (torch.bool, torch.uint8)
                       for t in _tensors(args[1]))
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name
        label = self._stack[-1] if self._stack else None
        counts = [self.facts]
        if label is not None:
            counts.append(self.programs[label])
        sync = self._is_sync(name, args)
        plain = sync and (self._cpu_checks > 0 or self._in_plain_version())
        collective = func.namespace in COLLECTIVE_NAMESPACES
        for f in counts:
            f.ops += 1
            if plain:
                f.cpu_only_syncs += 1
            elif sync:
                f.host_syncs += 1
                f.note(f"sync:{name}")
            if collective:
                f.collectives += 1
                f.note(f"collective:{name}")
        if label is not None:
            self._track_reads(label, name, args, kwargs)
        out = func(*args, **kwargs)
        f64 = [t for t in _tensors(out) if t.dtype in _F64]
        for f in counts:
            f.f64_values += len(f64)
            if f64:
                f.note(f"f64:{name}")
        if label is not None:
            self._track_writes(label, func, args, kwargs, out)
        return out

    def _track_reads(self, label, name, args, kwargs) -> None:
        for t in _tensors((args, kwargs)):
            key = _storage(t)
            for other, written in self._writes.items():
                if other != label and key in written:
                    self.hazards.append(
                        f"{label} reads ({name}) what {other} wrote "
                        f"({written[key]})")

    def _track_writes(self, label, func, args, kwargs, out) -> None:
        # Fresh outputs and mutated arguments; a view's output aliases its
        # input and writes nothing.
        fresh = all(r.alias_info is None for r in func._schema.returns)
        written = _tensors(out) if fresh else []
        for arg, value in zip(func._schema.arguments, args):
            if arg.alias_info is not None and arg.alias_info.is_write:
                written += _tensors(value)
        for arg in func._schema.arguments:
            if (arg.kwarg_only and arg.name in kwargs
                    and arg.alias_info is not None
                    and arg.alias_info.is_write):
                written += _tensors(kwargs[arg.name])
        mine = self._writes.setdefault(label, {})
        for t in written:
            key = _storage(t)
            if key is not None:
                mine.setdefault(key, func._schema.name)
                self._held.append(t)


def raise_site(err: BaseException) -> str:
    """The two innermost ``repro_torch`` frames of ``err``'s traceback,
    outside this package: the line that synced and its caller, as
    ``file:line <- file:line``."""
    here = Path(__file__).resolve().parent
    frames = [f"{Path(fs.filename).resolve().relative_to(_PACKAGE)}:"
              f"{fs.lineno}" for fs in traceback.extract_tb(err.__traceback__)
              if _PACKAGE in Path(fs.filename).resolve().parents
              and Path(fs.filename).resolve().parent != here]
    return " <- ".join(reversed(frames[-2:])) or "?"


@contextlib.contextmanager
def sync_debug(device: torch.device):
    """``set_sync_debug_mode("error")`` on CUDA, nothing on the CPU: a
    host sync, a blocking copy from pageable memory included, raises.
    The mode before is restored on exit."""
    if device.type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def count_program(fn: Callable[[], Any], *, device="cpu",
                  counter: Optional[DispatchCounter] = None
                  ) -> Tuple[Any, ProgramFacts, Optional[str]]:
    """Run ``fn()`` once under a :class:`DispatchCounter` (and, on CUDA,
    sync-debug "error").  Returns ``(result, facts, sync_error)``: the
    result is None and ``sync_error`` the ``file:line`` that synced (and
    its caller's) when the card raised."""
    counter = DispatchCounter() if counter is None else counter
    counter.reset()
    device = torch.device(device)
    try:
        with counter, sync_debug(device):
            out = fn()
    except RuntimeError as err:
        if device.type != "cuda" or _SYNC_ERROR not in str(err):
            raise
        counter.facts.host_syncs += 1
        counter.facts.note("sync:cuda")
        return None, counter.facts, raise_site(err)
    return out, counter.facts, None


# ---------------------------------------------------------------------------
# Canonical runs: every registered engine on a tiny problem


@dataclass
class ProgramRun:
    """One run of one program: ``outer`` (an outer iteration) or
    ``continue`` (an overflow batch)."""

    name: str
    iteration: int
    facts: ProgramFacts
    out: Any                     # (state, clock, stats), or None
    sync_error: Optional[str] = None
    #: program span -> spans entered and their facts (async engines)
    entries: Dict[str, int] = field(default_factory=dict)
    programs: Dict[str, ProgramFacts] = field(default_factory=dict)
    hazards: List[str] = field(default_factory=list)
    #: passes that ran (multipass engines, from the stats read) and the
    #: collectives the ledger and the mesh counted for this run
    passes_run: Optional[int] = None
    queued_passes: int = 0
    ledger_collectives: int = 0
    mesh_issued: int = 0


@dataclass
class EngineTrace:
    """All runs of one engine configuration."""

    engine: str
    label: str                    # e.g. "mpbcfw-gram[mesh]"
    caps: Any                     # EngineCapabilities
    on_mesh: bool
    device: str
    programs: List[ProgramRun]
    #: CollectiveTrace's per-section sites (shard engines), else None
    sections: Optional[Dict[str, int]] = None
    launches: Dict[str, int] = field(default_factory=dict)

    def expected_budgets(self) -> Tuple[Optional[int], Optional[int]]:
        """(per-pass, setup) collective budget for this configuration.
        Off-mesh programs are single-device: 0 whatever the engine
        declares for its mesh path."""
        if not self.on_mesh:
            return 0, 0
        return self.caps.collectives_per_pass, self.caps.collectives_setup


def _tiny_problem(device="cpu"):
    """The canonical problem: small enough that running every registered
    engine stays cheap, structured enough (multiclass, n not a multiple of
    anything interesting) to run the real programs."""
    from ..core.oracles import multiclass
    from ..data import synthetic

    x, y = synthetic.usps_like(n=8, f=6, num_classes=3, seed=0)
    return multiclass.make_problem(x, y, 3, device=device)


def _trace_config(name: str, caps, on_mesh: bool, device="cpu"):
    from ..api.config import RunConfig

    mesh = None
    if on_mesh:
        from ..launch.mesh import make_data_mesh

        mesh = make_data_mesh(device=device)
    tau = 2 if (on_mesh and caps.requires_tau) else None
    return RunConfig(lam=0.01, algo=name, cap=4, ttl=10, max_iters=1,
                     approx_batch=2, max_approx_passes=4, seed=0,
                     mesh=mesh, tau=tau)


def _device_of(problem) -> torch.device:
    return next(iter(problem.data.values())).device


def trace_engine(name: str, *, on_mesh: Optional[bool] = None,
                 problem=None, device=None,
                 iterations: int = 2) -> EngineTrace:
    """Instantiate engine ``name`` on the tiny problem (on ``device``, CUDA
    by default; or on ``problem``'s device) and run, each under a
    :class:`DispatchCounter`, ``iterations`` outer iterations (each read
    once after its dispatch, as the Solver does) and, for a multipass
    engine, one overflow batch."""
    from ..api.engine import engine_entry
    from ..core import mpbcfw
    from ..kernels import ops as kops

    entry = engine_entry(name)
    caps = entry.capabilities
    if on_mesh is None:
        on_mesh = bool(caps.supports_mesh and not caps.mesh_optional)
    if problem is None:
        problem = _tiny_problem(resolve_device(device))
    dev = _device_of(problem)
    cfg = _trace_config(name, caps, on_mesh, dev)
    engine = entry.factory(problem, cfg)
    state = engine.init_state(cfg.cap)
    n = problem.n
    label = (f"{name}[{'mesh' if on_mesh else 'single'}]"
             if caps.mesh_optional else name)
    counter = DispatchCounter()
    engine.program = counter.program
    mesh = getattr(engine, "mesh", None)
    shard = getattr(engine, "eng", None)
    trace = EngineTrace(name, label, caps, on_mesh, str(dev), [])

    perm = np.arange(n, dtype=np.int64) if caps.needs_perm else None
    k = min(cfg.approx_batch, cfg.max_approx_passes)
    perms = np.tile(np.arange(n, dtype=np.int64), (k, 1))
    launches0 = kops.launch_counts()

    def clock():
        return mpbcfw.make_slope_clock(0.0, 0.0, 1.0, 1e-3, dev)

    def run(prog: str, it: int, fn: Callable[[], Any]) -> bool:
        nonlocal state
        led0 = engine.ledger.collectives
        issued0 = mesh.issued if mesh is not None else 0
        out, facts, err = count_program(fn, device=dev, counter=counter)
        pr = ProgramRun(prog, it, facts, out, err, dict(counter.entries),
                        dict(counter.programs), list(counter.hazards),
                        queued_passes=k if caps.multipass else 0)
        trace.programs.append(pr)
        if err is not None:
            return False
        state, _, stats = out
        st = engine.read_stats(stats)
        if caps.multipass:
            pr.passes_run = int(st.passes_run)
            state = engine.count_passes(state, st)
        pr.ledger_collectives = engine.ledger.collectives - led0
        pr.mesh_issued = (mesh.issued - issued0) if mesh is not None else 0
        return True

    ok = True
    for it in range(iterations):
        key = dict(key=it) if caps.needs_key else {}
        c = clock()
        ok = run("outer", it, lambda c=c, key=key: engine.outer_iteration(
            state, perm, perms if caps.multipass else None,
            c if caps.multipass else None, ttl=cfg.ttl, **key))
        if not ok:
            break
    if ok and caps.multipass:
        c = clock()
        run("continue", iterations, lambda: engine.continue_passes(
            state, perms, c))
    if shard is not None:
        trace.sections = {tag: shard.collectives.count("multi_approx", tag)
                          for tag in ("setup", "pass")}
    after = kops.launch_counts()
    trace.launches = {k_: after[k_] - launches0[k_] for k_ in after}
    # The facts' collective split: the shard engine's sections, or, with
    # no sections, every counted collective as setup.
    for pr in trace.programs:
        f = pr.facts
        if trace.sections is not None and pr.name in ("outer", "continue"):
            f.setup_collectives = trace.sections["setup"]
            f.pass_collectives = trace.sections["pass"]
        else:
            f.setup_collectives = f.collectives
    return trace


def trace_cases(engines: Optional[Iterable[str]] = None, problem=None,
                device=None) -> List[EngineTrace]:
    """Run every requested engine (default: all registered), the
    ``mesh_optional`` ones without and with a mesh, on ``device`` (CUDA
    by default) or ``problem``'s."""
    from ..api.engine import algorithms, engine_entry

    names = list(engines) if engines is not None else list(algorithms())
    if problem is None:
        problem = _tiny_problem(resolve_device(device))
    traces: List[EngineTrace] = []
    for name in names:
        caps = engine_entry(name).capabilities
        forms = (False, True) if caps.mesh_optional else (None,)
        for on_mesh in forms:
            traces.append(trace_engine(name, on_mesh=on_mesh,
                                       problem=problem, device=device))
    return traces


# ---------------------------------------------------------------------------
# The checks (rules J001-J007, J009)


def _float_leaf_dtypes(tree) -> List[str]:
    return [str(t.dtype).replace("torch.", "") for t in _tensors(tree)
            if t.is_floating_point()]


def _scalar(leaf, dtype: torch.dtype) -> bool:
    return (isinstance(leaf, torch.Tensor) and leaf.shape == ()
            and leaf.dtype == dtype)


def check_trace(et: EngineTrace) -> Tuple[List[Finding], Dict[str, object]]:
    """Hold one engine configuration's runs against its declared budgets.
    Returns (findings, per-engine facts for the report)."""
    findings: List[Finding] = []
    caps = et.caps
    exp_pass, exp_setup = et.expected_budgets()
    facts: Dict[str, object] = {"on_mesh": et.on_mesh, "device": et.device,
                                "runs": len(et.programs)}
    if et.launches:
        facts["launches"] = {k: v for k, v in et.launches.items() if v}
    if caps.supports_mesh and (caps.collectives_per_pass is None
                               or caps.collectives_setup is None):
        findings.append(Finding(
            "J004", et.label,
            "mesh-capable engine must declare collectives_per_pass and "
            "collectives_setup budgets on its EngineCapabilities"))
    for pr in et.programs:
        f = pr.facts
        where = f"{et.label}:{pr.name}"
        for key, v in ((f"{pr.name}_setup", f.setup_collectives),
                       (f"{pr.name}_pass", f.pass_collectives),
                       (f"{pr.name}_syncs", f.host_syncs),
                       (f"{pr.name}_collectives", f.collectives),
                       (f"{pr.name}_cpu_only_syncs", f.cpu_only_syncs),
                       (f"{pr.name}_ops", f.ops)):
            facts[key] = max(v, facts.get(key, 0))
        if pr.entries:
            facts[f"{pr.name}_programs"] = dict(pr.entries)
        if pr.sync_error is not None:
            findings.append(Finding(
                "J003", where,
                f"host sync inside the dispatch at {pr.sync_error} "
                "(sync-debug \"error\" raised on the card)"))
            continue
        if exp_pass is not None and f.pass_collectives != exp_pass:
            findings.append(Finding(
                "J001", where,
                f"{f.pass_collectives} collective(s) per approximate "
                f"pass, budget declares {exp_pass} (detail: {f.detail})"))
        if exp_setup is not None and f.setup_collectives != exp_setup:
            findings.append(Finding(
                "J002", where,
                f"{f.setup_collectives} setup collective(s) per program, "
                f"budget declares {exp_setup} (detail: {f.detail})"))
        findings.extend(_check_collective_totals(et, pr))
        if f.host_syncs > caps.host_callbacks:
            findings.append(Finding(
                "J003", where,
                f"{f.host_syncs} host sync(s) inside the dispatch, budget "
                f"allows {caps.host_callbacks} (detail: {f.detail})"))
        if f.f64_values:
            findings.append(Finding(
                "J005", where,
                f"{f.f64_values} float64 value(s) in the dispatched "
                f"program (accum_dtype={caps.accum_dtype}; detail: "
                f"{f.detail})"))
        findings.extend(_check_accum_dtype(et, pr))
        findings.extend(_check_obs_drain(et, pr))
        findings.extend(_check_policy_contract(et, pr))
        findings.extend(_check_async_pipeline(et, pr))
    return findings, facts


def _check_collective_totals(et: EngineTrace,
                             pr: ProgramRun) -> List[Finding]:
    """The sections' counts against what ran: every queued pass issues
    its all-reduce (gated or not), so the dispatcher and the mesh count
    ``setup + queued * per_pass``; the ledger charges ``setup + passes_run
    * per_pass`` after the read (the reference's runtime total)."""
    if et.sections is None or pr.passes_run is None:
        return []
    f = pr.facts
    where = f"{et.label}:{pr.name}"
    queued = f.setup_collectives + pr.queued_passes * f.pass_collectives
    charged = f.setup_collectives + pr.passes_run * f.pass_collectives
    out: List[Finding] = []
    if f.collectives != queued or pr.mesh_issued != queued:
        out.append(Finding(
            "J002", where,
            f"{f.collectives} collective op(s) dispatched and "
            f"{pr.mesh_issued} issued by the mesh, the sections account "
            f"for {queued} ({f.setup_collectives} + {pr.queued_passes} x "
            f"{f.pass_collectives}): a collective outside the counted "
            "sections"))
    if pr.ledger_collectives != charged:
        out.append(Finding(
            "J001", where,
            f"the ledger charged {pr.ledger_collectives} collective(s) for "
            f"{pr.passes_run} pass(es) run, the sections say {charged}"))
    return out


def _check_async_pipeline(et: EngineTrace, pr: ProgramRun) -> List[Finding]:
    """Rule J009: an async engine's outer iteration is two programs.

    For engines declaring ``EngineCapabilities.async_oracle`` each outer
    iteration must enter exactly one ``async_oracle`` span and one
    ``async_cache`` span (the engine's ``program`` hook); the oracle
    program dispatches no collective and no host sync (it must overlap
    the cache program), and neither program reads a storage the other
    wrote in the same iteration (a read-after-write hazard would
    serialize them)."""
    if not getattr(et.caps, "async_oracle", False) or pr.name != "outer":
        return []
    where = f"{et.label}:{pr.name}"
    n_o = pr.entries.get("async_oracle", 0)
    n_c = pr.entries.get("async_cache", 0)
    if n_o != 1 or n_c != 1:
        return [Finding(
            "J009", where,
            f"expected exactly one async_oracle and one async_cache "
            f"program per outer iteration, found {n_o} oracle / {n_c} "
            "cache")]
    out: List[Finding] = []
    o = pr.programs["async_oracle"]
    if o.host_syncs or o.collectives:
        out.append(Finding(
            "J009", where,
            f"async_oracle program dispatches {o.host_syncs} host sync(s) "
            f"and {o.collectives} collective(s) (detail: {o.detail}); it "
            "must be communication-free to overlap the cache program"))
    for h in sorted(set(pr.hazards)):
        out.append(Finding("J009", where, f"read-after-write hazard: {h}"))
    return out


def _check_policy_contract(et: EngineTrace,
                           pr: ProgramRun) -> List[Finding]:
    """Rule J007: the declared policy names resolve to one bundle's kinds
    (one sampling, one eviction, one oracle policy), and a keyed gap
    engine returns ``stats.metrics.gap_total`` (() float32) and
    ``gap_sampled`` in the stats it reads once.  The port's
    ``gap_sampled`` is the schedule's length, a host int, so it is held
    to being present."""
    caps = et.caps
    if not getattr(caps, "policy_capable", False) or pr.name != "outer":
        return []
    where = f"{et.label}:{pr.name}"
    out: List[Finding] = []
    names = getattr(caps, "policies", None) or ()
    if names:
        from ..api.errors import UnsupportedConfigError
        from ..policy import policy_kind

        kinds: Dict[str, int] = {}
        for nm in names:
            try:
                kind = policy_kind(nm)
            except UnsupportedConfigError:
                out.append(Finding(
                    "J007", where,
                    f"capability-declared policy {nm!r} is not registered "
                    "in the repro_torch.policy registry"))
                continue
            kinds[kind] = kinds.get(kind, 0) + 1
        if not out and (sorted(kinds) != ["eviction", "oracle", "sampling"]
                        or any(v != 1 for v in kinds.values())):
            out.append(Finding(
                "J007", where,
                f"capability-declared policies {tuple(names)} resolve to "
                f"kinds {kinds}; a bundle is exactly one sampling + one "
                "eviction + one oracle policy"))
    if getattr(caps, "needs_key", False):
        metrics = getattr(pr.out[2], "metrics", None)
        total = getattr(metrics, "gap_total", None)
        if total is None:
            out.append(Finding(
                "J007", where,
                "keyed gap engine does not return stats.metrics.gap_total "
                "(gap telemetry must ride the existing single host sync)"))
        elif not _scalar(total, torch.float32):
            out.append(Finding(
                "J007", where,
                f"stats.metrics.gap_total is {_describe(total)}, expected "
                "a () float32 tensor"))
        if getattr(metrics, "gap_sampled", None) is None:
            out.append(Finding(
                "J007", where,
                "keyed gap engine does not return stats.metrics"
                ".gap_sampled"))
    return out


def _describe(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return f"{str(leaf.dtype).replace('torch.', '')}{list(leaf.shape)}"
    return type(leaf).__name__


def _check_obs_drain(et: EngineTrace, pr: ProgramRun) -> List[Finding]:
    """Rule J006: a multipass engine returns the on-device cache counters
    (:class:`repro_torch.core.types.ObsMetrics`) as () int32 tensors in
    the stats of its outer iteration, read in the iteration's one host
    sync.  Only the built-in MP-BCFW family (its stats are
    ``ApproxBatchStats``) is held to it; a third-party engine with its own
    stats type is exempt."""
    if not et.caps.multipass or pr.name != "outer":
        return []
    where = f"{et.label}:{pr.name}"
    stats = pr.out[2]
    if not hasattr(stats, "metrics"):
        return []
    metrics = stats.metrics
    if metrics is None:
        return [Finding(
            "J006", where,
            "stats.metrics is None: the outer iteration does not keep the "
            "ObsMetrics counters on the device, so the obs layer would "
            "need a second host sync to report them")]
    out: List[Finding] = []
    for fld in ("ttl_evicted", "lru_evicted", "occupancy",
                "nonempty_blocks"):
        leaf = getattr(metrics, fld, None)
        if leaf is None:
            out.append(Finding(
                "J006", where,
                f"stats.metrics.{fld} missing from the returned counters"))
        elif not _scalar(leaf, torch.int32):
            out.append(Finding(
                "J006", where,
                f"stats.metrics.{fld} is {_describe(leaf)}, expected a () "
                "int32 tensor (one fixed-size rider on the existing "
                "sync)"))
    return out


def _check_accum_dtype(et: EngineTrace, pr: ProgramRun) -> List[Finding]:
    """The dual accumulators and the per-pass dual telemetry carry the
    declared ``accum_dtype`` (fp32 discipline, paper Sec. 2)."""
    want = et.caps.accum_dtype
    where = f"{et.label}:{pr.name}"
    out: List[Finding] = []
    state, _, stats = pr.out
    if et.caps.multipass:
        phi = state.inner.phi
        if str(phi.dtype).replace("torch.", "") != want:
            out.append(Finding(
                "J005", where,
                f"dual accumulator phi is {phi.dtype}, declared "
                f"accum_dtype is {want}"))
        for fld in ("duals", "f_entry"):
            leaf = getattr(stats, fld, None)
            if isinstance(leaf, torch.Tensor) and \
                    str(leaf.dtype).replace("torch.", "") != want:
                out.append(Finding(
                    "J005", where,
                    f"stats.{fld} telemetry is {leaf.dtype}, declared "
                    f"accum_dtype is {want}"))
    else:
        bad = sorted({d for d in _float_leaf_dtypes(state) if d != want})
        if bad:
            out.append(Finding(
                "J005", where,
                f"float state leaves with dtype(s) {bad}, declared "
                f"accum_dtype is {want}"))
    return out


# ---------------------------------------------------------------------------
# Rule J008: the serving engines


def check_serve_engines(device=None) -> Tuple[
        List[Finding], Dict[str, Dict[str, object]]]:
    """Rule J008: a serving round is one clean dispatch.

    Every :class:`repro_torch.serve.engine.DecodeEngine` registered with a
    trace case runs one ``decode`` round of its canonical batch under the
    counter (on ``device``, CUDA by default: the case's model moved
    there; on CUDA the
    round captures its bucket's graph and replays it, under sync-debug
    "error").  Serving is single-device and the batcher reads the labels
    in the round's one sync, after ``decode``: inside it there may be no
    host sync, no collective and no float64 value."""
    from ..kernels import ops as kops
    from ..serve.engine import decode_engine_for, serve_trace_cases
    from ..serve.export import ServableModel

    device = resolve_device(device)
    findings: List[Finding] = []
    facts: Dict[str, Dict[str, object]] = {}
    for label, engine, batch in serve_trace_cases():
        where = f"serve:{label}"
        if device.type != "cpu":
            model = engine.model
            engine = decode_engine_for(ServableModel(
                model.spec, model.w.to(device), model.meta))
        launches0 = kops.launch_counts()
        _, f, err = count_program(lambda: engine.decode(batch),
                                  device=device)
        after = kops.launch_counts()
        facts[where] = {"collectives": f.collectives,
                        "host_syncs": f.host_syncs,
                        "f64_values": f.f64_values}
        launches = {k: after[k] - launches0[k] for k in after
                    if after[k] > launches0[k]}
        if launches:
            facts[where]["launches"] = launches
        if err is not None or f.host_syncs:
            findings.append(Finding(
                "J008", where,
                f"{f.host_syncs} host sync(s) in the decode round"
                + (f" at {err}" if err else "")
                + f" (detail: {f.detail}); a serving round is one clean "
                "dispatch, read once by the batcher"))
        if f.collectives:
            findings.append(Finding(
                "J008", where,
                f"{f.collectives} collective(s) in the decode round "
                f"(detail: {f.detail}); serving is single-device"))
        if f.f64_values:
            findings.append(Finding(
                "J008", where,
                f"{f.f64_values} float64 value(s) in the decode round "
                "(fp32 serving discipline)"))
    return findings, facts


def run_program_layer(engines: Optional[Iterable[str]] = None,
                      device=None) -> Tuple[
        List[Finding], Dict[str, Dict[str, object]], List[EngineTrace]]:
    """Run and check all requested engines (training engines against
    their declared budgets, serving engines against J008) on ``device``,
    CUDA by default.  The port's ``run_jaxpr_layer``."""
    device = resolve_device(device)
    findings: List[Finding] = []
    facts: Dict[str, Dict[str, object]] = {}
    traces = trace_cases(engines, device=device)
    for et in traces:
        fs, fx = check_trace(et)
        findings.extend(fs)
        facts[et.label] = fx
    serve_findings, serve_facts = check_serve_engines(device)
    findings.extend(serve_findings)
    facts.update(serve_facts)
    return findings, facts, traces


# ---------------------------------------------------------------------------
# Registration-time guard


def _registration_guard(entry) -> None:
    caps = entry.capabilities
    if caps.supports_mesh and (caps.collectives_per_pass is None
                               or caps.collectives_setup is None):
        raise ValueError(
            f"engine {entry.name!r}: mesh-capable engines must declare "
            "collectives_per_pass and collectives_setup budgets "
            "(repro_torch.analysis holds each run to them)")


def install_registration_guard() -> Callable:
    """Require collective budgets on every mesh-capable engine at
    registration time (retroactively over the registered engines).
    Returns the hook, for
    :func:`repro_torch.api.engine.remove_registration_hook`."""
    from ..api.engine import add_registration_hook

    add_registration_hook(_registration_guard, retroactive=True)
    return _registration_guard

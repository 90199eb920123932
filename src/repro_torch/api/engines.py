"""Built-in engines and their registry entries (PyTorch port of
``repro/api/engines.py``).

Importing this module registers, in the reference's order, every engine
the port runs into the :mod:`repro_torch.api.engine` registry:

  * ``fw``, ``ssg``, ``bcfw`` and ``bcfw-avg`` (:class:`FWEngine`,
    :class:`SSGEngine`, :class:`BCFWEngine`): one exact program per outer
    iteration, driven by the Solver's simple loop.  BCFW's and SSG's
    passes replay one captured CUDA graph per block on the card; FW runs
    one batched oracle over all blocks;
  * ``mpbcfw``, ``mpbcfw-avg``, ``mpbcfw-gap`` and ``mpbcfw-gram``
    (:class:`FusedEngine`; ``mpbcfw-gap`` runs the
    :mod:`repro_torch.policy` gap bundle, the gram variant keeps Sec-3.5
    Gram blocks in its plane cache);
  * ``mpbcfw-async`` (:class:`AsyncEngine`, the pipelined oracle);
  * ``mpbcfw-shard-async``, ``mpbcfw-shard``, ``mpbcfw-shard-avg``,
    ``mpbcfw-shard-tau`` and ``mpbcfw-shard-gram``
    (:class:`ShardDriverEngine`, :class:`ShardAsyncDriverEngine`: the
    :mod:`repro_torch.shard` engine on the ``RunConfig.mesh`` data mesh,
    one rank per process), and ``mpbcfw-gram`` and ``mpbcfw-gap`` given
    a mesh.

The MP-BCFW engines take ``RunConfig.policies`` (a bundle of
:mod:`repro_torch.policy`).  The ``-avg`` engines report ``primal_avg``
at the Sec-3.6 averaged iterate; the others keep the averages
(``extract`` returns them) and report the primal again.  Every name the
reference registers is registered here, in its order, with its
capabilities, entry for entry.  The
engines' states are tensors and NamedTuples of tensors in the reference's
layout, which :class:`repro_torch.checkpoint.CheckpointManager` saves as
they are, so each package resumes the other's checkpoints.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..cache import CacheLayout
from ..core import bcfw, mpbcfw, subgradient
from ..core.averaging import extract as extract_average, init_averaging
from ..core.graphs import StepGraphs
from ..core.selection import SyncLedger
from ..core.ssvm import init_state as init_bcfw_state, weights_of
from ..core.types import SSVMProblem
from ..kernels import approx_pass as approx_kernel
from ..launch.mesh import ensure_data_mesh
from ..shard import ShardEngine
from . import solver as solver_mod
from .config import RunConfig
from .engine import EngineCapabilities, register_engine
from .errors import UnsupportedConfigError


class IterStats(NamedTuple):
    """Host telemetry returned by a non-multipass engine's read_stats."""

    n_exact: int
    n_approx: int


# Contract budgets: single-device engines issue no collectives and no host
# callbacks; the shard engines one setup all-reduce per program and one per
# approximate pass.
_SINGLE_DEVICE_BUDGET = dict(collectives_per_pass=0, collectives_setup=0,
                             host_callbacks=0)
_SHARD_BUDGET = dict(collectives_per_pass=1, collectives_setup=1,
                     host_callbacks=0)


def _policies(problem: SSVMProblem, cfg: RunConfig, *,
              allow_key: bool = False, default=None):
    """Resolve ``cfg.policies`` (or the engine's ``default`` names) into
    a :class:`repro_torch.policy.PolicyBundle`, or None for the baked-in
    pre-policy behaviour."""
    from ..policy import make_bundle
    names = cfg.policies if cfg.policies is not None else default
    if names is None:
        return None
    bundle = make_bundle(names, cfg, problem.n)
    if bundle.needs_key and not allow_key:
        raise UnsupportedConfigError(
            f"policy bundle {tuple(names)} contains a keyed sampler "
            f"({bundle.sampling.name!r}), but {cfg.algo!r} does not "
            "thread per-iteration PRNG keys; use algo='mpbcfw-gap'.")
    return bundle


def _device(problem: SSVMProblem) -> torch.device:
    """Where the problem's data, and so the engine's state, lives."""
    return next(iter(problem.data.values())).device


_NO_PROGRAM = contextlib.nullcontext()


class _EngineBase:
    """Shared plumbing: the ledger, the captured block steps, and the
    default checkpoint pack/unpack hooks."""

    @staticmethod
    def program(name: str):
        """The span of program ``name`` of an outer iteration (the async
        engines' ``async_oracle`` and ``async_cache``): a context that
        does nothing, which the contract checker
        (:mod:`repro_torch.analysis.contracts`) replaces on an instance to
        tell the programs apart."""
        return _NO_PROGRAM

    def __init__(self, problem: SSVMProblem, lam: float):
        self.problem = problem
        self.lam = float(lam)
        self.ledger = SyncLedger()
        # The engine's block steps: captured CUDA graphs on the card.
        self.graphs = StepGraphs()

    def pack_state(self, state):
        """Checkpointable tree for ``state`` (identity by default)."""
        return state

    def unpack_state(self, tree):
        """Inverse of :meth:`pack_state`."""
        return tree

    def continue_passes(self, state, perms, clock):
        raise NotImplementedError(
            f"{type(self).__name__} is not a multipass engine")


# ---------------------------------------------------------------------------
# MP-BCFW engines (multipass: the full slope-ruled control loop)


class FusedEngine(_EngineBase):
    """Single-device MP-BCFW engine (:func:`repro_torch.core.mpbcfw
    .outer_iteration`).  ``outer_iteration`` enqueues the iteration's
    device work, the slope-gated approximate passes included, without a
    host read; ``read_stats`` is the one host sync per dispatch, counted
    on ``ledger``, and ``count_passes`` then charges the passes that ran
    to the state's host counters.  A ``gram_steps`` count keeps Gram
    blocks in the plane cache, which switches the approximate passes to
    the Sec-3.5 scheme, ``gram_steps`` updates per block.  ``averaged``
    reports ``primal_avg`` at the averaged iterate (``mpbcfw-avg``).
    ``policies`` is a :class:`repro_torch.policy.PolicyBundle` or None;
    a bundle that needs the gap vector makes the cache track it
    (``track_gap``), which the Sec-3.5 scheme refuses.  On CUDA the exact
    pass replays one captured CUDA graph per block, kept in ``graphs``
    while the state's tensors live
    (:class:`~repro_torch.core.graphs.StepGraphs`).

    ``init_state`` takes the ``approx_pass`` kernel's launch plan for the
    problem's width and the cache's capacity (shape arithmetic, on any
    device), so a shape the kernel cannot take is refused when the Solver
    is built, not at the first approximate pass."""

    capabilities = EngineCapabilities(multipass=True,
                                      supports_averaging=True,
                                      policy_capable=True,
                                      policies=("uniform", "ttl-lru",
                                                "slope"),
                                      **_SINGLE_DEVICE_BUDGET)

    def __init__(self, problem: SSVMProblem, lam: float, *,
                 gram_steps: Optional[int] = None, averaged: bool = False,
                 policies=None):
        super().__init__(problem, lam)
        self.gram_steps = gram_steps
        self.use_gram = gram_steps is not None
        self.averaged = averaged
        self.policies = policies
        self.track_gap = policies is not None and policies.needs_gap
        if self.track_gap and self.use_gram:
            raise UnsupportedConfigError(
                "gap-tracking policies are unsupported with the Sec-3.5 "
                "gram scheme (the gram pass body exposes no per-visit "
                "scores to fold into the gap vector)")

    def _check_plan(self, cap: int) -> None:
        try:
            approx_kernel.plan(self.problem.d, cap, self.gram_steps or 0)
        except ValueError as err:
            raise UnsupportedConfigError(
                f"the approx_pass kernel cannot run d={self.problem.d}, "
                f"cap={cap}: {err}") from err

    def init_state(self, cap: int) -> mpbcfw.MPState:
        self._check_plan(cap)
        return mpbcfw.init_mp_state(
            self.problem, CacheLayout(cap=cap, gram=self.use_gram,
                                      track_gap=self.track_gap))

    def outer_iteration(self, mp, perm, perms, clock, *, ttl: int,
                        key=None):
        self.ledger.dispatched()
        return mpbcfw.outer_iteration(self.problem, mp, perm, perms, clock,
                                      lam=self.lam, ttl=ttl,
                                      steps=self.gram_steps,
                                      graphs=self.graphs,
                                      policies=self.policies, key=key)

    def continue_passes(self, mp, perms, clock):
        """Overflow batch of approximate passes (only when an iteration
        runs more than ``approx_batch`` passes)."""
        self.ledger.dispatched()
        return mpbcfw.multi_approx_pass(mp, perms, clock, lam=self.lam,
                                        steps=self.gram_steps,
                                        policies=self.policies)

    def read_stats(self, stats):
        return self.ledger.sync(stats)

    def count_passes(self, mp, st):
        """The state with its host counters charged for the passes that
        ``st`` (stats already read) says ran."""
        return mpbcfw.count_passes(mp, int(st.passes_run), st.blocks,
                                   self.gram_steps)

    def evaluate(self, mp):
        """``(primal, dual, primal_avg)``: ``primal_avg`` at the averaged
        iterate when ``averaged`` (``mpbcfw-avg``), else the primal again
        (the averages are kept all the same; ``extract`` returns them)."""
        return solver_mod.evaluate_objectives(
            self.problem, mp.inner.phi, mp.avg if self.averaged else None,
            self.lam)

    def extract(self, mp):
        w = weights_of(mp.inner.phi, self.lam).cpu().numpy()
        w_avg = weights_of(extract_average(mp.avg, self.lam),
                           self.lam).cpu().numpy()
        return w, w_avg


class AsyncEngine(FusedEngine):
    """Pipelined single-device engine (``mpbcfw-async``).

    Two programs per outer iteration, with no host sync between them: the
    exact oracle of every block at the stale iteration-entry ``w``
    (:func:`repro_torch.core.mpbcfw.async_oracle_program`) and the
    eviction, fold-in and approximate passes on the current state
    (:func:`repro_torch.core.mpbcfw.async_cache_program`).  On CUDA the
    oracle program runs on a side stream, the counterpart of JAX's async
    dispatch:

      * it reads a snapshot ``w`` made on the main stream before the cache
        program mutates ``phi`` in place, after the side stream waits for
        an event recorded behind that snapshot;
      * it is enqueued once the cache program's fold is (one replay of a
        captured step per block, which the host enqueues faster than the
        device runs), so its kernels run beside the fold's;
      * its planes are folded on the main stream in the next iteration,
        after the main stream waits on an event recorded behind the
        oracle; ``record_stream`` tells the caching allocator about both
        cross-stream uses;
      * the kernels launch on the current stream, so the oracle's Viterbi
        launch happens inside ``torch.cuda.stream(side)``.

    On the CPU the two programs run one after the other.  The ledger
    carries the modeled oracle overlap (``TraceRow.oracle_overlap``), read
    in the same sync as the stats.  ``outcome_fn(iteration, k) -> (k,)
    bool`` injects oracle arrivals (stragglers); None means all arrive.
    A bundle's sampler schedules the oracle program's blocks at iteration
    entry, its eviction and oracle policies run in the cache program; a
    gap vector (``gap-ttl``) is written by the approximate passes only,
    as in the reference (the fold writes none).
    """

    capabilities = EngineCapabilities(multipass=True,
                                      supports_averaging=True,
                                      policy_capable=True,
                                      async_oracle=True,
                                      policies=("uniform", "ttl-lru",
                                                "slope"),
                                      **_SINGLE_DEVICE_BUDGET)

    def __init__(self, problem: SSVMProblem, lam: float, *, policies=None):
        super().__init__(problem, lam, policies=policies)
        self.outcome_fn = None
        self._overlap_pending = None
        self._it = 0
        self._side = None           # the oracle's CUDA stream
        self._oracle_ready = None   # event behind the in-flight oracle
        # Timed CUDA events around the latest oracle program on the side
        # stream, and on the main stream around the cache program up to the
        # end of its fold: their device spans, for measuring the overlap.
        self.oracle_span = None
        self.fold_span = None

    def init_state(self, cap: int) -> mpbcfw.AsyncMPState:
        self._check_plan(cap)
        return mpbcfw.init_async_state(
            self.problem, CacheLayout(cap=cap, track_gap=self.track_gap))

    def _done_mask(self, k: int) -> np.ndarray:
        self._it += 1
        if self.outcome_fn is None:
            return np.ones((k,), bool)
        return np.asarray(self.outcome_fn(self._it, k), dtype=bool
                          ).reshape(k)

    def _dispatch_oracle(self, w: torch.Tensor, w_ready, perm):
        """The oracle program at the snapshot ``w``; on CUDA on the side
        stream, after ``w_ready`` (the event behind the snapshot, not
        behind the fold enqueued since)."""
        if w.device.type != "cuda":
            return mpbcfw.async_oracle_program(self.problem, w, perm)
        main = torch.cuda.current_stream(w.device)
        if self._side is None:
            self._side = torch.cuda.Stream(w.device)
        side = self._side
        side.wait_event(w_ready)
        start = torch.cuda.Event(enable_timing=True)
        ready = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(side):
            start.record(side)
            ids, planes = mpbcfw.async_oracle_program(self.problem, w, perm)
            ready.record(side)
        w.record_stream(side)
        planes.record_stream(main)
        self._oracle_ready = ready
        self.oracle_span = (start, ready)
        return ids, planes

    def outer_iteration(self, state, perm, perms, clock, *, ttl: int,
                        key=None):
        mp, pending = state.mp, state.pending
        # The oracle program's blocks, from the iteration-entry cache.
        perm = mpbcfw.exact_schedule(self.policies, mp.cache, perm, key)
        w_ready = None
        if mp.inner.phi.device.type == "cuda":
            main = torch.cuda.current_stream(mp.inner.phi.device)
            if self._oracle_ready is not None:
                # The fold below reads the previous oracle's planes.
                main.wait_event(self._oracle_ready)
        self.ledger.dispatched()
        w = weights_of(mp.inner.phi, self.lam)   # a snapshot: phi mutates
        if w.device.type == "cuda":
            w_ready = torch.cuda.Event()
            w_ready.record(main)
        oracle = []
        self.ledger.dispatched()
        fold_start = fold_end = None
        if w_ready is not None:
            fold_start = torch.cuda.Event(enable_timing=True)
            fold_end = torch.cuda.Event(enable_timing=True)
            fold_start.record(main)

        def after_fold():
            # The oracle program is enqueued once the fold is: the fold is
            # host-enqueued graph replays the device takes longer to run,
            # so the oracle's kernels run beside them.
            if fold_end is not None:
                fold_end.record(main)
                self.fold_span = (fold_start, fold_end)
            with self.program("async_oracle"):
                oracle.append(self._dispatch_oracle(w, w_ready, perm))
        with self.program("async_cache"):
            mp2, clock2, stats = mpbcfw.async_cache_program(
                mp, pending, perms, clock, lam=self.lam, ttl=ttl,
                graphs=self.graphs, after_fold=after_fold,
                policies=self.policies)
        ids, planes = oracle[0]
        new_pending = mpbcfw.PendingOracle(
            ids=ids, planes=planes, done=self._done_mask(len(ids)),
            live=True)
        # Overlap accounting, on the device until read_stats: the oracle
        # program's modeled time is the slope clock's exact-pass constant
        # (clock.t), the cache program's the approximate phase's advance;
        # min(oracle, cache) of it is hidden by the pipeline.
        self._overlap_pending = (
            clock.t, torch.minimum(clock.t, clock2.t - clock.t))
        return (mpbcfw.AsyncMPState(mp=mp2, pending=new_pending), clock2,
                stats)

    def continue_passes(self, state, perms, clock):
        self.ledger.dispatched()
        mp2, clock2, stats = mpbcfw.multi_approx_pass(
            state.mp, perms, clock, lam=self.lam, policies=self.policies)
        return state._replace(mp=mp2), clock2, stats

    def count_passes(self, state, st):
        return state._replace(mp=super().count_passes(state.mp, st))

    def read_stats(self, stats):
        pend, self._overlap_pending = self._overlap_pending, None
        if pend is None:
            return self.ledger.sync(stats)
        st, total, hidden = self.ledger.sync((stats, pend[0], pend[1]))
        self.ledger.overlapped(float(total), float(hidden))
        return st

    def evaluate(self, state):
        return super().evaluate(state.mp)

    def extract(self, state):
        return super().extract(state.mp)


class ShardDriverEngine(FusedEngine):
    """The :class:`repro_torch.shard.ShardEngine` behind the engine
    protocol: each outer iteration (eviction, the exact epoch, the
    approximate batch) one dispatch on this rank of the mesh, read once.
    ``tau`` is the tau-nice chunk size (None: the rank count; 1 runs the
    sequential exact pass).  Checkpoints hold the global arrays
    (``pack_state`` gathers them on every rank; the Solver writes on rank
    0) and restore at any world size (``unpack_state`` slices them)."""

    capabilities = EngineCapabilities(multipass=True, supports_mesh=True,
                                      supports_averaging=True,
                                      uses_tau=True, policy_capable=True,
                                      policies=("uniform", "ttl-lru",
                                                "slope"),
                                      **_SHARD_BUDGET)

    def __init__(self, problem: SSVMProblem, lam: float, mesh,
                 tau: Optional[int], *, averaged: bool = False,
                 use_gram: bool = False, gram_steps: int = 10,
                 policies=None):
        super().__init__(problem, lam,
                         gram_steps=gram_steps if use_gram else None,
                         averaged=averaged, policies=policies)
        self.eng = ShardEngine(problem, mesh, lam=lam, use_gram=use_gram,
                               gram_steps=gram_steps, policies=policies)
        self.mesh = mesh
        self.tau = int(tau) if tau is not None else self.eng.n_shards
        self.ledger = self.eng.ledger
        self.graphs = self.eng.graphs

    def init_state(self, cap: int):
        self._check_plan(cap)
        return self.eng.init_state(cap)

    def outer_iteration(self, mp, perm, perms, clock, *, ttl: int,
                        key=None):
        return self.eng.outer_iteration(mp, perm, perms, clock,
                                        tau=self.tau, ttl=ttl, key=key)

    def continue_passes(self, mp, perms, clock):
        return self.eng.multi_approx_pass(mp, perms, clock)

    def read_stats(self, stats):
        return self.eng.read_stats(stats)

    def pack_state(self, state):
        return self.eng.gather(state)

    def unpack_state(self, tree):
        return self.eng.place(tree)


class ShardAsyncDriverEngine(AsyncEngine):
    """Pipelined mesh engine (``mpbcfw-shard-async``): per outer iteration
    the oracle program (:meth:`repro_torch.shard.ShardEngine
    .async_oracle_pass`: the exact oracles of all blocks at the
    iteration-entry ``w``, ``n / S`` per rank) and the cache program
    (:meth:`~repro_torch.shard.ShardEngine.async_cache_pass`: eviction,
    the fold of the previous oracle results, the sharded approximate
    batch), two dispatches and one host sync, with the serial shard
    engines' collective budget.  The oracle program is enqueued first, on
    the same stream: the state is updated in place, so it reads ``w``
    before the cache program moves ``phi``.  Uniform schedules only, as
    in the reference."""

    capabilities = EngineCapabilities(multipass=True, supports_mesh=True,
                                      supports_averaging=True,
                                      policy_capable=True,
                                      async_oracle=True,
                                      policies=("uniform", "ttl-lru",
                                                "slope"),
                                      **_SHARD_BUDGET)

    def __init__(self, problem: SSVMProblem, lam: float, mesh, *,
                 gram_steps: int = 10, policies=None):
        super().__init__(problem, lam, policies=policies)
        if policies is not None and policies.sampling.name != "uniform":
            raise UnsupportedConfigError(
                "mpbcfw-shard-async runs the uniform exact schedule (the "
                "pipelined oracle program shards the whole permutation); "
                f"sampler {policies.sampling.name!r} is unsupported — use "
                "mpbcfw-async for sampled schedules.")
        self.eng = ShardEngine(problem, mesh, lam=lam,
                               gram_steps=gram_steps, policies=policies)
        self.mesh = mesh
        self.ledger = self.eng.ledger
        self.graphs = self.eng.graphs

    def init_state(self, cap: int) -> mpbcfw.AsyncMPState:
        self._check_plan(cap)
        return mpbcfw.AsyncMPState(
            mp=self.eng.init_state(cap),
            pending=mpbcfw.init_pending(self.problem.n, self.problem.d,
                                        self.mesh.device))

    def outer_iteration(self, state, perm, perms, clock, *, ttl: int,
                        key=None):
        del key
        with self.program("async_oracle"):
            ids, planes = self.eng.async_oracle_pass(state.mp.inner.phi,
                                                     perm)
        with self.program("async_cache"):
            mp2, clock2, stats = self.eng.async_cache_pass(
                state.mp, state.pending, perms, clock, ttl=ttl)
        new_pending = mpbcfw.PendingOracle(
            ids=ids, planes=planes, done=self._done_mask(len(ids)),
            live=True)
        self._overlap_pending = (
            clock.t, torch.minimum(clock.t, clock2.t - clock.t))
        return (mpbcfw.AsyncMPState(mp=mp2, pending=new_pending), clock2,
                stats)

    def continue_passes(self, state, perms, clock):
        mp2, clock2, stats = self.eng.multi_approx_pass(state.mp, perms,
                                                        clock)
        return state._replace(mp=mp2), clock2, stats

    def read_stats(self, stats):
        pend, self._overlap_pending = self._overlap_pending, None
        if pend is None:
            return self.eng.read_stats(stats)
        st, (total, hidden) = self.eng.read_stats(stats, extra=pend)
        self.ledger.overlapped(float(total), float(hidden))
        return st

    def pack_state(self, state):
        return state._replace(mp=self.eng.gather(state.mp))

    def unpack_state(self, tree):
        return tree._replace(mp=self.eng.place(tree.mp))


# ---------------------------------------------------------------------------
# Single-program engines (one exact pass per outer iteration)
#
# Each returns as its stats a device value the iteration wrote last, with
# the host counters, so that read_stats' one sync waits for the
# iteration's device work (wall-clock mode times the compute).


class FWEngine(_EngineBase):
    """Batch Frank-Wolfe (paper Alg. 1): n oracle calls per iteration in
    one batched call, no per-block state, no permutation.  The oracle-call
    counter rides in the state tuple (a host int), so checkpoints resume
    it exactly."""

    capabilities = EngineCapabilities(needs_perm=False,
                                      **_SINGLE_DEVICE_BUDGET)

    def init_state(self, cap: int):
        del cap
        return (torch.zeros((self.problem.d + 1,), dtype=torch.float32,
                            device=_device(self.problem)), 0)

    def outer_iteration(self, state, perm, perms, clock, *, ttl: int):
        del perm, perms, clock, ttl
        phi, calls = state
        self.ledger.dispatched()
        phi = bcfw.fw_pass(self.problem, phi, self.lam)
        calls += self.problem.n
        return (phi, calls), None, (calls, phi[-1:])

    def read_stats(self, stats):
        calls, _ = self.ledger.sync(stats)
        return IterStats(n_exact=int(calls), n_approx=0)

    def evaluate(self, state):
        return solver_mod.evaluate_objectives(self.problem, state[0], None,
                                              self.lam)

    def extract(self, state):
        return weights_of(state[0], self.lam).cpu().numpy(), None


class SSGEngine(_EngineBase):
    """Stochastic subgradient baseline: no dual certificate (dual and gap
    are reported as NaN).  The step counter ``t`` (the 1/(lam t)
    schedule, starting at 1, an () int32 tensor on the device) doubles as
    the oracle-call counter.  One captured-graph replay per block on the
    card (:func:`repro_torch.core.subgradient.ssg_pass`)."""

    capabilities = EngineCapabilities(needs_perm=True,
                                      **_SINGLE_DEVICE_BUDGET)

    def init_state(self, cap: int):
        del cap
        dev = _device(self.problem)
        return (torch.zeros((self.problem.d,), dtype=torch.float32,
                            device=dev),
                torch.ones((), dtype=torch.int32, device=dev))

    def outer_iteration(self, state, perm, perms, clock, *, ttl: int):
        del perms, clock, ttl
        w, t = state
        self.ledger.dispatched()
        subgradient.ssg_pass(self.problem, w, t, perm, self.lam,
                             graphs=self.graphs)
        return (w, t), None, t

    def read_stats(self, stats):
        return IterStats(n_exact=int(self.ledger.sync(stats)) - 1,
                         n_approx=0)

    def evaluate(self, state):
        primal = solver_mod.ssg_primal(self.problem, state[0], self.lam)
        return primal, float("nan"), primal

    def extract(self, state):
        return state[0].cpu().numpy(), None


class BCFWEngine(_EngineBase):
    """Block-coordinate Frank-Wolfe (paper Alg. 2), with the Sec-3.6
    averaging tracks kept (reported when ``averaged``, ``bcfw-avg``).  The
    pass replays one captured CUDA graph per block on the card
    (:func:`repro_torch.core.bcfw.exact_pass`)."""

    capabilities = EngineCapabilities(needs_perm=True,
                                      supports_averaging=True,
                                      **_SINGLE_DEVICE_BUDGET)

    def __init__(self, problem: SSVMProblem, lam: float, *,
                 averaged: bool = False):
        super().__init__(problem, lam)
        self.averaged = averaged

    def init_state(self, cap: int):
        del cap
        dev = _device(self.problem)
        return (init_bcfw_state(self.problem, dev),
                init_averaging(self.problem.d, dev))

    def outer_iteration(self, state, perm, perms, clock, *, ttl: int):
        del perms, clock, ttl
        st, avg = state
        self.ledger.dispatched()
        st, avg = bcfw.exact_pass(self.problem, st, avg, perm, self.lam,
                                  graphs=self.graphs)
        return (st, avg), None, (st.n_exact, st.phi[-1:])

    def read_stats(self, stats):
        n_exact, _ = self.ledger.sync(stats)
        return IterStats(n_exact=int(n_exact), n_approx=0)

    def evaluate(self, state):
        st, avg = state
        return solver_mod.evaluate_objectives(
            self.problem, st.phi, avg if self.averaged else None, self.lam)

    def extract(self, state):
        st, avg = state
        w = weights_of(st.phi, self.lam).cpu().numpy()
        w_avg = weights_of(extract_average(avg, self.lam),
                           self.lam).cpu().numpy()
        return w, w_avg


# ---------------------------------------------------------------------------
# Registration, in the reference's order.  overwrite=True keeps a re-import
# after a failed first import clear of the duplicate guard.


def _shard_factory(problem: SSVMProblem, cfg: RunConfig,
                   averaged: bool = False,
                   use_gram: bool = False) -> ShardDriverEngine:
    """The shard engines on ``RunConfig.mesh`` (None: a mesh of the
    default process group, on the problem's device)."""
    return ShardDriverEngine(
        problem, cfg.lam, ensure_data_mesh(cfg.mesh,
                                           device=_device(problem)),
        cfg.tau, averaged=averaged, use_gram=use_gram,
        gram_steps=cfg.gram_steps, policies=_policies(problem, cfg))


def _gram_factory(problem: SSVMProblem, cfg: RunConfig):
    """``mpbcfw-gram`` resolves by configuration: the single-device engine
    without a mesh, the sharded gram engine with one."""
    if cfg.mesh is not None:
        return _shard_factory(problem, cfg, use_gram=True)
    return FusedEngine(problem, cfg.lam, gram_steps=cfg.gram_steps,
                       policies=_policies(problem, cfg))


def _shard_async_factory(problem: SSVMProblem,
                         cfg: RunConfig) -> ShardAsyncDriverEngine:
    return ShardAsyncDriverEngine(
        problem, cfg.lam, ensure_data_mesh(cfg.mesh,
                                           device=_device(problem)),
        gram_steps=cfg.gram_steps, policies=_policies(problem, cfg))


def _gap_factory(problem: SSVMProblem, cfg: RunConfig):
    """``mpbcfw-gap``: gap-proportional gumbel-top-k sampling and gap-aware
    eviction (default bundle ``GAP_POLICIES``; ``RunConfig.policies``
    overrides it).  With a mesh the sampled schedule needs the sequential
    exact path, so tau is pinned to 1 (``RunConfig.tau`` is refused by
    the capability check), which only a world size of 1 divides, as in
    the reference."""
    from ..policy import GAP_POLICIES
    bundle = _policies(problem, cfg, allow_key=True, default=GAP_POLICIES)
    if cfg.mesh is not None:
        return ShardDriverEngine(
            problem, cfg.lam, ensure_data_mesh(cfg.mesh,
                                               device=_device(problem)),
            1, gram_steps=cfg.gram_steps, policies=bundle)
    return FusedEngine(problem, cfg.lam, policies=bundle)


def _register(name, factory, capabilities):
    def make(problem, cfg, _factory=factory, _caps=capabilities):
        engine = _factory(problem, cfg)
        # The instance's capabilities are its registry entry's, also where
        # the entry refines the class default (mpbcfw-gram).
        engine.capabilities = _caps
        return engine

    register_engine(name, make, capabilities, overwrite=True)


_register("fw", lambda p, cfg: FWEngine(p, cfg.lam), FWEngine.capabilities)
_register("ssg", lambda p, cfg: SSGEngine(p, cfg.lam),
          SSGEngine.capabilities)
_register("bcfw", lambda p, cfg: BCFWEngine(p, cfg.lam),
          BCFWEngine.capabilities)
_register("bcfw-avg", lambda p, cfg: BCFWEngine(p, cfg.lam, averaged=True),
          BCFWEngine.capabilities)
_register("mpbcfw",
          lambda p, cfg: FusedEngine(p, cfg.lam, policies=_policies(p, cfg)),
          FusedEngine.capabilities)
_register("mpbcfw-avg",
          lambda p, cfg: FusedEngine(p, cfg.lam, averaged=True,
                                     policies=_policies(p, cfg)),
          FusedEngine.capabilities)
_register(
    "mpbcfw-gap", _gap_factory,
    EngineCapabilities(
        multipass=True, supports_averaging=True, supports_mesh=True,
        mesh_optional=True, policy_capable=True, needs_key=True,
        policies=("gap-topk", "gap-ttl", "slope"), **_SHARD_BUDGET,
        note="Gap-proportional sampling (gumbel-top-k over per-block "
             "duality gaps) with gap-aware eviction; RunConfig.gap_frac "
             "sets the exact-pass fraction.  With RunConfig.mesh the "
             "sampled schedule runs the sequential (tau=1) exact path; "
             "a 1-device mesh is bit-for-bit equal to the single-device "
             "program."))
_register(
    "mpbcfw-gram", _gram_factory,
    EngineCapabilities(
        multipass=True, supports_gram=True, supports_averaging=True,
        supports_mesh=True, uses_tau=True, tau_requires_mesh=True,
        mesh_optional=True, policy_capable=True,
        policies=("uniform", "ttl-lru", "slope"), **_SHARD_BUDGET,
        note="mpbcfw-gram with RunConfig.mesh resolves to the sharded "
             "gram engine (the mpbcfw-shard-gram path: PlaneCache.gram "
             "shards with the blocks), which also consumes "
             "RunConfig.tau."))
_register(
    "mpbcfw-async",
    lambda p, cfg: AsyncEngine(p, cfg.lam, policies=_policies(p, cfg)),
    dataclasses.replace(
        AsyncEngine.capabilities,
        note="Pipelined oracle: two programs dispatched per outer "
             "iteration (exact oracles for the next iteration at stale "
             "w, eviction + monotone fold-in + approximate batch on the "
             "current state), <= 2 dispatches + 1 host sync, proven by "
             "analysis rule J009; TraceRow.oracle_overlap reports the "
             "hidden fraction of the modeled oracle time."))
_register(
    "mpbcfw-shard-async", _shard_async_factory,
    dataclasses.replace(
        ShardAsyncDriverEngine.capabilities,
        note="Pipelined oracle on the 1-D data mesh: the per-shard "
             "oracle program (zero collectives) overlaps the "
             "psum-synchronized cache passes; collective budgets match "
             "the serial shard family."))
_register("mpbcfw-shard", _shard_factory, ShardDriverEngine.capabilities)
_register("mpbcfw-shard-avg",
          lambda p, cfg: _shard_factory(p, cfg, averaged=True),
          ShardDriverEngine.capabilities)
_register("mpbcfw-shard-tau", _shard_factory,
          dataclasses.replace(ShardDriverEngine.capabilities,
                              requires_tau=True))
_register(
    "mpbcfw-shard-gram",
    lambda p, cfg: _shard_factory(p, cfg, use_gram=True),
    dataclasses.replace(ShardDriverEngine.capabilities,
                        supports_gram=True,
                        note="Sec-3.5 Gram scheme on the mesh-sharded "
                             "plane cache; bit-for-bit equal to "
                             "mpbcfw-gram on a 1-device mesh."))

"""Execution engines and their registry (PyTorch port).

An engine owns the passes of one optimizer family and is driven by
:class:`repro_torch.api.Solver` through a fixed seam: ``init_state``,
``outer_iteration``, ``continue_passes``, ``read_stats``,
``count_passes``, ``evaluate`` and ``extract``, plus a
:class:`~repro_torch.core.selection.SyncLedger`.

Ported: :class:`FusedEngine` as ``mpbcfw`` and, with the Sec-3.5 Gram
blocks in its plane cache, as ``mpbcfw-gram``; :class:`AsyncEngine` as
``mpbcfw-async``.  Every other algorithm name raises
:class:`~repro_torch.api.errors.UnsupportedConfigError` (not yet ported).
The engines' states are NamedTuples of tensors, which
:class:`repro_torch.checkpoint.CheckpointManager` saves as they are.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..cache import CacheLayout
from ..core import mpbcfw
from ..core.averaging import extract as extract_average
from ..core.graphs import StepGraphs
from ..core.selection import SyncLedger
from ..core.ssvm import weights_of
from ..core.types import SSVMProblem
from .config import RunConfig
from .errors import UnsupportedConfigError

class FusedEngine:
    """Single-device MP-BCFW engine (:func:`repro_torch.core.mpbcfw
    .outer_iteration`).  ``outer_iteration`` enqueues the iteration's
    device work, the slope-gated approximate passes included, without a
    host read; ``read_stats`` is the one host sync per dispatch, counted
    on ``ledger``, and ``count_passes`` then charges the passes that ran
    to the state's host counters.  A ``gram_steps`` count keeps Gram
    blocks in the plane cache, which switches the approximate passes to
    the Sec-3.5 scheme, ``gram_steps`` updates per block.  On CUDA the
    exact pass replays one captured CUDA graph per block, kept in
    ``graphs`` while the state's tensors live
    (:class:`~repro_torch.core.graphs.StepGraphs`)."""

    def __init__(self, problem: SSVMProblem, lam: float, *,
                 gram_steps: Optional[int] = None):
        self.problem = problem
        self.lam = float(lam)
        self.gram_steps = gram_steps
        self.use_gram = gram_steps is not None
        self.ledger = SyncLedger()
        # The exact pass's (and the fold's) captured block steps on CUDA.
        self.graphs = StepGraphs()

    def init_state(self, cap: int) -> mpbcfw.MPState:
        return mpbcfw.init_mp_state(
            self.problem, CacheLayout(cap=cap, gram=self.use_gram))

    def outer_iteration(self, mp, perm, perms, clock, *, ttl: int):
        self.ledger.dispatched()
        return mpbcfw.outer_iteration(self.problem, mp, perm, perms, clock,
                                      lam=self.lam, ttl=ttl,
                                      steps=self.gram_steps,
                                      graphs=self.graphs)

    def continue_passes(self, mp, perms, clock):
        """Overflow batch of approximate passes (only when an iteration
        runs more than ``approx_batch`` passes)."""
        self.ledger.dispatched()
        return mpbcfw.multi_approx_pass(mp, perms, clock, lam=self.lam,
                                        steps=self.gram_steps)

    def read_stats(self, stats):
        return self.ledger.sync(stats)

    def count_passes(self, mp, st):
        """The state with its host counters charged for the passes that
        ``st`` (stats already read) says ran."""
        return mpbcfw.count_passes(mp, int(st.passes_run), st.blocks,
                                   self.gram_steps)

    def evaluate(self, mp):
        """``(primal, dual, primal)``: ``mpbcfw`` reports no averaged
        primal (the averages are kept; ``extract`` returns them)."""
        from .solver import evaluate_objectives
        return evaluate_objectives(self.problem, mp.inner.phi, None,
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
    """

    def __init__(self, problem: SSVMProblem, lam: float):
        super().__init__(problem, lam)
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
        return mpbcfw.init_async_state(self.problem, cap)

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

    def outer_iteration(self, state, perm, perms, clock, *, ttl: int):
        mp, pending = state.mp, state.pending
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
            oracle.append(self._dispatch_oracle(w, w_ready, perm))
        mp2, clock2, stats = mpbcfw.async_cache_program(
            mp, pending, perms, clock, lam=self.lam, ttl=ttl,
            graphs=self.graphs, after_fold=after_fold)
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
            state.mp, perms, clock, lam=self.lam)
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


EngineFactory = Callable[[SSVMProblem, RunConfig], FusedEngine]

_REGISTRY: Dict[str, EngineFactory] = {
    "mpbcfw": lambda problem, cfg: FusedEngine(problem, cfg.lam),
    "mpbcfw-gram": lambda problem, cfg: FusedEngine(
        problem, cfg.lam, gram_steps=cfg.gram_steps),
    "mpbcfw-async": lambda problem, cfg: AsyncEngine(problem, cfg.lam),
}


def algorithms():
    """The algorithm names the port runs."""
    return tuple(_REGISTRY)


def engine_factory(name: str) -> EngineFactory:
    factory = _REGISTRY.get(name)
    if factory is None:
        raise UnsupportedConfigError(
            f"algorithm {name!r} is not yet ported to repro_torch; "
            f"ported: {algorithms()}")
    return factory


def validate_config(cfg: RunConfig) -> None:
    """Reject configs the ported engine cannot run."""
    if cfg.approx_batch < 1:
        raise UnsupportedConfigError(
            "approx_batch must be >= 1 (use max_approx_passes=0 to "
            "disable approximate passes)")
    if cfg.ttl < 1:
        raise UnsupportedConfigError(
            f"ttl must be >= 1 (planes must survive at least the iteration "
            f"that inserted them), got {cfg.ttl}")
    if cfg.gap_tol is not None and cfg.gap_tol < 0.0:
        raise UnsupportedConfigError(
            f"gap_tol must be >= 0, got {cfg.gap_tol}")

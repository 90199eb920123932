"""The :class:`Solver` facade: the MP-BCFW control loop (PyTorch port).

The loop draws the block permutations from ``np.random.RandomState(
cfg.seed)`` in exactly the reference's order (``repro/api/solver.py``):
per outer iteration one permutation for the exact pass, then
``min(approx_batch, max_approx_passes)`` for the approximate batch, used
or not, then one more batch per overflow continuation.  The same seed
therefore gives both packages the same block schedule.

Sync accounting: the engine reads the slope rule's continue flag once per
approximate pass and the iteration's telemetry once, all counted on its
:class:`~repro_torch.core.selection.SyncLedger` and reported in
``TraceRow.host_syncs`` (1 + passes run).  The reference holds one sync
per iteration; the gap is logged in ROADMAP C.

Time comes from a :class:`~repro_torch.core.selection.CostModel` (virtual
clock, deterministic) or from the wall clock, with the evaluation sweep
(:func:`evaluate_objectives`, n oracle calls) excluded from every reading.
This slice has no checkpoint and no recorder.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Callable, Iterable, Iterator, List, Optional

import numpy as np
import torch

from ..core import mpbcfw
from ..core.selection import CostModel, attribute_wall_time
from ..core.ssvm import dual_value, primal_value, weights_of
from ..core.averaging import extract as extract_average
from ..core.types import SSVMProblem
from .config import RunConfig, RunResult, TraceRow
from .engines import engine_factory, validate_config
from .stopping import (MaxIters, StopContext, StopOnGap, StoppingCriterion,
                       WallTimeBudget)

Callback = Callable[["Solver", TraceRow], None]


class _Clock:
    """Wall or virtual time; durations inside :meth:`exclude` never reach
    trace rows.  A CostModel clock only advances through explicit
    charges."""

    def __init__(self, cost_model: Optional[CostModel]):
        self.cm = cost_model
        self._wall0 = time.perf_counter()
        self._excluded = 0.0
        self._started = False

    def start(self) -> None:
        """Anchor the wall clock when iteration begins (once)."""
        if not self._started:
            self._started = True
            self._wall0 = time.perf_counter()
            self._excluded = 0.0

    def _wall(self) -> float:
        return time.perf_counter() - self._wall0 - self._excluded

    @contextmanager
    def exclude(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._excluded += time.perf_counter() - t0

    def exact(self, n_calls: int) -> float:
        if self.cm is not None:
            return self.cm.exact_pass(n_calls)
        return self._wall()

    def approx(self, total_planes: int) -> float:
        if self.cm is not None:
            return self.cm.approx_pass(total_planes)
        return self._wall()

    def now(self) -> float:
        if self.cm is not None:
            return self.cm.now
        return self._wall()


def evaluate_objectives(problem: SSVMProblem, phi: torch.Tensor, avg,
                        lam: float):
    """Primal, dual and the primal at the averaged iterate (the primal
    again when ``avg`` is None): one batched oracle sweep each."""
    primal = primal_value(problem, weights_of(phi, lam), lam)
    dual = dual_value(phi, lam)
    primal_avg = (primal if avg is None else primal_value(
        problem, weights_of(extract_average(avg, lam), lam), lam))
    return float(primal), float(dual), float(primal_avg)


def _fit_pass_costs(xs: List[float], ys: List[float]):
    """Least-squares fit of iteration time ~ exact_cost + plane_cost * x
    over the last 8 iterations; None unless both terms come out > 0."""
    if len(xs) < 2:
        return None
    x = np.asarray(xs[-8:], np.float64)
    y = np.asarray(ys[-8:], np.float64)
    var = float(np.var(x))
    if var <= 0.0:
        return None
    b = float(np.mean((x - x.mean()) * (y - y.mean()))) / var
    a = float(y.mean() - b * x.mean())
    if a <= 0.0 or b <= 0.0:
        return None
    return a, b


def _draw_perms(rng: np.random.RandomState, n: int, k: int) -> np.ndarray:
    if k == 0:
        return np.zeros((0, n), np.int64)
    return np.stack([rng.permutation(n) for _ in range(k)])


class Solver:
    """SSVM training facade: ``Solver(problem, cfg).run()``.

    :meth:`iterate` streams one :class:`TraceRow` per outer iteration
    until a stopping criterion fires; :meth:`run` drains it and returns a
    :class:`RunResult`.
    """

    def __init__(self, problem: SSVMProblem, cfg: RunConfig, *,
                 stop: Iterable[StoppingCriterion] = (),
                 callbacks: Iterable[Callback] = ()):
        factory = engine_factory(cfg.algo)
        validate_config(cfg)
        self.problem = problem
        self.cfg = cfg
        self.engine = factory(problem, cfg)
        self.callbacks = list(callbacks)
        self.stop_criteria: List[StoppingCriterion] = [
            MaxIters(cfg.max_iters)]
        if cfg.gap_tol is not None:
            self.stop_criteria.append(StopOnGap(cfg.gap_tol))
        if cfg.time_budget is not None:
            self.stop_criteria.append(WallTimeBudget(cfg.time_budget))
        self.stop_criteria.extend(stop)

        self._rng = np.random.RandomState(cfg.seed)
        self._clock = _Clock(cfg.cost_model)
        self._state = self.engine.init_state(cfg.cap)
        self._it = 0
        self._last_row: Optional[TraceRow] = None
        self.trace: List[TraceRow] = []
        # Per-pass cost constants of the slope rule: the CostModel's own
        # in simulation; in wall mode, defaults recalibrated from measured
        # iteration times.
        cm = cfg.cost_model
        self._est_exact = cm.oracle_cost * problem.n if cm is not None else 1.0
        self._est_plane = cm.plane_cost if cm is not None else 1e-3
        self._wall_x: List[float] = []  # plane-steps per iteration
        self._wall_y: List[float] = []  # measured iteration seconds

    @property
    def state(self):
        return self._state

    def result(self) -> RunResult:
        w, w_avg = self.engine.extract(self._state)
        return RunResult(trace=list(self.trace), w=w, w_avg=w_avg)

    def run(self) -> RunResult:
        for _ in self.iterate():
            pass
        return self.result()

    def _should_stop(self) -> bool:
        ctx = StopContext(iteration=self._it, last_row=self._last_row,
                          elapsed=self._clock.now())
        return any(c.should_stop(ctx) for c in self.stop_criteria)

    def iterate(self) -> Iterator[TraceRow]:
        """Run outer iterations, yielding one ``TraceRow`` each, until a
        stopping criterion fires; iterating again continues the run."""
        self._clock.start()
        inner = self._iterate_multipass()
        while not self._should_stop():
            row = next(inner)
            self.trace.append(row)
            self._last_row = row
            self._it += 1
            for cb in self.callbacks:
                cb(self, row)
            yield row

    def _iterate_multipass(self) -> Iterator[TraceRow]:
        """The MP-BCFW control loop (reference ``_iterate_multipass``)."""
        problem, cfg, engine, clock = (self.problem, self.cfg, self.engine,
                                       self._clock)
        n, lam = problem.n, cfg.lam
        cm = cfg.cost_model
        rng = self._rng
        device = self._state.inner.phi.device
        while True:
            it = self._it
            mp = self._state
            led0 = engine.ledger.counts()
            t0 = clock.now()
            plane_cost = cm.plane_cost if cm is not None else self._est_plane
            # Device times are relative to the iteration start (t0 = 0);
            # outer_iteration seeds f0 on the device from the dual at entry.
            clock_dev = mpbcfw.make_slope_clock(0.0, 0.0, self._est_exact,
                                                plane_cost, device)
            perm = rng.permutation(n)
            perms = _draw_perms(rng, n, min(cfg.approx_batch,
                                            cfg.max_approx_passes))
            mp, clock_dev, stats = engine.outer_iteration(
                mp, perm, perms, clock_dev, ttl=cfg.ttl)
            st = engine.read_stats(stats)
            met = st.metrics
            ws_total = int(st.ws_total)
            planes_all = [int(x) for x in st.planes[:st.passes_run]]
            while st.more and len(planes_all) < cfg.max_approx_passes:
                batch = min(cfg.approx_batch,
                            cfg.max_approx_passes - len(planes_all))
                perms = _draw_perms(rng, n, batch)
                mp, clock_dev, stats = engine.continue_passes(mp, perms,
                                                              clock_dev)
                st = engine.read_stats(stats)
                planes_all += [int(x) for x in st.planes[:st.passes_run]]
            led1 = engine.ledger.counts()

            # Charge the device-chosen pass schedule to the virtual clock.
            if cm is not None:
                clock.exact(n)
                for n_planes in planes_all:
                    clock.approx(n_planes)
            else:
                elapsed = clock.now() - t0
                weights = [self._est_exact] + [self._est_plane * max(p, 1)
                                               for p in planes_all]
                durs = attribute_wall_time(elapsed, weights)
                # Calibrate the rule's cost constants: regress elapsed ~
                # a + b * plane_steps across iterations, else pro rata.
                self._wall_x.append(float(sum(max(p, 1)
                                              for p in planes_all)))
                self._wall_y.append(float(elapsed))
                fit = _fit_pass_costs(self._wall_x, self._wall_y)
                if fit is not None:
                    self._est_exact, self._est_plane = fit
                else:
                    self._est_exact = max(durs[0], 1e-9)
                    if planes_all:
                        tot = sum(max(p, 1) for p in planes_all)
                        self._est_plane = max(sum(durs[1:]) / tot, 1e-12)

            w_exact = self._est_exact
            w_total = w_exact + sum(self._est_plane * max(p, 1)
                                    for p in planes_all)
            oracle_share = w_exact / w_total if w_total > 0 else 1.0
            with clock.exclude():
                primal, dual, primal_avg = engine.evaluate(mp)
            self._state = mp
            yield TraceRow(
                it, int(mp.inner.n_exact), int(mp.inner.n_approx),
                clock.now(), primal, dual, primal - dual, primal_avg,
                ws_total / n, len(planes_all),
                led1[0] - led0[0], led1[2] - led0[2],
                cache_hit_rate=int(met.nonempty_blocks) / n,
                planes_evicted=int(met.ttl_evicted) + int(met.lru_evicted),
                oracle_share=oracle_share)

"""The :class:`Solver` facade: the engine-generic SSVM control loop
(PyTorch port).

``RunConfig.algo`` names an engine of the registry
(:mod:`repro_torch.api.engine`), whose capabilities choose the loop: the
MP-BCFW loop for multipass engines (``mpbcfw``, ``mpbcfw-avg``,
``mpbcfw-gram``, ``mpbcfw-async``), one program per outer iteration for
the others (``fw``, ``ssg``, ``bcfw``, ``bcfw-avg``).  The loop draws the
block permutations from ``np.random.RandomState(cfg.seed)`` in exactly the
reference's order (``repro/api/solver.py``): per outer iteration one
permutation for the exact pass (only when the engine ``needs_perm``),
then, in the MP-BCFW loop, ``min(approx_batch, max_approx_passes)`` for
the approximate batch, used or not, then, for an engine that
``needs_key`` (``mpbcfw-gap``), one ``randint(0, 2**31 - 1)`` seed for its
sampler, then one more batch per overflow continuation.  The same seed
therefore gives both packages the same block schedule.

Sync accounting: the approximate passes are gated on the device by the
slope rule, so the engine reads each dispatch's telemetry once and
nothing else, counted on its
:class:`~repro_torch.core.selection.SyncLedger` and reported in
``TraceRow.host_syncs``: one per dispatch, as in the reference.  After
that read the engine charges the passes that ran to the state's host
counters (``count_passes``).  The pipelined engine (``mpbcfw-async``)
also charges the modeled oracle time it hid behind its
cache program on the ledger; the loop reports the hidden share as
``TraceRow.oracle_overlap`` and credits it back to a CostModel clock.

Time comes from a :class:`~repro_torch.core.selection.CostModel` (virtual
clock, deterministic) or from the wall clock, with the evaluation sweep
(:func:`evaluate_objectives`, n oracle calls) excluded from every reading.

:meth:`Solver.save` and :meth:`Solver.restore` checkpoint the engine state
with the host control loop's state (iteration, last row, RNG stream,
clock, slope-rule calibration) through :class:`repro_torch.checkpoint
.CheckpointManager`, in the reference's format: a resumed run continues
bit for bit, and a checkpoint of either package resumes in the other.
The manifest's ``metrics`` carries :attr:`Solver.metrics`' snapshot, which
:meth:`Solver.restore` loads, so the metric series continues across a
resume in either package.

On a data mesh (the shard engines, ``RunConfig.mesh``) every rank runs
the same Solver: the same RNG stream, the same reduced telemetry, so the
same trace on every rank.  :meth:`Solver.save` gathers the global state
on every rank and writes it on rank 0 alone, then waits for the ranks; a
recorder is taken on rank 0 only (another rank's is refused).

Observability: ``Solver(..., recorder=RunRecorder(path))`` installs a
:class:`repro_torch.obs.RunRecorder` after the user's callbacks; it owns
the metrics registry and writes the reference's run trace (rows, phase
spans, events; ``checkpoint_save``/``checkpoint_restore`` spans).  In wall
mode the loop timestamps the host syncs it already pays (one segment per
dispatch) and, with a recorder, takes the slope rule's cost constants
from the recorder's fit of those segments
(:meth:`~repro_torch.obs.RunRecorder.observe_phases`).  Neither the
registry nor the recorder reads a tensor.
"""
from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager, nullcontext
from typing import (TYPE_CHECKING, Callable, Iterable, Iterator, List,
                    Optional)

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..core import mpbcfw
from ..core.selection import CostModel, attribute_wall_time
from ..core.ssvm import batched_oracle, dual_value, primal_value, weights_of
from ..core.averaging import extract as extract_average
from ..core.types import SSVMProblem
from ..obs.metrics import MetricsRegistry
from .config import RunConfig, RunResult, TraceRow
from .engine import engine_entry, validate_config
from .stopping import (MaxIters, StopContext, StopOnGap, StoppingCriterion,
                       WallTimeBudget)

if TYPE_CHECKING:  # annotation only
    from ..obs.recorder import RunRecorder

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


def ssg_primal(problem: SSVMProblem, w: torch.Tensor, lam: float) -> float:
    """Primal objective at a raw weight vector (no dual certificate)."""
    planes = batched_oracle(problem, w)
    return float(0.5 * lam * torch.dot(w, w)
                 + torch.sum(planes[:, :-1] @ w + planes[:, -1]))


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


def _rng_state_to_json(rng: np.random.RandomState) -> list:
    name, keys, pos, has_gauss, cached = rng.get_state()
    return [name, [int(x) for x in keys], int(pos), int(has_gauss),
            float(cached)]


def _rng_state_from_json(state: list):
    name, keys, pos, has_gauss, cached = state
    return (name, np.asarray(keys, np.uint32), int(pos), int(has_gauss),
            float(cached))


class Solver:
    """SSVM training facade: ``Solver(problem, cfg).run()``.

    :meth:`iterate` streams one :class:`TraceRow` per outer iteration
    until a stopping criterion fires; :meth:`run` drains it and returns a
    :class:`RunResult`; :meth:`save` and :meth:`restore` checkpoint and
    resume.  With ``checkpoint`` and ``checkpoint_every > 0`` the loop
    saves after every ``checkpoint_every``-th iteration, off the clock.
    ``recorder`` writes the run's JSONL trace (:mod:`repro_torch.obs`).
    """

    def __init__(self, problem: SSVMProblem, cfg: RunConfig, *,
                 stop: Iterable[StoppingCriterion] = (),
                 callbacks: Iterable[Callback] = (),
                 checkpoint: Optional[CheckpointManager] = None,
                 checkpoint_every: int = 0,
                 recorder: Optional["RunRecorder"] = None):
        entry = engine_entry(cfg.algo)
        validate_config(entry, cfg)
        self.problem = problem
        self.cfg = cfg
        self.engine = entry.factory(problem, cfg)
        self.caps = entry.capabilities
        # The engine's data mesh, on the mesh engines: rank 0 writes.
        self.mesh = getattr(self.engine, "mesh", None)
        self.rank = 0 if self.mesh is None else self.mesh.rank
        if recorder is not None and self.rank != 0:
            raise ValueError(
                f"a RunRecorder writes on rank 0 only; pass recorder=None "
                f"on rank {self.rank}")
        self.callbacks = list(callbacks)
        self.checkpoint = checkpoint
        self.checkpoint_every = int(checkpoint_every)
        # One metrics registry always, so a checkpoint carries the series:
        # the recorder's (it runs as the last row callback and feeds it),
        # else the Solver's own, fed in iterate().
        self.recorder = recorder
        if recorder is not None:
            self.metrics: MetricsRegistry = recorder.registry
            self.callbacks.append(recorder)
            recorder.open_run(self)
        else:
            self.metrics = MetricsRegistry()
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

    @property
    def iteration(self) -> int:
        """Index of the next outer iteration to run."""
        return self._it

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
        inner = (self._iterate_multipass() if self.caps.multipass
                 else self._iterate_simple())
        ledger = getattr(self.engine, "ledger", None)
        while not self._should_stop():
            ann = (self.recorder.step_annotation(self._it)
                   if self.recorder is not None else nullcontext())
            coll0 = getattr(ledger, "collectives", 0)
            bytes0 = getattr(ledger, "collective_bytes", 0)
            with ann:
                row = next(inner)
            self.trace.append(row)
            self._last_row = row
            self._it += 1
            if self.recorder is None:
                # With a recorder its row callback feeds the registry.
                self.metrics.observe_row(
                    row,
                    collectives=getattr(ledger, "collectives", 0) - coll0,
                    collective_bytes=getattr(ledger, "collective_bytes",
                                             0) - bytes0)
            for cb in self.callbacks:
                cb(self, row)
            if (self.checkpoint is not None and self.checkpoint_every > 0
                    and self._it % self.checkpoint_every == 0):
                with self._clock.exclude():
                    self.save(self.checkpoint)
            yield row

    def _iterate_simple(self) -> Iterator[TraceRow]:
        """One program per outer iteration, no approximate phase (``fw``,
        ``ssg``, ``bcfw`` and any registered non-multipass engine)."""
        engine, cfg, clock = self.engine, self.cfg, self._clock
        n = self.problem.n
        while True:
            it = self._it
            led0 = engine.ledger.counts()
            perm = self._rng.permutation(n) if self.caps.needs_perm else None
            self._state, _, stats = engine.outer_iteration(
                self._state, perm, None, None, ttl=cfg.ttl)
            st = engine.read_stats(stats)   # the iteration's one sync
            t = clock.exact(n)
            with clock.exclude():
                primal, dual, primal_avg = engine.evaluate(self._state)
            led1 = engine.ledger.counts()
            yield TraceRow(it, int(st.n_exact), int(st.n_approx), t,
                           primal, dual, primal - dual, primal_avg,
                           0.0, 0, led1[0] - led0[0], led1[2] - led0[2])

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
            ovl0 = (engine.ledger.oracle_time_total,
                    engine.ledger.oracle_time_hidden)
            t0 = clock.now()
            plane_cost = cm.plane_cost if cm is not None else self._est_plane
            # Device times are relative to the iteration start (t0 = 0);
            # outer_iteration seeds f0 on the device from the dual at entry.
            clock_dev = mpbcfw.make_slope_clock(0.0, 0.0, self._est_exact,
                                                plane_cost, device)
            perm = rng.permutation(n)
            perms = _draw_perms(rng, n, min(cfg.approx_batch,
                                            cfg.max_approx_passes))
            # A keyed sampler's seed, drawn after the permutations (the
            # reference's order and call), so every engine without the
            # capability keeps its RNG stream.
            key_kw = ({"key": int(rng.randint(0, 2 ** 31 - 1))}
                      if self.caps.needs_key else {})
            mp, clock_dev, stats = engine.outer_iteration(
                mp, perm, perms, clock_dev, ttl=cfg.ttl, **key_kw)
            st = engine.read_stats(stats)
            # Right after the sync, where the host waited for the card.
            t_sync = clock.now()
            mp = engine.count_passes(mp, st)
            met = st.metrics
            ws_total = int(st.ws_total)
            planes_all = [int(x) for x in st.planes[:st.passes_run]]
            # Measured program-boundary segments (plane steps, seconds),
            # one per dispatch, from the syncs the loop pays anyway:
            # segment 0 spans the exact pass and the first batch, later
            # ones approximate-only continuations (the recorder's
            # calibration in wall mode).
            segs = [(sum(max(p, 1) for p in planes_all), t_sync - t0)]
            while st.more and len(planes_all) < cfg.max_approx_passes:
                batch = min(cfg.approx_batch,
                            cfg.max_approx_passes - len(planes_all))
                perms = _draw_perms(rng, n, batch)
                mp, clock_dev, stats = engine.continue_passes(mp, perms,
                                                              clock_dev)
                st = engine.read_stats(stats)
                t_prev, t_sync = t_sync, clock.now()
                mp = engine.count_passes(mp, st)
                b_planes = [int(x) for x in st.planes[:st.passes_run]]
                planes_all += b_planes
                segs.append((sum(max(p, 1) for p in b_planes),
                             t_sync - t_prev))
            led1 = engine.ledger.counts()
            ovl_total = engine.ledger.oracle_time_total - ovl0[0]
            ovl_hidden = engine.ledger.oracle_time_hidden - ovl0[1]
            oracle_overlap = (ovl_hidden / ovl_total if ovl_total > 0
                              else 0.0)

            # Charge the device-chosen pass schedule to the virtual clock; a
            # sampled schedule runs fewer exact oracle calls than n.
            if cm is not None:
                clock.exact(n if met.gap_sampled is None
                            else int(met.gap_sampled))
                for n_planes in planes_all:
                    clock.approx(n_planes)
                # Pipelined engines: the oracle and cache programs ran
                # side by side, so the iteration costs max(oracle, cache),
                # not their sum; credit back the hidden part (at most the
                # exact charge above, so the clock stays monotone).
                if ovl_hidden > 0.0:
                    cm.now -= ovl_hidden
            else:
                elapsed = clock.now() - t0
                weights = [self._est_exact] + [self._est_plane * max(p, 1)
                                               for p in planes_all]
                durs = attribute_wall_time(elapsed, weights)
                # Calibrate the rule's cost constants.  With a recorder,
                # from its fit of the measured segments (None keeps the
                # current constants); without one, regress elapsed ~
                # a + b * plane_steps across iterations, else pro rata.
                self._wall_x.append(float(sum(max(p, 1)
                                              for p in planes_all)))
                self._wall_y.append(float(elapsed))
                if self.recorder is not None:
                    fit = self.recorder.observe_phases(segs)
                    if fit is not None:
                        self._est_exact, self._est_plane = fit
                else:
                    fit = _fit_pass_costs(self._wall_x, self._wall_y)
                    if fit is not None:
                        self._est_exact, self._est_plane = fit
                    else:
                        self._est_exact = max(durs[0], 1e-9)
                        if planes_all:
                            tot = sum(max(p, 1) for p in planes_all)
                            self._est_plane = max(sum(durs[1:]) / tot,
                                                  1e-12)

            w_exact = self._est_exact
            w_total = w_exact + sum(self._est_plane * max(p, 1)
                                    for p in planes_all)
            oracle_share = w_exact / w_total if w_total > 0 else 1.0
            # The gap columns ride the same sync; engines without a gap
            # vector report the TraceRow defaults.
            gap_kw = ({} if met.gap_total is None else dict(
                gap_total=float(met.gap_total),
                gap_sampled=int(met.gap_sampled)))
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
                oracle_share=oracle_share, oracle_overlap=oracle_overlap,
                **gap_kw)

    # -- serving export -----------------------------------------------------

    def servable(self, *, averaged: bool = False,
                 meta: Optional[dict] = None):
        """Export the current weights as a
        :class:`repro_torch.serve.ServableModel` (the problem must have been
        built from an :class:`~repro_torch.api.oracle.OracleSpec`).  The
        lazy import keeps training-only processes free of the serving
        layer."""
        from ..serve.export import ServableModel

        return ServableModel.from_solver(self, averaged=averaged,
                                         meta=meta)

    # -- checkpoint / resume ------------------------------------------------

    def save(self, manager: Optional[CheckpointManager] = None,
             step: Optional[int] = None) -> int:
        """Checkpoint the engine state and the control loop's host state
        under ``step`` (default: the current iteration); returns it.  The
        ``extra`` keys are the reference's, legacy flat keys included.  On
        a mesh every rank calls it: the state is gathered on every rank,
        rank 0 writes, and the ranks wait for the write."""
        manager = manager or self.checkpoint
        if manager is None:
            raise ValueError("no CheckpointManager: pass one to save() or "
                             "to the Solver constructor")
        step = self._it if step is None else int(step)
        pack = getattr(self.engine, "pack_state", None)
        tree = pack(self._state) if pack is not None else self._state
        extra = {
            "algo": self.cfg.algo,
            "iteration": self._it,
            # Stopping criteria read the previous row before the first
            # resumed iteration.
            "last_row": (dataclasses.asdict(self._last_row)
                         if self._last_row is not None else None),
            "rng_state": _rng_state_to_json(self._rng),
            "clock_now": self._clock.now(),
            # JSON round-trips Python floats exactly.
            "calibration": {
                "est_exact": self._est_exact,
                "est_plane": self._est_plane,
                "wall_x": list(self._wall_x),
                "wall_y": list(self._wall_y),
            },
            "est_exact": self._est_exact,
            "est_plane": self._est_plane,
            "wall_x": self._wall_x,
            "wall_y": self._wall_y,
        }
        span = (self.recorder.span("checkpoint_save", step=step)
                if self.recorder is not None else nullcontext())
        with span:
            if self.rank == 0:
                manager.save(step, tree, extra=extra,
                             metrics=self.metrics.snapshot())
        if self.mesh is not None:
            self.mesh.barrier()
        return step

    @classmethod
    def restore(cls, problem: SSVMProblem, cfg: RunConfig,
                manager: CheckpointManager, step: Optional[int] = None,
                **solver_kwargs) -> "Solver":
        """A solver resumed from a checkpoint (default: the latest step)
        at the saved iteration, RNG stream, clock and metric series.  Under
        a CostModel the rest of the run is bit for bit the uninterrupted
        one.  A recorder in ``solver_kwargs`` records a
        ``checkpoint_restore`` span."""
        solver = cls(problem, cfg, **solver_kwargs)
        span = (solver.recorder.span("checkpoint_restore")
                if solver.recorder is not None else nullcontext())
        with span:
            return cls._restore_into(solver, cfg, manager, step)

    @classmethod
    def _restore_into(cls, solver: "Solver", cfg: RunConfig,
                      manager: CheckpointManager,
                      step: Optional[int]) -> "Solver":
        if step is None:
            step = manager.latest_step()
        manifest = manager.load_manifest(step)
        extra = manifest.get("extra", {})
        if extra.get("algo") not in (None, cfg.algo):
            raise ValueError(
                f"checkpoint was saved by algo={extra['algo']!r}, "
                f"cannot resume as {cfg.algo!r}")
        pack = getattr(solver.engine, "pack_state", None)
        unpack = getattr(solver.engine, "unpack_state", None)
        template = pack(solver._state) if pack is not None else solver._state
        tree, _ = manager.restore(template, step)
        solver._state = unpack(tree) if unpack is not None else tree
        solver._it = int(extra.get("iteration", manifest["step"]))
        if extra.get("last_row") is not None:
            solver._last_row = TraceRow(**extra["last_row"])
        if "rng_state" in extra:
            solver._rng.set_state(_rng_state_from_json(extra["rng_state"]))
        now = float(extra.get("clock_now", 0.0))
        clock = solver._clock
        if clock.cm is not None:
            clock.cm.now = now
        else:
            # Resume the elapsed wall time; iterate() must not re-anchor.
            clock._wall0 = time.perf_counter() - now
            clock._excluded = 0.0
            clock._started = True
        cal = extra.get("calibration") or {
            "est_exact": extra.get("est_exact", solver._est_exact),
            "est_plane": extra.get("est_plane", solver._est_plane),
            "wall_x": extra.get("wall_x", []),
            "wall_y": extra.get("wall_y", []),
        }
        solver._est_exact = float(cal["est_exact"])
        solver._est_plane = float(cal["est_plane"])
        solver._wall_x = [float(x) for x in cal.get("wall_x", [])]
        solver._wall_y = [float(y) for y in cal.get("wall_y", [])]
        solver.metrics.load(manifest.get("metrics"))
        return solver


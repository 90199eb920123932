"""RunRecorder: structured span/event/row persistence for one run (PyTorch
port of ``repro/obs/recorder.py``; both write the same JSONL).

A :class:`RunRecorder` is installed as a :class:`repro_torch.api.Solver`
callback (``Solver(..., recorder=RunRecorder(path))``).  Per outer
iteration it receives the finished :class:`~repro_torch.api.config
.TraceRow` (host scalars the control loop already paid one sync for) and
appends:

  * the row itself, plus the cumulative collective count/bytes read off
    the engine's :class:`~repro_torch.core.selection.SyncLedger` (0 where
    the ledger keeps none),
  * an ``outer_iteration`` span split into ``exact_pass`` /
    ``approx_passes`` sub-spans: from the Solver's measured
    program-boundary segments when it supplies them
    (:meth:`RunRecorder.observe_phases`, wall mode; also the source of
    the exact/plane cost calibration the Solver reads back), else by the
    row's modeled ``oracle_share``,
  * ``cache_evict`` / ``collectives`` events when they carry signal.

Every write goes through :func:`repro_torch.obs.schema.sanitize`, one
``json.dumps`` and a flush per line, so the file is strict JSONL (NaN/Inf
become null).  The recorder never touches a tensor: it adds no host
sync, no dispatch and no kernel launch to the recorded path.

``profile=True`` arms :meth:`step_annotation`, which the Solver enters
around each outer iteration as a
``torch.profiler.record_function("outer_iteration")`` range carrying the
step number, so a ``torch.profiler`` trace gets one marker per iteration.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Optional

from .metrics import MetricsRegistry
from .schema import SCHEMA_VERSION, sanitize


class RunRecorder:
    """JSONL run recorder + metrics registry owner (one file per run)."""

    def __init__(self, path, *, profile: bool = False,
                 registry: Optional[MetricsRegistry] = None):
        self.path = str(path)
        self.profile = bool(profile)
        self.registry = registry if registry is not None else \
            MetricsRegistry()
        self._fh = open(self.path, "w", encoding="utf-8")
        self._wall0 = time.perf_counter()
        self._closed = False
        self._prev_time = 0.0
        self._led_prev = None  # (collectives, collective_bytes) snapshot
        # Phase-cost calibration from measured program-boundary segments
        # (wall mode; Solver._iterate_multipass).  Segment 0 of an
        # iteration spans the exact(+first approximate batch) dispatch;
        # later segments are approximate-only overflow continuations whose
        # measured durations identify the per-plane cost directly.
        self._phase_pending = None      # this iteration's segments
        self._seg_first = []            # (plane_steps, duration) of seg 0
        self._seg_approx = []           # approx-only continuation samples
        self._phase_fit = None          # last (exact_cost, plane_cost)

    # -- plumbing -----------------------------------------------------------

    def _write(self, record: dict) -> None:
        if self._closed:
            return
        self._fh.write(json.dumps(sanitize(record),
                                  separators=(",", ":")) + "\n")
        self._fh.flush()

    def _host_now(self) -> float:
        return time.perf_counter() - self._wall0

    # -- lifecycle ----------------------------------------------------------

    def open_run(self, solver) -> None:
        """First record: run metadata + the engine's declared budgets
        (what the CLI later checks the measured ledger against).  Called
        by the Solver when the recorder is installed."""
        caps = getattr(solver, "caps", None)
        budgets = {}
        if caps is not None:
            budgets = {
                "collectives_per_pass": caps.collectives_per_pass,
                "collectives_setup": caps.collectives_setup,
                "host_callbacks": caps.host_callbacks,
                "multipass": caps.multipass,
            }
        self._write({
            "type": "meta", "schema": SCHEMA_VERSION,
            "algo": solver.cfg.algo,
            "n": int(solver.problem.n), "d": int(solver.problem.d),
            "time_mode": ("cost_model" if solver.cfg.cost_model is not None
                          else "wall"),
            "engine_budgets": budgets,
        })

    def open_custom(self, *, algo: str, n: int, d: int,
                    time_mode: str = "wall",
                    engine_budgets: Optional[dict] = None,
                    **extra) -> None:
        """Write a schema-valid meta record for a non-Solver run (the
        serving loop, :mod:`repro_torch.serve.batcher`): the same required
        fields, the caller's values (``algo`` names the workload, e.g.
        ``"serve:ChainSpec"``)."""
        self._write(dict(extra, type="meta", schema=SCHEMA_VERSION,
                         algo=algo, n=int(n), d=int(d),
                         time_mode=time_mode,
                         engine_budgets=dict(engine_budgets or {})))

    def close(self) -> None:
        """Write the summary record (final metrics snapshot) and close."""
        if self._closed:
            return
        self._write({"type": "summary",
                     "metrics": self.registry.snapshot()})
        self._closed = True
        self._fh.close()

    def __enter__(self) -> "RunRecorder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- the Solver callback ------------------------------------------------

    def __call__(self, solver, row) -> None:
        """Record one finished outer iteration (host scalars only)."""
        ledger = getattr(solver.engine, "ledger", None)
        coll = int(getattr(ledger, "collectives", 0))
        nbytes = int(getattr(ledger, "collective_bytes", 0))
        if self._led_prev is None:
            d_coll, d_bytes = coll, nbytes
        else:
            d_coll = coll - self._led_prev[0]
            d_bytes = nbytes - self._led_prev[1]
        self._led_prev = (coll, nbytes)

        self.registry.observe_row(row, collectives=d_coll,
                                  collective_bytes=d_bytes)
        rec = dict(dataclasses.asdict(row), type="row",
                   collectives=coll, collective_bytes=nbytes)
        self._write(rec)

        # Phase spans on the run clock.  Default: the iteration interval
        # split by the modeled oracle share (wall mode cannot time the
        # phases one by one without a sync per phase).  Measured
        # program-boundary segments (:meth:`observe_phases`) replace the
        # pro-rata split: segment 0 still needs a modeled sub-split (the
        # exact pass and the first approximate batch share one dispatch),
        # with the calibrated constants, and every overflow continuation
        # is a measured approximate-only span.
        t0, t1 = self._prev_time, float(row.time)
        self._prev_time = t1
        it = int(row.iteration)
        self.span_record("outer_iteration", t0, t1, iteration=it)
        seg, self._phase_pending = self._phase_pending, None
        if seg:
            p0, d0 = seg[0]
            if self._phase_fit is not None:
                exact, plane = self._phase_fit
                tot = exact + plane * p0
                share = exact / tot if tot > 0.0 else 1.0
            else:
                share = min(max(float(getattr(row, "oracle_share", 1.0)),
                                0.0), 1.0)
            t_mid = t0 + share * d0
            self.span_record("exact_pass", t0, t_mid, iteration=it)
            if row.approx_passes > 0:
                self.span_record("approx_passes", t_mid, t0 + d0,
                                 iteration=it,
                                 passes=int(row.approx_passes))
            t_cur = t0 + d0
            for planes, dur in seg[1:]:
                self.span_record("approx_passes", t_cur, t_cur + dur,
                                 iteration=it, planes=int(planes),
                                 measured=True)
                t_cur += dur
        else:
            share = min(max(float(getattr(row, "oracle_share", 1.0)),
                            0.0), 1.0)
            t_mid = t0 + share * (t1 - t0)
            self.span_record("exact_pass", t0, t_mid, iteration=it)
            if row.approx_passes > 0:
                self.span_record("approx_passes", t_mid, t1, iteration=it,
                                 passes=int(row.approx_passes))
        evicted = int(getattr(row, "planes_evicted", 0))
        if evicted > 0:
            self.event("cache_evict", t=t0, iteration=it, count=evicted)
        if d_coll > 0:
            self.event("collectives", t=t1, iteration=it, count=d_coll,
                       bytes=d_bytes)

    # -- phase-cost calibration (wall mode) ---------------------------------

    def observe_phases(self, segments):
        """Consume one iteration's measured program-boundary segments.

        ``segments`` is ``[(plane_steps, duration), ...]``: entry 0 spans
        the iteration's exact(+first approximate batch) dispatch, later
        entries are approximate-only overflow continuations.  The Solver
        timestamps the host syncs it already pays for, so this adds no
        sync.  Returns the current ``(exact_cost, plane_cost)``
        calibration, or ``None`` while unidentifiable (the caller then
        keeps its previous constants).
        """
        segs = [(float(p), float(d)) for p, d in segments]
        self._phase_pending = segs
        if segs:
            self._seg_first.append(segs[0])
            self._seg_approx.extend(s for s in segs[1:] if s[1] > 0.0)
        self._phase_fit = self._fit_phase_costs()
        return self._phase_fit

    def _fit_phase_costs(self):
        """(exact_cost, plane_cost) from the recorded segment series.

        Preferred: continuation segments hold only approximate passes, so
        ``plane_cost = sum(dur)/sum(planes)`` over them is a direct
        measurement; the exact cost is then the mean first-segment
        remainder.  Without continuations yet, least squares of
        first-segment duration ~ exact + plane * steps over the recorded
        series (identifiable once plane counts vary).  The arithmetic is
        the reference's, term for term, so both packages fit the same
        floats from the same segments."""
        first = self._seg_first[-32:]
        cont = self._seg_approx[-32:]
        if cont:
            den = sum(p for p, _ in cont)
            plane = (sum(d for _, d in cont) / den) if den > 0.0 else 0.0
            if plane > 0.0 and first:
                rems = [max(d - plane * p, 0.0) for p, d in first]
                exact = sum(rems) / len(rems)
                if exact > 0.0:
                    return exact, plane
            return self._phase_fit
        if len(first) < 2:
            return self._phase_fit
        xs = [p for p, _ in first]
        ys = [d for _, d in first]
        mx = sum(xs) / len(xs)
        my = sum(ys) / len(ys)
        var = sum((x - mx) ** 2 for x in xs)
        if var <= 0.0:
            return self._phase_fit
        b = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / var
        a = my - b * mx
        if a <= 0.0 or b <= 0.0:
            return self._phase_fit
        return a, b

    # -- spans / events (host-side phases) ----------------------------------

    def span_record(self, name: str, t0: float, t1: float,
                    timebase: str = "run", **attrs) -> None:
        self._write(dict(attrs, type="span", name=name,
                         t0=float(t0), t1=float(t1), timebase=timebase))

    def event(self, name: str, t: Optional[float] = None, **attrs) -> None:
        self._write(dict(attrs, type="event", name=name,
                         t=float(t if t is not None else self._host_now())))

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Time a host-side phase (checkpoint save/restore) on the
        recorder's wall clock."""
        t0 = self._host_now()
        try:
            yield
        finally:
            self.span_record(name, t0, self._host_now(), timebase="host",
                             **attrs)

    # -- profiler hooks -----------------------------------------------------

    def step_annotation(self, step: int):
        """Context the Solver enters around one outer iteration: a
        ``torch.profiler.record_function("outer_iteration")`` range (a
        host event carrying the step number) only under ``profile=True``,
        so the default recorder adds nothing to the dispatch path."""
        if not self.profile:
            return contextlib.nullcontext()
        import torch.profiler
        return torch.profiler.record_function(
            "outer_iteration", args=f"step_num={int(step)}")

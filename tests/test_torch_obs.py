"""repro_torch.obs against the JAX package's repro.obs, on the CPU.

The schema's verdicts, the Chrome-trace export and the recorder's
phase-cost fit equal the reference's on the same inputs (the fit bit for
bit).  A recorded Solver run of the port writes the reference's JSONL
record for record on the ``SMALL`` usps, ocr and horseseg scenarios for
``mpbcfw``, ``mpbcfw-gram``, ``mpbcfw-async``, ``mpbcfw-gap`` and
``bcfw``: types, names, span and event attributes and integers equal,
floats within rtol 1e-4.  Each package's reader, summary and diff take the
other's files; recording changes no row; wall mode adopts the recorder's
fit; the serving trace and the CLI work as the reference's.
"""
import json
import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro import obs as jobs
from repro.api import RunConfig as JRunConfig
from repro.api import Solver as JSolver
from repro.configs.paper import SMALL
from repro.core.oracles import chain as jchain
from repro.core.oracles import graph as jgraph
from repro.core.oracles import multiclass as jmulti
from repro.core.selection import CostModel as JCostModel
from repro.data import synthetic as jsyn
from repro.obs import schema as jschema
from repro.obs import summary as jsummary
from repro.obs.__main__ import main as jmain
from repro_torch import obs as tobs
from repro_torch import serve
from repro_torch.api import CostModel, RunConfig, Solver
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.oracles import chain as tchain
from repro_torch.core.oracles import graph as tgraph
from repro_torch.core.oracles import multiclass as tmulti
from repro_torch.core.oracles.multiclass import MulticlassSpec
from repro_torch.obs import schema as tschema
from repro_torch.obs import summary as tsummary
from repro_torch.obs.__main__ import main as tmain
from repro_torch.policy import sampling as tsampling

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
ALGOS = ["mpbcfw", "mpbcfw-gram", "mpbcfw-async", "mpbcfw-gap", "bcfw"]
RTOL = 1e-4


# -- the schema ----------------------------------------------------------------

META = {"type": "meta", "schema": 1, "algo": "mpbcfw", "n": 4, "d": 8,
        "time_mode": "cost_model", "engine_budgets": {}}
ROW = {"type": "row", "iteration": 0, "n_exact": 4, "n_approx": 8,
       "time": 1.0, "primal": 0.5, "dual": 0.1, "gap": 0.4,
       "ws_mean": 1.0, "approx_passes": 2, "host_syncs": 1, "dispatches": 1,
       "cache_hit_rate": 1.0, "planes_evicted": 0, "oracle_share": 0.9,
       "oracle_overlap": 0.0, "gap_total": None, "gap_sampled": 0,
       "collectives": 0, "collective_bytes": 0}
RECORDS = [
    META, ROW, {"type": "row"}, {"no_type": True}, [1, 2], "row", None,
    {"type": "nope"},
    {"type": "event", "name": "x", "t": float("nan")},
    {"type": "event", "name": "x", "t": float("inf")},
    {"type": "event", "name": "x", "t": True},
    {"type": "event", "name": 3, "t": 0.0},
    {"type": "span", "name": "exact_pass", "t0": 0, "t1": 1.5,
     "timebase": "run", "iteration": 0},
    {"type": "span", "name": "exact_pass", "t0": 0.0, "timebase": 1},
    {"type": "summary", "metrics": {}}, {"type": "summary", "metrics": []},
    dict(ROW, primal=None, dual=None, gap=None, gap_total=2.5),
    dict(ROW, iteration=1.0, host_syncs=False, time="1"),
    dict(META, n=True, engine_budgets=None, schema=1.0),
]


@pytest.mark.parametrize("k", range(len(RECORDS)))
def test_validate_record_matches_jax(k):
    rec = RECORDS[k]
    assert tschema.validate_record(rec) == jschema.validate_record(rec)


def test_sanitize_matches_jax():
    nan, inf = float("nan"), float("inf")
    value = {"a": nan, "b": [1.0, -inf, (inf, 2)], "c": {"d": nan,
                                                          "e": "s"},
             "f": 3, "g": None, "h": True}
    got, want = tschema.sanitize(value), jschema.sanitize(value)
    assert got == want
    assert json.dumps(got) == json.dumps(want)
    assert tschema.SCHEMA_VERSION == jschema.SCHEMA_VERSION == 1
    assert tschema._REQUIRED == jschema._REQUIRED


@pytest.mark.parametrize("lines", [
    [json.dumps(META), json.dumps(ROW)],
    [json.dumps(ROW)],
    [json.dumps(META), "", "{not json", json.dumps(META)],
    ["", "  "],
    [json.dumps(META), '{"type": "event", "name": "x", "t": NaN}'],
], ids=["valid", "no_meta", "broken", "empty", "nan_on_the_wire"])
def test_validate_lines_matches_jax(lines):
    assert tschema.validate_lines(lines) == jschema.validate_lines(lines)


# -- the Chrome-trace export ---------------------------------------------------

TRACE_RECORDS = [   # the reference's export unit test's records
    {"type": "meta", "schema_version": 1, "algo": "mpbcfw", "n": 4,
     "time_mode": "cost_model"},
    {"type": "span", "name": "exact_pass", "t0": 0.0, "t1": 1.0,
     "timebase": "run", "iteration": 0},
    {"type": "event", "name": "cache_evict", "t": 0.5,
     "iteration": 0, "data": {"planes": 3}},
    {"type": "row", "iteration": 0, "time": 1.0, "dual": 0.1,
     "gap": 0.9, "n_exact": 4, "n_approx": 8, "host_syncs": 1,
     "dispatches": 1},
]


def test_to_chrome_trace_matches_jax():
    extra = TRACE_RECORDS + [
        {"type": "span", "name": "checkpoint_save", "t0": 2.0, "t1": 2.5,
         "timebase": "host", "step": 1},
        {"type": "span", "name": "serve_round", "t0": 3.0, "t1": 2.0,
         "timebase": "run"},
        {"type": "row", "iteration": 1, "time": 2.0, "dual": None,
         "gap": 0.5, "cache_hit_rate": 0.5, "ws_mean": 2.0,
         "gap_total": 1.0}]
    for records in (TRACE_RECORDS, extra):
        got = tobs.to_chrome_trace(records)
        assert got == jobs.to_chrome_trace(records)
    events = tobs.to_chrome_trace(TRACE_RECORDS)["traceEvents"]
    assert {"X", "i", "C", "M"} <= {e["ph"] for e in events}
    span = next(e for e in events if e["ph"] == "X")
    assert span["dur"] == pytest.approx(1e6)


# -- the phase-cost fit ----------------------------------------------------------

def _random_series():
    r = np.random.RandomState(11)
    out = []
    for _ in range(40):
        k = r.randint(0, 4)
        segs = [(int(r.randint(1, 200)), float(r.uniform(0.5, 3.0)))]
        segs += [(int(r.randint(0, 60)),
                  float(r.choice([0.0, r.uniform(0.0, 0.4)])))
                 for _ in range(k)]
        out.append(segs)
    return out


SERIES = {
    # the reference's three unit series
    "continuations": [[(8, 4.0), (4, 1.0), (6, 1.5)]],
    "least_squares": [[(10, 2.5)], [(30, 4.5)]],
    "keeps_last_fit": [[(8, 4.0), (4, 1.0)], [(8, 4.0), (4, 0.0)]],
    "no_continuations_then_some": [[(10, 2.5)], [(10, 2.6)], [(30, 4.5)],
                                   [(20, 3.0), (5, 0.6)], []],
    "seeded_random": _random_series(),
}


@pytest.mark.parametrize("name", sorted(SERIES))
def test_observe_phases_fits_bit_for_bit(tmp_path, name):
    with tobs.RunRecorder(tmp_path / "t.jsonl") as t, \
            jobs.RunRecorder(str(tmp_path / "j.jsonl")) as j:
        fits = 0
        for segs in SERIES[name]:
            got, want = t.observe_phases(segs), j.observe_phases(segs)
            assert got == want, segs
            if got is not None:
                fits += 1
                assert all(type(v) is float for v in got)
            assert t._fit_phase_costs() == j._fit_phase_costs()
        assert fits > 0
    if name == "continuations":
        exact, plane = got
        assert plane == pytest.approx(0.25)
        assert exact == pytest.approx(2.0)


# -- recorded Solver runs against the reference's ---------------------------------

def _small(name):
    """``SMALL[name]`` as a problem of each package, from one numpy set."""
    sc = SMALL[name]
    if sc.kind == "multiclass":
        x, y = jsyn.usps_like(n=sc.n, f=sc.f, num_classes=sc.num_classes)
        return sc, (jmulti.make_problem(jnp.asarray(x), jnp.asarray(y),
                                        sc.num_classes),
                    tmulti.make_problem(x, y, sc.num_classes, device="cpu"))
    if sc.kind == "graph":
        arrays = jsyn.horseseg_like(n=sc.n, grid=sc.grid, f=sc.f)
        return sc, (jgraph.make_problem(*map(jnp.asarray, arrays),
                                        num_sweeps=sc.oracle_sweeps),
                    tgraph.make_problem(*arrays, num_sweeps=sc.oracle_sweeps,
                                        device="cpu"))
    X, Y, M = jsyn.ocr_like(n=sc.n, f=sc.f, num_labels=sc.num_classes,
                            mean_len=sc.mean_len, max_len=sc.max_len, seed=0)
    return sc, (jchain.make_problem(jnp.asarray(X), jnp.asarray(Y),
                                    jnp.asarray(M), sc.num_classes),
                tchain.make_problem(X, Y, M, sc.num_classes, device="cpu"))


def _jax_noise(seed, n):
    """The reference's gumbel noise for ``seed``, as the port's
    ``gumbel_noise`` returns it (so both packages sample one schedule)."""
    return torch.from_numpy(np.array(jax.random.gumbel(
        jax.random.PRNGKey(seed), (n,))))


def _stragglers(solver):
    """mpbcfw-async: every third oracle misses its deadline, as the
    cross-package async tests run it (without late planes a slope decision
    can rest on a float32 ulp of the dual in either package, ROADMAP C)."""
    if solver.cfg.algo == "mpbcfw-async":
        solver.engine.outcome_fn = lambda it, k: np.arange(k) % 3 != 0
    return solver


def _kw(sc, algo, **extra):
    kw = dict(lam=1.0 / sc.n, algo=algo, cap=16, ttl=2, max_iters=3,
              approx_batch=8, max_approx_passes=8)
    if algo == "mpbcfw-gram":
        kw["gram_steps"] = 10
    kw.update(extra)
    return kw


def _record_both(tmp_path, name, algo, monkeypatch, **extra):
    """One recorded 3-iteration run per package; returns the two paths,
    the port's solver and its result."""
    monkeypatch.setattr(tsampling, "gumbel_noise", _jax_noise)
    sc, (jp, tp) = _small(name)
    kw = _kw(sc, algo, **extra)
    jpath, tpath = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    with jobs.RunRecorder(str(jpath)) as rec:
        _stragglers(JSolver(jp, JRunConfig(cost_model=JCostModel(
            sc.oracle_cost, sc.plane_cost), **kw), recorder=rec)).run()
    with tobs.RunRecorder(tpath) as rec:
        ts = _stragglers(Solver(tp, RunConfig(cost_model=CostModel(
            sc.oracle_cost, sc.plane_cost), **kw), recorder=rec))
        res = ts.run()
    return jpath, tpath, ts, res


def _assert_same_value(a, b, where):
    """Equal types, keys and integers; floats within RTOL (NaN and None
    as they are)."""
    if isinstance(b, float) and not isinstance(b, bool):
        assert type(a) is float, (where, a, b)
        if math.isnan(b):
            assert math.isnan(a), (where, a, b)
        else:
            assert_allclose(a, b, rtol=RTOL, err_msg=where)
        return
    assert type(a) is type(b), (where, a, b)
    if isinstance(b, dict):
        assert list(a) == list(b), (where, list(a), list(b))
        for k in b:
            _assert_same_value(a[k], b[k], f"{where}.{k}")
    elif isinstance(b, list):
        assert len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_value(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


def _assert_same_records(got, want):
    assert len(got) == len(want)
    assert [r["type"] for r in got] == [r["type"] for r in want]
    assert [r.get("name") for r in got] == [r.get("name") for r in want]
    for i, (a, b) in enumerate(zip(got, want)):
        _assert_same_value(a, b, f"record {i} ({b['type']} "
                           f"{b.get('name', '')})")


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("name", ["usps", "ocr", "horseseg"])
def test_recorded_run_matches_jax(tmp_path, monkeypatch, name, algo):
    jpath, tpath, _, res = _record_both(tmp_path, name, algo, monkeypatch)
    want = jsummary.read_records(str(jpath))
    got = tsummary.read_records(tpath)
    _assert_same_records(got, want)
    assert got[0]["algo"] == algo and len(res.trace) == 3
    rows = [r for r in got if r["type"] == "row"]
    assert len(rows) == 3
    for r in rows:
        # strict JSON types: no numpy scalar, tensor or bool in a column
        for k in ("gap_total", "oracle_share", "cache_hit_rate", "time",
                  "ws_mean"):
            assert r[k] is None or type(r[k]) in (int, float), (k, r[k])
    spans = [r["name"] for r in got if r["type"] == "span"]
    assert spans.count("outer_iteration") == 3
    assert spans.count("exact_pass") == 3


@pytest.mark.parametrize("algo", ALGOS)
def test_recording_changes_no_row(tmp_path, monkeypatch, algo):
    """The recorded run's rows (syncs and dispatches too) equal the same
    run's without a recorder; the registry sees every row either way."""
    _, tpath, ts, res = _record_both(tmp_path, "ocr", algo, monkeypatch)
    sc, (_, tp) = _small("ocr")
    bare = _stragglers(Solver(tp, RunConfig(cost_model=CostModel(
        sc.oracle_cost, sc.plane_cost), **_kw(sc, algo))))
    bare_res = bare.run()
    assert res.trace == bare_res.trace
    snap, bare_snap = ts.metrics.snapshot(), bare.metrics.snapshot()
    assert snap == bare_snap
    assert snap["iterations"]["value"] == 3
    assert snap["host_syncs"]["value"] == sum(r.host_syncs
                                              for r in res.trace)
    assert tsummary.load_run(tpath)["summary"] == snap


def test_files_cross_between_the_packages(tmp_path, monkeypatch):
    """Each package validates, loads, summarizes and diffs the other's
    file as it does its own, and the two summaries agree."""
    jpath, tpath, _, _ = _record_both(tmp_path, "ocr", "mpbcfw",
                                      monkeypatch)
    for path in (jpath, tpath):
        count, errs = tobs.validate_file(path)
        assert (count, errs) == jobs.validate_file(str(path))
        assert errs == [] and count > 3
        assert tobs.load_run(path) == jobs.load_run(str(path))
        assert tobs.summarize_run(path) == jobs.summarize_run(str(path))
    js = jobs.summarize(jobs.load_run(str(jpath)))
    ts = tobs.summarize(tobs.load_run(tpath))
    _assert_same_value(ts, js, "summary")
    assert ts["contract"]["host_syncs_per_iter_max"] == 1
    assert ts["contract"]["dispatches_per_iter_max"] == 1
    assert ts["contract"]["within_budget"]
    assert ts["calls_to_gap"]
    runs = (tobs.load_run(tpath), tobs.load_run(jpath))
    got = tobs.diff_runs(*runs)
    assert got == jobs.diff_runs(*runs)
    assert tsummary.format_diff(got) == jsummary.format_diff(got)
    assert tsummary.format_summary(ts) == jsummary.format_summary(ts)
    assert abs(got["deltas"]["final_gap"]["delta"]) <= RTOL * abs(
        js["final_gap"]) + 1e-7
    assert got["deltas"]["oracle_calls"]["delta"] == 0
    out_t, out_j = tmp_path / "t.json", tmp_path / "j.json"
    assert tobs.export_chrome_trace(tpath, out_t) == \
        jobs.export_chrome_trace(str(tpath), str(out_j))
    assert json.loads(out_t.read_text()) == json.loads(out_j.read_text())


# -- wall mode, checkpoints, the profiler hook ------------------------------------

@pytest.fixture(scope="module")
def multiclass():
    """The conftest multiclass problem of the port."""
    x, y = jsyn.usps_like(n=48, f=12, num_classes=5, seed=0)
    return tmulti.make_problem(x, y, 5, device="cpu")


def _cfg(**kw):
    base = dict(lam=0.05, algo="mpbcfw", cap=8, ttl=4, max_iters=5,
                max_approx_passes=8, approx_batch=8, seed=1,
                cost_model=CostModel(oracle_cost=1.0, plane_cost=1e-3))
    base.update(kw)
    return RunConfig(**base)


def test_wall_mode_solver_adopts_recorder_calibration(tmp_path,
                                                      multiclass):
    """As the reference's test: with overflow continuations the Solver's
    cost constants are the recorder's fit, measured approx-only spans are
    written, and each iteration's phase spans tile its interval."""
    path = tmp_path / "wall.jsonl"
    fits = []
    with tobs.RunRecorder(path) as rec:
        solver = Solver(multiclass, _cfg(cost_model=None, max_iters=4,
                                         approx_batch=2,
                                         max_approx_passes=8),
                        recorder=rec)
        for row in solver.iterate():
            assert row.host_syncs == row.dispatches
            if rec._phase_fit is not None:
                assert (solver._est_exact, solver._est_plane) == \
                    rec._phase_fit
                fits.append(rec._phase_fit)
    assert fits
    run = tobs.load_run(path)
    assert run["meta"]["time_mode"] == "wall"
    assert any(sp.get("measured") for sp in run["spans"]
               if sp["name"] == "approx_passes")
    assert any(r["host_syncs"] > 1 for r in run["rows"])
    for it in range(4):
        sp = [s for s in run["spans"] if s.get("iteration") == it]
        outer = next(s for s in sp if s["name"] == "outer_iteration")
        phases = sorted((s["t0"], s["t1"]) for s in sp
                        if s["name"] != "outer_iteration")
        assert phases[0][0] == outer["t0"]
        for (_, a1), (b0, _) in zip(phases, phases[1:]):
            assert b0 == pytest.approx(a1, rel=1e-12, abs=1e-12)
        # the last measured segment ends before the row's time (the
        # evaluation sweep is off the clock; host work after the last
        # sync is not)
        assert phases[-1][1] <= outer["t1"] + 1e-12


def test_wall_mode_segments_feed_the_fit_in_order(tmp_path, multiclass):
    """The segments the loop hands over: one per dispatch, approx-only
    ones for each continuation, with the plane steps of the passes that
    ran."""
    seen = []
    with tobs.RunRecorder(tmp_path / "w.jsonl") as rec:
        inner = rec.observe_phases

        def observe(segs):
            seen.append(list(segs))
            return inner(segs)
        rec.observe_phases = observe
        solver = Solver(multiclass, _cfg(cost_model=None, max_iters=3,
                                         approx_batch=2,
                                         max_approx_passes=8),
                        recorder=rec)
        rows = list(solver.iterate())
    assert len(seen) == 3
    for segs, row in zip(seen, rows):
        assert len(segs) == row.dispatches
        assert all(dur >= 0.0 for _, dur in segs)
        assert sum(p for p, _ in segs) >= row.approx_passes


def test_wall_mode_without_recorder_keeps_the_regression(multiclass):
    solver = Solver(multiclass, _cfg(cost_model=None, max_iters=3))
    solver.run()
    assert solver.recorder is None and len(solver._wall_x) == 3
    assert solver._est_exact > 0 and solver._est_plane > 0


def test_checkpoint_spans_and_metrics(tmp_path, multiclass):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    path = tmp_path / "run.jsonl"
    with tobs.RunRecorder(path) as rec:
        s1 = Solver(multiclass, _cfg(max_iters=3), recorder=rec)
        it = s1.iterate()
        next(it)
        next(it)
        step = s1.save(mgr)
    manifest = mgr.load_manifest(step)
    assert manifest["metrics"] == s1.metrics.snapshot()
    assert manifest["metrics"]["iterations"]["value"] == 2
    with tobs.RunRecorder(tmp_path / "resumed.jsonl") as rec2:
        s2 = Solver.restore(multiclass, _cfg(max_iters=3), mgr,
                            recorder=rec2)
        assert s2.metrics is rec2.registry
        assert s2.metrics.snapshot() == s1.metrics.snapshot()
        s2.run()
    names = [sp["name"] for sp in tobs.load_run(path)["spans"]]
    assert names.count("checkpoint_save") == 1
    resumed = tobs.load_run(tmp_path / "resumed.jsonl")
    restore = [sp for sp in resumed["spans"]
               if sp["name"] == "checkpoint_restore"]
    assert len(restore) == 1 and restore[0]["timebase"] == "host"
    assert resumed["summary"]["iterations"]["value"] == 3
    assert [r["iteration"] for r in resumed["rows"]] == [2]


def test_step_annotation_marks_each_iteration(tmp_path, multiclass):
    with tobs.RunRecorder(tmp_path / "a.jsonl") as rec:
        assert type(rec.step_annotation(0)).__name__ == "nullcontext"
    with tobs.RunRecorder(tmp_path / "p.jsonl", profile=True) as rec:
        solver = Solver(multiclass, _cfg(max_iters=3), recorder=rec)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            solver.run()
    marks = [e for e in prof.events() if e.name == "outer_iteration"]
    assert len(marks) == 3


# -- serving -------------------------------------------------------------------

def _serve_model():
    spec = MulticlassSpec(num_classes=3)
    x, y = jsyn.usps_like(n=5, f=4, num_classes=3, seed=6)
    w = torch.from_numpy(np.random.RandomState(3).randn(
        spec.dim({"x": x})).astype(np.float32))
    return serve.ServableModel(spec, w), [{"x": x[i], "y": y[i]}
                                          for i in range(5)]


def test_serve_trace_is_schema_valid(tmp_path):
    """As the reference's serving trace test, read by both packages."""
    model, reqs = _serve_model()
    path = tmp_path / "serve.jsonl"
    with tobs.RunRecorder(path) as rec:
        server = serve.StructuredServer(model, batch_size=2, recorder=rec)
        labels = server.serve(reqs)
    bare = serve.StructuredServer(model, batch_size=2).serve(reqs)
    assert all(np.array_equal(a, b) for a, b in zip(labels, bare))
    n, errs = tobs.validate_file(path)
    assert errs == [] and n >= 1 + 3 + 5 + 1
    assert jobs.validate_file(str(path)) == (n, [])
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    meta = recs[0]
    assert meta["type"] == "meta"
    assert meta["algo"] == "serve:MulticlassSpec"
    assert meta["n"] == 2 and meta["d"] == model.d
    assert meta["engine_budgets"] == {"dispatches_per_round": 1,
                                      "host_syncs_per_round": 1}
    names = [r.get("name") for r in recs]
    assert names.count("serve_round") == 3 == server.ledger.rounds
    assert names.count("serve_request") == 5
    rounds = [r for r in recs if r.get("name") == "serve_round"]
    assert [r["batch"] for r in rounds] == [2, 2, 1]
    bucket = list(serve.bucket_key(server.engine.shape_key(reqs[0])))
    assert all(r["slots"] == 2 and r["timebase"] == "host"
               and r["bucket"] == bucket for r in rounds)
    reqs_ev = [r for r in recs if r.get("name") == "serve_request"]
    assert sorted(r["rid"] for r in reqs_ev) == list(range(5))
    assert all(r["labels"] == 1 and r["latency"] >= 0.0 for r in reqs_ev)
    assert recs[-1]["type"] == "summary"


def test_serve_recorder_on_a_virtual_clock(tmp_path):
    """Spans and events carry the server's clock: a request's latency is
    its round's end minus its submission, the span its round's interval."""
    model, reqs = _serve_model()
    ticks = iter(range(100))
    path = tmp_path / "serve.jsonl"
    with tobs.RunRecorder(path) as rec:
        server = serve.StructuredServer(model, batch_size=4, recorder=rec,
                                        clock=lambda: float(next(ticks)))
        for i, r in enumerate(reqs):
            server.submit(r, t=float(-i))
        server.drain()
    run = tobs.load_run(path)
    assert [(s["t0"], s["t1"]) for s in run["spans"]] == [(0.0, 1.0),
                                                          (2.0, 3.0)]
    assert [(e["rid"], e["t"], e["latency"]) for e in run["events"]] == [
        (0, 1.0, 1.0), (1, 1.0, 2.0), (2, 1.0, 3.0), (3, 1.0, 4.0),
        (4, 3.0, 7.0)]


# -- the CLI -------------------------------------------------------------------

def test_cli_smoke_validate_diff_export(tmp_path, capsys):
    t_run, j_run = str(tmp_path / "t.jsonl"), str(tmp_path / "j.jsonl")
    assert tmain(["--smoke-run", t_run, "--device", "cpu", "--iters",
                  "3"]) == 0
    assert jmain(["--smoke-run", j_run, "--iters", "3"]) == 0
    capsys.readouterr()
    assert tmain(["--validate", t_run, j_run]) == 0
    out = capsys.readouterr().out
    assert out.count("schema OK") == 2
    assert jmain(["--validate", t_run]) == 0
    capsys.readouterr()
    _assert_same_records(tsummary.read_records(t_run),
                         jsummary.read_records(j_run))
    assert tmain(["--diff", j_run, t_run]) == 0
    diff = capsys.readouterr().out
    assert diff.startswith("diff: a(algo=mpbcfw) vs b(algo=mpbcfw)")
    assert "oracle_calls" in diff
    assert tmain([t_run]) == 0
    summary = capsys.readouterr().out
    assert "iterations:        3" in summary and "contract:" in summary
    out_path = str(tmp_path / "trace.json")
    assert tmain(["--export-trace", t_run, "-o", out_path]) == 0
    trace = json.loads(Path(out_path).read_text())
    assert {"X", "C", "M"} <= {e["ph"] for e in trace["traceEvents"]}
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"type": "row"}\n')
    assert tmain(["--validate", str(bad)]) == 1
    assert "no meta record" in capsys.readouterr().out


def test_cli_smoke_run_refuses_the_cpu_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain(["--smoke-run", str(tmp_path / "x.jsonl")])


def test_cli_readers_import_no_torch(tmp_path):
    """The summarize, validate and export paths run without torch."""
    run = tmp_path / "r.jsonl"
    lines = [META, ROW, {"type": "summary", "metrics": {}}]
    run.write_text("".join(json.dumps(r) + "\n" for r in lines))
    code = (
        "import sys\n"
        "from repro_torch.obs.__main__ import main\n"
        f"assert main(['--validate', {str(run)!r}]) == 0\n"
        f"assert main([{str(run)!r}]) == 0\n"
        f"assert main(['--export-trace', {str(run)!r}, '-o', "
        f"{str(tmp_path / 'o.json')!r}]) == 0\n"
        "assert 'torch' not in sys.modules, 'torch imported'\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr

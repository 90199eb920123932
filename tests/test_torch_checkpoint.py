"""Checkpoints of repro_torch: the manager, bit-for-bit resume, and
checkpoints crossing between the port and the JAX package, on the CPU.

The port writes the reference's format (``step_%010d/arrays.npz`` plus
``manifest.json``, leaves keyed as JAX spells them), so a checkpoint of
either package resumes in the other.  Within the port a resumed run is
the uninterrupted one bit for bit (on the multiclass fixture, as the
reference's own resume test); across packages it stays within the Solver
tolerances (schedules equal, duals rtol 1e-4) on the conftest chain.  The
multiclass fixture is not used across packages: under ``mpbcfw-async`` its
iteration-3 oracle meets a near tie (two class scores 2e-8 apart), which
the two packages' last-bit differences in ``w`` decide apart (ROADMAP C).
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.api import RunConfig as JRunConfig
from repro.api import Solver as JSolver
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.checkpoint.manager import _flatten as jflatten
from repro.core.oracles import chain as jchain
from repro.core.oracles import multiclass as jmulti
from repro.core.selection import CostModel as JCostModel
from repro.data import synthetic as jsyn
from repro_torch.api import CostModel, RunConfig, Solver
from repro_torch.checkpoint import CheckpointManager, flatten
from repro_torch.core.oracles import chain as tchain
from repro_torch.core.oracles import multiclass as tmulti

torch.set_num_threads(1)
ALGOS = ["mpbcfw", "mpbcfw-gram", "mpbcfw-async"]


@pytest.fixture(scope="module")
def problems():
    """The conftest multiclass problem in both packages."""
    x, y = jsyn.usps_like(n=48, f=12, num_classes=5, seed=0)
    return (jmulti.make_problem(jnp.asarray(x), jnp.asarray(y), 5),
            tmulti.make_problem(x, y, 5, device="cpu"))


@pytest.fixture(scope="module")
def chain_problems():
    """The conftest chain problem in both packages."""
    X, Y, M = jsyn.ocr_like(n=24, f=8, num_labels=5, mean_len=6, max_len=8,
                            seed=1)
    return (jchain.make_problem(jnp.asarray(X), jnp.asarray(Y),
                                jnp.asarray(M), 5),
            tchain.make_problem(X, Y, M, 5, device="cpu"))


# At most 16 approximate passes per iteration: mpbcfw-async's first
# iteration runs every allowed pass over empty caches.
BASE = dict(max_iters=6, cap=8, seed=3, approx_batch=8,
            max_approx_passes=16)


def _cfg(n, algo, **kw):
    base = dict(BASE, lam=1.0 / n, algo=algo)
    base.update(kw)
    return RunConfig(cost_model=CostModel(plane_cost=1e-3), **base)


def _jcfg(n, algo, **kw):
    base = dict(BASE, lam=1.0 / n, algo=algo)
    base.update(kw)
    return JRunConfig(cost_model=JCostModel(plane_cost=1e-3), **base)


# -- the manager -------------------------------------------------------------

@pytest.mark.parametrize("algo", ALGOS)
def test_leaf_keys_dtypes_and_shapes_match_jax(problems, algo):
    jp, tp = problems
    ts = Solver(tp, _cfg(tp.n, algo, max_iters=2))
    ts.run()
    js = JSolver(jp, _jcfg(jp.n, algo, max_iters=2))
    js.run()
    got = flatten(ts.state)
    want = {k: np.asarray(v) for k, v in jflatten(js.state).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert (got[k].dtype, got[k].shape) == (want[k].dtype,
                                                want[k].shape), k
    if algo == "mpbcfw-gram":
        assert ".cache//.gram" in got
    assert got[".inner//.n_exact" if algo != "mpbcfw-async"
               else ".mp//.inner//.n_exact"].shape == ()


def test_roundtrip_restores_types_dtypes_and_devices(tmp_path, problems):
    _, tp = problems
    s = Solver(tp, _cfg(tp.n, "mpbcfw-async", max_iters=2))
    s.run()
    mgr = CheckpointManager(str(tmp_path / "rt"))
    mgr.save(2, s.state, extra={"note": "x"})
    fresh = Solver(tp, _cfg(tp.n, "mpbcfw-async")).state
    back, manifest = mgr.restore(fresh, 2)
    assert manifest["step"] == 2 and manifest["extra"] == {"note": "x"}
    assert manifest["metrics"] == {}
    assert type(back) is type(s.state)
    assert back.mp.inner.n_exact == s.state.mp.inner.n_exact
    assert isinstance(back.mp.outer_it, int)
    assert back.pending.live is True
    assert back.pending.ids.dtype == np.int64
    assert (back.pending.ids == s.state.pending.ids).all()
    assert (back.pending.done == s.state.pending.done).all()
    for a, b in ((back.mp.cache.planes, s.state.mp.cache.planes),
                 (back.mp.cache.valid, s.state.mp.cache.valid),
                 (back.mp.cache.last_active, s.state.mp.cache.last_active),
                 (back.pending.planes, s.state.pending.planes)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    leaves = manifest["leaves"]
    assert leaves[".pending//.ids"]["dtype"] == "int32"
    assert leaves[".mp//.cache//.valid"]["dtype"] == "bool"


def test_bfloat16_leaves_widen_and_come_back(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
            "k": 4}
    mgr = CheckpointManager(str(tmp_path / "bf16"))
    mgr.save(0, tree)
    assert mgr.load_manifest(0)["leaves"]["w"]["dtype"] == "float32"
    back, _ = mgr.restore({"w": torch.zeros((2, 3), dtype=torch.bfloat16),
                           "k": 0})
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"], tree["w"]) and back["k"] == 4


def test_gc_keeps_the_latest_steps_and_ignores_uncommitted(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "gc"), keep=2)
    assert mgr.latest_step() is None and mgr.all_steps() == []
    with pytest.raises(FileNotFoundError):
        mgr.load_manifest()
    tree = {"a": torch.zeros(3)}
    for step in (1, 5, 3, 7):
        mgr.save(step, tree)
    assert mgr.all_steps() == [5, 7] and mgr.latest_step() == 7
    (tmp_path / "gc" / "step_0000000009").mkdir()   # no manifest: torn
    (tmp_path / "gc" / ".tmp_step_0000000011_1").mkdir()
    assert mgr.all_steps() == [5, 7]
    assert json.loads((tmp_path / "gc" / "step_0000000007" /
                       "manifest.json").read_text())["step"] == 7


# -- resume within the port --------------------------------------------------

@pytest.mark.parametrize("algo", ALGOS)
def test_resume_is_bitwise_the_uninterrupted_run(tmp_path, problems, algo):
    _, tp = problems
    full = Solver(tp, _cfg(tp.n, algo)).run()
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    s1 = Solver(tp, _cfg(tp.n, algo))
    it = s1.iterate()
    head = [next(it) for _ in range(3)]
    assert s1.save(mgr) == 3
    s2 = Solver.restore(tp, _cfg(tp.n, algo), mgr)
    assert s2.iteration == 3
    tail = list(s2.iterate())
    assert [r.iteration for r in tail] == [3, 4, 5]
    for a, b in zip(head + tail, full.trace):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    res = s2.result()
    assert (res.w == full.w).all() and (res.w_avg == full.w_avg).all()


def test_wall_clock_resume_continues_the_clock(tmp_path, problems):
    _, tp = problems
    cfg = RunConfig(lam=1.0 / tp.n, max_iters=3, cap=8)
    s1 = Solver(tp, cfg)
    rows = [next(s1.iterate())]
    mgr = CheckpointManager(str(tmp_path / "wall"))
    s1.save(mgr)
    s2 = Solver.restore(tp, cfg, mgr)
    assert (s2._est_exact, s2._est_plane) == (s1._est_exact, s1._est_plane)
    rows += list(s2.iterate())
    assert len(rows) == 3
    times = [r.time for r in rows]
    assert times == sorted(times)


def test_checkpoint_every_autosaves(tmp_path, problems):
    _, tp = problems
    mgr = CheckpointManager(str(tmp_path / "auto"), keep=10)
    Solver(tp, _cfg(tp.n, "mpbcfw", max_iters=5), checkpoint=mgr,
           checkpoint_every=2).run()
    assert mgr.all_steps() == [2, 4]
    assert mgr.load_manifest(4)["extra"]["iteration"] == 4


def test_resume_honors_gap_tol_from_saved_row(tmp_path, problems):
    """A checkpoint taken after the gap met gap_tol resumes into no
    iteration: StopOnGap reads the restored last row first."""
    _, tp = problems
    cfg = _cfg(tp.n, "mpbcfw", max_iters=10, cap=16, gap_tol=1.0)
    assert len(Solver(tp, cfg).run().trace) == 1
    mgr = CheckpointManager(str(tmp_path / "gap"))
    s1 = Solver(tp, cfg)
    next(s1.iterate())
    s1.save(mgr)
    assert list(Solver.restore(tp, cfg, mgr).iterate()) == []


def test_restore_rejects_another_algorithm(tmp_path, problems):
    _, tp = problems
    mgr = CheckpointManager(str(tmp_path / "mismatch"))
    s = Solver(tp, _cfg(tp.n, "mpbcfw-gram", max_iters=2))
    next(s.iterate())
    s.save(mgr)
    with pytest.raises(ValueError, match="cannot resume"):
        Solver.restore(tp, _cfg(tp.n, "mpbcfw"), mgr)
    with pytest.raises(ValueError, match="no CheckpointManager"):
        s.save()


# -- across packages ---------------------------------------------------------

def _assert_tail_matches(got, want):
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert a.iteration == b.iteration
        assert (a.n_exact, a.n_approx, a.approx_passes) == (
            b.n_exact, b.n_approx, b.approx_passes)
        assert_allclose(a.dual, b.dual, rtol=1e-4)
        assert_allclose(a.primal, b.primal, rtol=1e-4)
        assert_allclose(a.time, b.time, rtol=1e-12)


def _stragglers(solver):
    """mpbcfw-async: every third oracle misses its deadline, a mask that
    depends on the block count alone (a resumed engine restarts its
    iteration count, in both packages).  Without late planes the third
    iteration folds planes made at w = 0 a second time and its passes
    gain a few ulps, where the two packages' slope decisions can part
    (ROADMAP C); tests/test_torch_async.py uses a mask for that reason."""
    if solver.cfg.algo == "mpbcfw-async":
        solver.engine.outcome_fn = lambda it, k: np.arange(k) % 3 != 0
    return solver


@pytest.mark.parametrize("algo", ALGOS)
def test_port_resumes_a_jax_checkpoint(tmp_path, chain_problems, algo):
    """JAX saves at iteration 2; the port restores and runs iterations
    2-3, matching JAX's uninterrupted run."""
    jp, tp = chain_problems
    jfull = _stragglers(JSolver(jp, _jcfg(jp.n, algo, max_iters=4))).run()
    js = _stragglers(JSolver(jp, _jcfg(jp.n, algo, max_iters=4)))
    it = js.iterate()
    [next(it) for _ in range(2)]
    js.save(JManager(str(tmp_path / "j")))
    ts = _stragglers(Solver.restore(tp, _cfg(tp.n, algo, max_iters=4),
                                    CheckpointManager(str(tmp_path / "j"))))
    assert ts.iteration == 2
    _assert_tail_matches(list(ts.iterate()), jfull.trace[2:])


@pytest.mark.parametrize("algo", ALGOS)
def test_jax_resumes_a_port_checkpoint(tmp_path, chain_problems, algo):
    """The port saves at iteration 2; JAX restores and runs iterations
    2-3, matching the port's uninterrupted run."""
    jp, tp = chain_problems
    tfull = _stragglers(Solver(tp, _cfg(tp.n, algo, max_iters=4))).run()
    ts = _stragglers(Solver(tp, _cfg(tp.n, algo, max_iters=4)))
    it = ts.iterate()
    [next(it) for _ in range(2)]
    ts.save(CheckpointManager(str(tmp_path / "t")))
    js = _stragglers(JSolver.restore(jp, _jcfg(jp.n, algo, max_iters=4),
                                     JManager(str(tmp_path / "t"))))
    assert js.iteration == 2
    _assert_tail_matches(list(js.iterate()), tfull.trace[2:])


# -- the metric series across packages ----------------------------------------

@pytest.mark.parametrize("algo", ALGOS)
def test_port_loads_the_metric_series_of_a_jax_checkpoint(
        tmp_path, chain_problems, algo):
    """A JAX checkpoint's manifest ``metrics`` (its registry snapshot) is
    the port's ``Solver.metrics`` after restore, and the series goes on."""
    jp, tp = chain_problems
    js = _stragglers(JSolver(jp, _jcfg(jp.n, algo, max_iters=4)))
    it = js.iterate()
    [next(it) for _ in range(2)]
    js.metrics.counter("user_events").inc(5)
    step = js.save(JManager(str(tmp_path / "j")))
    want = js.metrics.snapshot()
    manifest = CheckpointManager(str(tmp_path / "j")).load_manifest(step)
    assert manifest["metrics"] == want
    assert want["iterations"]["value"] == 2
    ts = _stragglers(Solver.restore(tp, _cfg(tp.n, algo, max_iters=4),
                                    CheckpointManager(str(tmp_path / "j"))))
    assert ts.metrics.snapshot() == want
    ts.run()
    # The series goes on as the reference's resumed from the same
    # checkpoint: counters equal, gauges and histogram sums within rtol.
    jr = _stragglers(JSolver.restore(jp, _jcfg(jp.n, algo, max_iters=4),
                                     JManager(str(tmp_path / "j"))))
    jr.run()
    snap, jsnap = ts.metrics.snapshot(), jr.metrics.snapshot()
    assert snap["iterations"]["value"] == 4
    assert snap["user_events"] == want["user_events"]
    assert sorted(snap) == sorted(jsnap)
    for name, entry in jsnap.items():
        got = snap[name]
        if entry["kind"] == "counter":
            assert got == entry, name
        elif entry["kind"] == "gauge":
            assert_allclose(got["value"], entry["value"], rtol=1e-4)
        else:
            assert (got["counts"], got["count"]) == (entry["counts"],
                                                     entry["count"]), name
            assert_allclose(got["total"], entry["total"], rtol=1e-4)


@pytest.mark.parametrize("algo", ALGOS)
def test_jax_loads_the_metric_series_of_a_port_checkpoint(
        tmp_path, chain_problems, algo):
    """The port's manifest ``metrics`` is its registry snapshot, and the
    JAX package restores it as its ``Solver.metrics``."""
    jp, tp = chain_problems
    ts = _stragglers(Solver(tp, _cfg(tp.n, algo, max_iters=4)))
    it = ts.iterate()
    [next(it) for _ in range(2)]
    ts.metrics.gauge("user_level").set(0.25)
    step = ts.save(CheckpointManager(str(tmp_path / "t")))
    want = ts.metrics.snapshot()
    assert JManager(str(tmp_path / "t")).load_manifest(step)[
        "metrics"] == want
    assert want["iterations"]["value"] == 2
    assert want["host_syncs"]["value"] == sum(r.host_syncs
                                              for r in ts.trace)
    js = _stragglers(JSolver.restore(jp, _jcfg(jp.n, algo, max_iters=4),
                                     JManager(str(tmp_path / "t"))))
    assert js.metrics.snapshot() == want

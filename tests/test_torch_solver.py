"""MP-BCFW passes, outer iterations and the Solver of repro_torch vs the JAX
package, on the CPU.

One outer iteration runs in both packages from the same mid-run state (a
JAX state carried across by ``repro_torch.convert``, with a part-filled
cache), the same permutations and the same slope clock.  Whole Solver
runs under a CostModel draw the same permutations from the same seed.
Schedules (pass counts, exact/approximate calls, cache occupancy) must be
equal; duals and primals agree to rtol 1e-4 over a run and 3e-5 in one
step.  A slope decision that flips on a near tie is reported with its
margins in the assertion message.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.api import RunConfig as JRunConfig
from repro.api import Solver as JSolver
from repro.core import mpbcfw as jmp
from repro.core.oracles import chain as jchain
from repro.core.selection import CostModel as JCostModel
from repro.data import synthetic as jsyn
from repro_torch import convert
from repro_torch.api import (CostModel, RunConfig, Solver, StopOnGap,
                             UnsupportedConfigError)
from repro_torch.core import mpbcfw as tmp
from repro_torch.core.graphs import StepGraphs
from repro_torch.core.oracles import chain as tchain

torch.set_num_threads(1)
TOL = dict(rtol=3e-5, atol=3e-5)

# (n, f, C, mean_len, max_len, seed): the conftest chain problem, and
# configs/paper.py SMALL["ocr"] (d = 528: approx_oracle goes through the
# plane_scores dispatch).
SIZES = {"conftest": (24, 8, 5, 6, 8, 1), "small_ocr": (120, 32, 12, 7, 10, 0)}


def _data(size):
    n, f, C, mean_len, max_len, seed = SIZES[size]
    X, Y, M = jsyn.ocr_like(n=n, f=f, num_labels=C, mean_len=mean_len,
                            max_len=max_len, seed=seed)
    return X, Y, M, C


def _problems(size):
    X, Y, M, C = _data(size)
    return (jchain.make_problem(jnp.asarray(X), jnp.asarray(Y),
                                jnp.asarray(M), C),
            tchain.make_problem(X, Y, M, C, device="cpu"))


def _slope_margins(stats, f0, t0):
    """slope_last - slope_iter after each pass that ran (float64)."""
    k = int(stats.passes_run)
    duals = np.asarray(stats.duals, np.float64)[:k]
    times = np.asarray(stats.times, np.float64)[:k]
    f_prev, t_prev, out = float(stats.f_entry), None, []
    for f, t in zip(duals, times):
        if t_prev is not None:
            out.append((f - f_prev) / (t - t_prev) - (f - f0) / (t - t0))
        f_prev, t_prev = f, t
    return out


@pytest.fixture(scope="module")
def midrun():
    """Both problems of each size, and a JAX MPState after two outer
    iterations of the reference Solver (cap 6, ttl 1: evictions happen)."""
    out = {}
    for size in SIZES:
        jp, tp = _problems(size)
        solver = JSolver(jp, JRunConfig(
            lam=1.0 / jp.n, cap=6, ttl=1, max_iters=2, approx_batch=4,
            max_approx_passes=4, cost_model=JCostModel(0.3, 1e-3)))
        solver.run()
        out[size] = (jp, tp, jax.device_get(solver.state))
    return out


def _schedule(n, k, seed=5):
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n)
    return perm, np.array([rng.permutation(n) for _ in range(k)],
                          np.int64).reshape(k, n)


def _assert_activity_matches(out, jcache, it):
    """``last_active`` equal, except where a block holds duplicate planes:
    a plane computed by the port and an equal one carried over from the
    JAX state can differ in the last bits, and the approximate oracle may
    then mark the other copy.  There the planes marked at ``it`` must
    agree as values."""
    la_j, la_t = np.asarray(jcache.last_active), out["last_active"]
    pj, pt = np.asarray(jcache.planes), out["planes"]
    for i in np.unique(np.argwhere(la_j != la_t)[:, 0]):
        act_j, act_t = pj[i][la_j[i] == it], pt[i][la_t[i] == it]
        for a, others in ((act_j, act_t), (act_t, act_j)):
            for p in a:
                assert any(np.allclose(p, q, **TOL) for q in others), (
                    f"block {i}: activity {la_t[i]} vs JAX {la_j[i]}")


@pytest.mark.parametrize("size", sorted(SIZES))
def test_outer_iteration_from_carried_state_matches_jax(midrun, size):
    jp, tp, host = midrun[size]
    lam, ttl, k = 1.0 / jp.n, 1, 5
    perm, perms = _schedule(jp.n, k)
    est_exact, plane_cost = 0.3 * jp.n, 1e-3
    jclock = jmp.make_slope_clock(0.0, 0.0, est_exact, plane_cost)
    jmp_out, jclk, jst = jmp.jit_outer_iteration(
        jp, jax.tree_util.tree_map(jnp.asarray, host), jnp.asarray(perm),
        jnp.asarray(perms), jclock, lam=lam, ttl=ttl)
    jst = jax.device_get(jst)

    state = convert.mp_state_from_numpy(host, "cpu")
    assert 0 < int(state.cache.valid.sum()) < state.cache.valid.numel()
    tclock = tmp.make_slope_clock(0.0, 0.0, est_exact, plane_cost, "cpu")
    tmp_out, tclk, tst = tmp.outer_iteration(tp, state, perm, perms, tclock,
                                             lam=lam, ttl=ttl,
                                             graphs=StepGraphs())
    # The passes ran gated on the device; the host counters follow them.
    tmp_out = tmp.count_passes(tmp_out, int(tst.passes_run), tst.blocks)
    assert tst.passes_run == int(jst.passes_run), (
        "slope decision flipped: port margins "
        f"{_slope_margins(tst, float(tclk.f0), 0.0)}, JAX duals "
        f"{jst.duals[:int(jst.passes_run)]}, port duals {tst.duals}")
    assert bool(tst.more) == bool(jst.more)
    out = convert.mp_state_to_numpy(tmp_out)
    assert (out["valid"] == np.asarray(jmp_out.cache.valid)).all()
    _assert_activity_matches(out, jmp_out.cache, out["outer_it"])
    assert out["outer_it"] == int(jmp_out.outer_it)
    assert (out["n_exact"], out["n_approx"]) == (
        int(jmp_out.inner.n_exact), int(jmp_out.inner.n_approx))
    assert_allclose(out["phi"], np.asarray(jmp_out.inner.phi), **TOL)
    assert_allclose(out["phi_i"], np.asarray(jmp_out.inner.phi_i), **TOL)
    assert_allclose(out["planes"], np.asarray(jmp_out.cache.planes), **TOL)
    assert_allclose(out["bar_exact"], np.asarray(jmp_out.avg.bar_exact),
                    **TOL)
    k_run = tst.passes_run
    assert_allclose(tst.duals[:k_run].numpy(), jst.duals[:k_run], **TOL)
    assert (tst.times.numpy() == jst.times).all()   # float32 t + cost
    assert (tst.planes.numpy() == jst.planes).all()
    assert float(tclk.t) == float(jclk.t)
    for f in ("ttl_evicted", "lru_evicted", "occupancy", "nonempty_blocks"):
        assert int(getattr(tst.metrics, f)) == int(getattr(jst.metrics, f)), f


@pytest.mark.parametrize("phase", ["exact", "approx"])
def test_single_passes_from_carried_state_match_jax(midrun, phase):
    jp, tp, host = midrun["small_ocr"]
    lam = 1.0 / jp.n
    perm, _ = _schedule(jp.n, 0, seed=9)
    jstate = jax.tree_util.tree_map(jnp.asarray, host)
    state = convert.mp_state_from_numpy(host, "cpu")
    if phase == "exact":
        jout = jmp.exact_pass(jp, jstate, jnp.asarray(perm), lam)
        tout = tmp.exact_pass(tp, state, perm, lam, graphs=StepGraphs())
    else:
        jout = jmp.approx_pass(None, jstate, jnp.asarray(perm), lam)
        tout = tmp.approx_pass(None, state, perm, lam)
    out = convert.mp_state_to_numpy(tout)
    assert_allclose(out["phi"], np.asarray(jout.inner.phi), **TOL)
    assert (out["valid"] == np.asarray(jout.cache.valid)).all()
    _assert_activity_matches(out, jout.cache, out["outer_it"])
    assert (out["k_exact"], out["k_approx"]) == (int(jout.avg.k_exact),
                                                 int(jout.avg.k_approx))
    assert_allclose(out["bar_approx"], np.asarray(jout.avg.bar_approx),
                    **TOL)


def test_multi_approx_pass_run_all_matches_jax(midrun):
    jp, tp, host = midrun["conftest"]
    lam = 1.0 / jp.n
    _, perms = _schedule(jp.n, 3, seed=4)
    jclock = jmp.make_slope_clock(0.0, 0.0, 7.2, 1e-3)
    jout, _, jst = jmp.multi_approx_pass(
        jax.tree_util.tree_map(jnp.asarray, host), jnp.asarray(perms),
        jclock, lam=lam, run_all=True)
    state = convert.mp_state_from_numpy(host, "cpu")
    tclock = tmp.make_slope_clock(0.0, 0.0, 7.2, 1e-3, "cpu")
    tout, _, tst = tmp.multi_approx_pass(state, perms, tclock, lam=lam,
                                         run_all=True)
    assert tst.passes_run == 3 == int(jst.passes_run)
    assert_allclose(tst.duals.numpy(), np.asarray(jst.duals), **TOL)
    assert_allclose(tout.inner.phi.numpy(), np.asarray(jout.inner.phi),
                    **TOL)


def _run_both(size, **kw):
    jp, tp = _problems(size)
    lam = 1.0 / jp.n
    jr = JSolver(jp, JRunConfig(lam=lam, cost_model=JCostModel(0.3, 1e-3),
                                **kw)).run()
    tr = Solver(tp, RunConfig(lam=lam, cost_model=CostModel(0.3, 1e-3),
                              **kw)).run()
    return jr, tr


def _assert_traces_match(jr, tr):
    assert len(tr.trace) == len(jr.trace)
    for a, b in zip(jr.trace, tr.trace):
        got = (b.n_exact, b.n_approx, b.approx_passes, b.planes_evicted,
               b.cache_hit_rate, b.ws_mean)
        want = (a.n_exact, a.n_approx, a.approx_passes, a.planes_evicted,
                a.cache_hit_rate, a.ws_mean)
        assert got == want, (
            f"iteration {a.iteration}: schedule differs (a slope decision "
            f"flipped?): port {got} vs JAX {want}; duals {b.dual} vs "
            f"{a.dual}")
        assert_allclose(b.dual, a.dual, rtol=1e-4)
        assert_allclose(b.primal, a.primal, rtol=1e-4)
        assert_allclose(b.time, a.time, rtol=1e-12)
        assert_allclose(b.oracle_share, a.oracle_share, rtol=1e-12)
    assert_allclose(tr.w, jr.w, rtol=1e-4, atol=1e-4)
    assert_allclose(tr.w_avg, jr.w_avg, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("size", sorted(SIZES))
def test_solver_three_iterations_match_jax(size):
    jr, tr = _run_both(size, cap=16, ttl=2, max_iters=3, approx_batch=8,
                       max_approx_passes=8)
    _assert_traces_match(jr, tr)
    for a, b in zip(jr.trace, tr.trace):
        # One dispatch and one host sync per iteration, as in the reference.
        assert (b.host_syncs, b.dispatches) == (a.host_syncs, a.dispatches)
        assert b.dispatches == 1


def test_solver_overflow_batches_consume_the_same_rng_stream():
    """approx_batch < max_approx_passes: overflow continuations draw their
    permutations in the reference's order."""
    jr, tr = _run_both("conftest", cap=8, ttl=3, max_iters=4,
                       approx_batch=2, max_approx_passes=7)
    _assert_traces_match(jr, tr)
    assert any(r.dispatches > 1 for r in tr.trace)
    for a, b in zip(jr.trace, tr.trace):
        assert b.dispatches == a.dispatches


def test_solver_zero_approx_passes_is_bcfw_with_a_cache():
    jr, tr = _run_both("conftest", cap=4, max_iters=2, approx_batch=1,
                       max_approx_passes=0)
    _assert_traces_match(jr, tr)
    assert all(r.approx_passes == 0 and r.n_approx == 0 for r in tr.trace)


def test_solver_duals_rise_and_gap_certifies():
    _, tp = _problems("conftest")
    res = Solver(tp, RunConfig(lam=1.0 / tp.n, max_iters=4, cap=8,
                               cost_model=CostModel(0.3, 1e-3))).run()
    duals = [r.dual for r in res.trace]
    assert duals == sorted(duals)
    assert all(r.gap >= -1e-5 * abs(r.primal) for r in res.trace)
    assert res.w.shape == (tp.d,) and np.isfinite(res.w).all()


def test_solver_wall_clock_mode_runs_and_calibrates():
    _, tp = _problems("conftest")
    solver = Solver(tp, RunConfig(lam=1.0 / tp.n, max_iters=3, cap=8))
    rows = list(solver.iterate())
    assert len(rows) == 3
    times = [r.time for r in rows]
    assert times == sorted(times) and times[0] > 0.0
    assert solver._est_exact > 0.0 and solver._est_plane > 0.0


def test_solver_stopping_criteria_and_callbacks():
    _, tp = _problems("conftest")
    seen = []
    solver = Solver(tp, RunConfig(lam=1.0 / tp.n, max_iters=50, cap=8,
                                  gap_tol=1e9, cost_model=CostModel()),
                    callbacks=[lambda s, row: seen.append(row.iteration)])
    assert len(solver.run().trace) == 1 and seen == [0]
    solver = Solver(tp, RunConfig(lam=1.0 / tp.n, max_iters=50, cap=8,
                                  time_budget=0.3 * tp.n * 2.5,
                                  cost_model=CostModel(0.3, 1e-3)))
    assert len(solver.run().trace) == 3
    solver = Solver(tp, RunConfig(lam=1.0 / tp.n, max_iters=50, cap=8,
                                  cost_model=CostModel()),
                    stop=[StopOnGap(1e9)])
    assert len(list(solver.iterate())) == 1
    assert len(list(solver.iterate())) == 0   # resumable, still stopped


@pytest.mark.parametrize("algo,mesh,match", [
    ("mpbcfw-shard-lite", False, "unknown algorithm"),
    ("shard", False, "unknown algorithm"),
    ("bcfw", True, "only consumed by"),
    ("nope", False, "unknown algorithm")])
def test_unported_algorithms_raise(algo, mesh, match):
    """Every name the reference registers runs in the port; a name it never
    registered is refused, and so is a mesh given to a single-device
    engine (the reference's test_mesh_on_single_device_engine_still_refused)."""
    from repro_torch.launch.mesh import make_data_mesh
    _, tp = _problems("conftest")
    kw = dict(mesh=make_data_mesh(device="cpu")) if mesh else {}
    with pytest.raises(UnsupportedConfigError, match=match):
        Solver(tp, RunConfig(lam=0.1, algo=algo, **kw))


@pytest.mark.parametrize("kw", [dict(approx_batch=0), dict(ttl=0),
                                dict(gap_tol=-1.0)])
def test_invalid_configs_raise(kw):
    _, tp = _problems("conftest")
    with pytest.raises(UnsupportedConfigError):
        Solver(tp, RunConfig(lam=0.1, **kw))

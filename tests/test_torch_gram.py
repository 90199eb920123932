"""The Sec-3.5 Gram scheme of repro_torch vs the JAX package, on the CPU.

The gram kernel's plain version against the Pallas kernel run in
interpret mode; the cache's Gram rows under inserts; one multi-step block
update, one gram pass and one outer iteration from a JAX gram state
carried across by ``repro_torch.convert``; and 3-iteration
``mpbcfw-gram`` Solver traces.  Single steps compare at 3e-5 with equal
win flags; whole runs with equal schedules and duals within rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro import cache as jcache
from repro.api import RunConfig as JRunConfig
from repro.api import Solver as JSolver
from repro.cache import CacheLayout as JLayout
from repro.core import gram as jgram
from repro.core import mpbcfw as jmp
from repro.core.oracles import chain as jchain
from repro.core.oracles import multiclass as jmulti
from repro.core.selection import CostModel as JCostModel
from repro.data import synthetic as jsyn
from repro.kernels import gram as jgram_kernel
from repro_torch import cache as tcache
from repro_torch import convert
from repro_torch.api import CostModel, RunConfig, Solver
from repro_torch.cache import CacheLayout
from repro_torch.core import gram as tgram
from repro_torch.core import mpbcfw as tmp
from repro_torch.core.graphs import StepGraphs
from repro_torch.core.oracles import chain as tchain
from repro_torch.core.oracles import multiclass as tmulti
from repro_torch.kernels import ops

torch.set_num_threads(1)
TOL = dict(rtol=3e-5, atol=3e-5)


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


# -- the kernel's plain version ----------------------------------------------

@pytest.mark.parametrize("n,d", [(4, 32), (33, 200), (64, 512)])
def test_gram_plain_matches_pallas_kernel(n, d):
    r = np.random.RandomState(n + d)
    P = r.randn(n, d).astype(np.float32)
    want = np.asarray(jgram_kernel.gram(jnp.asarray(P), interpret=True))
    got = ops.gram(T(P)).numpy()
    assert got.shape == (n, n) and got.dtype == np.float32
    assert_allclose(got, want, rtol=3e-5, atol=3e-4)
    assert_allclose(got, got.T, atol=1e-5)


def test_gram_plain_reads_a_strided_cache_block():
    r = np.random.RandomState(7)
    block = T(r.randn(6, 41).astype(np.float32))
    assert_allclose(ops.gram(block[:, :-1]).numpy(),
                    ops.gram(block[:, :-1].contiguous()).numpy(), **TOL)


# -- the cache's Gram leaf ---------------------------------------------------

def test_gram_leaf_shape_and_zero_init():
    c = tcache.init(CacheLayout(cap=4, gram=True), 3, 5, "cpu")
    assert c.gram.shape == (3, 4, 4) and c.gram.dtype == torch.float32
    assert not c.gram.any()
    assert tcache.init(CacheLayout(cap=4), 3, 5, "cpu").gram is None


@pytest.mark.parametrize("seed", [0, 1])
def test_insert_refreshes_gram_rows_like_jax(seed):
    """Random insert sequences (LRU overwrites and TTL evictions
    included): the whole Gram leaf, stale entries too, matches the
    reference's, and on valid slot pairs equals P_i P_i^T."""
    r = np.random.RandomState(seed)
    n, cap, d = 3, 3, 5
    jc = jcache.init(JLayout(cap=cap, gram=True), n, d)
    tc = tcache.init(CacheLayout(cap=cap, gram=True), n, d, "cpu")
    for t in range(12):
        i = int(r.randint(n))
        plane = r.randn(d + 1).astype(np.float32)
        jc = jcache.insert(jc, jnp.int32(i), jnp.asarray(plane),
                           jnp.int32(t))
        tc = tcache.insert(tc, i, T(plane), t)
        if t == 6:
            jc = jcache.evict_stale(jc, jnp.int32(t), 2)
            tc = tcache.evict_stale(tc, t, 2)
    assert (tc.valid.numpy() == np.asarray(jc.valid)).all()
    assert (tc.last_active.numpy() == np.asarray(jc.last_active)).all()
    g = tc.gram.numpy()
    assert_allclose(g, np.asarray(jc.gram), **TOL)
    stars = tc.planes.numpy()[:, :, :-1]
    valid = tc.valid.numpy()
    for i in range(n):
        occupied = np.outer(valid[i], valid[i])
        assert_allclose(g[i][occupied], (stars[i] @ stars[i].T)[occupied],
                        rtol=1e-5, atol=1e-5)
        assert (g[i] == g[i].T).all()


def test_mark_active_where_and_gather_carry_the_gram_leaf():
    tc = tcache.init(CacheLayout(cap=4, gram=True), 3, 2, "cpu")
    for i in range(3):
        tc = tcache.insert(tc, i, T(np.float32([1.0 + i, 2.0, 0.5])), 0)
    jc = jcache.init(JLayout(cap=4, gram=True), 3, 2)
    for i in range(3):
        jc = jcache.insert(jc, jnp.int32(i),
                           jnp.float32([1.0 + i, 2.0, 0.5]), jnp.int32(0))
    won = np.array([True, False, False, True])
    tc = tcache.mark_active_where(tc, 1, T(won), 7)
    jc = jcache.mark_active_where(jc, jnp.int32(1), jnp.asarray(won),
                                  jnp.int32(7))
    assert (tc.last_active.numpy() == np.asarray(jc.last_active)).all()
    sub = tcache.gather(tc, [2, 0])
    assert sub.gram.shape == (2, 4, 4)
    assert (sub.gram.numpy() == tc.gram.numpy()[[2, 0]]).all()
    sub.gram.zero_()                            # a copy, not a view
    assert tc.gram.any()


# -- carried state: one block, one pass, one outer iteration -----------------

def _chain_problems(n, f, C, mean_len, max_len, seed):
    X, Y, M = jsyn.ocr_like(n=n, f=f, num_labels=C, mean_len=mean_len,
                            max_len=max_len, seed=seed)
    return (jchain.make_problem(jnp.asarray(X), jnp.asarray(Y),
                                jnp.asarray(M), C),
            tchain.make_problem(X, Y, M, C, device="cpu"))


@pytest.fixture(scope="module")
def gram_midrun():
    """Both problems of SMALL["ocr"] and a JAX mpbcfw-gram state after two
    outer iterations (cap 6, ttl 1: evictions and LRU overwrites)."""
    jp, tp = _chain_problems(120, 32, 12, 7, 10, 0)
    solver = JSolver(jp, JRunConfig(
        lam=1.0 / jp.n, algo="mpbcfw-gram", cap=6, ttl=1, max_iters=2,
        approx_batch=2, max_approx_passes=2,
        cost_model=JCostModel(0.3, 1e-3)))
    solver.run()
    host = jax.device_get(solver.state)
    assert host.cache.gram is not None
    return jp, tp, host


@pytest.mark.parametrize("steps", [1, 10])
def test_multi_step_block_update_matches_jax(gram_midrun, steps):
    jp, _, host = gram_midrun
    lam = 1.0 / jp.n
    state = convert.mp_state_from_numpy(host, "cpu")
    sizes = host.cache.valid.sum(axis=1)
    blocks = [int(np.argmax(sizes)), int(np.argmin(sizes)), 0, 57]
    for i in blocks:
        jout = jgram.multi_step_block_update(
            *map(jnp.asarray, (host.cache.planes[i], host.cache.valid[i],
                               host.cache.gram[i], host.inner.phi,
                               host.inner.phi_i[i])), lam, steps)
        tout = tgram.multi_step_block_update(
            state.cache.planes[i], state.cache.valid[i], state.cache.gram[i],
            state.inner.phi, state.inner.phi_i[i], lam, steps)
        assert (tout[2].numpy() == np.asarray(jout[2])).all(), f"block {i}"
        assert_allclose(tout[0].numpy(), np.asarray(jout[0]), **TOL)
        assert_allclose(tout[1].numpy(), np.asarray(jout[1]), **TOL)
    # The function writes nothing.
    assert (state.inner.phi.numpy() == host.inner.phi).all()


def test_approx_pass_gram_matches_jax(gram_midrun):
    jp, _, host = gram_midrun
    lam = 1.0 / jp.n
    perm = np.random.RandomState(3).permutation(jp.n)
    jstate = jax.tree_util.tree_map(jnp.asarray, host)
    jin, jc, jav = jgram.approx_pass_gram(
        jstate.inner, jstate.cache, jstate.avg, jnp.asarray(perm),
        jstate.outer_it, lam, 10)
    state = convert.mp_state_from_numpy(host, "cpu")
    tmp.run_pass(state, torch.from_numpy(perm), lam, 10)
    state = tmp.count_passes(state, 1, jp.n, 10)
    tin, tc, tav = state.inner, state.cache, state.avg
    assert tin.n_approx == int(jin.n_approx)
    assert tav.k_approx == int(jav.k_approx)
    assert (tc.last_active.numpy() == np.asarray(jc.last_active)).all()
    assert_allclose(tin.phi.numpy(), np.asarray(jin.phi), **TOL)
    assert_allclose(tin.phi_i.numpy(), np.asarray(jin.phi_i), **TOL)
    assert_allclose(tav.bar_approx.numpy(), np.asarray(jav.bar_approx),
                    **TOL)


def test_outer_iteration_with_gram_from_carried_state_matches_jax(
        gram_midrun):
    """Eviction, the exact pass (inserts refresh Gram rows) and the
    slope-ruled gram passes, from the same carried state."""
    jp, tp, host = gram_midrun
    lam = 1.0 / jp.n
    rng = np.random.RandomState(5)
    perm = rng.permutation(jp.n)
    perms = np.stack([rng.permutation(jp.n) for _ in range(3)])
    jclock = jmp.make_slope_clock(0.0, 0.0, 0.3 * jp.n, 1e-3)
    jout, jclk, jst = jmp.jit_outer_iteration(
        jp, jax.tree_util.tree_map(jnp.asarray, host), jnp.asarray(perm),
        jnp.asarray(perms), jclock, lam=lam, ttl=1, steps=10)
    jst = jax.device_get(jst)
    state = convert.mp_state_from_numpy(host, "cpu")
    tclock = tmp.make_slope_clock(0.0, 0.0, 0.3 * jp.n, 1e-3, "cpu")
    tout, tclk, tst = tmp.outer_iteration(tp, state, perm, perms, tclock,
                                          lam=lam, ttl=1, steps=10,
                                          graphs=StepGraphs())
    tout = tmp.count_passes(tout, int(tst.passes_run), tst.blocks, 10)
    assert tst.passes_run == int(jst.passes_run)
    out = convert.mp_state_to_numpy(tout)
    assert (out["valid"] == np.asarray(jout.cache.valid)).all()
    assert (out["n_exact"], out["n_approx"]) == (
        int(jout.inner.n_exact), int(jout.inner.n_approx))
    assert_allclose(out["phi"], np.asarray(jout.inner.phi), **TOL)
    assert_allclose(out["gram"], np.asarray(jout.cache.gram), rtol=3e-5,
                    atol=3e-4)
    assert_allclose(tst.duals[:tst.passes_run].numpy(),
                    jst.duals[:tst.passes_run], **TOL)
    assert float(tclk.t) == float(jclk.t)


def test_convert_carries_the_gram_leaf(gram_midrun):
    _, _, host = gram_midrun
    state = convert.mp_state_from_numpy(host, "cpu")
    assert state.cache.gram.dtype == torch.float32
    assert (convert.mp_state_to_numpy(state)["gram"]
            == host.cache.gram).all()
    plain = convert.mp_state_from_numpy(
        host._replace(cache=host.cache._replace(gram=None)), "cpu")
    assert plain.cache.gram is None
    assert convert.mp_state_to_numpy(plain)["gram"] is None
    # A gap vector beside the Gram leaf is carried too, both ways.
    gap = np.linspace(0.0, 1.0, host.cache.valid.shape[0], dtype=np.float32)
    both = convert.mp_state_from_numpy(host._replace(
        cache=host.cache._replace(gap=gap)), "cpu")
    assert (both.cache.gap.numpy() == gap).all()
    assert (convert.mp_state_to_numpy(both)["gap"] == gap).all()
    assert (convert.mp_state_to_numpy(both)["gram"] == host.cache.gram).all()


# -- whole Solver runs -------------------------------------------------------

def _problems(name):
    if name == "multiclass":
        x, y = jsyn.usps_like(n=48, f=12, num_classes=5, seed=0)
        return (jmulti.make_problem(jnp.asarray(x), jnp.asarray(y), 5),
                tmulti.make_problem(x, y, 5, device="cpu"))
    if name == "conftest_chain":
        return _chain_problems(24, 8, 5, 6, 8, 1)
    return _chain_problems(120, 32, 12, 7, 10, 0)


@pytest.mark.parametrize("name", ["conftest_chain", "small_ocr",
                                  "multiclass"])
def test_gram_solver_three_iterations_match_jax(name):
    jp, tp = _problems(name)
    kw = dict(lam=1.0 / jp.n, algo="mpbcfw-gram", cap=16, ttl=2,
              max_iters=3, approx_batch=8, max_approx_passes=8)
    jr = JSolver(jp, JRunConfig(cost_model=JCostModel(0.3, 1e-3),
                                **kw)).run()
    tr = Solver(tp, RunConfig(cost_model=CostModel(0.3, 1e-3), **kw)).run()
    assert len(tr.trace) == len(jr.trace) == 3
    for a, b in zip(jr.trace, tr.trace):
        assert (b.n_exact, b.n_approx, b.approx_passes, b.planes_evicted,
                b.ws_mean) == (a.n_exact, a.n_approx, a.approx_passes,
                               a.planes_evicted, a.ws_mean), a.iteration
        assert_allclose(b.dual, a.dual, rtol=1e-4)
        assert_allclose(b.primal, a.primal, rtol=1e-4)
        assert_allclose(b.time, a.time, rtol=1e-12)
        # One sync per dispatch, as in the reference.
        assert (b.host_syncs, b.dispatches) == (a.host_syncs, a.dispatches)
    assert_allclose(tr.w, jr.w, rtol=1e-4, atol=1e-4)
    assert_allclose(tr.w_avg, jr.w_avg, rtol=1e-4, atol=1e-4)


def test_gram_steps_count_approximate_calls():
    _, tp = _problems("conftest_chain")
    for steps in (1, 3):
        res = Solver(tp, RunConfig(lam=1.0 / tp.n, algo="mpbcfw-gram",
                                   gram_steps=steps, max_iters=2, cap=8,
                                   cost_model=CostModel(0.3, 1e-3))).run()
        for row in res.trace:
            assert row.n_approx % (steps * tp.n) == 0
        assert res.trace[-1].n_approx == steps * tp.n * sum(
            r.approx_passes for r in res.trace)


def test_gram_engine_takes_its_step_count_from_the_config():
    _, tp = _problems("conftest_chain")
    engine = Solver(tp, RunConfig(lam=0.1, algo="mpbcfw-gram",
                                  gram_steps=4)).engine
    assert (engine.use_gram, engine.gram_steps) == (True, 4)
    assert engine.init_state(cap=8).cache.gram.shape == (tp.n, 8, 8)
    plain = Solver(tp, RunConfig(lam=0.1, algo="mpbcfw")).engine
    assert (plain.use_gram, plain.gram_steps) == (False, None)
    assert plain.init_state(cap=8).cache.gram is None


def test_gram_passes_without_a_step_count_are_refused():
    _, tp = _problems("conftest_chain")
    state = Solver(tp, RunConfig(lam=0.1, algo="mpbcfw-gram", cap=8)
                   ).engine.init_state(cap=8)
    clock = tmp.make_slope_clock(0.0, 0.0, 1.0, 1e-3, "cpu")
    perms = np.stack([np.arange(tp.n)])
    with pytest.raises(ValueError, match="step count"):
        tmp.multi_approx_pass(state, perms, clock, lam=0.1)

"""The pipelined engine ``mpbcfw-async`` of repro_torch vs the JAX package,
on the CPU: the batched score-and-select, the straggler fallback, the
fold-in, one cache program from a carried state, the host tau-nice pass
and whole Solver traces.

Inputs are made with numpy from seeds and handed to both packages; a JAX
``AsyncMPState`` taken mid-run is carried across with
``repro_torch.convert``.  Scores and states compare at rtol = atol = 3e-5,
Solver duals and primals at rtol 1e-4 and the modeled oracle overlap at
rtol 1e-6; counts, pass schedules and chosen slots must be equal, except
that a slot may differ between duplicate planes (then the planes it
picks must agree as values).
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
from repro.core import distributed as jdist
from repro.core import mpbcfw as jmp
from repro.core.oracles import chain as jchain
from repro.core.selection import CostModel as JCostModel
from repro.core.ssvm import weights_of as jweights_of
from repro.data import synthetic as jsyn
from repro.ft import StragglerPolicy as JStragglerPolicy
from repro.ft import simulate_oracle_outcomes as jsimulate
from repro.kernels import plane_select as jax_psel
from repro.kernels import ref as jax_ref
from repro_torch import cache as tcache
from repro_torch import convert
from repro_torch.api import CostModel, RunConfig, Solver, algorithms
from repro_torch.core import distributed as tdist
from repro_torch.core import mpbcfw as tmp
from repro_torch.core.graphs import StepGraphs
from repro_torch.core.oracles import chain as tchain
from repro_torch.core.ssvm import weights_of
from repro_torch.ft import (StragglerPolicy, fallback_planes,
                            simulate_oracle_outcomes)
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)
TOL = dict(rtol=3e-5, atol=3e-5)

# (n, f, C, mean_len, max_len, seed), as in tests/test_torch_solver.py.
SIZES = {"conftest": (24, 8, 5, 6, 8, 1), "small_ocr": (120, 32, 12, 7, 10, 0)}


def _problems(size):
    n, f, C, mean_len, max_len, seed = SIZES[size]
    X, Y, M = jsyn.ocr_like(n=n, f=f, num_labels=C, mean_len=mean_len,
                            max_len=max_len, seed=seed)
    return (jchain.make_problem(jnp.asarray(X), jnp.asarray(Y),
                                jnp.asarray(M), C),
            tchain.make_problem(X, Y, M, C, device="cpu"))


def _mask(it, k):
    """The straggler mask both packages' ``outcome_fn`` return."""
    return np.random.RandomState(100 + it).rand(k) > 0.3


# ---------------------------------------------------------------------------
# plane_select: the plain version against the Pallas kernel


def _select_inputs(n, cap, d, seed):
    r = np.random.RandomState(seed)
    stack = r.randn(n, cap, d + 1).astype(np.float32)
    valid = r.rand(n, cap) < 0.5
    valid[::5] = False                       # rows with no valid slot
    if cap > 2:
        stack[1::3, 2] = stack[1::3, 0]      # duplicate planes: ties
        valid[1::3, 0] = valid[1::3, 2] = True
    w = r.randn(d).astype(np.float32)
    return stack, valid, w


@pytest.mark.parametrize("n,cap,d", [(1, 1, 1), (13, 7, 200), (24, 8, 528)])
@pytest.mark.parametrize("permuted", [False, True])
def test_plane_select_ref_matches_pallas(n, cap, d, permuted):
    stack, valid, w = _select_inputs(n, cap, d, n * cap + d)
    rows = np.random.RandomState(d).permutation(n) if permuted else None
    sel = slice(None) if rows is None else rows
    args = (jnp.asarray(stack[sel][..., :-1]), jnp.asarray(w),
            jnp.asarray(stack[sel][..., -1]), jnp.asarray(valid[sel]))
    want_best, want_idx = jax_psel.plane_select(*args, interpret=True)
    ref_best, ref_idx = jax_ref.plane_select_ref(*args)
    ts = torch.from_numpy(stack)
    trows = None if rows is None else torch.from_numpy(rows)
    got = ops.plane_select(ts[..., :-1], torch.from_numpy(w), ts[..., -1],
                           torch.from_numpy(valid), rows=trows)
    plain = ref.plane_select_ref(ts[..., :-1], torch.from_numpy(w),
                                 ts[..., -1], torch.from_numpy(valid), trows)
    for best, idx in (got, plain):
        assert best.dtype == torch.float32 and idx.dtype == torch.int32
        for wb, wi in ((want_best, want_idx), (ref_best, ref_idx)):
            assert_allclose(best.numpy(), np.asarray(wb), **TOL)
            assert (idx.numpy() == np.asarray(wi)).all()
    empty = ~valid[sel].any(axis=1)
    assert (got[0].numpy()[empty] == ops.INVALID_SCORE).all()
    assert (got[1].numpy()[empty] == 0).all()


def test_plane_select_ref_ties_pick_first_and_match_approx_oracle():
    """Scores are bit-equal to the per-block approximate oracle's, so a
    duplicate plane ties exactly and the first copy wins."""
    stack, valid, w = _select_inputs(24, 8, 528, 7)
    ts, tw = torch.from_numpy(stack), torch.from_numpy(w)
    best, idx = ref.plane_select_ref(ts[..., :-1], tw, ts[..., -1],
                                     torch.from_numpy(valid))
    cache = tcache.PlaneCache(planes=ts, valid=torch.from_numpy(valid),
                              last_active=torch.zeros((24, 8),
                                                      dtype=torch.int32))
    for i in range(24):
        if not valid[i].any():
            continue
        _, slot, score = tcache.approx_oracle(cache, i, tw)
        assert int(slot) == int(idx[i]) and float(score) == float(best[i])
    dup = [i for i in range(1, 24, 3) if int(idx[i]) in (0, 2)]
    assert dup and all(int(idx[i]) == 0 for i in dup)


def test_plane_select_custom_neg_and_cpu_launches_nothing():
    stack, valid, w = _select_inputs(6, 4, 9, 3)
    ts = torch.from_numpy(stack)
    ops.reset_launch_counts()
    best, idx = ops.plane_select(ts[..., :-1], torch.from_numpy(w),
                                 ts[..., -1], torch.zeros((6, 4), dtype=bool),
                                 neg=-7.0)
    assert (best == -7.0).all() and (idx == 0).all()
    assert ops.launch_counts() == {"plane_scores": 0, "plane_select": 0,
                                   "viterbi_decode": 0, "moe_ffn": 0,
                                   "flash_attention": 0, "gram": 0,
                                   "approx_pass": 0}


# ---------------------------------------------------------------------------
# A JAX AsyncMPState taken mid-run, with a mixed straggler mask


@pytest.fixture(scope="module")
def midrun():
    """Both problems of each size, and the JAX mpbcfw-async state after
    two outer iterations (cap 6, ttl 1: evictions happen; the pending
    buffer is live with a mixed ``done``)."""
    out = {}
    for size in SIZES:
        jp, tp = _problems(size)
        solver = JSolver(jp, JRunConfig(
            lam=1.0 / jp.n, algo="mpbcfw-async", cap=6, ttl=1, max_iters=2,
            approx_batch=4, max_approx_passes=4,
            cost_model=JCostModel(0.3, 1e-3)))
        solver.engine.outcome_fn = lambda it, k: jnp.asarray(_mask(it, k))
        solver.run()
        host = jax.device_get(solver.state)
        assert bool(host.pending.live) and not host.pending.done.all()
        out[size] = (jp, tp, host)
    return out


def _jstate(host):
    return jax.tree_util.tree_map(jnp.asarray, host)


def _slots_agree(slots, want_slots, planes, want_planes, what):
    """Chosen slots equal, or else the chosen planes equal as values (a
    tie between duplicate planes broken the other way)."""
    for b in np.argwhere(slots != want_slots)[:, 0]:
        assert np.allclose(planes[b], want_planes[b], **TOL), (
            f"{what}: row {b} slot {slots[b]} vs JAX {want_slots[b]}")


@pytest.mark.parametrize("size", sorted(SIZES))
def test_approx_oracle_all_and_fallback_match_jax(midrun, size):
    jp, tp, host = midrun[size]
    lam = 1.0 / jp.n
    jst = _jstate(host)
    state = convert.async_state_from_numpy(host, "cpu")
    cache = state.mp.cache
    assert 0 < int(cache.valid.sum()) < cache.valid.numel()
    w = weights_of(state.inner.phi, lam)
    jw = jweights_of(jst.mp.inner.phi, lam)
    perm = np.random.RandomState(3).permutation(jp.n)
    cases = [(tcache.approx_oracle_all(cache, w),
              jcache.approx_oracle_all(jst.mp.cache, jw)),
             (fallback_planes(cache, perm, w),
              jdist.fallback_planes(jst.mp.cache, jnp.asarray(perm), jw))]
    for (planes, slots, scores), want in cases:
        want = jax.device_get(want)
        _slots_agree(slots.numpy(), want[1], planes.numpy(), want[0], size)
        assert_allclose(planes.numpy(), want[0], **TOL)
        assert_allclose(scores.numpy(), want[2], **TOL)
    # Empty blocks: the zero plane, slot 0, score 0.
    planes, slots, scores = cases[0][0]
    empty = ~cache.valid.any(dim=1)
    assert (planes[empty] == 0).all() and (slots[empty] == 0).all()
    assert (scores[empty] == 0).all()


def test_cache_views_and_score_all_match_jax(midrun):
    jp, _, host = midrun["small_ocr"]
    jst = _jstate(host)
    cache = convert.async_state_from_numpy(host, "cpu").mp.cache
    w = weights_of(convert.async_state_from_numpy(host, "cpu").inner.phi,
                   1.0 / jp.n)
    jw = jweights_of(jst.mp.inner.phi, 1.0 / jp.n)
    assert_allclose(tcache.score_all(cache, w).numpy(),
                    np.asarray(jcache.score_all(jst.mp.cache, jw)), **TOL)
    for got, want in zip(tcache.flat_view(cache),
                         jcache.flat_view(jst.mp.cache)):
        assert (got.numpy() == np.asarray(want)).all()
    ids = np.array([5, 0, 77, 5])
    sub, jsub = tcache.gather(cache, ids), jcache.gather(jst.mp.cache,
                                                         jnp.asarray(ids))
    for f in ("planes", "valid", "last_active"):
        assert (getattr(sub, f).numpy() == np.asarray(getattr(jsub, f))).all()


def _fold_inputs(jp, host, k, seed):
    """The JAX oracle planes, fallback and a mixed done mask for the first
    ``k`` blocks of a permutation, at the carried state's ``w``."""
    lam = 1.0 / jp.n
    jst = _jstate(host)
    rng = np.random.RandomState(seed)
    ids = rng.permutation(jp.n)[:k]
    jw = jweights_of(jst.mp.inner.phi, lam)
    planes = jdist.parallel_oracles(jp, jw, jnp.asarray(ids))
    fbp, fbs, _ = jdist.fallback_planes(jst.mp.cache, jnp.asarray(ids), jw)
    done = rng.rand(k) > 0.4
    assert done.any() and not done.all()
    return jst, ids, planes, fbp, fbs, done


def _assert_activity_matches(out, jcache_state, it):
    """``last_active`` equal, except where a block holds duplicate planes
    (a plane the port computed and an equal one carried over from JAX can
    differ in the last bits): there the planes marked at ``it`` must agree
    as values."""
    la_j, la_t = np.asarray(jcache_state.last_active), out["last_active"]
    pj, pt = np.asarray(jcache_state.planes), out["planes"]
    for i in np.unique(np.argwhere(la_j != la_t)[:, 0]):
        act_j, act_t = pj[i][la_j[i] == it], pt[i][la_t[i] == it]
        for a, others in ((act_j, act_t), (act_t, act_j)):
            for p in a:
                assert any(np.allclose(p, q, **TOL) for q in others), (
                    f"block {i}: activity {la_t[i]} vs JAX {la_j[i]}")


def _assert_mp_matches(out, jmp_state, it):
    assert (out["valid"] == np.asarray(jmp_state.cache.valid)).all()
    _assert_activity_matches(out, jmp_state.cache, it)
    assert (out["n_exact"], out["n_approx"]) == (
        int(jmp_state.inner.n_exact), int(jmp_state.inner.n_approx))
    assert (out["k_exact"], out["k_approx"]) == (
        int(jmp_state.avg.k_exact), int(jmp_state.avg.k_approx))
    for f, leaf in (("phi", jmp_state.inner.phi),
                    ("phi_i", jmp_state.inner.phi_i),
                    ("planes", jmp_state.cache.planes),
                    ("bar_exact", jmp_state.avg.bar_exact),
                    ("bar_approx", jmp_state.avg.bar_approx)):
        assert_allclose(out[f], np.asarray(leaf), **TOL, err_msg=f)


@pytest.mark.parametrize("size", sorted(SIZES))
def test_fold_planes_mixed_done_matches_jax(midrun, size):
    jp, _, host = midrun[size]
    lam = 1.0 / jp.n
    k = jp.n // 2
    jst, ids, planes, fbp, fbs, done = _fold_inputs(jp, host, k, seed=11)
    want = jax.device_get(jdist.jit_fold_planes(
        jst.mp, jnp.asarray(ids), planes, fbp, fbs, jnp.asarray(done),
        lam=lam, scatter="per-elem"))
    state = convert.async_state_from_numpy(host, "cpu")
    got = tdist.fold_planes(
        state.mp, ids, torch.from_numpy(np.array(planes)),
        torch.from_numpy(np.array(fbp)), torch.from_numpy(np.array(fbs)),
        done, lam, graphs=StepGraphs())
    _assert_mp_matches(convert.mp_state_to_numpy(got), want, got.outer_it)


def test_fold_planes_not_live_leaves_the_state_alone(midrun):
    jp, _, host = midrun["conftest"]
    lam = 1.0 / jp.n
    _, ids, planes, fbp, fbs, done = _fold_inputs(jp, host, jp.n, seed=4)
    args = (ids, torch.from_numpy(np.array(planes)),
            torch.from_numpy(np.array(fbp)),
            torch.from_numpy(np.array(fbs)), done, lam)
    mp = convert.async_state_from_numpy(host, "cpu").mp
    with pytest.raises(ValueError, match="done flags"):
        tdist.fold_planes(mp, *args[:4], done[:-1], lam,
                          graphs=StepGraphs())
    before = convert.mp_state_to_numpy(mp)
    assert tdist.fold_planes(mp, *args, live=False,
                             graphs=StepGraphs()) is mp
    for key, val in convert.mp_state_to_numpy(mp).items():
        assert np.array_equal(np.asarray(val), np.asarray(before[key])), key


def test_fold_planes_empty_cache_marks_slot_zero():
    """A straggler with an empty cache folds the zero plane and marks
    slot 0 active, as the reference's ``jnp.where`` form does."""
    _, tp = _problems("conftest")
    lam = 1.0 / tp.n
    mp = tmp.init_mp_state(tp, 4)
    mp = mp._replace(outer_it=3)
    ids = np.array([2, 7])
    w = weights_of(mp.inner.phi, lam)
    fbp, fbs, _ = fallback_planes(mp.cache, ids, w)
    planes = tdist.parallel_oracles(tp, w, ids)
    out = tdist.fold_planes(mp, ids, planes, fbp, fbs,
                            np.array([False, True]), lam,
                            graphs=StepGraphs())
    assert out.cache.last_active[2].tolist() == [3, -1, -1, -1]
    assert out.cache.valid[2].sum() == 0 and out.cache.valid[7].sum() == 1
    assert (out.inner.n_exact, out.inner.n_approx) == (1, 1)


@pytest.mark.parametrize("size", sorted(SIZES))
def test_async_cache_program_from_carried_state_matches_jax(midrun, size):
    jp, _, host = midrun[size]
    lam, ttl = 1.0 / jp.n, 1
    rng = np.random.RandomState(8)
    perms = np.stack([rng.permutation(jp.n) for _ in range(5)])
    est_exact, plane_cost = 0.3 * jp.n, 1e-3
    jst = _jstate(host)
    jout, jclk, jstats = jmp.jit_async_cache(
        jst.mp, jst.pending, jnp.asarray(perms),
        jmp.make_slope_clock(0.0, 0.0, est_exact, plane_cost), lam=lam,
        ttl=ttl)
    jout, jstats = jax.device_get(jout), jax.device_get(jstats)
    state = convert.async_state_from_numpy(host, "cpu")
    out, clk, st = tmp.async_cache_program(
        state.mp, state.pending, perms,
        tmp.make_slope_clock(0.0, 0.0, est_exact, plane_cost, "cpu"),
        lam=lam, ttl=ttl, graphs=StepGraphs())
    out = tmp.count_passes(out, int(st.passes_run), st.blocks)
    assert st.passes_run == int(jstats.passes_run)
    assert bool(st.more) == bool(jstats.more)
    _assert_mp_matches(convert.mp_state_to_numpy(out), jout, out.outer_it)
    assert out.outer_it == int(jout.outer_it)
    k = st.passes_run
    assert_allclose(st.duals[:k].numpy(), jstats.duals[:k], **TOL)
    assert (st.times.numpy() == jstats.times).all()
    assert (st.planes.numpy() == jstats.planes).all()
    assert float(clk.t) == float(jclk.t)
    assert_allclose(float(clk.f0), float(jclk.f0), **TOL)
    for f in ("ttl_evicted", "lru_evicted", "occupancy", "nonempty_blocks"):
        assert int(getattr(st.metrics, f)) == int(
            getattr(jstats.metrics, f)), f


def test_async_oracle_program_matches_jax(midrun):
    jp, tp, host = midrun["small_ocr"]
    lam = 1.0 / jp.n
    jst = _jstate(host)
    perm = np.random.RandomState(2).permutation(jp.n)
    jids, jplanes = jmp.async_oracle_program(
        jp.oracle, jp.data, jst.mp.inner.phi, jst.mp.cache,
        jnp.asarray(perm), None, lam=lam)
    state = convert.async_state_from_numpy(host, "cpu")
    ids, planes = tmp.async_oracle_program(
        tp, weights_of(state.inner.phi, lam), perm)
    assert (ids == np.asarray(jids)).all() and ids.dtype == np.int64
    assert_allclose(planes.numpy(), np.asarray(jplanes), **TOL)


def test_host_tau_nice_pass_with_done_mask_matches_jax(midrun):
    jp, tp, host = midrun["conftest"]
    lam, tau = 1.0 / jp.n, 6
    perm = np.random.RandomState(6).permutation(jp.n)
    done = np.random.RandomState(7).rand(jp.n // tau, tau) > 0.3
    jst = _jstate(host)
    want = jax.device_get(jdist.host_tau_nice_pass(
        jp, jst.mp, jnp.asarray(perm), lam, tau, jnp.asarray(done)))
    mp = convert.async_state_from_numpy(host, "cpu").mp
    got = tdist.host_tau_nice_pass(tp, mp, perm, lam, tau, done)
    _assert_mp_matches(convert.mp_state_to_numpy(got), want, got.outer_it)
    with pytest.raises(ValueError, match="multiple of tau"):
        tdist.host_tau_nice_pass(tp, mp, perm, lam, 5)


def test_distributed_entry_points_that_are_not_ported_raise():
    """Every entry point of core.distributed runs in the port now:
    parallel_oracles over a mesh (one rank here) equals the plain call,
    and refuses ids that do not split over the mesh's ranks."""
    from repro_torch.launch.mesh import make_data_mesh

    class TwoRanks:
        rank, size = 0, 2

    _, tp = _problems("conftest")
    w = torch.zeros((tp.d,))
    mesh = make_data_mesh(device="cpu")
    assert torch.equal(tdist.parallel_oracles(tp, w, np.arange(3), mesh),
                       tdist.parallel_oracles(tp, w, np.arange(3)))
    with pytest.raises(ValueError, match="do not split over 2 ranks"):
        tdist.parallel_oracles(tp, w, np.arange(3), mesh=TwoRanks())


def test_async_state_converts_both_ways(midrun):
    _, _, host = midrun["conftest"]
    state = convert.async_state_from_numpy(host, "cpu")
    assert state.inner is state.mp.inner
    out = convert.async_state_to_numpy(state)
    p = out["pending"]
    assert (p["ids"] == np.asarray(host.pending.ids)).all()
    assert (p["done"] == np.asarray(host.pending.done)).all()
    assert p["live"] is True
    assert (p["planes"] == np.asarray(host.pending.planes)).all()
    assert (out["planes"] == np.asarray(host.mp.cache.planes)).all()
    assert out["outer_it"] == int(host.mp.outer_it)


def test_straggler_simulation_matches_jax():
    for seed, policy in ((0, StragglerPolicy()),
                         (3, StragglerPolicy(straggler_prob=0.4,
                                             deadline_factor=1.5))):
        jpolicy = JStragglerPolicy(**policy.__dict__)
        got = simulate_oracle_outcomes(500, policy,
                                       np.random.RandomState(seed))
        want = jsimulate(500, jpolicy, np.random.RandomState(seed))
        assert (got[0] == want[0]).all() and (got[1] == want[1]).all()
    assert StragglerPolicy() == StragglerPolicy(**JStragglerPolicy().__dict__)


# ---------------------------------------------------------------------------
# Whole Solver runs


def _run_both(size, outcome=None, passes=8, batch=None, record=None):
    """Both packages' Solver runs; ``record`` (a dict) collects each
    run's per-iteration host stats under ``"jax"`` and ``"port"``."""
    jp, tp = _problems(size)
    lam = 1.0 / jp.n
    cfg = dict(algo="mpbcfw-async", cap=16, ttl=2, max_iters=3,
               approx_batch=batch or passes, max_approx_passes=passes)
    js = JSolver(jp, JRunConfig(lam=lam, cost_model=JCostModel(0.3, 1e-3),
                                **cfg))
    ts = Solver(tp, RunConfig(lam=lam, cost_model=CostModel(0.3, 1e-3),
                              **cfg))
    if outcome is not None:
        js.engine.outcome_fn = lambda it, k: jnp.asarray(outcome(it, k))
        ts.engine.outcome_fn = outcome
    if record is not None:
        for key, s in (("jax", js), ("port", ts)):
            def logged(stats, read=s.engine.read_stats,
                       log=record.setdefault(key, [])):
                log.append(read(stats))
                return log[-1]
            s.engine.read_stats = logged
    return js.run(), ts.run()


def _ulp_gain_margin(stats, it, k):
    """The change of the dual over passes ``k..`` of iteration ``it``, in
    float32 ulps of the iteration's dual (rounding can make it negative)."""
    duals = np.asarray(stats[it].duals, np.float32)
    last = int(stats[it].passes_run)
    return float((duals[last - 1] - duals[k - 1]) /
                 np.spacing(np.abs(duals[last - 1])))


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("stragglers", [False, True])
def test_async_solver_three_iterations_match_jax(size, stragglers):
    """Without stragglers the third iteration folds oracle planes made at
    ``w = 0`` a second time (the first iteration cannot move ``w``: its
    cache is empty), so its approximate passes gain a float32 ulp or two
    of the dual and a slope decision there rests on rounding in either
    package (ROADMAP C).  There the pass counts may differ, provided the
    passes one package ran beyond the other moved the dual by at most 4
    ulps; the margin is printed.  Every other iteration, and every iteration with
    stragglers (the missed blocks' planes arrive late and give real
    gains), must run the same schedule."""
    record = {}
    jr, tr = _run_both(size, _mask if stragglers else None, record=record)
    assert len(tr.trace) == len(jr.trace) == 3
    for it, (a, b) in enumerate(zip(jr.trace, tr.trace)):
        flipped = False
        got = (b.n_exact, b.n_approx, b.approx_passes, b.planes_evicted,
               b.cache_hit_rate, b.ws_mean)
        want = (a.n_exact, a.n_approx, a.approx_passes, a.planes_evicted,
                a.cache_hit_rate, a.ws_mean)
        if got != want and not stragglers and it == 2:
            more = "jax" if a.approx_passes > b.approx_passes else "port"
            k = min(a.approx_passes, b.approx_passes)
            margin = _ulp_gain_margin(record[more], it, k)
            print(f"{size} iteration {it}: slope decision flipped (port "
                  f"{b.approx_passes} passes, JAX {a.approx_passes}); the "
                  f"{more} run's extra passes moved the dual {margin} ulps")
            assert abs(margin) <= 4.0
            assert b.n_approx - a.n_approx == SIZES[size][0] * (
                b.approx_passes - a.approx_passes)
            got, want = got[:1] + got[3:], want[:1] + want[3:]
            flipped = True
        assert got == want, (f"iteration {a.iteration}: port {got} vs JAX "
                             f"{want}; duals {b.dual} vs {a.dual}")
        assert_allclose(b.dual, a.dual, rtol=1e-4)
        assert_allclose(b.primal, a.primal, rtol=1e-4)
        # The hidden oracle time and the modeled clock follow the pass
        # count; after a flip the overlap per pass still agrees.
        if flipped:
            assert_allclose(b.oracle_overlap / b.approx_passes,
                            a.oracle_overlap / a.approx_passes, rtol=1e-6)
        else:
            assert_allclose(b.oracle_overlap, a.oracle_overlap, rtol=1e-6)
            assert_allclose(b.time, a.time, rtol=1e-12)
        assert 0.0 < b.oracle_overlap <= 1.0
        # Two dispatches and one host sync, as in the reference.
        assert (b.host_syncs, b.dispatches) == (a.host_syncs, a.dispatches)
        assert b.dispatches == 2
    if stragglers:
        assert tr.trace[-1].n_exact < 2 * SIZES[size][0]
    assert_allclose(tr.w, jr.w, rtol=1e-4, atol=1e-4)


def test_async_solver_overflow_batches_match_jax():
    """approx_batch < max_approx_passes: the overflow continuations of the
    pipelined engine draw and dispatch as in the reference."""
    jr, tr = _run_both("conftest", _mask, passes=5, batch=2)
    assert any(r.dispatches > 2 for r in tr.trace)
    for a, b in zip(jr.trace, tr.trace):
        assert (b.n_exact, b.n_approx, b.approx_passes, b.dispatches) == (
            a.n_exact, a.n_approx, a.approx_passes, a.dispatches)
        assert b.host_syncs == a.host_syncs
        assert_allclose(b.dual, a.dual, rtol=1e-4)
        assert_allclose(b.oracle_overlap, a.oracle_overlap, rtol=1e-6)


def test_async_solver_duals_rise_with_stragglers():
    _, tp = _problems("conftest")
    solver = Solver(tp, RunConfig(lam=1.0 / tp.n, algo="mpbcfw-async",
                                  max_iters=4, cap=8,
                                  cost_model=CostModel(0.3, 1e-3)))
    solver.engine.outcome_fn = _mask
    rows = solver.run().trace
    duals = [r.dual for r in rows]
    assert duals == sorted(duals)
    assert all(r.gap >= -1e-5 * abs(r.primal) for r in rows)
    assert rows[-1].n_exact < 3 * tp.n
    assert "mpbcfw-async" in algorithms()

"""The approximate passes of repro_torch as one gated pass per launch, on
the CPU: the sync contract against the JAX package, and the gating.

Each approximate pass is one ``core.mpbcfw.run_pass`` call (the
``approx_pass`` kernel on CUDA, its eager plain version here), queued
behind the slope rule's flag on the device, so a batch of passes is
dispatched whole and read once.  The Solver traces must then count the
reference's host syncs and dispatches row for row; a pass queued after
the rule stopped must leave every state tensor bit for bit as it was; and
a gated batch must equal the same number of plain passes exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.api import RunConfig as JRunConfig
from repro.api import Solver as JSolver
from repro.core.oracles import chain as jchain
from repro.core.selection import CostModel as JCostModel
from repro.data import synthetic as jsyn
from repro_torch.api import CostModel, RunConfig, Solver
from repro_torch.configs.paper import SMALL
from repro_torch.core import mpbcfw as tmp
from repro_torch.core.oracles import chain as tchain
from repro_torch.kernels import ops

torch.set_num_threads(1)

ENGINES = ("mpbcfw", "mpbcfw-gram", "mpbcfw-async")


def _mask(it, k):
    """A fixed straggler mask for both packages' ``mpbcfw-async``: without
    late planes its third iteration decides on 1-2 ulp gains (ROADMAP C)."""
    return np.random.RandomState(100 + it).rand(k) > 0.3


def _small_ocr():
    sc = SMALL["ocr"]
    X, Y, M = jsyn.ocr_like(n=sc.n, f=sc.f, num_labels=sc.num_classes,
                            mean_len=sc.mean_len, max_len=sc.max_len, seed=0)
    return sc, (jchain.make_problem(jnp.asarray(X), jnp.asarray(Y),
                                    jnp.asarray(M), sc.num_classes),
                tchain.make_problem(X, Y, M, sc.num_classes, device="cpu"))


@pytest.mark.parametrize("algo", ENGINES)
def test_solver_syncs_and_dispatches_match_jax(algo):
    """SMALL ocr, 3 iterations of up to 6 passes in batches of 4 (an
    overflow batch where the rule wants more): per row the reference's
    host syncs, dispatches and pass counts; duals and primals within rtol
    1e-4."""
    sc, (jp, tp) = _small_ocr()
    kw = dict(lam=1.0 / sc.n, algo=algo, cap=16, ttl=2, max_iters=3,
              approx_batch=4, max_approx_passes=6)
    js = JSolver(jp, JRunConfig(
        cost_model=JCostModel(sc.oracle_cost, sc.plane_cost), **kw))
    ts = Solver(tp, RunConfig(
        cost_model=CostModel(sc.oracle_cost, sc.plane_cost), **kw))
    if algo == "mpbcfw-async":
        js.engine.outcome_fn = lambda it, k: jnp.asarray(_mask(it, k))
        ts.engine.outcome_fn = _mask
    ops.reset_launch_counts()
    jr, tr = js.run(), ts.run()
    assert ops.launch_counts()["approx_pass"] == 0   # CPU: plain version
    assert len(tr.trace) == len(jr.trace) == 3
    for a, b in zip(jr.trace, tr.trace):
        got = (b.host_syncs, b.dispatches, b.approx_passes, b.n_exact,
               b.n_approx)
        want = (a.host_syncs, a.dispatches, a.approx_passes, a.n_exact,
                a.n_approx)
        assert got == want, f"iteration {a.iteration}: {got} vs {want}"
        assert_allclose(b.dual, a.dual, rtol=1e-4)
        assert_allclose(b.primal, a.primal, rtol=1e-4)
    assert sum(r.approx_passes for r in tr.trace) > 0


def _trained(algo, iters=2):
    """A port state after ``iters`` Solver iterations on SMALL ocr."""
    sc, (_, tp) = _small_ocr()
    solver = Solver(tp, RunConfig(
        lam=1.0 / sc.n, algo=algo, cap=16, ttl=2, max_iters=iters,
        approx_batch=2, max_approx_passes=2,
        cost_model=CostModel(sc.oracle_cost, sc.plane_cost)))
    solver.run()
    return sc, solver


def _leaves(mp):
    """Every state tensor of an MPState, and its host counters."""
    c = mp.cache
    tensors = {"phi": mp.inner.phi, "phi_i": mp.inner.phi_i,
               "bar_exact": mp.avg.bar_exact, "bar_approx": mp.avg.bar_approx,
               "planes": c.planes, "valid": c.valid,
               "last_active": c.last_active}
    if c.gram is not None:
        tensors["gram"] = c.gram
    return tensors, (mp.inner.n_exact, mp.inner.n_approx, mp.avg.k_exact,
                     mp.avg.k_approx, mp.outer_it)


def _copy(mp):
    tensors, _ = _leaves(mp)
    cl = {k: v.clone() for k, v in tensors.items()}
    return mp._replace(
        inner=mp.inner._replace(phi=cl["phi"], phi_i=cl["phi_i"]),
        avg=mp.avg._replace(bar_exact=cl["bar_exact"],
                            bar_approx=cl["bar_approx"]),
        cache=mp.cache._replace(planes=cl["planes"], valid=cl["valid"],
                                last_active=cl["last_active"],
                                gram=cl.get("gram")))


def _assert_same(a, b):
    ta, ha = _leaves(a)
    tb, hb = _leaves(b)
    assert ha == hb
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k


@pytest.mark.parametrize("algo", ["mpbcfw", "mpbcfw-gram"])
def test_passes_after_the_stop_leave_the_state_alone(algo):
    """A clock whose chord is steep (f0 far below the dual) stops the rule
    after the first pass: the three passes queued behind it change no state
    tensor, bit for bit; the batch equals that one pass run alone."""
    sc, solver = _trained(algo)
    steps = solver.cfg.gram_steps if algo == "mpbcfw-gram" else None
    perms = np.stack([np.random.RandomState(s).permutation(sc.n)
                      for s in range(4)])
    clock = tmp.make_slope_clock(0.0, -1e6, 1.0, 1e-4, "cpu")
    mp = solver.state
    one = _copy(mp)
    out, _, st = tmp.multi_approx_pass(mp, perms, clock, lam=solver.cfg.lam,
                                       steps=steps)
    assert int(st.passes_run) == 1 and not bool(st.more)
    assert st.ran.tolist() == [True, False, False, False]
    assert (st.duals[1:] == 0).all() and (st.planes[1:] == 0).all()
    out = tmp.count_passes(out, int(st.passes_run), st.blocks, steps)
    ref, _, rst = tmp.multi_approx_pass(one, perms[:1], clock,
                                        lam=solver.cfg.lam, steps=steps,
                                        run_all=True)
    ref = tmp.count_passes(ref, int(rst.passes_run), rst.blocks, steps)
    _assert_same(out, ref)


@pytest.mark.parametrize("steps", [None, 10])
def test_a_false_flag_changes_nothing(steps):
    algo = "mpbcfw" if steps is None else "mpbcfw-gram"
    sc, solver = _trained(algo)
    mp = solver.state
    before = _copy(mp)
    perm = torch.from_numpy(np.random.RandomState(3).permutation(sc.n))
    tmp.run_pass(mp, perm, solver.cfg.lam, steps,
                 go=torch.zeros((), dtype=torch.bool))
    _assert_same(mp, before)
    tmp.run_pass(mp, perm, solver.cfg.lam, steps,
                 go=torch.ones((), dtype=torch.bool))
    assert not torch.equal(mp.inner.phi, before.inner.phi)


@pytest.mark.parametrize("algo", ["mpbcfw", "mpbcfw-gram"])
def test_run_all_batch_equals_sequential_plain_passes(algo):
    """Three gated passes with the rule off are three plain passes, bit for
    bit: the averaging count of pass k starts at k_approx + k n."""
    sc, solver = _trained(algo)
    lam = solver.cfg.lam
    steps = solver.cfg.gram_steps if algo == "mpbcfw-gram" else None
    perms = np.stack([np.random.RandomState(10 + s).permutation(sc.n)
                      for s in range(3)])
    clock = tmp.make_slope_clock(0.0, 0.0, 1.0, 1e-4, "cpu")
    seq = _copy(solver.state)
    out, _, st = tmp.multi_approx_pass(solver.state, perms, clock, lam=lam,
                                       steps=steps, run_all=True)
    assert int(st.passes_run) == 3 and bool(st.more)
    out = tmp.count_passes(out, 3, st.blocks, steps)
    for p in perms:
        tmp.run_pass(seq, torch.from_numpy(p), lam, steps)
        seq = tmp.count_passes(seq, 1, sc.n, steps)
    _assert_same(out, seq)


def test_cpu_dispatch_of_the_pass_launches_nothing():
    sc, solver = _trained("mpbcfw", iters=1)
    mp = solver.state
    ops.reset_launch_counts()
    tmp.run_pass(mp, torch.arange(sc.n), solver.cfg.lam)
    tmp.run_pass(mp, torch.arange(sc.n), solver.cfg.lam,
                 go=torch.ones((), dtype=torch.bool))
    assert all(v == 0 for v in ops.launch_counts().values())


def test_count_passes_charges_calls_and_averaging_steps():
    sc, solver = _trained("mpbcfw", iters=1)
    mp = solver.state
    out = tmp.count_passes(mp, 3, sc.n, 10)
    assert out.inner.n_approx == mp.inner.n_approx + 30 * sc.n
    assert out.avg.k_approx == mp.avg.k_approx + 3 * sc.n
    out = tmp.count_passes(mp, 2, sc.n)
    assert out.inner.n_approx == mp.inner.n_approx + 2 * sc.n

"""The tensor-indexed block steps of repro_torch (the exact pass and the
two fold-in bodies, which CUDA replays as captured graphs) vs the JAX
package, on the CPU, where the same bodies run in a plain loop.

From one mid-run JAX state carried across by ``repro_torch.convert`` and
the same numpy permutation, an exact pass on ``SMALL`` ocr (plain and Gram
cache), usps and horseseg, and the fold of arrived and straggler blocks,
agree with the reference at rtol = atol = 3e-5 with equal slots (validity
and activity stamps) and equal host counters.  The averaging weights come
from a table made on the host, bit-equal to the reference's float32 ``k /
(k + 2)`` and ``2 / (k + 2)``; the averaging step rounds both products and
then the sum.  The graph cache's keys (which tensors, which constants,
how many blocks) are checked here too; replays need a card
(``tests/test_torch_gpu.py``).
"""
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.api import RunConfig as JRunConfig
from repro.api import Solver as JSolver
from repro.configs.paper import SMALL
from repro.core import distributed as jdist
from repro.core import mpbcfw as jmp
from repro.core.oracles import chain as jchain
from repro.core.oracles import graph as jgraph
from repro.core.oracles import multiclass as jmulti
from repro.core.selection import CostModel as JCostModel
from repro.core.ssvm import weights_of as jweights_of
from repro.data import synthetic as jsyn
from repro_torch import convert
from repro_torch.core import distributed as tdist
from repro_torch.core import graphs
from repro_torch.core import mpbcfw as tmp
from repro_torch.core.averaging import average_step, weight_table
from repro_torch.core.oracles import chain as tchain
from repro_torch.core.oracles import graph as tgraph
from repro_torch.core.oracles import multiclass as tmulti
from repro_torch.kernels import ops

torch.set_num_threads(1)
TOL = dict(rtol=3e-5, atol=3e-5)

# SMALL scenario and engine of each case: the exact pass runs the spec's
# oracle (Viterbi, ICM, argmax); "ocr_gram" inserts with Gram rows.
CASES = {"ocr": ("ocr", "mpbcfw"), "ocr_gram": ("ocr", "mpbcfw-gram"),
         "usps": ("usps", "mpbcfw"), "horseseg": ("horseseg", "mpbcfw")}


def _problems(name):
    sc = SMALL[name]
    if sc.kind == "multiclass":
        x, y = jsyn.usps_like(n=sc.n, f=sc.f, num_classes=sc.num_classes)
        return (jmulti.make_problem(jnp.asarray(x), jnp.asarray(y),
                                    sc.num_classes),
                tmulti.make_problem(x, y, sc.num_classes, device="cpu"))
    if sc.kind == "graph":
        arrays = jsyn.horseseg_like(n=sc.n, grid=sc.grid, f=sc.f)
        return (jgraph.make_problem(*map(jnp.asarray, arrays),
                                    num_sweeps=sc.oracle_sweeps),
                tgraph.make_problem(*arrays, num_sweeps=sc.oracle_sweeps,
                                    device="cpu"))
    X, Y, M = jsyn.ocr_like(n=sc.n, f=sc.f, num_labels=sc.num_classes,
                            mean_len=sc.mean_len, max_len=sc.max_len, seed=0)
    return (jchain.make_problem(jnp.asarray(X), jnp.asarray(Y),
                                jnp.asarray(M), sc.num_classes),
            tchain.make_problem(X, Y, M, sc.num_classes, device="cpu"))


@pytest.fixture(scope="module")
def midrun():
    """Per case: both problems and a JAX MPState after two outer
    iterations of the reference Solver (cap 6, ttl 1: LRU overwrites and
    evictions happen)."""
    out = {}
    for case, (name, algo) in CASES.items():
        jp, tp = _problems(name)
        solver = JSolver(jp, JRunConfig(
            lam=1.0 / jp.n, algo=algo, cap=6, ttl=1, max_iters=2,
            approx_batch=2, max_approx_passes=2,
            cost_model=JCostModel(0.3, 1e-3)))
        solver.run()
        out[case] = (jp, tp, jax.device_get(solver.state))
    return out


def _weights(k):
    """k/(k+2) and 2/(k+2) in float32 scalar arithmetic."""
    kf, two = np.float32(k), np.float32(2.0)
    return float(kf / (kf + two)), float(two / (kf + two))


def _assert_state_matches(got, want):
    """Equal slots and host counters; planes, duals, averages and the
    Gram leaf within TOL."""
    out = convert.mp_state_to_numpy(got)
    for f, leaf in (("valid", want.cache.valid),
                    ("last_active", want.cache.last_active)):
        assert (out[f] == np.asarray(leaf)).all(), f
    assert (out["n_exact"], out["n_approx"], out["k_exact"]) == (
        int(want.inner.n_exact), int(want.inner.n_approx),
        int(want.avg.k_exact))
    leaves = [("phi", want.inner.phi), ("phi_i", want.inner.phi_i),
              ("planes", want.cache.planes),
              ("bar_exact", want.avg.bar_exact)]
    if want.cache.gram is not None:
        leaves.append(("gram", want.cache.gram))
    for f, leaf in leaves:
        got_leaf = (got.cache.gram.numpy() if f == "gram" else out[f])
        assert_allclose(got_leaf, np.asarray(leaf), **TOL, err_msg=f)


@pytest.mark.parametrize("case", sorted(CASES))
def test_exact_pass_matches_jax(midrun, case):
    jp, tp, host = midrun[case]
    lam = 1.0 / jp.n
    perm = np.random.RandomState(9).permutation(jp.n)
    jout = jmp.exact_pass(jp, jax.tree_util.tree_map(jnp.asarray, host),
                          jnp.asarray(perm), lam)
    state = convert.mp_state_from_numpy(host, "cpu")
    assert (state.cache.gram is not None) == (case == "ocr_gram")
    steps = graphs.StepGraphs()
    got = tmp.exact_pass(tp, state, perm, lam, graphs=steps)
    _assert_state_matches(got, jax.device_get(jout))
    assert steps.replays == 0                    # the CPU loops plainly


def test_exact_pass_steps_in_place_on_partial_permutations(midrun):
    """Two passes over halves of a permutation, sharing one StepGraphs
    (buffers sized by the first, reused by the second), equal one JAX
    pass over the whole permutation; the state tensors are the caller's,
    updated in place."""
    jp, tp, host = midrun["ocr"]
    lam = 1.0 / jp.n
    perm = np.random.RandomState(2).permutation(jp.n)
    jout = jmp.exact_pass(jp, jax.tree_util.tree_map(jnp.asarray, host),
                          jnp.asarray(perm), lam)
    state = convert.mp_state_from_numpy(host, "cpu")
    steps = graphs.StepGraphs()
    half = jp.n // 2
    mid = tmp.exact_pass(tp, state, perm[:half], lam, graphs=steps)
    ctl = steps.control("exact", tdist.state_tensors(mid) + tuple(
        tp.data.values()), (lam, tp.oracle), half, tp.d)
    got = tmp.exact_pass(tp, mid, perm[half:], lam, graphs=steps)
    assert steps.control("exact", tdist.state_tensors(got) + tuple(
        tp.data.values()), (lam, tp.oracle), half, tp.d) is ctl
    assert got.inner.phi is state.inner.phi
    assert got.avg.bar_exact is state.avg.bar_exact
    _assert_state_matches(got, jax.device_get(jout))


def _fold_inputs(jp, host, k, done_kind, seed):
    """Sampled blocks, their oracle planes and cached fallbacks at the
    state's w (from the reference), and an arrival mask."""
    rng = np.random.RandomState(seed)
    ids = rng.permutation(jp.n)[:k]
    jstate = jax.tree_util.tree_map(jnp.asarray, host)
    jw = jweights_of(jstate.inner.phi, 1.0 / jp.n)
    planes = jdist.parallel_oracles(jp, jw, jnp.asarray(ids))
    fbp, fbs, _ = jdist.fallback_planes(jstate.cache, jnp.asarray(ids), jw)
    done = {"arrived": np.ones(k, bool), "stragglers": np.zeros(k, bool),
            "alternating": np.arange(k) % 2 == 0,
            "mixed": rng.rand(k) > 0.4}[done_kind]
    return jstate, ids, planes, fbp, fbs, done


@pytest.mark.parametrize("case", ["ocr", "ocr_gram", "usps"])
@pytest.mark.parametrize("done_kind",
                         ["arrived", "stragglers", "alternating", "mixed"])
def test_fold_bodies_match_jax(midrun, case, done_kind):
    jp, _, host = midrun[case]
    lam = 1.0 / jp.n
    jstate, ids, planes, fbp, fbs, done = _fold_inputs(
        jp, host, (2 * jp.n) // 3, done_kind, seed=len(done_kind))
    want = jax.device_get(jdist.jit_fold_planes(
        jstate, jnp.asarray(ids), planes, fbp, fbs, jnp.asarray(done),
        lam=lam))
    state = convert.mp_state_from_numpy(host, "cpu")
    t = [torch.from_numpy(np.array(a)) for a in (planes, fbp, fbs)]
    got = tdist.fold_planes(state, ids, *t, done, lam,
                            graphs=graphs.StepGraphs())
    _assert_state_matches(got, want)


def test_fold_step_bodies_one_by_one(midrun):
    """The two bodies driven by hand through one control equal
    fold_planes: each reads its block, plane or fallback by the cursor
    and advances it by one."""
    jp, tp, host = midrun["ocr"]
    lam = 1.0 / jp.n
    _, ids, planes, fbp, fbs, done = _fold_inputs(jp, host, 9, "mixed", 3)
    t = [torch.from_numpy(np.array(a)) for a in (planes, fbp, fbs)]
    want = tdist.fold_planes(convert.mp_state_from_numpy(host, "cpu"), ids,
                             *t, done, lam, graphs=graphs.StepGraphs())
    mp = convert.mp_state_from_numpy(host, "cpu")
    ctl = graphs.new_control(len(ids), tp.d, "cpu", fold=True)
    graphs.load_control(ctl, ids, k0=mp.avg.k_exact, it=mp.outer_it,
                        planes=t[0], fb_planes=t[1], fb_slots=t[2])
    for b, ok in enumerate(done):
        assert int(ctl.cursor) == b
        tdist.fold_step(mp, ctl, lam, arrived=bool(ok))
    for a, b in ((mp.inner.phi, want.inner.phi),
                 (mp.cache.last_active, want.cache.last_active),
                 (mp.avg.bar_exact, want.avg.bar_exact)):
        assert torch.equal(a, b)


def test_weight_table_is_bit_equal_to_the_reference_up_to_a_million():
    """The device table's weights for k = 0 .. 10^6 against the
    reference's float32 arithmetic (XLA), and on a sample against numpy's
    float32 scalars."""
    m = 10 ** 6 + 1
    tab = weight_table(0, m)
    assert tab.dtype == np.float32 and tab.shape == (m, 2)

    @jax.jit
    def ref(k):
        kf = k.astype(jnp.float32)
        return kf / (kf + 2.0), 2.0 / (kf + 2.0)
    a, b = map(np.asarray, ref(jnp.arange(m, dtype=jnp.int32)))
    assert np.array_equal(tab[:, 0], a) and np.array_equal(tab[:, 1], b)
    for k in list(range(40)) + list(range(7, m, 9973)) + [m - 1]:
        assert tuple(tab[k]) == _weights(k)
    assert np.array_equal(weight_table(123_456, 500), tab[123_456:123_956])


@pytest.mark.parametrize("k", [0, 1, 7, 12345, 999_999])
def test_average_step_rounds_each_product_then_the_sum(k):
    """``bar <- fl(fl(a bar) + fl(b phi))`` bit for bit, in place.  XLA on
    the CPU contracts the reference's expression into ``fma(a, bar, fl(b
    phi))``, 1-2 ulps away; that comparison is at TOL."""
    from repro.core import averaging as javg
    from repro.core.types import AveragingState as JAvg
    r = np.random.RandomState(k % 97)
    bar, phi = (r.randn(4001).astype(np.float32) for _ in range(2))
    a, b = weight_table(k, 1)[0]
    tb = torch.from_numpy(bar.copy())
    ptr = tb.data_ptr()
    average_step(tb, torch.from_numpy(phi),
                 torch.from_numpy(weight_table(k, 1)[0]), torch.empty(4001))
    assert tb.data_ptr() == ptr
    assert np.array_equal(tb.numpy(), a * bar + b * phi)
    javg_state = JAvg(bar_exact=jnp.asarray(bar), bar_approx=jnp.asarray(bar),
                      k_exact=jnp.int32(k), k_approx=jnp.int32(k))
    want = jax.jit(lambda s, p: javg.update_average(s, p, exact=True))(
        javg_state, jnp.asarray(phi)).bar_exact
    assert_allclose(tb.numpy(), np.asarray(want), **TOL)


def _key(n=6, d=3):
    return [torch.zeros(n, d + 1), torch.zeros(d + 1)]


def test_step_graphs_keep_buffers_while_the_tensors_live():
    steps = graphs.StepGraphs()
    tensors = _key()
    ctl = steps.control("exact", tensors, (0.5,), 6, 3)
    assert ctl.ids.shape == (6,) and ctl.scratch.shape == (4,)
    assert steps.control("exact", tensors, (0.5,), 4, 3) is ctl
    assert steps.control("fold", tensors, (0.5,), 4, 3, fold=True) is not ctl


@pytest.mark.parametrize("change", ["tensor", "dead", "const", "longer"])
def test_step_graphs_recapture_when_the_key_changes(change):
    """A replaced or freed tensor, another constant or a longer pass
    gives new buffers (and, on CUDA, a new capture): a graph never runs on
    tensors it was not captured on."""
    steps = graphs.StepGraphs()
    tensors = _key()
    ctl = steps.control("exact", tensors, (0.5,), 6, 3)
    consts, m = (0.5,), 6
    if change == "tensor":
        tensors = [tensors[0], tensors[1].clone()]
    elif change == "dead":
        tensors = _key()
        gc.collect()
    elif change == "const":
        consts = (0.25,)
    else:
        m = 7
    assert steps.control("exact", tensors, consts, m, 3) is not ctl


def test_step_graphs_run_loops_on_the_cpu():
    steps = graphs.StepGraphs()
    ctl = steps.control("exact", _key(), (1.0,), 6, 3)
    graphs.load_control(ctl, np.array([5, 3, 1]), k0=10, it=4)
    seen = []

    def body():
        seen.append(int(ctl.block()))
        ctl.cursor.add_(1)
    steps.run("exact", "exact", body, 3)
    steps.run("exact", "exact", body, 0)
    assert seen == [5, 3, 1] and steps.replays == 0
    assert int(ctl.it) == 4
    assert tuple(ctl.weights[2].tolist()) == _weights(12)
    ctl.cursor.fill_(1)
    assert tuple(ctl.weight().tolist()) == _weights(11)


def test_launch_counts_can_be_set_and_added():
    """The graph runner's bookkeeping: take back the capture's counts,
    add the body's launches on each replay."""
    before = ops.launch_counts()
    try:
        ops.reset_launch_counts()
        ops.add_launches({"viterbi_decode": 2, "plane_scores": 1})
        ops.add_launches({"viterbi_decode": 2})
        counts = ops.launch_counts()
        assert counts["viterbi_decode"] == 4 and counts["plane_scores"] == 1
        assert sum(counts.values()) == 5
        ops.set_launch_counts({k: 7 for k in counts})
        assert set(ops.launch_counts().values()) == {7}
    finally:
        ops.set_launch_counts(before)

"""The multiclass and graph specs of repro_torch vs the JAX package, on the
CPU: their synthetic data, decoders, feature maps, losses and planes, and
3-iteration Solver traces on ``SMALL["usps"]`` and ``SMALL["horseseg"]``.

Planes compare at rtol = atol = 3e-5, labels must be equal; whole runs
need equal schedules and duals within rtol 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.api import RunConfig as JRunConfig
from repro.api import Solver as JSolver
from repro.configs.paper import SMALL
from repro.core import ssvm as jssvm
from repro.core.oracles import graph as jgraph
from repro.core.oracles import multiclass as jmulti
from repro.core.selection import CostModel as JCostModel
from repro.data import synthetic as jsyn
from repro_torch.api import CostModel, RunConfig, Solver
from repro_torch.core import ssvm as tssvm
from repro_torch.core.oracles import graph as tgraph
from repro_torch.core.oracles import multiclass as tmulti
from repro_torch.data import synthetic as tsyn

torch.set_num_threads(1)
TOL = dict(rtol=3e-5, atol=3e-5)


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


# -- data --------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(n=48, f=12, num_classes=5, seed=0),
                                dict(n=200, f=64, num_classes=10),
                                dict(n=31, f=256, num_classes=10, seed=4,
                                     noise=0.5)])
def test_usps_like_emits_identical_arrays(kw):
    for a, b in zip(tsyn.usps_like(**kw), jsyn.usps_like(**kw)):
        assert a.dtype == b.dtype and a.shape == b.shape and (a == b).all()


@pytest.mark.parametrize("kw", [dict(n=16, grid=(4, 4), f=8, seed=2),
                                dict(n=80, grid=(6, 6), f=48),
                                dict(n=5, grid=(3, 7), f=20, seed=9)])
def test_horseseg_like_emits_identical_arrays(kw):
    for a, b in zip(tsyn.horseseg_like(**kw), jsyn.horseseg_like(**kw)):
        assert a.dtype == b.dtype and a.shape == b.shape and (a == b).all()


# -- the specs ---------------------------------------------------------------

def _multiclass(n, f, C, seed=0):
    x, y = jsyn.usps_like(n=n, f=f, num_classes=C, seed=seed)
    return (jmulti.make_problem(jnp.asarray(x), jnp.asarray(y), C),
            tmulti.make_problem(x, y, C, device="cpu"))


def _graph(n, grid, f, sweeps, seed=0):
    arrays = jsyn.horseseg_like(n=n, grid=grid, f=f, seed=seed)
    return (jgraph.make_problem(*map(jnp.asarray, arrays),
                                num_sweeps=sweeps),
            tgraph.make_problem(*arrays, num_sweeps=sweeps, device="cpu"))


PROBLEMS = {
    "multiclass_conftest": lambda: _multiclass(48, 12, 5),
    "multiclass_small": lambda: _multiclass(200, 64, 10),
    "graph_conftest": lambda: _graph(16, (4, 4), 8, 8, seed=2),
    "graph_small": lambda: _graph(80, (6, 6), 48, 20),
}


@pytest.mark.parametrize("name", sorted(PROBLEMS))
@pytest.mark.parametrize("scale", [0.0, 0.5, 3.0])
def test_oracle_planes_and_labels_match_jax(name, scale):
    """Per-example and batched planes at a random w (w = 0: every
    non-true class ties, the first wins), with the decoded labels."""
    jp, tp = PROBLEMS[name]()
    assert (tp.n, tp.d) == (jp.n, jp.d) and tp.meta == jp.meta
    w = (scale * np.random.RandomState(11).randn(tp.d)).astype(np.float32)
    want = np.asarray(jssvm.batched_oracle(jp, jnp.asarray(w)))
    got = tssvm.batched_oracle(tp, T(w)).numpy()
    assert_allclose(got, want, **TOL)
    labels = tp.spec.decode(T(w), tp.data).numpy()
    jlabels = np.asarray(jax.vmap(
        lambda ex: jp.spec.decode(jnp.asarray(w), ex))(jp.data))
    assert (labels == jlabels).all()
    for i in range(0, tp.n, max(tp.n // 5, 1)):
        ex = {k: v[i:i + 1] for k, v in tp.data.items()}
        jex = jax.tree_util.tree_map(lambda a: a[i], jp.data)
        assert_allclose(tp.oracle(T(w), ex)[0].numpy(),
                        np.asarray(jp.oracle(jnp.asarray(w), jex)), **TOL)


def test_multiclass_decode_keeps_the_first_maximal_class():
    _, tp = PROBLEMS["multiclass_conftest"]()
    y = tp.data["y"].long()
    labels = tp.spec.decode(torch.zeros(tp.d), tp.data)
    # At w = 0 every class but the true one scores 1.
    assert (labels == torch.where(y == 0, 1, 0)).all()


@pytest.mark.parametrize("name", ["graph_conftest", "graph_small"])
def test_graph_spec_parts_match_jax(name):
    jp, tp = PROBLEMS[name]()
    r = np.random.RandomState(3)
    y = r.randint(0, 2, size=tuple(tp.data["y"].shape)).astype(np.int32)
    jy = jnp.asarray(y)
    for part in ("features", "loss", "offset"):
        got = getattr(tp.spec, part)(tp.data, T(y)).numpy()
        want = np.asarray(jax.vmap(
            lambda ex, yy: getattr(jp.spec, part)(ex, yy))(jp.data, jy))
        assert_allclose(got, want, **TOL, err_msg=part)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_icm_decode_matches_jax(seed):
    """Red-black ICM on random unaries (strong enough to disagree with
    their neighbours), partly masked graphs included."""
    r = np.random.RandomState(seed)
    B, (H, W) = 6, (5, 4)
    _, _, _, edges, emask, color = jsyn.horseseg_like(n=B, grid=(H, W), f=2)
    unary = (2.0 * r.randn(B, H * W, 2)).astype(np.float32)
    mask = r.rand(B, H * W) > 0.1
    emask = emask & (r.rand(*emask.shape) > 0.2)
    for sweeps in (0, 1, 5):
        got = tgraph.icm_decode(T(unary), T(edges), T(emask), T(color),
                                T(mask), sweeps).numpy()
        want = np.stack([np.asarray(jgraph.icm_decode(
            jnp.asarray(unary[b]), jnp.asarray(edges[b]),
            jnp.asarray(emask[b]), jnp.asarray(color[b]),
            jnp.asarray(mask[b]), sweeps)) for b in range(B)])
        assert got.dtype == np.int32 and (got == want).all()


def test_graph_explicit_plane_matches_the_assembled_one():
    """``_plane`` (the written-out phi^{iy}) equals what build_problem
    assembles from the spec where the clamp keeps the plane, and the clamp
    zeroes the rest; at weights after two iterations most examples decode
    to planes that do not beat the ground truth.  A score within 1e-6 of 0
    is the clamp's own near tie: the two forms round it apart (one such
    example here scores 3.7e-9 in one form and 0 in the other), so there
    either outcome is accepted."""
    _, tp = PROBLEMS["graph_small"]()
    w = Solver(tp, RunConfig(lam=1.0 / tp.n, max_iters=2, cap=8,
                             cost_model=CostModel())).run().w
    ex = tp.data
    y_pred = tp.spec.decode(T(w), ex)
    explicit = tgraph._plane(ex["x"], ex["y"], y_pred, ex["mask"],
                             ex["edges"], ex["edge_mask"], tp.n)
    planes = tp.oracle(T(w), ex)
    score = explicit[:, :-1] @ T(w) + explicit[:, -1]
    kept, dropped = score > 1e-6, score <= 0.0
    assert kept.any() and dropped.any()
    assert_allclose(planes[kept].numpy(), explicit[kept].numpy(), **TOL)
    assert not planes[dropped].any()
    for i in torch.nonzero(~kept & ~dropped).flatten().tolist():
        assert not planes[i].any() or torch.allclose(
            planes[i], explicit[i], rtol=3e-5, atol=3e-5)
    jp, _ = PROBLEMS["graph_small"]()
    jexplicit = jax.vmap(jgraph._plane, in_axes=(0, 0, 0, 0, 0, 0, None))(
        jp.data["x"], jp.data["y"], jnp.asarray(y_pred.numpy()),
        jp.data["mask"], jp.data["edges"], jp.data["edge_mask"], tp.n)
    assert_allclose(explicit.numpy(), np.asarray(jexplicit), **TOL)


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_primal_at_random_w_matches_jax(name):
    jp, tp = PROBLEMS[name]()
    w = (0.3 * np.random.RandomState(12).randn(tp.d)).astype(np.float32)
    lam = 1.0 / tp.n
    assert_allclose(float(tssvm.primal_value(tp, T(w), lam)),
                    float(jssvm.primal_value(jp, jnp.asarray(w), lam)),
                    rtol=1e-4)


def test_make_problem_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y = tsyn.usps_like(n=4, f=3, num_classes=3)
    arrays = tsyn.horseseg_like(n=2, grid=(2, 2), f=3)
    with pytest.raises(RuntimeError, match="no CUDA"):
        tmulti.make_problem(x, y, 3)
    with pytest.raises(RuntimeError, match="no CUDA"):
        tgraph.make_problem(*arrays)
    assert tmulti.make_problem(x, y, 3, device="cpu").data["y"].dtype \
        == torch.int32
    g = tgraph.make_problem(*arrays, device="cpu")
    assert g.data["mask"].dtype == torch.bool and g.spec.clamp
    assert dataclasses.asdict(g.spec) == {"num_sweeps": 20}


# -- whole runs on the paper's small scenarios -------------------------------

def _small(name):
    sc = SMALL[name]
    if name == "usps":
        return sc, _multiclass(sc.n, sc.f, sc.num_classes)
    return sc, _graph(sc.n, sc.grid, sc.f, sc.oracle_sweeps)


@pytest.mark.parametrize("name", ["usps", "horseseg"])
def test_small_scenario_three_iterations_match_jax(name):
    sc, (jp, tp) = _small(name)
    kw = dict(lam=1.0 / sc.n, cap=16, ttl=2, max_iters=3, approx_batch=8,
              max_approx_passes=8)
    jr = JSolver(jp, JRunConfig(cost_model=JCostModel(
        sc.oracle_cost, sc.plane_cost), **kw)).run()
    tr = Solver(tp, RunConfig(cost_model=CostModel(
        sc.oracle_cost, sc.plane_cost), **kw)).run()
    assert len(tr.trace) == len(jr.trace) == 3
    for a, b in zip(jr.trace, tr.trace):
        assert (b.n_exact, b.n_approx, b.approx_passes, b.planes_evicted,
                b.cache_hit_rate, b.ws_mean) == (
            a.n_exact, a.n_approx, a.approx_passes, a.planes_evicted,
            a.cache_hit_rate, a.ws_mean), a.iteration
        assert_allclose(b.dual, a.dual, rtol=1e-4)
        assert_allclose(b.primal, a.primal, rtol=1e-4)
        assert_allclose(b.time, a.time, rtol=1e-12)
    assert_allclose(tr.w, jr.w, rtol=1e-4, atol=1e-4)
    assert_allclose(tr.w_avg, jr.w_avg, rtol=1e-4, atol=1e-4)

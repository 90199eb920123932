"""The shard layer of repro_torch (``repro_torch.shard``,
``repro_torch.launch.mesh``) at world size 1, in process, on the CPU.

Mirrors ``tests/test_shard.py``: the mesh and its refusals, the layout's
spec trees and messages, the collective trace, the sharded multi-pass
program and tau-nice epoch bit for bit against the single-device ones,
one dispatch and one sync per outer iteration, one collective per pass.
Beside those: the averaging stride (``weight_table``, ``eager_pass``)
against a hand-rolled per-block loop and the reference's float32
weights; ``plane_scores_masked``, ``parallel_oracles(mesh=)`` and the
local schedule against JAX's; on ``SMALL`` ocr each shard engine's
3-iteration trace within rtol 1e-4 of JAX's same engine on a 1-device
mesh, its collectives and bytes equal (usps and horseseg in
``tests/test_torch_shard_jax.py``; the bit-for-bit twins in the port in
``tests/test_torch_shard_twins.py``).  A world-size-1 sharded checkpoint
resumes bit for bit, and single-device ``mpbcfw`` resumes its files.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import RunConfig as JRunConfig
from repro.api import Solver as JSolver
from repro.cache import CacheLayout as JCacheLayout
from repro.cache import partition_specs as jpartition_specs
from repro.configs.paper import SMALL
from repro.core import distributed as jdist
from repro.core.oracles import chain as jchain
from repro.core.oracles import graph as jgraph
from repro.core.oracles import multiclass as jmulti
from repro.core.selection import CostModel as JCostModel
from repro.core.selection import SyncLedger as JSyncLedger
from repro.data import synthetic as jsyn
from repro.kernels import ops as jops
from repro.launch.mesh import make_data_mesh as jmake_mesh
from repro.shard import engine as jshard_engine
from repro.shard import layout as jlayout
from repro_torch import cache as tcache
from repro_torch.api import CostModel, RunConfig, Solver
from repro_torch.cache import CacheLayout, PlaneCache
from repro_torch.checkpoint import CheckpointManager, restore_resharded
from repro_torch.core import distributed as tdist
from repro_torch.core import mpbcfw as tmp
from repro_torch.core.averaging import average_step, weight_table
from repro_torch.core.bcfw import block_update
from repro_torch.core.gram import multi_step_block_update
from repro_torch.core.oracles import chain as tchain
from repro_torch.core.oracles import graph as tgraph
from repro_torch.core.oracles import multiclass as tmulti
from repro_torch.core.selection import SyncLedger
from repro_torch.core.ssvm import dual_value, weights_of
from repro_torch.kernels import ops as tops
from repro_torch.launch import mesh as tmesh
from repro_torch.policy import sampling as tsampling
from repro_torch.shard import (ShardEngine, gather_mp_state, mp_state_specs,
                               place_mp_state, sharded_approx_pass,
                               validate_layout)
from repro_torch.shard.engine import local_schedules
from repro_torch.shard.telemetry import CollectiveTrace

torch.set_num_threads(1)
TOL = dict(rtol=3e-5, atol=3e-5)

# (port engine on the mesh, its single-device twin in the port)
TWINS = (("mpbcfw-shard", "mpbcfw"), ("mpbcfw-shard-avg", "mpbcfw-avg"),
         ("mpbcfw-shard-gram", "mpbcfw-gram"),
         ("mpbcfw-gram", "mpbcfw-gram"), ("mpbcfw-gap", "mpbcfw-gap"),
         ("mpbcfw-shard-async", "mpbcfw-async"))
# The engines held against JAX's on a 1-device mesh (tau for -shard-tau).
AGAINST_JAX = (("mpbcfw-shard", None), ("mpbcfw-shard-avg", None),
               ("mpbcfw-shard-tau", 8), ("mpbcfw-shard-gram", None),
               ("mpbcfw-gap", None), ("mpbcfw-shard-async", None))


@pytest.fixture(scope="module")
def mesh():
    return tmesh.make_data_mesh(device="cpu")


@pytest.fixture(scope="module")
def multiclass():
    """The conftest multiclass problem in both packages."""
    x, y = jsyn.usps_like(n=48, f=12, num_classes=5, seed=0)
    return (jmulti.make_problem(jnp.asarray(x), jnp.asarray(y), 5),
            tmulti.make_problem(x, y, 5, device="cpu"))


def small(name):
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


def run_cfg(cls, cm_cls, sc, algo, passes=(4, 6), **kw):
    """3 iterations of up to ``passes[1]`` passes in batches of
    ``passes[0]``, cap 16, at the scenario's costs."""
    return cls(lam=1.0 / sc.n, algo=algo, max_iters=3, cap=16,
               approx_batch=passes[0], max_approx_passes=passes[1],
               cost_model=cm_cls(sc.oracle_cost, sc.plane_cost), **kw)


# The pipelined engines' dual stalls from the second iteration on (the
# fold's planes are a pass old), so there the slope rule's stop turns on
# the last bits of the two packages' sums: the port's mpbcfw-async and
# JAX's part ways alike (tests/test_torch_async.py measures the margins).
# Against JAX the shard pipeline runs one pass per iteration, with no
# stopping decision to make, as the reference's multi-device tests use
# run_all.
ASYNC_PASSES = (1, 1)


def rows_equal(ra, rb):
    da, db = dataclasses.asdict(ra), dataclasses.asdict(rb)
    assert da.keys() == db.keys()
    for k in da:
        va, vb = da[k], db[k]
        if isinstance(va, float) and math.isnan(va):
            assert isinstance(vb, float) and math.isnan(vb), k
        else:
            assert va == vb, (k, va, vb)


def rows_close(tr, jr):
    """The same schedule and sync counts, objectives within rtol 1e-4."""
    assert len(tr) == len(jr)
    for a, b in zip(tr, jr):
        assert (a.n_exact, a.n_approx, a.approx_passes, a.host_syncs,
                a.dispatches, a.planes_evicted, a.gap_sampled) == (
            b.n_exact, b.n_approx, b.approx_passes, b.host_syncs,
            b.dispatches, b.planes_evicted, b.gap_sampled)
        for f in ("dual", "primal", "primal_avg", "ws_mean",
                  "cache_hit_rate", "oracle_overlap"):
            va, vb = getattr(a, f), getattr(b, f)
            assert abs(va - vb) <= 1e-4 * abs(vb) + 1e-7, (f, va, vb)
        if b.gap_total is not None:
            assert abs(a.gap_total - b.gap_total) <= (
                1e-4 * abs(b.gap_total) + 1e-7)


def _jax_noise(seed, n):
    """The reference's gumbel noise, as the port's function returns it."""
    return torch.from_numpy(np.array(jax.random.gumbel(
        jax.random.PRNGKey(seed), (n,))))


def against_jax(name, algo, tau, mesh, monkeypatch):
    """The port's engine on the world-size-1 mesh against JAX's on a
    1-device mesh: rows within tolerance, collectives and bytes equal."""
    monkeypatch.setattr(tsampling, "gumbel_noise", _jax_noise)
    sc, (jp, tp) = small(name)
    kw = {} if tau is None else dict(tau=tau)
    if algo == "mpbcfw-shard-async":
        kw["passes"] = ASYNC_PASSES
    mine = Solver(tp, run_cfg(RunConfig, CostModel, sc, algo, mesh=mesh,
                              **kw))
    ref = JSolver(jp, run_cfg(JRunConfig, JCostModel, sc, algo,
                              mesh=jmake_mesh(), **kw))
    rows_close(mine.run().trace, ref.run().trace)
    ml, rl = mine.engine.ledger, ref.engine.ledger
    assert (ml.collectives, ml.collective_bytes, ml.host_syncs,
            ml.dispatches) == (rl.collectives, rl.collective_bytes,
                               rl.host_syncs, rl.dispatches)
    assert mine.engine.eng.psums_per_approx_pass == 1 == (
        ref.engine.eng.psums_per_approx_pass)


# -- the mesh ----------------------------------------------------------------

def test_world_size_one_mesh(mesh):
    assert mesh.axis_names == ("data",) and mesh.shape == {"data": 1}
    assert (mesh.rank, mesh.size, mesh.device.type) == (0, 1, "cpu")
    assert mesh.backend == "gloo"
    tmesh.validate_mesh(mesh, ("data",))
    assert tmesh.ensure_data_mesh(mesh) is mesh
    n0, b0 = mesh.issued, mesh.issued_bytes
    t = torch.arange(6, dtype=torch.float32)
    assert mesh.all_reduce(t) is t and t.tolist() == list(range(6))
    g = mesh.all_gather(torch.ones(2, 3))
    assert g.shape == (1, 2, 3)
    assert (mesh.issued - n0, mesh.issued_bytes - b0) == (2, 24 + 24)
    other = tmesh.ensure_data_mesh(device="cpu")
    assert other.size == 1 and other is not mesh


def test_mesh_refusals(mesh):
    with pytest.raises(ValueError, match="requested 2 devices"):
        tmesh.make_data_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="missing required"):
        tmesh.validate_mesh(mesh, ("data", "model"))
    with pytest.raises(ValueError, match="DataMesh"):
        tmesh.ensure_data_mesh("data")
    with pytest.raises(RuntimeError, match="already belongs"):
        tmesh.init_ranks(0, 1, "unused")
    with pytest.raises(ValueError, match="got a tensor on"):
        mesh.all_reduce(torch.zeros(1, dtype=torch.float32,
                                    device="meta"))


# -- layout, specs and telemetry ----------------------------------------------

@pytest.mark.parametrize("gram,track_gap", [(False, False), (True, False),
                                            (False, True)])
def test_specs_equal_the_references(gram, track_gap):
    mine = tcache.partition_specs(CacheLayout(gram=gram, axis="data",
                                              track_gap=track_gap))
    ref = jpartition_specs(JCacheLayout(gram=gram, axis="data",
                                        track_gap=track_gap))
    for a, b in zip(mine, ref):
        assert (a is None) == (b is None)
        if a is not None:
            assert a == tuple(b)
    specs = mp_state_specs("data", gram=gram, track_gap=track_gap)
    jspecs = jlayout.mp_state_specs("data", gram=gram, track_gap=track_gap)
    assert specs.inner.phi_i == tuple(jspecs.inner.phi_i)
    assert specs.inner.phi == tuple(jspecs.inner.phi)
    assert specs.avg.bar_approx == tuple(jspecs.avg.bar_approx)
    with pytest.raises(ValueError, match="CacheLayout.axis is None"):
        tcache.partition_specs(CacheLayout())
    assert [f.name for f in dataclasses.fields(CacheLayout)] == [
        f.name for f in dataclasses.fields(JCacheLayout)
        if f.name != "fold_scatter"]


class _StubMesh:
    """A rank of an S-rank mesh, for the layout's arithmetic alone."""

    def __init__(self, rank, size, axis="data"):
        self.rank, self.size, self.device = rank, size, torch.device("cpu")
        self.axis_names, self.shape = (axis,), {axis: size}


def test_validate_layout_messages_are_the_references():
    class JStub:
        axis_names, shape = ("data",), {"data": 4}
    for n in (10, 7):
        with pytest.raises(ValueError) as mine:
            validate_layout(n, _StubMesh(0, 4))
        with pytest.raises(ValueError) as ref:
            jlayout.validate_layout(n, JStub())
        assert str(mine.value) == str(ref.value)
    with pytest.raises(ValueError, match="do not include 'blocks'"):
        validate_layout(8, _StubMesh(0, 4), "blocks")
    assert validate_layout(12, _StubMesh(1, 4)) == 4


@pytest.mark.parametrize("gram", [False, True])
def test_place_slices_each_ranks_rows(gram):
    g = torch.Generator().manual_seed(0)
    lay = CacheLayout(cap=3, gram=gram, track_gap=True)
    mp = tmp.MPState(
        inner=tmp.BCFWState(phi_i=torch.randn(8, 5, generator=g),
                            phi=torch.randn(5, generator=g), n_exact=3,
                            n_approx=4),
        cache=tcache.init(lay, 8, 4, "cpu"),
        avg=tmp.AveragingState(torch.randn(5, generator=g),
                               torch.randn(5, generator=g), 5, 6),
        outer_it=2)
    mp.cache.valid[5, 1] = True
    mp.cache.gap.copy_(torch.arange(8.0))
    parts = [place_mp_state(mp, _StubMesh(r, 4)) for r in range(4)]
    for r, p in enumerate(parts):
        assert torch.equal(p.inner.phi_i, mp.inner.phi_i[2 * r:2 * r + 2])
        assert torch.equal(p.cache.gap, mp.cache.gap[2 * r:2 * r + 2])
        assert p.inner.phi is not mp.inner.phi
        assert torch.equal(p.inner.phi, mp.inner.phi)
        assert (p.inner.n_exact, p.avg.k_approx, p.outer_it) == (3, 6, 2)
        assert (p.cache.gram is None) == (not gram)
    assert bool(parts[2].cache.valid[1, 1])
    with pytest.raises(ValueError, match="not divisible by 3 shards"):
        place_mp_state(mp, _StubMesh(0, 3))


def test_gather_and_place_are_the_identity_on_one_rank(mesh):
    sc, (_, tp) = small("usps")
    eng = ShardEngine(tp, mesh, lam=1.0 / sc.n)
    mp = eng.init_state(8)
    assert gather_mp_state(mp, mesh) is mp
    placed = eng.place(mp)
    for a, b in zip(torch.utils._pytree.tree_leaves(placed),
                    torch.utils._pytree.tree_leaves(mp)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()


def test_collective_trace_counts_sites_per_section(mesh):
    trace = CollectiveTrace()
    with pytest.raises(RuntimeError, match="outside a begin"):
        trace.all_reduce(torch.zeros(2), mesh, tag="pass")
    trace.begin("multi_approx")
    with trace.section("setup"):
        trace.all_reduce(torch.zeros(4, dtype=torch.int32), mesh,
                         tag="setup")
    for _ in range(3):
        with trace.section("pass"):
            trace.all_reduce(torch.zeros(2, 7), mesh, tag="pass")
    with pytest.raises(RuntimeError, match="outside its section"):
        with trace.section("pass"):
            trace.all_reduce(torch.zeros(1), mesh, tag="setup")
    with pytest.raises(RuntimeError, match="issued 2 collectives"):
        with trace.section("pass"):
            trace.all_reduce(torch.zeros(2, 7), mesh, tag="pass")
            trace.all_reduce(torch.zeros(2, 7), mesh, tag="pass")
    trace.commit()
    assert (trace.count("multi_approx", "setup"),
            trace.count("multi_approx", "pass")) == (1, 1)
    assert (trace.bytes_of("multi_approx", "setup"),
            trace.bytes_of("multi_approx", "pass")) == (16, 56)
    assert trace.count("other", "pass") == 0


def test_sync_ledger_fields_are_the_references():
    assert [f.name for f in dataclasses.fields(SyncLedger)] == [
        f.name for f in dataclasses.fields(JSyncLedger)]
    led = SyncLedger()
    led.collected(3, nbytes=40)
    led.collected()
    assert (led.collectives, led.collective_bytes) == (4, 40)
    assert led.counts() == (0, 4, 0)


@pytest.mark.parametrize("n,size", [(48, 1), (48, 4), (120, 8)])
def test_local_schedule_matches_the_references(n, size):
    rng = np.random.RandomState(n + size)
    perms = np.stack([rng.permutation(n) for _ in range(3)])
    n_local = n // size
    for r in range(size):
        mine = local_schedules(perms, r * n_local, n_local)
        for k in range(3):
            ref = jshard_engine._local_schedule(jnp.asarray(perms[k]),
                                                r * n_local, n_local)
            np.testing.assert_array_equal(mine[k], np.asarray(ref))
    assert local_schedules(np.zeros((0, n), np.int64), 0, n_local).shape \
        == (0, n_local)


# -- the stride, masked scores, parallel oracles -----------------------------

@pytest.mark.parametrize("stride", [1, 2, 4, 8])
@pytest.mark.parametrize("k0", [0, 5, 999_983])
def test_weight_table_stride_is_the_references_float32(k0, stride):
    m = 300
    mine = weight_table(k0, m, stride)
    k = jnp.asarray(k0 + stride * np.arange(m), jnp.int32).astype(
        jnp.float32)
    ref = np.stack([np.asarray(k / (k + 2.0)), np.asarray(2.0 / (k + 2.0))],
                   axis=1)
    assert mine.dtype == np.float32
    np.testing.assert_array_equal(mine.view(np.int32), ref.view(np.int32))


def _pass_state(gram, seed=0, n=12, cap=6, d=9):
    g = torch.Generator().manual_seed(seed)
    cache = tcache.init(CacheLayout(cap=cap, gram=gram), n, d, "cpu")
    for i in range(n):
        for s in range(int(torch.randint(0, cap + 1, (1,), generator=g))):
            tcache.insert(cache, i, torch.randn(d + 1, generator=g), 1)
    phi_i = torch.randn(n, d + 1, generator=g) * 0.1
    bar = torch.randn(d + 1, generator=g)
    return phi_i.sum(0), phi_i, bar, cache


@pytest.mark.parametrize("gram", [False, True])
@pytest.mark.parametrize("stride", [2, 4])
def test_eager_pass_stride_equals_a_hand_rolled_loop(stride, gram):
    """eager_pass at k_stride S: per block the plain (or Sec-3.5) step,
    then an averaging step with k = k0 + S t, bit for bit."""
    lam, k0, steps = 0.05, 17, (4 if gram else None)
    phi, phi_i, bar, cache = _pass_state(gram)
    perm = torch.tensor([3, 0, 7, 11, 5, 1], dtype=torch.int64)
    got = [t.clone() for t in (phi, phi_i, bar, cache.last_active)]
    tmp.eager_pass(got[0], got[1], got[2], cache.planes, cache.valid, got[3],
                   perm, lam=lam, k0=k0, outer_it=3, gram=cache.gram,
                   steps=steps, k_stride=stride)
    phi_w, phi_i_w, bar_w, last_w = (t.clone() for t in (
        phi, phi_i, bar, cache.last_active))
    view = tcache.PlaneCache(cache.planes, cache.valid, last_w, cache.gram)
    st = tmp.BCFWState(phi_i=phi_i_w, phi=phi_w, n_exact=0, n_approx=0)
    scratch = torch.empty_like(phi_w)
    for t, i in enumerate(perm.tolist()):
        if gram:
            new_i, new_phi, won = multi_step_block_update(
                cache.planes[i], cache.valid[i], cache.gram[i], phi_w,
                phi_i_w[i], lam, steps)
            phi_w.copy_(new_phi)
            phi_i_w[i].copy_(new_i)
            tcache.mark_active_where(view, i, won, 3)
        else:
            plane, slot, _ = tcache.approx_oracle(view, i,
                                                  weights_of(phi_w, lam))
            block_update(st, i, plane, lam)
            tcache.mark_active(view, i, slot, 3)
        k = np.float32(k0 + stride * t)
        ab = torch.tensor([k / (k + np.float32(2)), np.float32(2) / (
            k + np.float32(2))])
        average_step(bar_w, phi_w, ab, scratch)
    for a, b in zip(got, (phi_w, phi_i_w, bar_w, last_w)):
        assert torch.equal(a, b)


def test_plane_scores_masked_matches_the_references():
    rng = np.random.RandomState(3)
    planes = rng.randn(40, 17).astype(np.float32)
    w = rng.randn(17).astype(np.float32)
    off = rng.randn(40).astype(np.float32)
    valid = rng.rand(40) > 0.4
    mine = tops.plane_scores_masked(torch.from_numpy(planes),
                                    torch.from_numpy(w),
                                    torch.from_numpy(off),
                                    torch.from_numpy(valid))
    ref = np.asarray(jops.plane_scores_masked(
        jnp.asarray(planes), jnp.asarray(w), jnp.asarray(off),
        jnp.asarray(valid)))
    assert (mine.numpy()[~valid] == ref[~valid]).all()
    np.testing.assert_allclose(mine.numpy(), ref, **TOL)
    assert (mine[~torch.from_numpy(valid)] == tops.INVALID_SCORE).all()


def test_parallel_oracles_over_the_mesh_match_the_references(mesh,
                                                             multiclass):
    jp, tp = multiclass
    w = np.random.RandomState(1).randn(tp.d).astype(np.float32) * 0.1
    ids = np.random.RandomState(2).permutation(48)[:16]
    mine = tdist.parallel_oracles(tp, torch.from_numpy(w), ids, mesh)
    plain = tdist.parallel_oracles(tp, torch.from_numpy(w), ids)
    ref = jdist.parallel_oracles(jp, jnp.asarray(w), jnp.asarray(ids),
                                 jmake_mesh())
    assert torch.equal(mine, plain) and mine.shape == (16, tp.d + 1)
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), **TOL)
    assert list(tdist.local_block_ids(ids, _StubMesh(2, 4))) == list(
        ids[8:12])
    with pytest.raises(ValueError, match="do not split over 3 ranks"):
        tdist.local_block_ids(ids, _StubMesh(0, 3))


# -- the engine, bit for bit against the single-device programs ---------------

def _warm(prob, lam, cap=8, seed=0):
    rng = np.random.RandomState(seed)
    mp = tmp.init_mp_state(prob, cap)
    mp = tmp.begin_iteration(mp, ttl=10)
    mp = tmp.exact_pass(prob, mp, rng.permutation(prob.n), lam,
                        graphs=tmp.StepGraphs())
    return mp, rng


def _clone(mp):
    return tmp.MPState(*(
        type(x)(*(t.clone() if isinstance(t, torch.Tensor) else t
                  for t in x)) if isinstance(x, tuple) else x for x in mp))


def _assert_states_equal(a, b):
    for x, y in zip(torch.utils._pytree.tree_leaves(a),
                    torch.utils._pytree.tree_leaves(b)):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert x == y


def test_sharded_multi_approx_bitwise_matches_single_device(mesh,
                                                            multiclass):
    _, prob = multiclass
    lam = 1.0 / prob.n
    eng = ShardEngine(prob, mesh, lam=lam)
    mp, rng = _warm(prob, lam)
    perms = np.stack([rng.permutation(prob.n) for _ in range(4)])
    f0 = float(dual_value(mp.inner.phi, lam))
    seq = _clone(mp)
    shd = eng.place(mp)
    c1 = tmp.make_slope_clock(0.0, f0, float(prob.n), 1e-3, "cpu")
    seq, c_seq, st_seq = tmp.multi_approx_pass(seq, perms, c1, lam=lam,
                                               run_all=True)
    shd, c_shd, st_shd = eng.multi_approx_pass(shd, perms, c1, run_all=True)
    _assert_states_equal(seq, shd)
    assert torch.equal(st_seq.duals, st_shd.duals)
    assert torch.equal(st_seq.planes, st_shd.planes)
    assert float(c_seq.t) == float(c_shd.t)
    st = eng.read_stats(st_shd)
    assert eng.psums_per_approx_pass == 1 and eng.setup_psums == 1
    assert eng.ledger.collectives == 1 + int(st.passes_run) == 5
    assert eng.ledger.collective_bytes == 16 + 4 * 2 * (prob.d + 1) * 4
    assert st.blocks == prob.n


def test_sharded_slope_decisions_match_single_device(mesh, multiclass):
    _, prob = multiclass
    lam = 1.0 / prob.n
    eng = ShardEngine(prob, mesh, lam=lam)
    mp, rng = _warm(prob, lam)
    perms = np.stack([rng.permutation(prob.n) for _ in range(32)])
    f0 = float(dual_value(mp.inner.phi, lam))
    clock = tmp.make_slope_clock(0.0, f0, float(prob.n), 1e-3, "cpu")
    _, _, st_seq = tmp.multi_approx_pass(_clone(mp), perms, clock, lam=lam)
    _, _, st_shd = eng.multi_approx_pass(eng.place(mp), perms, clock)
    assert int(st_seq.passes_run) == int(st_shd.passes_run)
    assert 1 <= int(st_shd.passes_run) < 32
    assert bool(st_seq.more) == bool(st_shd.more)
    assert torch.equal(st_seq.ran, st_shd.ran)
    assert torch.equal(st_seq.duals, st_shd.duals)


def test_sharded_tau_nice_bitwise_matches_host_reference(mesh, multiclass):
    """The engine's epoch == the host chunk loop, straggler epochs
    included: duals, caches and counters bit for bit."""
    _, prob = multiclass
    lam = 1.0 / prob.n
    eng = ShardEngine(prob, mesh, lam=lam)
    rng = np.random.RandomState(0)
    mp_h = tmp.init_mp_state(prob, 8)
    mp_s = eng.place(tmp.init_mp_state(prob, 8))
    d0, s0 = eng.ledger.dispatches, eng.ledger.host_syncs
    for ep in range(3):
        mp_h = tmp.begin_iteration(mp_h, ttl=10)
        mp_s = eng.begin_iteration(mp_s, ttl=10)
        perm = rng.permutation(prob.n)
        done = rng.rand(prob.n // 8, 8) > 0.3 if ep == 2 else None
        mp_h = tdist.host_tau_nice_pass(prob, mp_h, perm, lam, tau=8,
                                        done=done)
        mp_s = eng.tau_nice_pass(mp_s, perm, tau=8, done=done)
        assert float(dual_value(mp_h.inner.phi, lam)) == float(
            dual_value(mp_s.inner.phi, lam))
    _assert_states_equal(mp_h, mp_s)
    assert eng.ledger.dispatches == d0 + 6 and eng.ledger.host_syncs == s0
    assert eng.gathers == 0     # one rank: every block is local
    with pytest.raises(ValueError, match="not divisible by tau=7"):
        eng.tau_nice_pass(mp_s, rng.permutation(prob.n), tau=7)


def test_outer_iteration_one_dispatch_one_sync(mesh, multiclass):
    """One fused dispatch and one host sync per outer iteration; the
    sequential (tau = 1) path equals the single-device outer iteration."""
    _, prob = multiclass
    lam = 1.0 / prob.n
    eng = ShardEngine(prob, mesh, lam=lam)
    rng = np.random.RandomState(1)
    mp_h = tmp.init_mp_state(prob, 8)
    mp_s = eng.init_state(8)
    graphs = tmp.StepGraphs()
    f = 0.0
    for it in range(3):
        perm = rng.permutation(prob.n)
        perms = np.stack([rng.permutation(prob.n) for _ in range(8)])
        clock = tmp.make_slope_clock(0.0, f, float(prob.n), 1e-3, "cpu")
        mp_h, _, st_h = tmp.outer_iteration(prob, mp_h, perm, perms, clock,
                                            lam=lam, ttl=10, graphs=graphs)
        d0 = eng.ledger.dispatches
        mp_s, _, st_s = eng.outer_iteration(mp_s, perm, perms, clock,
                                            tau=1, ttl=10)
        assert eng.ledger.dispatches == d0 + 1
        st_s = eng.read_stats(st_s)
        assert eng.ledger.host_syncs == it + 1
        assert int(st_h.passes_run) == int(st_s.passes_run)
        for k in ("ttl_evicted", "lru_evicted", "occupancy",
                  "nonempty_blocks"):
            assert int(getattr(st_h.metrics, k)) == int(
                getattr(st_s.metrics, k))
        mp_h = tmp.count_passes(mp_h, int(st_h.passes_run), prob.n)
        mp_s = tmp.count_passes(mp_s, int(st_s.passes_run), prob.n)
        f = float(dual_value(mp_h.inner.phi, lam))
        assert f == float(dual_value(mp_s.inner.phi, lam))
    with pytest.raises(ValueError, match="sampling policies need"):
        from repro_torch.policy import GAP_POLICIES, make_bundle
        bundle = make_bundle(GAP_POLICIES, RunConfig(lam=lam), prob.n)
        ShardEngine(prob, mesh, lam=lam, policies=bundle).outer_iteration(
            eng.init_state(8), perm, perms, clock, tau=8, ttl=10, key=1)


def test_module_level_api_and_refusals(mesh, multiclass):
    _, prob = multiclass
    lam = 1.0 / prob.n
    mp, rng = _warm(prob, lam)
    perm = rng.permutation(prob.n)
    seq = tmp.approx_pass(None, _clone(mp), perm, lam)
    shd = sharded_approx_pass(prob, _clone(mp), perm, lam=lam, mesh=mesh)
    _assert_states_equal(seq, shd)
    with pytest.raises(ValueError, match="gap-tracking policies"):
        from repro_torch.policy import GAP_POLICIES, make_bundle
        ShardEngine(prob, mesh, lam=lam, use_gram=True, policies=make_bundle(
            GAP_POLICIES, RunConfig(lam=lam), prob.n))
    sc, (_, other) = small("usps")
    with pytest.raises(ValueError, match="not divisible by 7 shards"):
        ShardEngine(other, _StubMesh(0, 7), lam=lam)


# -- whole runs against JAX ---------------------------------------------------

@pytest.mark.parametrize("algo,tau", AGAINST_JAX)
def test_world_size_one_matches_jax_on_ocr(algo, tau, mesh, monkeypatch):
    against_jax("ocr", algo, tau, mesh, monkeypatch)


def test_shard_async_collective_bytes_survive_split(mesh, multiclass):
    """The oracle program issues no collective; the ledger's totals are
    setup + passes * per_pass per iteration, as in the reference, with
    JAX's numbers."""
    jp, tp = multiclass
    kw = dict(lam=1 / 48, algo="mpbcfw-shard-async", max_iters=4, cap=8,
              max_approx_passes=12, approx_batch=12)
    solver = Solver(tp, RunConfig(mesh=mesh, cost_model=CostModel(), **kw))
    res = solver.run()
    eng = solver.engine.eng
    assert set(eng.collectives.sites) == {"multi_approx"}
    per_pass = eng.collectives.count("multi_approx", "pass")
    setup = eng.collectives.count("multi_approx", "setup")
    assert per_pass == 1 and setup == 1
    b_pass = eng.collectives.bytes_of("multi_approx", "pass")
    b_setup = eng.collectives.bytes_of("multi_approx", "setup")
    iters = len(res.trace)
    passes = sum(r.approx_passes for r in res.trace)
    led = solver.engine.ledger
    assert led.collectives == iters * setup + passes * per_pass
    assert led.collective_bytes == iters * b_setup + passes * b_pass
    ref = JSolver(jp, JRunConfig(mesh=jmake_mesh(), cost_model=JCostModel(),
                                 **kw))
    ref.run()
    jeng = ref.engine.eng
    assert (b_pass, b_setup) == (jeng.collectives.bytes_of(
        "multi_approx", "pass"), jeng.collectives.bytes_of(
        "multi_approx", "setup"))
    assert (led.collectives, led.collective_bytes) == (
        ref.engine.ledger.collectives, ref.engine.ledger.collective_bytes)
    for row in res.trace:
        assert row.dispatches == 2 and row.host_syncs == 1


def test_sharded_checkpoint_resumes_bit_for_bit(mesh, tmp_path):
    """A world-size-1 sharded checkpoint, restored through
    restore_resharded and by the Solver, resumes bit for bit; its files
    resume single-device mpbcfw too, which continues as mpbcfw does."""
    sc, (_, tp) = small("ocr")
    full = Solver(tp, run_cfg(RunConfig, CostModel, sc, "mpbcfw-shard",
                              mesh=mesh)).run()
    part = Solver(tp, dataclasses.replace(
        run_cfg(RunConfig, CostModel, sc, "mpbcfw-shard", mesh=mesh),
        max_iters=1))
    part.run()
    mgr = CheckpointManager(str(tmp_path / "c"))
    part.save(mgr)
    tree, manifest = restore_resharded(mgr, part.state, mesh)
    assert manifest["extra"]["algo"] == "mpbcfw-shard"
    _assert_states_equal(tree, part.state)
    resumed = Solver.restore(tp, run_cfg(RunConfig, CostModel, sc,
                                         "mpbcfw-shard", mesh=mesh), mgr)
    for ra, rb in zip(resumed.run().trace, full.trace[1:]):
        rows_equal(ra, rb)
    twin_full = Solver(tp, run_cfg(RunConfig, CostModel, sc,
                                   "mpbcfw")).run()
    mgr_b = CheckpointManager(str(tmp_path / "b"))
    manifest["extra"]["algo"] = "mpbcfw"
    mgr_b.save(1, tmp.MPState(*tree), extra=manifest["extra"],
               metrics=manifest["metrics"])
    twin = Solver.restore(tp, run_cfg(RunConfig, CostModel, sc, "mpbcfw"),
                          mgr_b)
    for ra, rb in zip(twin.run().trace, twin_full.trace[1:]):
        rows_equal(ra, rb)


def test_plane_cache_block_slice_copies():
    c = tcache.init(CacheLayout(cap=2, gram=True), 4, 3, "cpu")
    s = tcache.block_slice(c, 1, 3)
    assert isinstance(s, PlaneCache) and s.planes.shape == (2, 2, 4)
    assert s.gap is None and s.gram.shape == (2, 2, 2)
    s.valid[0, 0] = True
    assert not c.valid[1, 0]

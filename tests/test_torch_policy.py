"""The policy layer of repro_torch (``repro_torch.policy``) and the engine
``mpbcfw-gap`` against the JAX package, on the CPU.

Mirrors ``tests/test_policy.py``: the registry and bundle assembly, the
typed refusals at Solver construction, the default bundle reproducing the
engines without one bit for bit, the gap columns of the trace, seed
determinism and bitwise resume.  Beside those, against the reference on
the same numpy inputs: ``update_gap`` and ``evict_gap_stale``; the
gap-topk schedule on the same gap vector and the same noise (the port's
noise function patched to ``jax.random.gumbel``); the gap written by an
exact and by an approximate pass from a carried JAX state; 4-iteration
``mpbcfw-gap`` traces on ``SMALL`` usps, ocr and horseseg, schedules
included; ``mpbcfw-async`` under a gap-aware eviction; and ``mpbcfw-gap``
states and checkpoints crossing between the packages.

Tolerances: duals, primals and ``gap_total`` within rtol 1e-4 over whole
runs; a pass's per-block gap, a difference of two nearly equal scores,
within ``3e-5 * (|s_a| + |s_b|) + 1e-9`` of the scores' scale.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro import cache as jcache
from repro.api import RunConfig as JRunConfig
from repro.api import Solver as JSolver
from repro.api import UnsupportedConfigError as JUnsupported
from repro.api.solver import _draw_perms as jdraw_perms
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs.paper import SMALL
from repro.core import mpbcfw as jmp
from repro.core.oracles import chain as jchain
from repro.core.oracles import graph as jgraph
from repro.core.oracles import multiclass as jmulti
from repro.core.selection import CostModel as JCostModel
from repro.data import synthetic as jsyn
from repro.policy import make_bundle as jmake_bundle
from repro.policy import policy_names as jpolicy_names
from repro_torch import cache as tcache
from repro_torch import convert
from repro_torch.api import (CostModel, RunConfig, Solver,
                             UnsupportedConfigError)
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import mpbcfw as tmp
from repro_torch.core.graphs import StepGraphs
from repro_torch.core.oracles import chain as tchain
from repro_torch.core.oracles import graph as tgraph
from repro_torch.core.oracles import multiclass as tmulti
from repro_torch.core.ssvm import weights_of
from repro_torch.policy import (DEFAULT_POLICIES, GAP_POLICIES, GapSampling,
                                GapTTL, PolicyBundle, SlopeOracle,
                                TTLEviction, UniformSampling, make_bundle,
                                policy_kind, policy_names)
from repro_torch.policy import sampling as tsampling

torch.set_num_threads(1)
MULTIPASS = ("mpbcfw", "mpbcfw-avg", "mpbcfw-gram", "mpbcfw-async")


def _cm():
    # A fresh CostModel per run: its virtual clock is mutable state.
    return CostModel(oracle_cost=0.02, plane_cost=1e-4)


def _jcm():
    return JCostModel(oracle_cost=0.02, plane_cost=1e-4)


def _rows_equal(ra, rb):
    da, db = dataclasses.asdict(ra), dataclasses.asdict(rb)
    assert da.keys() == db.keys()
    for k in da:
        va, vb = da[k], db[k]
        if isinstance(va, float) and math.isnan(va):
            assert isinstance(vb, float) and math.isnan(vb), k
        else:
            assert va == vb, (k, va, vb)


def _jax_noise(seed, n):
    """The reference's noise for seed ``seed``, as the port's function
    returns it (the test substitution of ``gumbel_noise``)."""
    return torch.from_numpy(np.array(jax.random.gumbel(
        jax.random.PRNGKey(seed), (n,))))


@pytest.fixture
def jax_noise(monkeypatch):
    monkeypatch.setattr(tsampling, "gumbel_noise", _jax_noise)


@pytest.fixture(scope="module")
def multiclass():
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


# -- registry and bundle assembly --------------------------------------------

def test_registry_kinds_and_names():
    assert policy_kind("uniform") == "sampling"
    assert policy_kind("gap-topk") == "sampling"
    assert policy_kind("ttl-lru") == "eviction"
    assert policy_kind("gap-ttl") == "eviction"
    assert policy_kind("slope") == "oracle"
    assert "uniform" in policy_names("sampling")
    assert "slope" not in policy_names("sampling")
    for kind in (None, "sampling", "eviction", "oracle"):
        assert policy_names(kind) == jpolicy_names(kind)


@pytest.mark.parametrize("names", [DEFAULT_POLICIES, GAP_POLICIES])
@pytest.mark.parametrize("n", [1, 7, 48, 6877])
def test_bundles_assemble_as_the_references(names, n):
    """The same policies with the same parameters as JAX's bundle (k =
    max(1, round(gap_frac n)), Python's round: 6877 -> 3438)."""
    cfg = dict(lam=0.1, ttl=5, gap_frac=0.5, gap_temperature=3.0,
               gap_floor=0.2)
    b = make_bundle(names, RunConfig(**cfg), n)
    jb = jmake_bundle(names, JRunConfig(**cfg), n)
    assert isinstance(b, PolicyBundle) and b.names == names == jb.names
    assert (b.needs_gap, b.needs_key) == (jb.needs_gap, jb.needs_key)
    for mine, theirs in zip((b.sampling, b.eviction, b.oracle),
                            (jb.sampling, jb.eviction, jb.oracle)):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert hash(b) == hash(make_bundle(names, RunConfig(**cfg), n))
    if names == GAP_POLICIES:
        assert isinstance(b.sampling, GapSampling)
        assert b.sampling.k == max(1, round(0.5 * n))
        assert isinstance(b.eviction, GapTTL) and b.eviction.ttl_cold == 2
    else:
        assert isinstance(b.sampling, UniformSampling)
        assert isinstance(b.eviction, TTLEviction)
    assert isinstance(b.oracle, SlopeOracle)
    assert make_bundle(GAP_POLICIES, RunConfig(lam=0.1, ttl=1),
                       n).eviction.ttl_cold == 1


def test_unknown_policy_name_raises():
    with pytest.raises(UnsupportedConfigError, match="unknown policy"):
        policy_kind("nope")
    with pytest.raises(UnsupportedConfigError, match="unknown policy"):
        make_bundle(("nope", "ttl-lru", "slope"), RunConfig(lam=0.1), 8)


def test_bundle_duplicate_kind_raises():
    with pytest.raises(UnsupportedConfigError, match="two sampling"):
        make_bundle(("uniform", "gap-topk", "slope"), RunConfig(lam=0.1), 8)


def test_bundle_missing_kind_raises():
    with pytest.raises(UnsupportedConfigError, match="missing a"):
        make_bundle(("uniform", "ttl-lru"), RunConfig(lam=0.1), 8)


def test_register_policy_guards():
    from repro_torch.policy import register_policy
    with pytest.raises(ValueError, match="unknown policy kind"):
        register_policy("x", "schedule", lambda cfg, n: None)
    with pytest.raises(ValueError, match="already registered"):
        register_policy("slope", "oracle", lambda cfg, n: SlopeOracle())


# -- typed refusals at Solver construction -----------------------------------

def _solver(problem, **kw):
    kw.setdefault("max_iters", 2)
    return Solver(problem, RunConfig(lam=1.0 / problem.n, cap=8,
                                     cost_model=_cm(), **kw))


def test_unknown_policy_rejected_at_solver_construction(multiclass):
    with pytest.raises(UnsupportedConfigError, match="unknown policy"):
        _solver(multiclass[1], algo="mpbcfw",
                policies=("nope", "ttl-lru", "slope"))


@pytest.mark.parametrize("kw,match", [
    (dict(gap_frac=0.0), "gap_frac"), (dict(gap_frac=-0.5), "gap_frac"),
    (dict(gap_frac=1.5), "gap_frac"),
    (dict(gap_temperature=0.0), "gap_temperature"),
    (dict(gap_floor=-1.0), "gap_floor")])
def test_bad_gap_parameters_rejected_at_solver_construction(multiclass, kw,
                                                            match):
    with pytest.raises(UnsupportedConfigError, match=match):
        _solver(multiclass[1], algo="mpbcfw-gap", **kw)
    with pytest.raises(JUnsupported, match=match):
        JSolver(multiclass[0], JRunConfig(lam=0.1, algo="mpbcfw-gap",
                                          cost_model=_jcm(), **kw))


@pytest.mark.parametrize("algo", ["mpbcfw", "mpbcfw-gap"])
@pytest.mark.parametrize("ttl", [0, -3])
def test_nonpositive_ttl_rejected(multiclass, algo, ttl):
    with pytest.raises(UnsupportedConfigError, match="ttl"):
        _solver(multiclass[1], algo=algo, ttl=ttl)


@pytest.mark.parametrize("algo", ["mpbcfw", "mpbcfw-avg", "mpbcfw-async"])
def test_keyed_bundle_rejected_on_unkeyed_algo(multiclass, algo):
    """Only ``mpbcfw-gap`` draws the per-iteration seed a keyed sampler
    needs: asking another engine for it names the right one."""
    with pytest.raises(UnsupportedConfigError, match="mpbcfw-gap"):
        _solver(multiclass[1], algo=algo, policies=GAP_POLICIES)


def test_gap_tracking_refused_with_the_gram_scheme(multiclass):
    policies = ("uniform", "gap-ttl", "slope")
    with pytest.raises(UnsupportedConfigError, match="gram scheme"):
        _solver(multiclass[1], algo="mpbcfw-gram", policies=policies)
    with pytest.raises(JUnsupported, match="gram scheme"):
        JSolver(multiclass[0], JRunConfig(lam=0.1, algo="mpbcfw-gram",
                                          policies=policies,
                                          cost_model=_jcm()))


def test_policies_refused_on_engines_without_the_layer(multiclass):
    with pytest.raises(UnsupportedConfigError, match="predates"):
        _solver(multiclass[1], algo="bcfw", policies=DEFAULT_POLICIES)


# -- the default bundle is the pre-policy behaviour, bit for bit --------------

@pytest.mark.parametrize("algo", MULTIPASS)
def test_default_bundle_reproduces_engine_bitwise(multiclass, algo):
    """``policies=None`` and an explicit uniform/ttl-lru/slope bundle give
    the same rows and weights bit for bit."""
    tp = multiclass[1]

    def run(policies):
        return Solver(tp, RunConfig(lam=1.0 / tp.n, algo=algo, max_iters=4,
                                    cap=8, seed=11, cost_model=_cm(),
                                    policies=policies)).run()

    base, bundled = run(None), run(DEFAULT_POLICIES)
    assert len(base.trace) == len(bundled.trace) == 4
    for ra, rb in zip(base.trace, bundled.trace):
        _rows_equal(ra, rb)
        assert ra.gap_total is None and ra.gap_sampled == 0
    assert np.array_equal(base.w, bundled.w)
    assert np.array_equal(base.w_avg, bundled.w_avg)


# -- mpbcfw-gap: gap columns, determinism ------------------------------------

def _gap_cfg(n, **kw):
    kw.setdefault("max_iters", 4)
    kw.setdefault("seed", 5)
    return RunConfig(lam=1.0 / n, algo="mpbcfw-gap", cap=8, gap_frac=0.5,
                     cost_model=_cm(), **kw)


def test_gap_trace_columns_populated(multiclass):
    tp = multiclass[1]
    solver = Solver(tp, _gap_cfg(tp.n))
    res = solver.run()
    k = max(1, round(0.5 * tp.n))
    for row in res.trace:
        assert row.gap_sampled == k
        assert row.gap_total is not None
        assert math.isfinite(row.gap_total) and row.gap_total >= 0.0
        assert row.dispatches == 1 and row.host_syncs == 1
    # Each iteration charges k exact calls, on the counters and the clock
    # (k oracle calls, then each pass's planes).
    assert res.trace[-1].n_exact == k * len(res.trace)
    first = res.trace[0]
    assert first.time == pytest.approx(
        0.02 * k + first.approx_passes * 1e-4 * max(
            round(first.ws_mean * tp.n), 1), rel=1e-9)
    assert res.trace[-1].gap_total < res.trace[0].gap_total
    gap = solver.state.cache.gap
    assert gap.shape == (tp.n,) and gap.dtype == torch.float32
    assert bool((gap >= 0).all()) and bool((gap < tcache.GAP_UNSEEN).all())


def test_unkeyed_engines_report_gap_defaults(multiclass):
    tp = multiclass[1]
    res = _solver(tp, algo="mpbcfw").run()
    for row in res.trace:
        assert row.gap_total is None and row.gap_sampled == 0


def test_gap_run_is_seed_deterministic(multiclass):
    tp = multiclass[1]
    a = Solver(tp, _gap_cfg(tp.n)).run()
    b = Solver(tp, _gap_cfg(tp.n)).run()
    for ra, rb in zip(a.trace, b.trace):
        _rows_equal(ra, rb)
    assert np.array_equal(a.w, b.w)
    c = Solver(tp, _gap_cfg(tp.n, seed=6)).run()
    assert any(ra.gap_total != rc.gap_total
               for ra, rc in zip(a.trace, c.trace)) or not np.array_equal(
                   a.w, c.w)


def test_gap_checkpoint_resume_trace_bitwise(tmp_path, multiclass):
    tp = multiclass[1]
    whole = Solver(tp, _gap_cfg(tp.n, max_iters=6))
    full = whole.run()
    mgr = CheckpointManager(str(tmp_path / "gap-ckpt"))
    s1 = Solver(tp, _gap_cfg(tp.n, max_iters=6))
    it = s1.iterate()
    head = [next(it) for _ in range(3)]
    assert s1.save(mgr) == 3
    s2 = Solver.restore(tp, _gap_cfg(tp.n, max_iters=6), mgr)
    tail = list(s2.iterate())
    assert [r.iteration for r in tail] == [3, 4, 5]
    for ra, rb in zip(head + tail, full.trace):
        _rows_equal(ra, rb)
    assert np.array_equal(s2.result().w, full.w)
    assert torch.equal(s2.state.cache.gap, whole.state.cache.gap)


# -- the gap vector's operations against JAX's -------------------------------

def _gap_cache(n, cap, seed):
    r = np.random.RandomState(seed)
    gap = np.where(r.rand(n) < 0.3, np.float32(jcache.GAP_UNSEEN),
                   r.randn(n).astype(np.float32) ** 2 * 1e-3)
    gap[r.rand(n) < 0.2] = 0.0
    valid = r.rand(n, cap) < 0.6
    last = r.randint(-1, 8, size=(n, cap)).astype(np.int32)
    return gap.astype(np.float32), valid, last


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_update_gap_matches_jax(seed):
    n, cap = 17, 4
    gap, valid, last = _gap_cache(n, cap, seed)
    r = np.random.RandomState(10 + seed)
    ids = r.permutation(n)[:9]
    vals = r.randn(9).astype(np.float32) * 1e-2
    jc = jcache.init(jcache.CacheLayout(cap=cap, track_gap=True), n, 3)
    jc = jc._replace(gap=jnp.asarray(gap))
    tc = tcache.init(tcache.CacheLayout(cap=cap, track_gap=True), n, 3,
                     "cpu")
    tc.gap.copy_(torch.from_numpy(gap))
    for j, (i, v) in enumerate(zip(ids, vals)):
        jc = jcache.update_gap(jc, jnp.int32(i), jnp.float32(v))
        # Host ints and (1,) index tensors, as the pass and the captured
        # step give them.
        at = int(i) if j % 2 else torch.tensor([int(i)])
        tcache.update_gap(tc, at, torch.tensor(v))
    assert np.array_equal(tc.gap.numpy(), np.asarray(jc.gap))
    assert bool((tc.gap[torch.from_numpy(ids)] >= 0).all())
    plain = tcache.init(tcache.CacheLayout(cap=cap), n, 3, "cpu")
    assert tcache.update_gap(plain, 0, torch.tensor(1.0)).gap is None


@pytest.mark.parametrize("it,ttl,ttl_cold,gap_cold",
                         [(8, 4, 2, 0.0), (8, 10, 5, 1e-3), (3, 1, 1, 0.0),
                          (9, 5, 1, 5e-4)])
def test_evict_gap_stale_matches_jax(it, ttl, ttl_cold, gap_cold):
    n, cap = 23, 6
    gap, valid, last = _gap_cache(n, cap, it + ttl)
    jc = jcache.PlaneCache(planes=jnp.zeros((n, cap, 4)),
                           valid=jnp.asarray(valid),
                           last_active=jnp.asarray(last),
                           gap=jnp.asarray(gap))
    want = np.asarray(jcache.evict_gap_stale(jc, jnp.int32(it), ttl,
                                             ttl_cold, gap_cold).valid)
    tc = tcache.PlaneCache(planes=torch.zeros((n, cap, 4)),
                           valid=torch.from_numpy(valid.copy()),
                           last_active=torch.from_numpy(last),
                           gap=torch.from_numpy(gap))
    assert tcache.evict_gap_stale(tc, it, ttl, ttl_cold, gap_cold) is tc
    assert np.array_equal(tc.valid.numpy(), want)
    ev = GapTTL(ttl=ttl, ttl_cold=ttl_cold, gap_cold=gap_cold)
    tc2 = tcache.PlaneCache(planes=tc.planes,
                            valid=torch.from_numpy(valid.copy()),
                            last_active=tc.last_active, gap=tc.gap)
    assert np.array_equal(ev.evict(tc2, it).valid.numpy(), want)


# -- the gumbel-top-k schedule -----------------------------------------------

def _schedule_pair(gap, k, seed):
    """The port's and JAX's schedules of one gap vector under the same
    noise (JAX's, through the port's noise function)."""
    n = gap.shape[0]
    cfg = dict(lam=0.1, gap_frac=k / n)
    tb = make_bundle(GAP_POLICIES, RunConfig(**cfg), n)
    jb = jmake_bundle(GAP_POLICIES, JRunConfig(**cfg), n)
    assert tb.sampling.k == jb.sampling.k == k
    tc = tcache.init(tcache.CacheLayout(cap=2, track_gap=True), n, 3, "cpu")
    tc.gap.copy_(torch.from_numpy(gap))
    jc = jcache.init(jcache.CacheLayout(cap=2, track_gap=True), n, 3)
    jc = jc._replace(gap=jnp.asarray(gap))
    got = tb.sampling.schedule(tc, np.arange(n), seed)
    want = np.asarray(jb.sampling.schedule(jc, jnp.arange(n, dtype=jnp.int32),
                                           jax.random.PRNGKey(seed)))
    return got, want


@pytest.mark.parametrize("n,k", [(16, 4), (16, 16), (120, 60), (200, 100),
                                 (7, 1)])
def test_gap_schedule_all_unseen_is_index_order(n, k):
    gap = np.full((n,), np.float32(jcache.GAP_UNSEEN), np.float32)
    for seed in (0, 3):
        got, want = _schedule_pair(gap, k, seed)
        assert got.dtype == torch.int64
        assert np.array_equal(got.numpy(), np.arange(k))
        assert np.array_equal(want, np.arange(k))


def test_gap_schedule_matches_jax_under_the_same_noise(jax_noise):
    """Random gap vectors (seen, unseen, zero and tiny gaps; k below and
    at n; three temperatures' worth of spread): the same ids in the same
    order as the reference's ``lax.top_k``."""
    for case in range(12):
        r = np.random.RandomState(case)
        n = (16, 80, 120, 200)[case % 4]
        gap = (r.rand(n) * 10.0 ** r.uniform(-6, 0, n)).astype(np.float32)
        gap[r.rand(n) < 0.15] = np.float32(jcache.GAP_UNSEEN)
        gap[r.rand(n) < 0.1] = 0.0
        for k in (1, n // 2, n):
            got, want = _schedule_pair(gap, k, 1000 + case)
            assert np.array_equal(got.numpy(), want), (case, k)
            assert len(set(got.tolist())) == k


def test_gap_schedule_is_valid_sample_without_replacement():
    n, k = 32, 8
    gap = np.random.RandomState(0).rand(n).astype(np.float32)
    got, _ = _schedule_pair(gap, k, 0)
    assert got.shape == (k,) and len(set(got.tolist())) == k
    assert bool(((got >= 0) & (got < n)).all())


def test_gap_schedule_prefers_unseen_then_large_gaps():
    """Unseen blocks always come first.  One dominant gap (1e3 among
    1e-4s, n = 16, k = 4, the reference's test) is picked with the
    Plackett-Luce probability of its weight, 0.9295 here: over the port's
    own noise for seeds 0..399 the hit rate must lie within 4 standard
    errors (0.0513) of it.  (The reference's 18-of-20 threshold fails
    under jax 0.9.0's stream: 17 hits.)"""
    n, k = 16, 4
    bundle = make_bundle(GAP_POLICIES, RunConfig(lam=0.1, gap_frac=k / n), n)
    cache = tcache.init(tcache.CacheLayout(cap=4, track_gap=True), n, 3,
                        "cpu")
    cache.gap.fill_(1e-4)
    cache.gap[[2, 9]] = tcache.GAP_UNSEEN
    for s in range(40):
        ids = bundle.sampling.schedule(cache, None, s).tolist()
        assert ids[:2] == [2, 9]
    cache.gap.fill_(1e-4)
    cache.gap[7] = 1e3
    seeds = 400
    hits = sum(7 in bundle.sampling.schedule(cache, None, s).tolist()
               for s in range(seeds))
    # Weights: max(gap, 0.1 * mean) ** (1 / temperature).
    ref = (15 * 1e-4 + 1e3) / n
    wt = np.sqrt(np.maximum(np.full(n, 1e-4), 0.1 * ref))
    wt[7] = np.sqrt(1e3)
    rest, total, miss = wt.sum() - wt[7], wt.sum(), 1.0
    for j in range(k):          # block 7 not drawn in any of k draws
        miss *= (rest - j * wt[0]) / (total - j * wt[0])
    p = 1.0 - miss
    assert abs(p - 0.9295) < 1e-3
    margin = 4 * math.sqrt(p * (1 - p) / seeds)
    assert abs(hits / seeds - p) <= margin, (hits, p, margin)


def test_gumbel_noise_is_standard_gumbel_and_seeded():
    a = tsampling.gumbel_noise(7, 20000)
    assert a.dtype == torch.float32 and a.shape == (20000,)
    assert torch.equal(a, tsampling.gumbel_noise(7, 20000))
    assert not torch.equal(a, tsampling.gumbel_noise(8, 20000))
    # Mean Euler-Mascheroni, variance pi^2 / 6 (5 standard errors).
    assert abs(float(a.mean()) - 0.5772157) < 5 * 1.2825 / math.sqrt(20000)
    assert abs(float(a.var()) - math.pi ** 2 / 6) < 0.1
    assert bool(torch.isfinite(a).all())


# -- the gap written by the passes, from a carried JAX state -----------------

@pytest.fixture(scope="module")
def gap_midrun(chain_problems):
    """A JAX ``mpbcfw-gap`` state after 2 iterations, fetched to numpy."""
    jp, _ = chain_problems
    js = JSolver(jp, JRunConfig(lam=1.0 / jp.n, algo="mpbcfw-gap", cap=8,
                                ttl=3, max_iters=2, seed=4,
                                cost_model=_jcm()))
    js.run()
    return jax.device_get(js.state)


def _scale(mp_host, lam):
    """The magnitude of the two scores a block's gap differences: the
    largest |<p, [w 1]>| over cached planes and phi_i rows at ``w``."""
    w = -mp_host.inner.phi[:-1] / lam
    rows = np.concatenate([mp_host.cache.planes.reshape(-1, w.shape[0] + 1),
                           mp_host.inner.phi_i])
    return 2.0 * float(np.abs(rows[:, :-1] @ w + rows[:, -1]).max())


def _gap_close(got, want, scale):
    err = np.abs(got - want)
    assert (err <= 3e-5 * scale + 1e-9).all(), (err.max(), scale)


def test_approx_pass_gap_matches_jax(chain_problems, gap_midrun):
    jp, tp = chain_problems
    lam = 1.0 / jp.n
    host = gap_midrun
    assert host.cache.gap is not None
    perm = np.random.RandomState(0).permutation(jp.n)
    jout = jax.device_get(jmp.jit_approx_pass(jp, host, jnp.asarray(perm),
                                              lam=lam))
    mp = convert.mp_state_from_numpy(host, "cpu")
    out = tmp.approx_pass(None, mp, perm, lam)
    _gap_close(out.cache.gap.numpy(), jout.cache.gap, _scale(host, lam))
    assert_allclose(out.inner.phi.numpy(), jout.inner.phi, rtol=3e-5,
                    atol=3e-5)
    assert (out.cache.gap.numpy() >= 0).all()
    # Zero where the reference clamps a clear negative to zero.
    assert (out.cache.gap.numpy()[jout.cache.gap == 0] < 1e-6).all()


def test_exact_pass_gap_matches_jax(chain_problems, gap_midrun):
    jp, tp = chain_problems
    lam = 1.0 / jp.n
    host = gap_midrun
    perm = np.random.RandomState(1).permutation(jp.n)[:10]
    jout = jax.device_get(jmp.jit_exact_pass(jp, host, jnp.asarray(perm),
                                             lam=lam))
    mp = convert.mp_state_from_numpy(host, "cpu")
    # The schedule as a tensor on the state's device: the sampler's form.
    out = tmp.exact_pass(tp, mp, torch.from_numpy(perm), lam,
                         graphs=StepGraphs())
    assert out.inner.n_exact == int(host.inner.n_exact) + 10
    _gap_close(out.cache.gap.numpy(), jout.cache.gap, _scale(host, lam))
    untouched = np.setdiff1d(np.arange(jp.n), perm)
    assert np.array_equal(out.cache.gap.numpy()[untouched],
                          host.cache.gap[untouched])


def test_eager_pass_gap_output_leaves_the_rest_alone(chain_problems,
                                                     gap_midrun):
    """The gap output writes nothing else: the pass with it and without
    it end in the same bits."""
    jp, _ = chain_problems
    lam = 1.0 / jp.n
    perm = torch.from_numpy(np.random.RandomState(2).permutation(jp.n))
    outs = []
    for with_gap in (True, False):
        mp = convert.mp_state_from_numpy(gap_midrun, "cpu")
        gap = mp.cache.gap if with_gap else None
        tmp.eager_pass(mp.inner.phi, mp.inner.phi_i, mp.avg.bar_approx,
                       mp.cache.planes, mp.cache.valid, mp.cache.last_active,
                       perm, lam=lam, k0=5, outer_it=3, gap=gap)
        outs.append(mp)
    a, b = outs
    for x, y in ((a.inner.phi, b.inner.phi), (a.inner.phi_i, b.inner.phi_i),
                 (a.avg.bar_approx, b.avg.bar_approx),
                 (a.cache.last_active, b.cache.last_active)):
        assert torch.equal(x, y)
    assert not torch.equal(a.cache.gap, b.cache.gap)
    with pytest.raises(ValueError, match="Sec-3.5"):
        tmp.eager_pass(a.inner.phi, a.inner.phi_i, a.avg.bar_approx,
                       a.cache.planes, a.cache.valid, a.cache.last_active,
                       perm, lam=lam, k0=5, outer_it=3, steps=2,
                       gram=torch.zeros((jp.n, 8, 8)), gap=a.cache.gap)


def test_empty_block_gap_is_the_negated_iterate_score_clamped():
    """A block with no valid plane scores 0: its gap is max(-<phi_i,
    [w 1]>, 0), exactly."""
    n, cap, d = 6, 2, 4
    r = np.random.RandomState(0)
    phi_i = torch.from_numpy(r.randn(n, d + 1).astype(np.float32))
    phi = torch.from_numpy(r.randn(d + 1).astype(np.float32))
    planes = torch.zeros((n, cap, d + 1))
    valid = torch.zeros((n, cap), dtype=torch.bool)
    w = weights_of(phi, 0.5)
    scores = phi_i[:, :-1] @ w + phi_i[:, -1]
    assert (scores > 0).any() and (scores < 0).any()
    for i in range(n):
        gap = torch.full((n,), tcache.GAP_UNSEEN)
        tmp.eager_pass(phi.clone(), phi_i.clone(), torch.zeros(d + 1),
                       planes, valid, torch.zeros((n, cap),
                                                  dtype=torch.int32),
                       torch.tensor([i]), lam=0.5, k0=0, outer_it=1,
                       gap=gap)
        want = torch.clamp_min(-(torch.dot(phi_i[i, :-1], w)
                                 + phi_i[i, -1]), 0.0)
        assert float(gap[i]) == float(want)
        assert (gap[np.arange(n) != i] == tcache.GAP_UNSEEN).all()


# -- whole mpbcfw-gap runs against JAX ---------------------------------------

def _jax_schedules(js, n, iters):
    """Run ``js`` (a JAX mpbcfw-gap Solver) ``iters`` iterations; before
    each, replay its host RNG to the iteration's seed and take the
    sampler's schedule of the iteration-entry gap vector (eviction leaves
    the gaps alone).  Returns ``(rows, schedules)``."""
    bundle = js.engine.policies
    batch = min(js.cfg.approx_batch, js.cfg.max_approx_passes)
    rows, scheds = [], []
    it = js.iterate()
    for _ in range(iters):
        r = np.random.RandomState()
        r.set_state(js._rng.get_state())
        r.permutation(n)
        jdraw_perms(r, n, batch)
        seed = int(r.randint(0, 2 ** 31 - 1))
        scheds.append(np.asarray(bundle.sampling.schedule(
            js.state.cache, None, jax.random.PRNGKey(seed))))
        rows.append(next(it))
    return rows, scheds


def _port_schedules(monkeypatch):
    """Record every schedule the port's gap sampler returns."""
    log = []
    inner = GapSampling.schedule

    def recorded(self, cache, perm, key):
        ids = inner(self, cache, perm, key)
        log.append(ids.clone())
        return ids
    monkeypatch.setattr(GapSampling, "schedule", recorded)
    return log


@pytest.mark.parametrize("name", ["usps", "ocr", "horseseg"])
def test_four_gap_iterations_match_jax(name, jax_noise, monkeypatch):
    sc, (jp, tp) = _small(name)
    kw = dict(lam=1.0 / sc.n, algo="mpbcfw-gap", cap=16, ttl=2,
              max_iters=4, approx_batch=8, max_approx_passes=8)
    js = JSolver(jp, JRunConfig(cost_model=JCostModel(
        sc.oracle_cost, sc.plane_cost), **kw))
    jrows, jscheds = _jax_schedules(js, sc.n, 4)
    log = _port_schedules(monkeypatch)
    ts = Solver(tp, RunConfig(cost_model=CostModel(
        sc.oracle_cost, sc.plane_cost), **kw))
    k = max(1, round(0.5 * sc.n))
    rows = ts.iterate()
    trows = [next(rows)]
    # Iteration 1 sweeps the unseen blocks 0..k-1 in index order.  Its
    # approximate passes then visit every block: a block no exact step
    # reached (phi_i = 0, no cached plane) scores 0 against an iterate
    # scoring 0, so its gap becomes 0, as in the reference, and from
    # iteration 2 on no block is unseen and every schedule is sampled.
    assert np.array_equal(log[0].numpy(), np.arange(k))
    gap = ts.state.cache.gap
    assert bool((gap[k:] == 0).all())
    assert not bool((gap >= tcache.GAP_UNSEEN).any())
    trows += list(rows)
    assert len(trows) == len(jrows) == 4 and len(log) == 4
    for it, (a, b) in enumerate(zip(trows, jrows)):
        assert np.array_equal(log[it].numpy(), jscheds[it]), it
        assert (a.n_exact, a.n_approx, a.approx_passes, a.gap_sampled,
                a.planes_evicted, a.dispatches, a.host_syncs) == (
            b.n_exact, b.n_approx, b.approx_passes, b.gap_sampled,
            b.planes_evicted, b.dispatches, b.host_syncs), it
        assert a.gap_sampled == k and a.n_exact == k * (it + 1)
        for f in ("dual", "primal", "gap_total"):
            assert_allclose(getattr(a, f), getattr(b, f), rtol=1e-4,
                            err_msg=f"{f} at {it}")
        assert_allclose(a.time, b.time, rtol=1e-12)
    assert_allclose(ts.result().w, np.asarray(js.result().w), rtol=1e-4,
                    atol=1e-4)


def test_async_with_gap_aware_eviction_matches_jax():
    """``mpbcfw-async`` with ("uniform", "gap-ttl", "slope"): the gap
    vector is written by the approximate passes only (the fold writes
    none), and the cold TTL evicts as in the reference.  A fixed
    straggler mask, as the async tests use (ROADMAP C)."""
    X, Y, M = jsyn.ocr_like(n=120, f=32, num_labels=12, mean_len=7,
                            max_len=10, seed=0)
    jp = jchain.make_problem(jnp.asarray(X), jnp.asarray(Y),
                             jnp.asarray(M), 12)
    tp = tchain.make_problem(X, Y, M, 12, device="cpu")
    kw = dict(lam=1.0 / 120, algo="mpbcfw-async", cap=16, ttl=2,
              max_iters=4, approx_batch=8, max_approx_passes=8,
              policies=("uniform", "gap-ttl", "slope"))

    def mask(it, k):
        return np.random.RandomState(100 + it).rand(k) > 0.3
    js = JSolver(jp, JRunConfig(cost_model=JCostModel(0.3, 1e-3), **kw))
    js.engine.outcome_fn = lambda it, k: jnp.asarray(mask(it, k))
    ts = Solver(tp, RunConfig(cost_model=CostModel(0.3, 1e-3), **kw))
    ts.engine.outcome_fn = mask
    jr, tr = js.run(), ts.run()
    assert ts.state.mp.cache.gap is not None
    for a, b in zip(tr.trace, jr.trace):
        assert (a.n_exact, a.n_approx, a.approx_passes, a.planes_evicted,
                a.dispatches, a.host_syncs) == (
            b.n_exact, b.n_approx, b.approx_passes, b.planes_evicted,
            b.dispatches, b.host_syncs), a.iteration
        assert a.gap_total is None and b.gap_total is None
        assert_allclose(a.dual, b.dual, rtol=1e-4)
        assert_allclose(a.primal, b.primal, rtol=1e-4)
    _gap_close(ts.state.mp.cache.gap.numpy(),
               np.asarray(js.state.mp.cache.gap),
               _scale(jax.device_get(js.state.mp), 1.0 / 120))


# -- states and checkpoints crossing the packages ----------------------------

def test_gap_state_converts_both_ways(gap_midrun):
    state = convert.mp_state_from_numpy(gap_midrun, "cpu")
    assert state.cache.gap.dtype == torch.float32
    assert np.array_equal(state.cache.gap.numpy(), gap_midrun.cache.gap)
    flat = convert.mp_state_to_numpy(state)
    assert np.array_equal(flat["gap"], gap_midrun.cache.gap)
    plain = convert.mp_state_to_numpy(tmp.init_mp_state(
        tchain.make_problem(*jsyn.ocr_like(n=4, f=3, num_labels=2,
                                           mean_len=2, max_len=3), 2,
                            device="cpu"), 2))
    assert plain["gap"] is None


def test_gap_leaf_key_matches_jax(multiclass):
    from repro.checkpoint.manager import _flatten as jflatten
    from repro_torch.checkpoint import flatten
    jp, tp = multiclass
    ts = Solver(tp, _gap_cfg(tp.n, max_iters=1))
    ts.run()
    js = JSolver(jp, JRunConfig(lam=1.0 / jp.n, algo="mpbcfw-gap", cap=8,
                                max_iters=1, cost_model=_jcm()))
    js.run()
    got = flatten(ts.state)
    want = {k: np.asarray(v) for k, v in jflatten(js.state).items()}
    assert sorted(got) == sorted(want) and ".cache//.gap" in got
    assert (got[".cache//.gap"].dtype, got[".cache//.gap"].shape) == (
        want[".cache//.gap"].dtype, want[".cache//.gap"].shape)


def _ckpt_cfgs(n):
    kw = dict(lam=1.0 / n, algo="mpbcfw-gap", cap=8, seed=3, max_iters=4,
              approx_batch=8, max_approx_passes=16)
    return (RunConfig(cost_model=CostModel(plane_cost=1e-3), **kw),
            JRunConfig(cost_model=JCostModel(plane_cost=1e-3), **kw))


def _assert_tail(got, want):
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert a.iteration == b.iteration
        assert (a.n_exact, a.n_approx, a.approx_passes, a.gap_sampled) == (
            b.n_exact, b.n_approx, b.approx_passes, b.gap_sampled)
        for f in ("dual", "primal", "gap_total"):
            assert_allclose(getattr(a, f), getattr(b, f), rtol=1e-4)
        assert_allclose(a.time, b.time, rtol=1e-12)


def test_port_resumes_a_jax_gap_checkpoint(tmp_path, chain_problems,
                                           jax_noise):
    """JAX saves at iteration 2 (its last row carries the gap columns);
    the port restores and runs iterations 2-3, matching JAX's
    uninterrupted run."""
    jp, tp = chain_problems
    tcfg, jcfg = _ckpt_cfgs(jp.n)
    jfull = JSolver(jp, jcfg).run()
    js = JSolver(jp, _ckpt_cfgs(jp.n)[1])
    it = js.iterate()
    [next(it) for _ in range(2)]
    js.save(JManager(str(tmp_path / "j")))
    ts = Solver.restore(tp, tcfg, CheckpointManager(str(tmp_path / "j")))
    assert ts.iteration == 2
    assert ts._last_row.gap_sampled == jfull.trace[1].gap_sampled
    assert_allclose(ts._last_row.gap_total, jfull.trace[1].gap_total,
                    rtol=0)
    assert np.array_equal(ts.state.cache.gap.numpy(),
                          np.asarray(js.state.cache.gap))
    _assert_tail(list(ts.iterate()), jfull.trace[2:])


def test_jax_resumes_a_port_gap_checkpoint(tmp_path, chain_problems,
                                           jax_noise):
    jp, tp = chain_problems
    tcfg, jcfg = _ckpt_cfgs(tp.n)
    tfull = Solver(tp, tcfg).run()
    ts = Solver(tp, _ckpt_cfgs(tp.n)[0])
    it = ts.iterate()
    [next(it) for _ in range(2)]
    ts.save(CheckpointManager(str(tmp_path / "t")))
    js = JSolver.restore(jp, jcfg, JManager(str(tmp_path / "t")))
    assert js.iteration == 2
    _assert_tail(list(js.iterate()), tfull.trace[2:])


def test_captured_steps_are_keyed_by_the_gap_vector(chain_problems):
    """A captured exact step writes the gap vector, so the graph key
    (``state_tensors``) holds it: a plain and a gap-tracking state of one
    problem never share an entry of one StepGraphs."""
    from repro_torch.cache import CacheLayout
    from repro_torch.core.distributed import state_tensors
    _, tp = chain_problems
    plain = tmp.init_mp_state(tp, CacheLayout(cap=4))
    gap = tmp.init_mp_state(tp, CacheLayout(cap=4, track_gap=True))
    assert gap.cache.gap is state_tensors(gap)[-1]
    assert len(state_tensors(gap)) == len(state_tensors(plain)) + 1
    graphs = StepGraphs()
    key = (1.0 / tp.n, tp.oracle)
    a = graphs.control("exact", state_tensors(plain), key, 4, tp.d)
    b = graphs.control("exact", state_tensors(gap), key, 4, tp.d)
    assert a is not b
    assert graphs.control("exact", state_tensors(gap), key, 4, tp.d) is b

"""Core math, cache, data and chain oracle of repro_torch vs the JAX package.

The same numpy inputs, made from a seed, go through both packages.
Single steps compare at rtol = atol = 3e-5 (float32 in another order);
argmax outputs (slots, labels) and integer state must be equal.
"""
import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro import cache as jcache
from repro.configs import paper as jpaper
from repro.core import averaging as javg
from repro.core import bcfw as jbcfw
from repro.core import mpbcfw as jmp
from repro.core import selection as jsel
from repro.core import ssvm as jssvm
from repro.core.oracles import chain as jchain
from repro.core.types import AveragingState as JAvg
from repro.core.types import BCFWState as JState
from repro.data import synthetic as jsyn
from repro_torch import cache as tcache
from repro_torch import convert
from repro_torch.cache import CacheLayout
from repro_torch.configs import paper as tpaper
from repro_torch.core import averaging as tavg
from repro_torch.core import bcfw as tbcfw
from repro_torch.core import selection as tsel
from repro_torch.core import ssvm as tssvm
from repro_torch.core.oracles import chain as tchain
from repro_torch.core.types import BCFWState
from repro_torch.data import synthetic as tsyn

torch.set_num_threads(1)
TOL = dict(rtol=3e-5, atol=3e-5)
ROOT = Path(__file__).resolve().parents[1]


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def _vecs(seed, d, k=3, scale=1.0):
    r = np.random.RandomState(seed)
    return [(scale * r.randn(d + 1)).astype(np.float32) for _ in range(k)]


# -- objective and BCFW step -------------------------------------------------

@pytest.mark.parametrize("case", ["random", "zero_den", "clip_hi", "clip_lo"])
def test_line_search_gamma_matches_jax(case):
    phi, phi_i, phi_hat = _vecs(3, 40)
    lam = 0.05
    if case == "zero_den":
        phi_hat = phi_i.copy()
        phi_hat[-1] += 1.0
    elif case == "clip_hi":
        phi = 50.0 * (phi_i - phi_hat)
    elif case == "clip_lo":
        phi = -50.0 * (phi_i - phi_hat)
    want = float(jbcfw.line_search_gamma(jnp.asarray(phi), jnp.asarray(phi_i),
                                         jnp.asarray(phi_hat), lam))
    got = float(tbcfw.line_search_gamma(T(phi), T(phi_i), T(phi_hat), lam))
    assert_allclose(got, want, **TOL)
    assert 0.0 <= got <= 1.0
    if case == "zero_den":
        assert got == 0.0
    if case == "clip_hi":
        assert got == 1.0


def test_block_update_matches_jax():
    r = np.random.RandomState(4)
    n, d, lam = 5, 30, 0.1
    phi_i = (0.1 * r.randn(n, d + 1)).astype(np.float32)
    phi = phi_i.sum(0)
    phi_hat = (0.1 * r.randn(d + 1)).astype(np.float32)
    js, jg = jbcfw.block_update(
        JState(jnp.asarray(phi_i), jnp.asarray(phi), jnp.int32(0),
               jnp.int32(0)), 2, jnp.asarray(phi_hat), lam)
    ts, tg = tbcfw.block_update(BCFWState(T(phi_i), T(phi), 0, 0), 2,
                                T(phi_hat), lam)
    assert_allclose(float(tg), float(jg), **TOL)
    assert_allclose(ts.phi_i.numpy(), np.asarray(js.phi_i), **TOL)
    assert_allclose(ts.phi.numpy(), np.asarray(js.phi), **TOL)
    # phi stays the running sum of phi_i
    assert_allclose(ts.phi.numpy(), ts.phi_i.numpy().sum(0), rtol=1e-5,
                    atol=1e-6)


def test_dual_value_weights_and_score_match_jax():
    phi, w_in, _ = _vecs(5, 64)
    lam = 0.02
    assert_allclose(float(tssvm.dual_value(T(phi), lam)),
                    float(jssvm.dual_value(jnp.asarray(phi), lam)), **TOL)
    assert_allclose(tssvm.weights_of(T(phi), lam).numpy(),
                    np.asarray(jssvm.weights_of(jnp.asarray(phi), lam)),
                    **TOL)
    assert_allclose(float(tssvm.plane_score(T(phi), T(w_in[:-1]))),
                    float(jssvm.plane_score(jnp.asarray(phi),
                                            jnp.asarray(w_in[:-1]))), **TOL)


@pytest.mark.parametrize("schedule", ["EEAAEA", "AAA", "EEE", ""])
def test_averaging_tracks_match_jax(schedule):
    d, lam = 20, 0.05
    vecs = _vecs(6, d, k=max(len(schedule), 1), scale=0.3)
    ja = javg.init_averaging(d)
    ta = tavg.init_averaging(d, "cpu")
    scratch = torch.empty(d + 1)
    for step, v in zip(schedule, vecs):
        ja = javg.update_average(ja, jnp.asarray(v), exact=step == "E")
        # The port steps a track in place with weights from its table.
        exact = step == "E"
        k = ta.k_exact if exact else ta.k_approx
        tavg.average_step(ta.bar_exact if exact else ta.bar_approx, T(v),
                          T(tavg.weight_table(k, 1)[0]), scratch)
        ta = ta._replace(k_exact=ta.k_exact + exact,
                         k_approx=ta.k_approx + (not exact))
    assert (ta.k_exact, ta.k_approx) == (int(ja.k_exact), int(ja.k_approx))
    assert_allclose(ta.bar_exact.numpy(), np.asarray(ja.bar_exact), **TOL)
    assert_allclose(ta.bar_approx.numpy(), np.asarray(ja.bar_approx), **TOL)
    assert_allclose(tavg.extract(ta, lam).numpy(),
                    np.asarray(javg.extract(ja, lam)), **TOL)


def test_averaging_weights_are_float32_exact():
    """k/(k+2) and 2/(k+2) round as the reference's float32 division."""
    for k in (0, 1, 2, 3, 7, 1000, 123457):
        a, b = map(float, tavg.weight_table(k, 1)[0])
        kf = jnp.float32(k)
        assert a == float(kf / (kf + 2.0)) and b == float(2.0 / (kf + 2.0))


# -- the slope rule ----------------------------------------------------------

def test_slope_rule_tensor_twin_matches_jnp_bit_for_bit():
    """Random float32 checkpoints, exact ties and zero-length intervals:
    the tensor rule decides exactly as ``slope_continue_jnp``."""
    r = np.random.RandomState(7)
    rows = [r.randn(6).astype(np.float32) for _ in range(300)]
    rows += [np.array([0, 0, 1, 1, 2, 2], np.float32),      # equal slopes
             np.array([0, 0, 1, 1, 1, 1], np.float32),      # dt_last = 0
             np.array([1, 2, 1, 2, 1, 2], np.float32),      # nothing moves
             np.array([0.0, 0.0, 0.5, 0.3, 0.5 + 1e-7, 0.3 + 2e-7],
                      np.float32)]
    for f0, t0, fp, tp, fl, tl in rows:
        want = bool(jsel.slope_continue_jnp(*(jnp.float32(x) for x in
                                              (f0, t0, fp, tp, fl, tl))))
        got = bool(tsel.slope_continue_t(*(torch.tensor(x) for x in
                                           (f0, t0, fp, tp, fl, tl))))
        assert got == want, (f0, t0, fp, tp, fl, tl)


def test_slope_rule_host_form_and_tracker_match_reference():
    r = np.random.RandomState(8)
    for _ in range(100):
        args = [float(x) for x in r.randn(6)]
        assert tsel.slope_continue(*args) == jsel.slope_continue(*args)
    jt, tt = jsel.IterationTracker(), tsel.IterationTracker()
    for tr in (jt, tt):
        tr.start(0.0, 1.0)
        tr.record_batch([1.0, 2.0, 3.0], [2.0, 2.5, 2.6])
    assert tt.continue_approx() == jt.continue_approx()
    assert (tsel.attribute_wall_time(3.0, [1, 2, 0])
            == jsel.attribute_wall_time(3.0, [1, 2, 0]))
    cm_j, cm_t = jsel.CostModel(0.3, 1e-3), tsel.CostModel(0.3, 1e-3)
    assert cm_t.exact_pass(10) == cm_j.exact_pass(10)
    assert cm_t.approx_pass(0) == cm_j.approx_pass(0)


def test_sync_ledger_counts_one_sync_per_fetch():
    led = tsel.SyncLedger()
    out = led.sync((torch.ones(2), torch.tensor(True), 3))
    assert led.counts() == (1, 0, 0)
    assert isinstance(out[0], np.ndarray) and bool(out[1]) and out[2] == 3
    led.dispatched()
    assert led.counts() == (1, 0, 1)


# -- the plane cache ---------------------------------------------------------

def _cache_pair(n, cap, d):
    return jcache.init(jcache.CacheLayout(cap=cap), n, d), \
        tcache.init(CacheLayout(cap=cap), n, d, "cpu")


def _assert_cache_equal(tc, jc, exact=True):
    assert (tc.valid.numpy() == np.asarray(jc.valid)).all()
    assert (tc.last_active.numpy() == np.asarray(jc.last_active)).all()
    if exact:
        assert (tc.planes.numpy() == np.asarray(jc.planes)).all()
    else:
        assert_allclose(tc.planes.numpy(), np.asarray(jc.planes), **TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cache_insert_evict_sequence_matches_jax(seed):
    """Random inserts (overfilling blocks: LRU victims), activity marks and
    TTL evictions, applied to both caches step by step."""
    r = np.random.RandomState(seed)
    n, cap, d = 4, 3, 6
    jc, tc = _cache_pair(n, cap, d)
    for it in range(1, 9):
        jc, tc = jcache.evict_stale(jc, it, 2), tcache.evict_stale(tc, it, 2)
        for i in r.permutation(n)[:3]:
            p = r.randn(d + 1).astype(np.float32)
            jc = jcache.insert(jc, jnp.int32(i), jnp.asarray(p), jnp.int32(it))
            tc = tcache.insert(tc, int(i), T(p), it)
            if r.rand() < 0.5:
                s = int(r.randint(cap))
                jc = jcache.mark_active(jc, jnp.int32(i), jnp.int32(s),
                                        jnp.int32(it))
                tc = tcache.mark_active(tc, int(i), torch.tensor([s]), it)
        _assert_cache_equal(tc, jc)
        assert (tcache.sizes(tc).numpy() == np.asarray(jcache.sizes(jc))).all()
        assert int(tc.occupancy) == int(jc.occupancy)
        assert int(tc.nonempty_blocks) == int(jc.nonempty_blocks)


def test_lru_ties_break_to_lowest_slot():
    """A full block whose slots share one activity stamp evicts slot 0,
    then the lowest of the remaining oldest; an empty slot beats all."""
    jc, tc = _cache_pair(1, 4, 2)
    for s in range(4):
        jc = jcache.insert(jc, jnp.int32(0), jnp.full((3,), s, jnp.float32),
                           jnp.int32(5))
        tc = tcache.insert(tc, 0, torch.full((3,), float(s)), 5)
    assert int(tcache.ops._lru_slot(tc, 0)) == 0 == int(
        jcache.ops._lru_slot(jc, 0))
    jc = jcache.mark_active(jc, jnp.int32(0), jnp.int32(0), jnp.int32(6))
    tc = tcache.mark_active(tc, 0, torch.tensor([0]), 6)
    assert int(tcache.ops._lru_slot(tc, 0)) == 1 == int(
        jcache.ops._lru_slot(jc, 0))
    tc.valid[0, 3] = False
    jc = jc._replace(valid=jc.valid.at[0, 3].set(False))
    assert int(tcache.ops._lru_slot(tc, 0)) == 3 == int(
        jcache.ops._lru_slot(jc, 0))


def test_ttl_boundary_matches_jax():
    """A plane last active ttl iterations ago survives; ttl+1 is dropped."""
    jc, tc = _cache_pair(1, 3, 2)
    for s, it in enumerate((1, 2, 3)):
        jc = jcache.insert(jc, jnp.int32(0), jnp.ones(3), jnp.int32(it))
        tc = tcache.insert(tc, 0, torch.ones(3), it)
    jc, tc = jcache.evict_stale(jc, 4, 2), tcache.evict_stale(tc, 4, 2)
    assert tc.valid.tolist() == [[False, True, True]]
    _assert_cache_equal(tc, jc)


@pytest.mark.parametrize("d", [5, 200])
def test_approx_oracle_matches_jax(d):
    """Best cached plane per block: ties (duplicate planes) go to the
    lowest slot, invalid slots never win, an empty block gives the zero
    plane with score 0.  d=200 routes through the plane_scores dispatch."""
    r = np.random.RandomState(d)
    n, cap = 3, 8
    jc, tc = _cache_pair(n, cap, d)
    dup = r.randn(d + 1).astype(np.float32)
    for i in (0, 1):
        for s in range(cap):
            p = dup if s in (2, 5) else r.randn(d + 1).astype(np.float32)
            jc = jcache.insert(jc, jnp.int32(i), jnp.asarray(p), jnp.int32(1))
            tc = tcache.insert(tc, i, T(p), 1)
    # make the duplicate the best plane of block 0; invalidate slot 2 of 1
    w = dup[:-1].copy()
    tc.valid[1, 2] = False
    jc = jc._replace(valid=jc.valid.at[1, 2].set(False))
    for i in range(n):
        jp, js, jsc = jcache.approx_oracle(jc, jnp.int32(i), jnp.asarray(w))
        tp, ts, tsc = tcache.approx_oracle(tc, i, T(w))
        assert ts.shape == (1,) and int(ts) == int(js)
        assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
        assert_allclose(float(tsc), float(jsc), rtol=3e-5, atol=3e-4)
    assert int(tcache.approx_oracle(tc, 0, T(w))[1]) == 2
    tp, _, tsc = tcache.approx_oracle(tc, 2, T(w))
    assert float(tsc) == 0.0 and not tp.any()


def test_unported_cache_layouts_raise():
    """The Gram leaf is ported (its shape here, its rows in
    tests/test_torch_gram.py), and so is the gap vector: a (n,) float32
    vector filled with GAP_UNSEEN, as the reference's; only float32
    planes are taken."""
    c = tcache.init(CacheLayout(cap=4, gram=True), 2, 3, "cpu")
    assert c.gram.shape == (2, 4, 4) and c.gram.dtype == torch.float32
    assert c.gap is None
    assert tcache.init(CacheLayout(cap=4), 2, 3, "cpu").gram is None
    g = tcache.init(CacheLayout(cap=4, track_gap=True), 2, 3, "cpu").gap
    want = np.asarray(jcache.init(jcache.CacheLayout(cap=4, track_gap=True),
                                  2, 3).gap)
    assert g.dtype == torch.float32 and (g.numpy() == want).all()
    assert (g == tcache.GAP_UNSEEN).all()
    with pytest.raises(NotImplementedError, match="float32"):
        tcache.init(CacheLayout(cap=4, dtype=torch.float64), 2, 3, "cpu")


# -- data, configs, chain oracle ---------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(n=24, f=8, num_labels=5, mean_len=6, max_len=8, seed=1),
    dict(n=40, f=32, num_labels=12, mean_len=7, max_len=10, seed=0),
    dict(n=30, f=128, num_labels=26, mean_len=8, max_len=14, seed=3)])
def test_ocr_like_emits_identical_arrays(kw):
    for a, b in zip(tsyn.ocr_like(**kw), jsyn.ocr_like(**kw)):
        assert a.dtype == b.dtype and (a == b).all()


def test_paper_configs_match_reference():
    for name in ("USPS", "OCR", "HORSESEG"):
        assert dataclasses.asdict(getattr(tpaper, name)) == \
            dataclasses.asdict(getattr(jpaper, name))
    for k in jpaper.SMALL:
        assert dataclasses.asdict(tpaper.SMALL[k]) == \
            dataclasses.asdict(jpaper.SMALL[k])
    o = tpaper.OCR
    assert o.num_classes * o.f + o.num_classes ** 2 == 4004


def _chain_pair(n, f, C, mean_len, max_len, seed):
    X, Y, M = jsyn.ocr_like(n=n, f=f, num_labels=C, mean_len=mean_len,
                            max_len=max_len, seed=seed)
    jp = jchain.make_problem(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(M),
                             C)
    tp = tchain.make_problem(X, Y, M, C, device="cpu")
    return jp, tp


CHAIN_SIZES = {"conftest": (24, 8, 5, 6, 8, 1),
               "small_ocr": (120, 32, 12, 7, 10, 0)}


@pytest.mark.parametrize("size", sorted(CHAIN_SIZES))
def test_chain_oracle_planes_match_jax(size):
    """Per-example and batched oracle planes at a random w (scaled so the
    decode is not the ground truth), labels included."""
    jp, tp = _chain_pair(*CHAIN_SIZES[size])
    assert (tp.n, tp.d) == (jp.n, jp.d)
    assert tp.meta == jp.meta
    r = np.random.RandomState(11)
    w = (0.5 * r.randn(tp.d)).astype(np.float32)
    want = np.asarray(jssvm.batched_oracle(jp, jnp.asarray(w)))
    got = tssvm.batched_oracle(tp, T(w)).numpy()
    assert got.shape == (tp.n, tp.d + 1)
    assert_allclose(got, want, **TOL)
    for i in range(0, tp.n, max(tp.n // 6, 1)):
        ex = {k: v[i:i + 1] for k, v in tp.data.items()}
        one = tp.oracle(T(w), ex)[0].numpy()
        jex = jax.tree_util.tree_map(lambda a: a[i], jp.data)
        assert_allclose(one, np.asarray(jp.oracle(jnp.asarray(w), jex)),
                        **TOL)
        spec_j, x = jp.spec, jex
        assert (tp.spec.decode(T(w), ex)[0].numpy()
                == np.asarray(spec_j.decode(jnp.asarray(w), x))).all()


@pytest.mark.parametrize("size", sorted(CHAIN_SIZES))
def test_chain_primal_at_random_w_matches_jax(size):
    jp, tp = _chain_pair(*CHAIN_SIZES[size])
    w = (0.3 * np.random.RandomState(12).randn(tp.d)).astype(np.float32)
    lam = 1.0 / tp.n
    assert_allclose(float(tssvm.primal_value(tp, T(w), lam)),
                    float(jssvm.primal_value(jp, jnp.asarray(w), lam)),
                    rtol=1e-4)


def test_make_problem_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, Y, M = tsyn.ocr_like(n=4, f=3, num_labels=3, max_len=5)
    with pytest.raises(RuntimeError, match="no CUDA"):
        tchain.make_problem(X, Y, M, 3)
    with pytest.raises(RuntimeError, match="no CUDA"):
        tchain.make_problem(X, Y, M, 3, device="cuda")
    prob = tchain.make_problem(X, Y, M, 3, device="cpu")
    assert prob.data["x"].device.type == "cpu"


# -- state carried across ----------------------------------------------------

def test_convert_round_trips_a_reference_state():
    jp, tp = _chain_pair(*CHAIN_SIZES["conftest"])
    r = np.random.RandomState(13)
    mp = jmp.init_mp_state(jp, 4)
    for i in range(jp.n):
        for it in range(r.randint(0, 6)):
            mp = mp._replace(cache=jcache.insert(
                mp.cache, jnp.int32(i),
                jnp.asarray(r.randn(jp.d + 1).astype(np.float32)),
                jnp.int32(it)))
    mp = mp._replace(outer_it=jnp.int32(5),
                     inner=mp.inner._replace(n_exact=jnp.int32(48)),
                     avg=JAvg(*(jnp.asarray(r.randn(jp.d + 1), jnp.float32)
                                for _ in range(2)), jnp.int32(3),
                              jnp.int32(7)))
    host = jax.device_get(mp)
    state = convert.mp_state_from_numpy(host, "cpu")
    flat = convert.mp_state_to_numpy(state)
    assert flat["outer_it"] == 5 and flat["n_exact"] == 48
    assert (flat["k_exact"], flat["k_approx"]) == (3, 7)
    assert (flat["planes"] == host.cache.planes).all()
    assert (flat["valid"] == host.cache.valid).all()
    assert (flat["last_active"] == host.cache.last_active).all()
    assert (flat["bar_approx"] == host.avg.bar_approx).all()
    assert state.cache.valid.dtype == torch.bool
    assert state.cache.last_active.dtype == torch.int32


# -- import hygiene ----------------------------------------------------------

def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_never_imports_jax_or_the_reference_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in files[:-1]}
    assert {"models/moe.py", "models/attention.py", "models/transformer.py",
            "kernels/moe_ffn.py", "kernels/flash_attention.py",
            "trainer/ssvm_head.py", "launch/serve.py", "obs/metrics.py",
            "serve/__init__.py", "serve/export.py", "serve/engine.py",
            "serve/batcher.py", "serve/metrics.py", "policy/__init__.py",
            "policy/base.py", "policy/sampling.py", "policy/eviction.py",
            "policy/oracle.py", "obs/__init__.py", "obs/__main__.py",
            "obs/schema.py", "obs/recorder.py", "obs/summary.py",
            "obs/trace_export.py", "shard/__init__.py", "shard/engine.py",
            "shard/layout.py", "shard/telemetry.py", "launch/mesh.py",
            "cache/layout.py", "analysis/__init__.py",
            "analysis/__main__.py", "analysis/findings.py",
            "analysis/lint.py", "analysis/contracts.py",
            "analysis/kernels.py", "optim/__init__.py",
            "optim/adamw.py", "optim/schedule.py", "optim/compression.py",
            "data/lm.py", "ft/restart.py", "launch/train.py",
            "examples/__init__.py", "examples/quickstart.py",
            "examples/sequence_labeling.py",
            "examples/segmentation_distributed.py", "examples/ssvm_head.py",
            "examples/lm_train.py", "configs/deepseek_v3_671b.py",
            "configs/internvl2_76b.py", "configs/minitron_8b.py",
            "configs/mistral_nemo_12b.py", "configs/qwen2_5_14b.py",
            "configs/shapes.py", "configs/__init__.py",
            "models/common.py", "models/registry.py", "convert.py",
            "models/ssm.py", "models/hybrid.py", "models/xlstm.py",
            "models/xlstm_lm.py", "models/encdec.py",
            "configs/zamba2_7b.py", "configs/xlstm_125m.py",
            "configs/whisper_base.py", "launch/dryrun.py",
            "launch/roofline.py", "launch/trace_analysis.py"} <= names
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)

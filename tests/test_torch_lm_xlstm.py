"""The xLSTM family in repro_torch -- xlstm-125m's mLSTM and sLSTM blocks
and the interleaved LM -- against the JAX package, on the CPU, at
``reduced_config``.

The JAX parameters come from ``init_params(PRNGKey(0))`` and cross into
the port through ``convert.lm_params_from_numpy``; inputs come from numpy
with a seed.  Tolerances are ``tests/test_torch_lm_family.py``'s: models
and modules at rtol = atol = 1e-4 in float32 (bfloat16 at a relative L2
of 2e-2), the loss at rtol 1e-5, each gradient leaf at rtol 1e-4, atol
1e-6.  No kernel runs on this family.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import common as jcommon
from repro.models import registry as jregistry
from repro.models import xlstm as jxlstm
from repro.models import xlstm_lm as jxlstm_lm
from repro_torch import configs, convert
from repro_torch.kernels import ops
from repro_torch.launch import serve, train
from repro_torch.models import common, registry, xlstm, xlstm_lm

torch.set_num_threads(1)
ARCH = "xlstm-125m"
TOL = dict(rtol=1e-4, atol=1e-4)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _models(dtype="f32", **over):
    jdt, tdt = DTYPES[dtype]
    jcfg = dataclasses.replace(jconfigs.reduced_config(ARCH), dtype=jdt,
                               **over)
    tcfg = dataclasses.replace(configs.reduced_config(ARCH), dtype=tdt,
                               **over)
    jp = jcommon.init_params(jregistry.param_specs(jcfg),
                             jax.random.PRNGKey(0))
    tp = convert.lm_params_from_numpy(jax.device_get(jp), tcfg, "cpu")
    return jcfg, jp, tcfg, tp


def _batches(cfg, B=3, S=10, seed=0):
    tb = registry.make_train_batch(cfg, B, S, seed)
    return {k: jnp.asarray(v.numpy()) for k, v in tb.items()}, tb


def _cache_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _cache_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _cache_leaves(t)]
    return [] if tree is None else [tree]


def _f32(a):
    return np.asarray(a, np.float32)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _first(tree, nd):
    """Layer 0 of a stacked tree (``nd`` leading layer axes)."""
    idx = (0,) * nd
    if isinstance(tree, dict):
        return {k: _first(v, nd) for k, v in tree.items()}
    return tree[idx]


def _x(cfg, S, seed, dtype=np.float32):
    return np.random.RandomState(seed).randn(2, S, cfg.d_model).astype(dtype)


# -- config and specs -------------------------------------------------------------

def test_config_matches_the_reference():
    for get in ("get_config", "reduced_config"):
        a = getattr(jconfigs, get)(ARCH)
        b = getattr(configs, get)(ARCH)
        for f in dataclasses.fields(b):
            if f.name != "dtype":
                assert getattr(b, f.name) == getattr(a, f.name), f.name
    assert configs.long_context_overrides(ARCH) == {}


@pytest.mark.parametrize("get", ["reduced_config", "get_config"])
def test_spec_tree_and_param_count_match_jax(get):
    jcfg, tcfg = getattr(jconfigs, get)(ARCH), getattr(configs, get)(ARCH)
    jspecs = jax.tree_util.tree_leaves_with_path(
        jregistry.param_specs(jcfg),
        is_leaf=lambda s: isinstance(s, jcommon.ParamSpec))
    tspecs = common.leaves(registry.param_specs(tcfg))
    assert len(tspecs) == len(jspecs)
    for t, (_, j) in zip(tspecs, jspecs):
        assert (t.shape, t.axes, t.scale) == (j.shape, j.axes, j.scale)
        assert str(t.dtype).split(".")[-1] == np.dtype(j.dtype).name
    assert tcfg.param_count() == jcfg.param_count()


def test_full_model_layout():
    cfg = configs.get_config(ARCH)
    assert cfg.param_count() == 183_571_968
    assert xlstm_lm._groups(cfg) == jxlstm_lm._groups(
        jconfigs.get_config(ARCH)) == (3, 4, 0)
    assert xlstm_lm._groups(configs.reduced_config(ARCH)) == (2, 2, 1)
    assert xlstm.mlstm_dims(cfg) == (1536, 4, 384)
    cache = registry.init_cache(cfg, 4, 256, "meta")
    assert cache["mlstm"].shape == (3, 3, 4, 4, 384, 384)
    assert cache["slstm"]["h"].shape == (3, 4, 4, 192)
    assert cache["mlstm_tail"] is None


# -- the blocks on their own -------------------------------------------------------

# S below, equal to, and not a multiple of the chunk (8), and two chunks.
@pytest.mark.parametrize("S", [5, 8, 13, 16])
def test_mlstm_forward_matches_jax(S):
    jcfg, jp, tcfg, tp = _models()
    x = _x(tcfg, S, S)
    want = np.asarray(jxlstm.mlstm_forward(_first(jp["mlstm"], 2),
                                           jnp.asarray(x), jcfg, chunk=8))
    got = xlstm.mlstm_forward(_first(tp["mlstm"], 2), _t(x), tcfg, chunk=8)
    assert got.shape == (2, S, tcfg.d_model)
    assert_allclose(got.numpy(), want, **TOL)


def test_mlstm_decode_matches_jax_and_the_chunked_forward():
    jcfg, jp, tcfg, tp = _models()
    jl, tl = _first(jp["mlstm"], 2), _first(tp["mlstm"], 2)
    x = _x(tcfg, 6, 2)
    js = jxlstm.init_mlstm_cache(jcfg, 2, 1)[0]
    ts = xlstm.init_mlstm_cache(tcfg, 2, 1, "cpu")[0]
    outs = []
    for t in range(6):
        jo, js = jxlstm.mlstm_decode(jl, jnp.asarray(x[:, t:t + 1]), js,
                                     jcfg)
        to, ts = xlstm.mlstm_decode(tl, _t(x[:, t:t + 1]), ts, tcfg)
        assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        outs.append(to)
    assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    assert_allclose(torch.cat(outs, 1).numpy(),
                    xlstm.mlstm_forward(tl, _t(x), tcfg, chunk=4).numpy(),
                    **TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_slstm_forward_matches_jax(dtype):
    """The recurrence over time, h rounded to the input's dtype at every
    step as the reference carries it."""
    jcfg, jp, tcfg, tp = _models(dtype)
    x = _x(tcfg, 12, 4)
    jx = jnp.asarray(x).astype(DTYPES[dtype][0])
    tx = _t(x).to(DTYPES[dtype][1])
    want = _f32(jxlstm.slstm_forward(_first(jp["slstm"], 1), jx, jcfg))
    got = xlstm.slstm_forward(_first(tp["slstm"], 1), tx, tcfg)
    assert got.dtype == tx.dtype
    if dtype == "f32":
        assert_allclose(got.numpy(), want, **TOL)
    else:
        assert _rel_l2(got.float().numpy(), want) <= 2e-2


def test_slstm_decode_matches_jax_and_the_forward():
    jcfg, jp, tcfg, tp = _models()
    jl, tl = _first(jp["slstm"], 1), _first(tp["slstm"], 1)
    x = _x(tcfg, 6, 3)
    jc = jax.tree_util.tree_map(lambda a: a[0],
                                jxlstm.init_slstm_cache(jcfg, 2, 1))
    tc = {k: v[0] for k, v in xlstm.init_slstm_cache(tcfg, 2, 1,
                                                     "cpu").items()}
    outs = []
    for t in range(6):
        jo, jc = jxlstm.slstm_decode(jl, jnp.asarray(x[:, t:t + 1]), jc,
                                     jcfg)
        to, tc = xlstm.slstm_decode(tl, _t(x[:, t:t + 1]), tc, tcfg)
        assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        outs.append(to)
    for k in ("h", "c", "n"):
        assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **TOL)
    assert_allclose(torch.cat(outs, 1).numpy(),
                    xlstm.slstm_forward(tl, _t(x), tcfg).numpy(), **TOL)


def test_slstm_gates_split_per_head():
    """(i, f, z, o) split along each head's 4 hd: a pre-activation that
    drives only head 0's f block changes only head 0's cell."""
    B, H, hd = 2, 2, 3
    g = torch.zeros((B, H, 4 * hd))
    c0 = n0 = torch.ones((B, H, hd))
    base = xlstm._slstm_cell(g, c0, n0, torch.float32)
    g2 = g.clone()
    g2[:, 0, hd:2 * hd] = 5.0
    moved = xlstm._slstm_cell(g2, c0, n0, torch.float32)
    assert not torch.allclose(moved[1][:, 0], base[1][:, 0])
    assert torch.equal(moved[1][:, 1], base[1][:, 1])


# -- whole models ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_and_decode_match_jax(dtype):
    """Prefill logits, six decode steps' logits and every cache leaf."""
    jcfg, jp, tcfg, tp = _models(dtype)
    jb, tb = _batches(tcfg)

    def close(got, want):
        if dtype == "f32":
            assert_allclose(got, want, **TOL)
        else:
            assert _rel_l2(got, want) <= 2e-2
    got = registry.prefill(tp, tcfg, tb)
    assert got.shape == (3, 1, tcfg.vocab_size)
    close(_f32(got.float()), _f32(jregistry.prefill(jp, jcfg, jb)))
    jcache = jregistry.init_cache(jcfg, 3, 16)
    tcache = registry.init_cache(tcfg, 3, 16, "cpu")
    tok = tb["tokens"].numpy()
    for pos in range(6):
        step = tok[:, pos:pos + 1]
        jlog, jcache = jregistry.decode_step(jp, jcfg, jcache,
                                             jnp.asarray(step), jnp.int32(pos))
        tlog, tcache = registry.decode_step(tp, tcfg, tcache, _t(step), pos)
        close(_f32(tlog.float()), _f32(jlog))
    want = jax.tree_util.tree_leaves(jcache)
    got = _cache_leaves(tcache)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[-1] == np.dtype(w.dtype).name
        close(_f32(g.float()), _f32(w))


def test_decode_ignores_pos():
    _, _, tcfg, tp = _models()
    tok = _t(np.array([[3], [7], [11]], np.int32))
    a, _ = registry.decode_step(tp, tcfg,
                                registry.init_cache(tcfg, 3, 4, "cpu"),
                                tok, 0)
    b, _ = registry.decode_step(tp, tcfg,
                                registry.init_cache(tcfg, 3, 4, "cpu"),
                                tok, 99)
    assert torch.equal(a, b)


def test_loss_and_gradients_match_jax():
    jcfg, jp, tcfg, tp = _models()
    jb, tb = _batches(tcfg, seed=5)
    want_loss = float(jregistry.loss_fn(jp, jcfg, jb))
    assert_allclose(float(registry.loss_fn(tp, tcfg, tb)), want_loss,
                    rtol=1e-5)
    want = jax.grad(lambda p: jregistry.loss_fn(p, jcfg, jb))(jp)
    ops.reset_launch_counts()
    loss, grads = train.value_and_grad(tp, tcfg, tb)
    assert set(ops.launch_counts().values()) == {0}
    assert_allclose(float(loss), want_loss, rtol=1e-5)
    want_l = jax.tree_util.tree_leaves(want)
    got_l = common.leaves(grads)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        assert g.shape == w.shape
        assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6)
    assert np.abs(grads["slstm"]["rh"].numpy()).max() > 0


def test_server_generates_the_reference_tokens():
    jcfg, jp, tcfg, tp = _models()
    r = np.random.RandomState(2)
    prompts = [r.randint(0, tcfg.vocab_size, size=int(n))
               for n in r.randint(1, 6, size=6)]
    jserver = jserve.Server(jcfg, jp, slots=4, max_seq=64)
    pending, jdone = [jserve.Request(i, p, 4 + i % 3)
                      for i, p in enumerate(prompts)], []
    while pending or any(jserver.active):
        while pending and jserver.add(pending[0]):
            pending.pop(0)
        jdone += jserver.decode_round()
    tserver = serve.Server(tcfg, tp, slots=4, max_seq=64, device="cpu")
    tdone = tserver.serve([serve.Request(i, p, 4 + i % 3)
                           for i, p in enumerate(prompts)])
    assert [q.rid for q in tdone] == [q.rid for q in jdone]
    assert [q.out for q in tdone] == [q.out for q in jdone]


def test_parameters_round_trip_through_convert():
    jcfg, jp, tcfg, tp = _models("bf16")
    back = convert.lm_params_to_numpy(tp)
    jl = jax.tree_util.tree_leaves(jax.device_get(jp))
    tl = common.leaves(back)
    assert len(jl) == len(tl) == len(common.leaves(
        registry.param_specs(tcfg)))
    for a, b in zip(jl, tl):
        assert (np.asarray(a, np.float32) == b).all()
    assert "mlstm_tail" in tp and tp["mlstm"]["up"].dtype == torch.bfloat16


def test_train_lm_runs_xlstm_on_the_cpu(capsys):
    out = train.train_lm(ARCH, 2, batch_size=2, seq_len=12, reduced=True,
                         log_every=1, device="cpu")
    assert len(out["step_losses"]) == 2
    assert all(np.isfinite(out["step_losses"]))

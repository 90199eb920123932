"""The encoder-decoder family in repro_torch -- whisper-base's
bidirectional encoder over stub frame embeddings, its causal decoder and
cross-attention -- against the JAX package, on the CPU, at
``reduced_config``.

The JAX parameters come from ``init_params(PRNGKey(0))`` and cross into
the port through ``convert.lm_params_from_numpy``; inputs come from numpy
with a seed.  Tolerances are ``tests/test_torch_lm_family.py``'s: models
and modules at rtol = atol = 1e-4 in float32, the loss at rtol 1e-5, each
gradient leaf at rtol 1e-4, atol 1e-6; the plain flash attention at rtol
= atol = 3e-5.
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
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import encdec as jencdec
from repro.models import registry as jregistry
from repro_torch import configs, convert
from repro_torch.kernels import ops
from repro_torch.launch import serve, train
from repro_torch.models import attention, common, encdec, registry

torch.set_num_threads(1)
ARCH = "whisper-base"
TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _models(**over):
    jcfg = dataclasses.replace(jconfigs.reduced_config(ARCH),
                               dtype=jnp.float32, **over)
    tcfg = dataclasses.replace(configs.reduced_config(ARCH),
                               dtype=torch.float32, **over)
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


def _first(tree):
    if isinstance(tree, dict):
        return {k: _first(v) for k, v in tree.items()}
    return tree[0]


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
    jspecs = jax.tree_util.tree_leaves(
        jregistry.param_specs(jcfg),
        is_leaf=lambda s: isinstance(s, jcommon.ParamSpec))
    tspecs = common.leaves(registry.param_specs(tcfg))
    assert [(t.shape, t.axes, t.scale) for t in tspecs] == \
        [(j.shape, j.axes, j.scale) for j in jspecs]
    assert all(str(t.dtype).split(".")[-1] == np.dtype(j.dtype).name
               for t, j in zip(tspecs, jspecs))
    assert tcfg.param_count() == jcfg.param_count()


def test_full_model_shapes():
    cfg = configs.get_config(ARCH)
    assert cfg.param_count() == 109_749_248
    assert (cfg.encoder_layers, cfg.num_layers, cfg.encoder_seq,
            cfg.hd) == (6, 6, 1500, 64)
    cache = registry.init_cache(cfg, 4, 256, "meta")
    assert cache["self"][0].shape == (6, 4, 256, 8, 64)
    assert cache["cross_k"].shape == cache["cross_v"].shape == \
        (6, 4, 1500, 8, 64)


def test_make_train_batch_draws_frames_after_the_tokens():
    got = registry.make_train_batch(configs.reduced_config(ARCH), 3, 9, 7)
    want = jregistry.make_train_batch(jconfigs.reduced_config(ARCH), 3, 9, 7)
    assert set(got) == set(want) == {"tokens", "labels", "frames"}
    assert got["frames"].shape == (3, 12, 64)
    assert got["frames"].dtype == torch.float32
    for k in want:
        assert (got[k].numpy() == np.asarray(want[k])).all(), k


# -- attention paths -------------------------------------------------------------

def test_plain_flash_attention_bidirectional_matches_the_einsum():
    """``flash_attention_ref(causal=False)`` against the reference's
    encoder softmax (float32 einsums, no mask), grouped kv heads, and the
    backward's function."""
    r = np.random.RandomState(0)
    q = r.randn(2, 37, 4, 64).astype(np.float32)
    k, v = (r.randn(2, 37, 2, 64).astype(np.float32) for _ in range(2))
    qj, kj, vj = (jnp.asarray(t) for t in (q, k, v))
    kj, vj = jattn.repeat_kv(kj, 4), jattn.repeat_kv(vj, 4)
    s = jnp.einsum("bqhd,bkhd->bhqk", qj, kj) * 64 ** -0.5
    want = np.asarray(jnp.einsum("bhqk,bkhd->bqhd",
                                 jax.nn.softmax(s, axis=-1), vj))
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=False)
    assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-5)
    assert_allclose(ops.attention_math(_t(q), _t(k), _t(v), causal=False)
                    .numpy(), want, rtol=3e-5, atol=3e-5)
    assert_allclose(attention.bidirectional_attention(
        _t(q), *(_t(np.repeat(t, 2, axis=2)) for t in (k, v))).numpy(),
        want, rtol=3e-5, atol=3e-5)


def test_bidir_and_cross_attention_match_jax():
    jcfg, jp, tcfg, tp = _models()
    r = np.random.RandomState(1)
    x = r.randn(2, 12, tcfg.d_model).astype(np.float32)
    enc = r.randn(2, 17, tcfg.d_model).astype(np.float32)
    want = jencdec._bidir_attention(_first(jp["enc_layers"]["attn"]),
                                    jnp.asarray(x), jcfg)
    got = encdec._bidir_attention(_first(tp["enc_layers"]["attn"]), _t(x),
                                  tcfg)
    assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = jencdec._cross_attention(_first(jp["dec_layers"]["cross_attn"]),
                                    jnp.asarray(x[:, :5]), jnp.asarray(enc),
                                    jcfg)
    got = encdec._cross_attention(_first(tp["dec_layers"]["cross_attn"]),
                                  _t(x[:, :5]), _t(enc), tcfg)
    assert got.shape == (2, 5, tcfg.d_model)
    assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_encode_matches_jax():
    jcfg, jp, tcfg, tp = _models()
    jb, tb = _batches(tcfg)
    want = np.asarray(jencdec.encode(jp, jcfg, jb["frames"]))
    assert_allclose(encdec.encode(tp, tcfg, tb["frames"]).numpy(), want,
                    **TOL)


# -- whole models ---------------------------------------------------------------

def test_prefill_and_decode_match_jax():
    """Prefill logits, six decode steps' logits (against the zero cross
    cache, as the reference) and every cache leaf."""
    jcfg, jp, tcfg, tp = _models()
    jb, tb = _batches(tcfg)
    got = registry.prefill(tp, tcfg, tb)
    assert got.shape == (3, 1, tcfg.vocab_size)
    assert_allclose(got.numpy(), np.asarray(jregistry.prefill(jp, jcfg, jb)),
                    **TOL)
    jcache = jregistry.init_cache(jcfg, 3, 16)
    tcache = registry.init_cache(tcfg, 3, 16, "cpu")
    tok = tb["tokens"].numpy()
    for pos in range(6):
        step = tok[:, pos:pos + 1]
        jlog, jcache = jregistry.decode_step(jp, jcfg, jcache,
                                             jnp.asarray(step), jnp.int32(pos))
        tlog, tcache = registry.decode_step(tp, tcfg, tcache, _t(step), pos)
        assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    want = jax.tree_util.tree_leaves(jcache)
    got = _cache_leaves(tcache)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert not tcache["cross_k"].any() and not tcache["cross_v"].any()


def test_loss_and_gradients_match_jax():
    jcfg, jp, tcfg, tp = _models()
    jb, tb = _batches(tcfg, seed=5)
    want_loss = float(jregistry.loss_fn(jp, jcfg, jb))
    assert_allclose(float(registry.loss_fn(tp, tcfg, tb)), want_loss,
                    rtol=1e-5)
    want = jax.grad(lambda p: jregistry.loss_fn(p, jcfg, jb))(jp)
    loss, grads = train.value_and_grad(tp, tcfg, tb)
    assert_allclose(float(loss), want_loss, rtol=1e-5)
    want_l = jax.tree_util.tree_leaves(want)
    got_l = common.leaves(grads)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        assert g.shape == w.shape
        assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6)
    assert np.abs(grads["enc_layers"]["attn"]["wq"].numpy()).max() > 0
    assert np.abs(grads["dec_layers"]["cross_attn"]["wk"].numpy()).max() > 0


def test_loss_needs_frames():
    _, _, tcfg, tp = _models()
    _, tb = _batches(tcfg)
    with pytest.raises(KeyError, match="frames"):
        registry.loss_fn(tp, tcfg, {k: v for k, v in tb.items()
                                    if k != "frames"})


def test_server_generates_the_reference_tokens():
    """Served against the zero cross cache on both sides."""
    jcfg, jp, tcfg, tp = _models()
    r = np.random.RandomState(3)
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
    jcfg, jp, tcfg, tp = _models()
    back = convert.lm_params_to_numpy(tp)
    jl = jax.tree_util.tree_leaves(jax.device_get(jp))
    tl = common.leaves(back)
    assert len(jl) == len(tl) == len(common.leaves(
        registry.param_specs(tcfg)))
    for a, b in zip(jl, tl):
        assert (np.asarray(a, np.float32) == b).all()

"""The hybrid family in repro_torch -- zamba2-7b's Mamba2 (SSD) layers and
its shared attention block, with and without the long-context sliding
window -- against the JAX package, on the CPU, at ``reduced_config``.

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
from repro.models import hybrid as jhybrid
from repro.models import registry as jregistry
from repro.models import ssm as jssm
from repro_torch import configs, convert
from repro_torch.kernels import ops
from repro_torch.launch import serve, train
from repro_torch.models import common, hybrid, registry, ssm

torch.set_num_threads(1)
ARCH = "zamba2-7b"
WINDOW = {"sliding_window": 3}
TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _models(**over):
    """(JAX cfg, JAX params, port cfg, port params) in float32: one set of
    weights, drawn by the JAX package and carried across."""
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
    """A port cache's tensors in ``jax.tree_util.tree_leaves`` order (dict
    keys sorted, tuples in order, None an empty subtree)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _cache_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _cache_leaves(t)]
    return [] if tree is None else [tree]


def _spec_table(specs):
    def name(dt):
        return (str(dt).split(".")[-1] if isinstance(dt, torch.dtype)
                else np.dtype(dt).name)

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from walk(tree[k], f"{prefix}/{k}")
        else:
            yield (prefix, tuple(tree.shape), name(tree.dtype), tree.axes,
                   tree.scale)
    return list(walk(specs, ""))


def _layer0(tree):
    return jax.tree_util.tree_map(lambda a: a[0, 0], tree)


# -- config, specs, the full model's shapes -------------------------------------

def test_config_matches_the_reference():
    for get in ("get_config", "reduced_config"):
        a = getattr(jconfigs, get)(ARCH)
        b = getattr(configs, get)(ARCH)
        for f in dataclasses.fields(b):
            if f.name != "dtype":
                assert getattr(b, f.name) == getattr(a, f.name), f.name
    assert configs.long_context_overrides(ARCH) == \
        jconfigs.long_context_overrides(ARCH) == {"sliding_window": 4096}
    assert configs.supported_shapes(configs.get_config(ARCH)) == \
        jconfigs.supported_shapes(jconfigs.get_config(ARCH))


@pytest.mark.parametrize("get", ["reduced_config", "get_config"])
def test_spec_tree_and_param_count_match_jax(get):
    jcfg, tcfg = getattr(jconfigs, get)(ARCH), getattr(configs, get)(ARCH)
    assert _spec_table(registry.param_specs(tcfg)) == \
        _spec_table(jregistry.param_specs(jcfg))
    assert tcfg.param_count() == jcfg.param_count()


def test_full_model_groups_heads_and_caches():
    """81 = 13 groups x 6 + a tail of 3; head dim 3584 / 32 = 112; one KV
    cache per shared-block invocation (nothing allocated)."""
    cfg = configs.get_config(ARCH)
    assert cfg.param_count() == 6_751_130_832
    assert hybrid._groups(cfg) == (13, 6, 3) and cfg.hd == 112
    specs = registry.param_specs(cfg)
    assert specs["mamba_groups"]["in_proj"].shape == (13, 6, 3584, 14576)
    assert specs["mamba_tail"]["in_proj"].shape == (3, 3584, 14576)
    assert ssm.ssm_dims(cfg) == (7168, 112, 64)
    cache = registry.init_cache(cfg, 2, 1024, "meta")
    assert cache["attn_k"].shape == cache["attn_v"].shape == \
        (13, 2, 1024, 32, 112)
    assert cache["ssm_groups"]["state"].shape == (13, 6, 2, 112, 64, 64)
    assert cache["ssm_groups"]["conv"].shape == (13, 6, 2, 3, 7296)
    assert cache["ssm_tail"]["state"].shape == (3, 2, 112, 64, 64)
    shapes = [tuple(s.shape) for s in _cache_leaves(cache)]
    want = [tuple(a.shape) for a in jax.tree_util.tree_leaves(
        jax.eval_shape(lambda: jregistry.init_cache(
            jconfigs.get_config(ARCH), 2, 1024)))]
    assert shapes == want


# -- the SSD layer on its own -----------------------------------------------------

def test_causal_conv_matches_jax():
    r = np.random.RandomState(0)
    x, w, b = r.randn(2, 9, 12), r.randn(4, 12), r.randn(12)
    x, w, b = (a.astype(np.float32) for a in (x, w, b))
    want = np.asarray(jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                        jnp.asarray(b)))
    assert_allclose(ssm._causal_conv(_t(x), _t(w), _t(b)).numpy(), want,
                    rtol=1e-5, atol=1e-6)


# S below, equal to, and not a multiple of the chunk (8), and two chunks.
@pytest.mark.parametrize("S", [5, 8, 13, 16])
def test_ssd_forward_matches_jax(S):
    jcfg, jp, tcfg, tp = _models(ssm_chunk=8)
    x = np.random.RandomState(S).randn(2, S, tcfg.d_model).astype(np.float32)
    want = np.asarray(jssm.ssd_forward(_layer0(jp["mamba_groups"]),
                                       jnp.asarray(x), jcfg))
    got = ssm.ssd_forward(hybrid._layer(tp["mamba_groups"], (0, 0)), _t(x),
                          tcfg)
    assert got.shape == (2, S, tcfg.d_model)
    assert_allclose(got.numpy(), want, **TOL)


def test_ssd_decode_matches_jax():
    """Six one-token steps from a zero cache: outputs, state and conv
    buffer; and the steps reproduce the chunked forward's outputs."""
    jcfg, jp, tcfg, tp = _models(ssm_chunk=4)
    jl, tl = _layer0(jp["mamba_groups"]), hybrid._layer(tp["mamba_groups"],
                                                       (0, 0))
    x = np.random.RandomState(1).randn(2, 6, tcfg.d_model).astype(np.float32)
    jc = jax.tree_util.tree_map(lambda a: a[0],
                                jssm.init_ssm_cache(jcfg, 2, 1))
    tc = {k: v[0] for k, v in ssm.init_ssm_cache(tcfg, 2, 1, "cpu").items()}
    outs = []
    for t in range(6):
        jo, jc = jssm.ssd_decode(jl, jnp.asarray(x[:, t:t + 1]), jc, jcfg)
        to, tc = ssm.ssd_decode(tl, _t(x[:, t:t + 1]), tc, tcfg)
        assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        outs.append(to)
    for k in ("state", "conv"):
        assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **TOL)
    assert_allclose(torch.cat(outs, 1).numpy(),
                    ssm.ssd_forward(tl, _t(x), tcfg).numpy(), **TOL)


# -- the plain flash attention's window -----------------------------------------

@pytest.mark.parametrize("window", [1, 3, 36])
def test_plain_flash_attention_window_matches_jax(window):
    """``flash_attention_ref(window=W)`` against the reference's
    ``chunked_causal_attention(sliding_window=W)`` at W = 1, 3 and S - 1,
    grouped kv heads, and the backward's function."""
    r = np.random.RandomState(window)
    q = r.randn(2, 37, 4, 112).astype(np.float32)
    k, v = (r.randn(2, 37, 2, 112).astype(np.float32) for _ in range(2))
    want = np.asarray(jattn.chunked_causal_attention(
        jnp.asarray(q), *(jnp.repeat(jnp.asarray(t), 2, axis=2)
                          for t in (k, v)), chunk=16, sliding_window=window))
    got = ops.flash_attention(_t(q), _t(k), _t(v), window=window)
    assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-5)
    assert_allclose(ops.attention_math(_t(q), _t(k), _t(v), window=window)
                    .numpy(), want, rtol=3e-5, atol=3e-5)


# -- whole models ---------------------------------------------------------------

@pytest.mark.parametrize("over", [{}, WINDOW], ids=["causal", "window"])
def test_prefill_and_decode_match_jax(over):
    """Prefill logits, six decode steps' logits and every cache leaf."""
    jcfg, jp, tcfg, tp = _models(**over)
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
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("over", [{}, WINDOW], ids=["causal", "window"])
def test_loss_and_gradients_match_jax(over):
    jcfg, jp, tcfg, tp = _models(**over)
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
    assert np.abs(grads["shared_attn"]["attn"]["wq"].numpy()).max() > 0


class _ExpBelow80:
    """``jax.numpy`` with an exp whose argument is clipped at 80: the
    reference's SSD with the port's mask-before-exp.  Every exp the
    reference's SSD keeps has an argument <= 0 (``A`` < 0, ``dt`` > 0), so
    its values are unchanged; the entries above the diagonal, which
    ``where`` discards, stay finite, and their gradient is 0 instead of
    0 * inf."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def exp(x):
        return jnp.exp(jnp.minimum(x, 80.0))


def test_gradient_is_finite_where_the_reference_overflows(monkeypatch):
    """At a 32-token chunk the reference's ``where(causal, exp(seg), 0)``
    overflows above the diagonal and its gradient is NaN (0 * inf); the
    port masks before the exp: the same loss, a finite gradient, equal to
    the reference's at every element where that is finite, and every leaf
    equal to the reference's through an exp that cannot overflow."""
    jcfg, jp, tcfg, tp = _models()
    jb, tb = _batches(tcfg, B=4, S=32, seed=0)
    want_loss = float(jregistry.loss_fn(jp, jcfg, jb))
    want = jax.tree_util.tree_leaves(
        jax.grad(lambda p: jregistry.loss_fn(p, jcfg, jb))(jp))
    assert any(bool(jnp.isnan(g).any()) for g in want)
    loss, grads = train.value_and_grad(tp, tcfg, tb)
    assert_allclose(float(loss), want_loss, rtol=1e-5)
    got = [g.numpy() for g in common.leaves(grads)]
    assert len(got) == len(want)
    assert all(np.isfinite(g).all() for g in got)
    for g, w in zip(got, want):
        w = np.asarray(w)
        finite = np.isfinite(w)
        assert_allclose(g[finite], w[finite], rtol=1e-4, atol=1e-6)
    monkeypatch.setattr(jssm, "jnp", _ExpBelow80())
    assert_allclose(float(jregistry.loss_fn(jp, jcfg, jb)), want_loss,
                    rtol=1e-6)
    witness = jax.tree_util.tree_leaves(
        jax.grad(lambda p: jregistry.loss_fn(p, jcfg, jb))(jp))
    for g, w in zip(got, witness):
        assert g.shape == w.shape
        assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-6)


def test_window_changes_the_model():
    """The override reaches the shared attention: at S = 10 a 3-key window
    gives other logits than full causal attention."""
    _, _, tcfg, tp = _models()
    _, tb = _batches(tcfg)
    assert not torch.allclose(
        registry.prefill(tp, tcfg, tb),
        registry.prefill(tp, dataclasses.replace(tcfg, **WINDOW), tb))


def test_server_generates_the_reference_tokens():
    jcfg, jp, tcfg, tp = _models()
    r = np.random.RandomState(1)
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
    assert tp["mamba_groups"]["A_log"].dtype == torch.float32
    bf = convert.lm_params_from_numpy(
        jax.device_get(jcommon.init_params(
            jregistry.param_specs(jconfigs.reduced_config(ARCH)),
            jax.random.PRNGKey(1))), configs.reduced_config(ARCH), "cpu")
    assert bf["mamba_groups"]["in_proj"].dtype == torch.bfloat16
    assert bf["mamba_groups"]["D"].dtype == torch.float32


def test_make_train_batch_matches_reference():
    got = registry.make_train_batch(configs.reduced_config(ARCH), 3, 9, 7)
    want = jregistry.make_train_batch(jconfigs.reduced_config(ARCH), 3, 9, 7)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in want:
        assert (got[k].numpy() == np.asarray(want[k])).all()


def test_jax_module_layout_matches():
    """The port's group split is the reference's."""
    for cfg, jcfg in ((configs.get_config(ARCH), jconfigs.get_config(ARCH)),
                      (configs.reduced_config(ARCH),
                       jconfigs.reduced_config(ARCH))):
        assert hybrid._groups(cfg) == jhybrid._groups(jcfg)

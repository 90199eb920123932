"""bf16 attention scores (``attn_score_dtype="bf16"``) in repro_torch
against the JAX package, on the CPU.

The reference takes the (chunk, S) score slab in bf16 through the softmax
(``repro/models/attention.py:81-124``); the port's
``chunked_causal_attention`` does the same, and B5's plain version
(``kernels/ref.py``) takes the scores as the kernel's bf16-score build:
rounded to bf16 after the product and after the bf16 scale, then a
float32 softmax.  Tolerances: the two packages' bf16 score slabs at a
relative L2 error of 2^-7 over the output (the softmax's bf16 roundings
land at different places); B5's plain version against the bf16 slab at
2e-2 (its softmax is float32, the reference's bf16); whole-model losses
at rtol 2e-3, as ``tests/test_torch_lm_family.py``'s bf16 losses; the
autograd Function's gradient equal to autograd of the math it names.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import registry as jregistry
from repro_torch import configs, convert
from repro_torch.kernels import ops, ref
from repro_torch.models import attention, registry

torch.set_num_threads(1)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _qkv(B, S, H, D, Dv=None, seed=0):
    r = np.random.RandomState(seed)
    return (r.randn(B, S, H, D).astype(np.float32),
            r.randn(B, S, H, D).astype(np.float32),
            r.randn(B, S, H, Dv or D).astype(np.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("S,chunk,window", [(12, 5, 0), (12, 12, 4),
                                            (40, 16, 0), (33, 8, 7)])
def test_chunked_attention_bf16_scores_match_jax(dtype, S, chunk, window):
    q, k, v = _qkv(2, S, 3, 16, seed=S + window)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = jattn.chunked_causal_attention(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), chunk, window,
        score_dtype="bf16")
    got = attention.chunked_causal_attention(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), chunk, window,
        score_dtype="bf16")
    assert got.dtype == tdt and got.shape == (2, S, 3, 16)
    rel = _rel(got.float().numpy(), np.asarray(want, np.float32))
    assert rel <= 2.0 ** -7, rel
    # The bf16 slab is not the float32 one.
    f32 = attention.chunked_causal_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), chunk, window)
    assert not torch.equal(got.float(), f32)


@pytest.mark.parametrize("D,Dv,window", [(16, 16, 0), (16, 16, 5),
                                          (24, 16, 0)])
def test_plain_flash_attention_bf16_scores_match_jax(D, Dv, window):
    q, k, v = _qkv(2, 20, 4, D, Dv, seed=7)
    want = np.asarray(jattn.chunked_causal_attention(
        *(jnp.asarray(a) for a in (q, k, v)), 8, window,
        score_dtype="bf16"), np.float32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = ref.flash_attention_ref(tq, tk, tv, window=window,
                                  score_dtype="bf16")
    assert got.dtype == torch.float32 and got.shape == (2, 20, 4, Dv)
    assert _rel(got.numpy(), want) <= 2e-2
    # The scores are rounded as the kernel's build rounds them: a bf16
    # product, times the bf16 scale, rounded again.
    bh = lambda t: t.transpose(1, 2).reshape(8, 20, -1)   # noqa: E731
    qb, kb = bh(tq).bfloat16(), bh(tk).bfloat16()
    s = (qb.float() @ kb.float().transpose(1, 2)).bfloat16()
    s = (s.float() * float(torch.tensor(D ** -0.5).bfloat16())).bfloat16()
    row = torch.arange(20)[:, None]
    col = torch.arange(20)[None]
    mask = row >= col
    if window:
        mask &= col > row - window
    p = torch.softmax(s.float().masked_fill(~mask, ref.INVALID_SCORE), -1)
    emu = (p @ bh(tv).bfloat16().float()).reshape(2, 4, 20, Dv)
    torch.testing.assert_close(got, emu.transpose(1, 2), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="causal or windowed"):
        ref.flash_attention_ref(tq, tk, tq, causal=False, score_dtype="bf16")


def test_flash_attention_function_backward_is_the_bf16_math():
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(2, 12, 4, 16, seed=3))
    out = ops.FlashAttention.apply(q, k, v, None, 3, True, "bf16")
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    got = torch.autograd.grad(out, (q, k, v), g)
    want = torch.autograd.grad(
        ops.attention_math(q, k, v, None, 3, True, "bf16"), (q, k, v), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    f32 = torch.autograd.grad(ops.attention_math(q, k, v, None, 3), (q, k, v),
                              g)
    assert not torch.equal(got[0], f32[0])
    with pytest.raises(ValueError, match="causal or windowed"):
        ops.attention_math(q, k, v, causal=False, score_dtype="bf16")


@pytest.mark.parametrize("arch,over", [
    ("qwen2-0.5b", {}), ("deepseek-v3-671b", {}),
    ("zamba2-7b", {"sliding_window": 3}), ("whisper-base", {})])
def test_loss_fn_at_bf16_scores_matches_jax(arch, over):
    over = dict(over, attn_score_dtype="bf16")
    jcfg = dataclasses.replace(jconfigs.reduced_config(arch),
                               dtype=jnp.float32, **over)
    tcfg = dataclasses.replace(configs.reduced_config(arch),
                               dtype=torch.float32, **over)
    jp = jcommon.init_params(jregistry.param_specs(jcfg),
                             jax.random.PRNGKey(0))
    tp = convert.lm_params_from_numpy(jax.device_get(jp), tcfg, "cpu")
    tb = registry.make_train_batch(tcfg, 2, 12, 4)
    jb = {k: jnp.asarray(v.numpy()) for k, v in tb.items()}
    want = float(jregistry.loss_fn(jp, jcfg, jb))
    got = float(registry.loss_fn(tp, tcfg, tb))
    assert_allclose(got, want, rtol=2e-3)
    f32 = float(registry.loss_fn(tp, dataclasses.replace(
        tcfg, attn_score_dtype="f32"), tb))
    assert got != f32

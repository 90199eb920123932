"""The rest of the transformer family in repro_torch -- MLA and MTP
(deepseek-v3-671b), the vision stub (internvl2-76b) and the dense
minitron-8b, mistral-nemo-12b and qwen2.5-14b -- against the JAX package,
on the CPU, at each arch's ``reduced_config``.

The JAX parameters come from ``init_params(PRNGKey(0))`` and cross into
the port through ``convert.lm_params_from_numpy``; inputs come from numpy
with a seed.  Tolerances are those of ``tests/test_torch_lm.py``: whole
models at rtol = atol = 1e-4 in float32, and in bfloat16 at a relative L2
error of 2e-2 over the tensor (the two packages round bf16 values at
different places); the loss at rtol 1e-5 and each gradient leaf at rtol
1e-4, atol 1e-6 in float32, as ``tests/test_torch_train.py``; the plain
flash attention at rtol = atol = 3e-5.
"""
import dataclasses
import math

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
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro_torch import configs, convert
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ops
from repro_torch.launch import serve, train
from repro_torch.models import common, moe, registry, transformer

torch.set_num_threads(1)
ARCHS = ("deepseek-v3-671b", "internvl2-76b", "minitron-8b",
         "mistral-nemo-12b", "qwen2.5-14b")
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _f32(a):
    return np.asarray(a, np.float32)


def _models(arch, dtype="f32", **over):
    """(JAX cfg, JAX params, port cfg, port params): one set of weights,
    drawn by the JAX package and carried across."""
    jdt, tdt = DTYPES[dtype]
    jcfg = dataclasses.replace(jconfigs.reduced_config(arch), dtype=jdt,
                               **over)
    tcfg = dataclasses.replace(configs.reduced_config(arch), dtype=tdt,
                               **over)
    jp = jcommon.init_params(jregistry.param_specs(jcfg),
                             jax.random.PRNGKey(0))
    tp = convert.lm_params_from_numpy(jax.device_get(jp), tcfg, "cpu")
    return jcfg, jp, tcfg, tp


def _batches(cfg, B=3, S=10, seed=0):
    """The reference's batch (jnp) and the port's (torch) from one draw."""
    tb = registry.make_train_batch(cfg, B, S, seed)
    return {k: jnp.asarray(v.numpy()) for k, v in tb.items()}, tb


def _assert_close(got, want, dtype):
    if dtype == "f32":
        assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        assert rel <= 2e-2, (rel, float(np.abs(got - want).max()))


def _spec_table(specs):
    """[(path, shape, dtype name, axes, scale)] in the flattening order."""
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


# -- configs and parameter specs ----------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_reference(arch):
    for get in ("get_config", "reduced_config"):
        a = getattr(jconfigs, get)(arch)
        b = getattr(configs, get)(arch)
        for f in dataclasses.fields(b):
            if f.name != "dtype":
                assert getattr(b, f.name) == getattr(a, f.name), f.name
        assert b.dtype == torch.bfloat16
    assert configs.supported_shapes(configs.get_config(arch)) == \
        jconfigs.supported_shapes(jconfigs.get_config(arch))
    assert configs.long_context_overrides(arch) == \
        jconfigs.long_context_overrides(arch)


def test_shape_cells_match_the_reference():
    assert set(configs.SHAPES) == set(jconfigs.SHAPES)
    for name, cell in configs.SHAPES.items():
        assert dataclasses.asdict(cell) == dataclasses.asdict(
            jconfigs.SHAPES[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_tree_and_param_count_match_jax(arch):
    for get in ("reduced_config", "get_config"):
        jcfg = getattr(jconfigs, get)(arch)
        tcfg = getattr(configs, get)(arch)
        want = _spec_table(jregistry.param_specs(jcfg))
        got = _spec_table(registry.param_specs(tcfg))
        assert got == want
    full = configs.get_config(arch)
    assert full.param_count() == jconfigs.get_config(arch).param_count()
    assert full.param_count() == sum(
        math.prod(s.shape) for s in common.leaves(registry.param_specs(full)))


def test_deepseek_capacity_at_the_smoke_shapes():
    cfg = configs.get_config("deepseek-v3-671b")
    assert moe.capacity(cfg, 4) == 1               # decode, 4 slots
    assert moe.capacity(cfg, 2 * 1024) == 64       # prefill of 2 x 1024


# -- the plain flash attention at DQK != DV -----------------------------------

@pytest.mark.parametrize("D,Dv", [(24, 16), (192, 128)])
def test_plain_flash_attention_with_its_own_v_head_dim_matches_jax(D, Dv):
    r = np.random.RandomState(D)
    q = r.randn(2, 37, 4, D).astype(np.float32)
    k = r.randn(2, 37, 2, D).astype(np.float32)
    v = r.randn(2, 37, 2, Dv).astype(np.float32)
    want = np.asarray(jattn.chunked_causal_attention(
        jnp.asarray(q), *(jnp.repeat(jnp.asarray(t), 2, axis=2)
                          for t in (k, v)), chunk=16))
    got = ops.flash_attention(_t(q), _t(k), _t(v))
    assert got.shape == (2, 37, 4, Dv)
    assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-5)
    # (BH, S, D) q, k with (BH, S, Dv) v, and the backward's function.
    flat = [_t(t[:, :, 0]) for t in (q, k, v)]
    want0 = np.asarray(jattn.chunked_causal_attention(
        *(jnp.asarray(t[:, :, :1]) for t in (q, k, v)), chunk=16))[:, :, 0]
    assert_allclose(ops.flash_attention(*flat).numpy(), want0, rtol=3e-5,
                    atol=3e-5)
    assert_allclose(ops.attention_math(_t(q), _t(k), _t(v)).numpy(), want,
                    rtol=3e-5, atol=3e-5)


def test_flash_attention_builds_and_their_shared_memory():
    for D in (16, 64, 100, 128):
        p = kfa.plan(D, D, 1024, torch.bfloat16)
        assert p["path"] == "mma" and p["dq"] == p["dv"] >= D
    p = kfa.plan(192, 128, 1024, torch.bfloat16)
    assert (p["dq"], p["dv"], p["rows"], p["bk"]) == (192, 128, 64, 64)
    assert p["smem"] == 111616 <= kfa.SMEM_LIMIT
    assert kfa.plan(24, 16, 12, torch.bfloat16)["dq"] == 192
    assert kfa.plan(24, 16, 12, torch.float32)["path"] == "fma"
    for D, Dv, dt in ((129, 129, torch.bfloat16), (193, 128, torch.bfloat16),
                      (192, 160, torch.bfloat16), (16, 24, torch.bfloat16),
                      (192, 128, torch.float32)):
        with pytest.raises(ValueError, match="head dim"):
            kfa.plan(D, Dv, 64, dt)
    with pytest.raises(ValueError, match="CUDA"):
        kfa.flash_attention(*(torch.zeros(1, 4, 1, 8) for _ in range(3)))


# -- whole models -----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_backbone_prefill_and_decode_match_jax(arch, dtype):
    jcfg, jp, tcfg, tp = _models(arch, dtype)
    jb, tb = _batches(tcfg)
    jx, jpos = jtransformer._embed_inputs(jp, jcfg, jb)
    tx, tpos = transformer._embed_inputs(tp, tcfg, tb)
    _assert_close(_f32(tx.float()), _f32(jx), dtype)
    want = _f32(jtransformer.backbone(jp, jcfg, jx, jpos))
    got = _f32(transformer.backbone(tp, tcfg, tx, tpos).float())
    assert got.shape == (3, 10, tcfg.d_model)
    _assert_close(got, want, dtype)
    got = _f32(registry.prefill(tp, tcfg, tb).float())
    assert got.shape == (3, 1, tcfg.vocab_size)
    _assert_close(got, _f32(jregistry.prefill(jp, jcfg, jb)), dtype)

    jcache = jregistry.init_cache(jcfg, 3, 16)
    tcache = registry.init_cache(tcfg, 3, 16, "cpu")
    tok = tb["tokens"].numpy()
    for pos in range(4):
        step = tok[:, pos:pos + 1]
        jlog, jcache = jregistry.decode_step(jp, jcfg, jcache,
                                             jnp.asarray(step), jnp.int32(pos))
        tlog, tcache = registry.decode_step(tp, tcfg, tcache, _t(step), pos)
        assert tlog.shape == (3, 1, tcfg.vocab_size)
        _assert_close(_f32(tlog.float()), _f32(jlog), dtype)
    for name in tcache:
        for got, want in zip(tcache[name], jcache[name]):
            assert tuple(got.shape) == tuple(want.shape)
            _assert_close(_f32(got.float()), _f32(want), dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_jax(arch, dtype):
    jcfg, jp, tcfg, tp = _models(arch, dtype)
    jb, tb = _batches(tcfg, seed=3)
    want = float(jregistry.loss_fn(jp, jcfg, jb))
    got = float(registry.loss_fn(tp, tcfg, tb))
    assert_allclose(got, want, rtol=1e-5 if dtype == "f32" else 2e-3)
    if tcfg.mtp:   # the MTP term is in: the loss without it is lower
        plain = dataclasses.replace(jcfg, mtp=False)
        assert want > float(jregistry.loss_fn(
            {k: v for k, v in jp.items() if k != "mtp"}, plain, jb))


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "internvl2-76b"])
def test_gradients_match_jax_grad(arch):
    jcfg, jp, tcfg, tp = _models(arch)
    jb, tb = _batches(tcfg, seed=5)
    want = jax.grad(lambda p: jregistry.loss_fn(p, jcfg, jb))(jp)
    loss, grads = train.value_and_grad(tp, tcfg, tb)
    assert_allclose(float(loss), float(jregistry.loss_fn(jp, jcfg, jb)),
                    rtol=1e-5)
    want_l = [np.asarray(x) for x in jax.tree_util.tree_leaves(want)]
    got_l = [g.numpy() for g in common.leaves(grads)]
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        assert g.shape == w.shape
        assert_allclose(g, w, rtol=1e-4, atol=1e-6)
    if tcfg.mtp:
        assert np.abs(grads["mtp"]["proj"].numpy()).max() > 0
    if tcfg.vision_tokens:
        assert np.abs(grads["vision_proj"].numpy()).max() > 0


def test_mla_absorbed_decode_reproduces_prefill():
    """Teacher-forced absorbed decode against the compressed cache gives
    prefill's last-position logits (MLA without MoE routing, whose
    capacity differs between one token and a sequence)."""
    cfg = dataclasses.replace(configs.reduced_config("deepseek-v3-671b"),
                              moe=False, dtype=torch.float32)
    g = torch.Generator("cpu")
    g.manual_seed(0)
    p = common.init_params(registry.param_specs(cfg), g, "cpu")
    B, S = 2, 8
    batch = registry.make_train_batch(cfg, B, S, 0)
    last = registry.prefill(p, cfg, batch)[:, -1]
    cache = registry.init_cache(cfg, B, S, "cpu")
    assert [tuple(c.shape) for c in cache["layers"]] == [
        (cfg.num_layers, B, S, cfg.kv_lora_rank),
        (cfg.num_layers, B, S, cfg.qk_rope_dim)]
    for t in range(S):
        logits, cache = registry.decode_step(p, cfg, cache,
                                             batch["tokens"][:, t:t + 1], t)
    assert_allclose(logits[:, 0].numpy(), last.numpy(), rtol=1e-4,
                    atol=1e-4)


@pytest.mark.parametrize("impl_arch", ["deepseek-v3-671b", "minitron-8b"])
def test_stub_attention_probe_matches_jax(impl_arch):
    jcfg, jp, tcfg, tp = _models(impl_arch, attn_impl="stub")
    jb, tb = _batches(tcfg)
    want = _f32(jregistry.prefill(jp, jcfg, jb))
    got = _f32(registry.prefill(tp, tcfg, tb))
    _assert_close(got, want, "f32")


def test_server_generates_the_reference_tokens_on_deepseek():
    jcfg, jp, tcfg, tp = _models("deepseek-v3-671b")
    r = np.random.RandomState(1)
    prompts = [r.randint(0, tcfg.vocab_size, size=int(n))
               for n in r.randint(1, 6, size=6)]
    jserver = jserve.Server(jcfg, jp, slots=4, max_seq=64)
    jreqs = [jserve.Request(i, p, 4 + i % 3) for i, p in enumerate(prompts)]
    pending, jdone = list(jreqs), []
    while pending or any(jserver.active):
        while pending and jserver.add(pending[0]):
            pending.pop(0)
        jdone += jserver.decode_round()
    tserver = serve.Server(tcfg, tp, slots=4, max_seq=64, device="cpu")
    tdone = tserver.serve([serve.Request(i, p, 4 + i % 3)
                           for i, p in enumerate(prompts)])
    assert [q.rid for q in tdone] == [q.rid for q in jdone]
    assert [q.out for q in tdone] == [q.out for q in jdone]
    assert tserver.pos == jserver.pos == tserver.rounds


@pytest.mark.parametrize("arch", ARCHS)
def test_make_train_batch_matches_reference(arch):
    cfg = configs.reduced_config(arch)
    got = registry.make_train_batch(cfg, 3, 9, 7)
    want = jregistry.make_train_batch(jconfigs.reduced_config(arch), 3, 9, 7)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == {"int32": torch.int32,
                                "float32": torch.float32}[str(want[k].dtype)]
        assert (got[k].numpy() == np.asarray(want[k])).all(), k
    assert ("vision_embeds" in got) == (cfg.family == "vlm")


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "internvl2-76b"])
def test_bf16_parameters_round_trip_through_convert(arch):
    jcfg, jp, tcfg, tp = _models(arch, "bf16")
    host = jax.device_get(jp)
    back = convert.lm_params_to_numpy(tp)
    jl = jax.tree_util.tree_leaves(host)
    tl = common.leaves(back)
    assert len(jl) == len(tl) == len(common.leaves(
        registry.param_specs(tcfg)))
    for a, b in zip(jl, tl):
        assert (np.asarray(a, np.float32) == b).all()
    assert ("mtp" in tp) == tcfg.mtp
    assert ("vision_proj" in tp) == bool(tcfg.vision_tokens)


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "internvl2-76b"])
def test_train_lm_runs_the_new_archs_on_the_cpu(arch, capsys):
    out = train.train_lm(arch, 2, batch_size=2, seq_len=12, reduced=True,
                         log_every=1, device="cpu")
    assert len(out["step_losses"]) == 2
    assert all(np.isfinite(out["step_losses"]))


def test_serve_main_serves_reduced_deepseek(capsys):
    serve.main(["--arch", "deepseek-v3-671b", "--requests", "3",
                "--max-new", "4", "--slots", "2", "--device", "cpu"])
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out

"""The LM substrate of repro_torch (models, configs, the SSVM head on
backbone features, the serving loop) vs the JAX package, on the CPU.

Inputs come from numpy with a seed; the JAX parameters come from
``init_params(PRNGKey(0))`` and cross into the port through
``convert.lm_params_from_numpy``; the JAX package runs unchanged (its
Pallas kernels in interpret mode or through their jnp references, as its
own tests run them).  Tolerances: kernel plain versions at the reference
tests' own (moe_ffn 2e-4, flash attention 3e-4); MoE routing in float32
at 1e-5 with equal kept sets; whole models at rtol 1e-4 in float32, and
in bfloat16 at a relative L2 error of 2e-2 over the tensor (the two round
bf16 values at different places: per layer on equal inputs they agree to
about one bf16 ulp, but XLA keeps some fused bf16 intermediates in float32
while the port rounds each op, and the final RMS norm scales the residual
stream's last-bit differences up ~25x, so single elements of a 4-layer
model differ by up to ~2.4 % of the tensor's largest value); Solver
traces with equal counts and duals at rtol 1e-4.
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
from repro.api import RunConfig as JRunConfig
from repro.api import Solver as JSolver
from repro.core.selection import CostModel as JCostModel
from repro.kernels import flash_attention as jfa
from repro.kernels import moe_ffn as jmf
from repro.kernels import ref as jref
from repro.launch import serve as jserve
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro.trainer import ssvm_head as jhead
from repro_torch import configs, convert
from repro_torch.api import CostModel, RunConfig, Solver
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import attention, common, moe, registry, transformer
from repro_torch.trainer.ssvm_head import backbone_chain_problem, \
    tagging_task

torch.set_num_threads(1)
ARCHS = ("olmoe-1b-7b", "qwen2-0.5b")
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _models(arch, dtype="f32"):
    """(JAX cfg, JAX params, port cfg, port params): one set of weights,
    drawn by the JAX package and carried across."""
    jdt, tdt = DTYPES[dtype]
    jcfg = dataclasses.replace(jconfigs.reduced_config(arch), dtype=jdt)
    tcfg = dataclasses.replace(configs.reduced_config(arch), dtype=tdt)
    jp = jcommon.init_params(jregistry.param_specs(jcfg),
                             jax.random.PRNGKey(0))
    tp = convert.lm_params_from_numpy(jax.device_get(jp), tcfg, "cpu")
    return jcfg, jp, tcfg, tp


def _tokens(n, L, vocab, seed=0):
    """Token rows with exact duplicates and shared first tokens, so MoE
    gates tie (equal hidden states at equal positions)."""
    r = np.random.RandomState(seed)
    tok = r.randint(0, vocab, (n, L)).astype(np.int32)
    tok[1] = tok[0]
    tok[2:, 0] = tok[0, 0]
    return tok


def _f32(a):
    return np.asarray(a, np.float32)


def _assert_close(got, want, dtype):
    if dtype == "f32":
        assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        assert rel <= 2e-2, (rel, float(np.abs(got - want).max()))


# -- the kernels' plain versions ----------------------------------------------

@pytest.mark.parametrize("E,C,D,F", [(2, 8, 64, 32), (3, 130, 128, 300)])
def test_moe_ffn_ref_matches_jax(E, C, D, F):
    r = np.random.RandomState(E * C + F)
    xs = r.randn(E, C, D).astype(np.float32)
    wg, wu = (r.randn(E, D, F).astype(np.float32) * 0.1 for _ in range(2))
    wd = r.randn(E, F, D).astype(np.float32) * 0.1
    got = ops.moe_ffn(*map(_t, (xs, wg, wu, wd))).numpy()
    args = [jnp.asarray(a) for a in (xs, wg, wu, wd)]
    tol = dict(rtol=2e-4, atol=2e-4)
    assert_allclose(got, np.asarray(jref.moe_ffn_ref(*args)), **tol)
    assert_allclose(got, np.asarray(jmf.moe_ffn(
        *args, block_c=64, block_f=128, interpret=True)), **tol)


@pytest.mark.parametrize("bh,s,d", [(1, 64, 32), (2, 200, 64), (4, 128, 128)])
def test_flash_attention_ref_matches_jax(bh, s, d):
    r = np.random.RandomState(bh + s + d)
    q, k, v = (r.randn(bh, s, d).astype(np.float32) for _ in range(3))
    got = ops.flash_attention(_t(q), _t(k), _t(v)).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tol = dict(rtol=3e-4, atol=3e-4)
    assert_allclose(got, np.asarray(jfa.flash_attention(
        jq, jk, jv, interpret=True, block_q=64, block_k=64)), **tol)
    # The model's attention on (B, S, H, hd) = (bh, s, 1, d).
    chunked = jattn.chunked_causal_attention(
        jq[:, :, None], jk[:, :, None], jv[:, :, None], chunk=48)
    assert_allclose(got, np.asarray(chunked)[:, :, 0], **tol)


def test_grouped_flash_attention_matches_the_port_chunked_attention():
    """The 4-D form reads kv head h // (H / K): equal to repeating k, v
    and running the model's chunked attention."""
    r = np.random.RandomState(7)
    q = _t(r.randn(2, 37, 6, 16).astype(np.float32))
    k, v = (_t(r.randn(2, 37, 2, 16).astype(np.float32)) for _ in range(2))
    got = ops.flash_attention(q, k, v)
    want = attention.chunked_causal_attention(
        q, attention.repeat_kv(k, 6), attention.repeat_kv(v, 6), chunk=16)
    assert got.shape == q.shape
    assert_allclose(got.numpy(), want.numpy(), rtol=3e-5, atol=3e-5)


# -- the MoE layer ----------------------------------------------------------

def _jax_route(p, xf, cfg):
    """The reference's routing (repro/models/moe.py:50-61)."""
    T, E, k = xf.shape[0], cfg.num_experts, cfg.experts_per_token
    logits = jnp.einsum("td,de->te", xf.astype(jnp.float32), p["router"])
    topv, topi = jax.lax.top_k(logits, k)
    gates = jnp.zeros((T, E), jnp.float32).at[
        jnp.arange(T)[:, None], topi].set(jax.nn.softmax(topv, axis=-1))
    C = max(1, int(T * k * cfg.capacity_factor) // E)
    return jax.lax.top_k(gates.T, C)


def test_moe_forward_with_duplicate_rows_matches_jax():
    jcfg, jp, tcfg, tp = _models("olmoe-1b-7b")
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["moe_layers"]["moe"])
    tl = {k: v[0] for k, v in tp["moe_layers"]["moe"].items()}
    r = np.random.RandomState(3)
    base = r.randn(5, tcfg.d_model).astype(np.float32)
    x = base[r.randint(0, 5, size=(4, 8))]               # many equal rows
    jev, jei = _jax_route(jl, jnp.asarray(x.reshape(32, -1)), jcfg)
    tev, tei = moe.route(tl, _t(x.reshape(32, -1)), tcfg)
    C = max(1, int(32 * 2 * 1.25) // 8)
    assert tei.shape == (8, C) == jei.shape
    # Ties: equal gates keep the lower token first, as jax.lax.top_k.
    assert len(np.unique(np.asarray(jev)[np.asarray(jev) > 0])) < (
        (np.asarray(jev) > 0).sum())
    assert (tei.numpy() == np.asarray(jei)).all()
    assert ((tev > 0).numpy() == (np.asarray(jev) > 0)).all()
    assert_allclose(tev.numpy(), np.asarray(jev), rtol=1e-5, atol=1e-6)
    got = moe.moe_forward(tl, _t(x), tcfg).numpy()
    want = np.asarray(jmoe.moe_forward(jl, jnp.asarray(x), jcfg))
    assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_capacity_and_top_k_order():
    cfg = configs.get_config("olmoe-1b-7b")
    assert moe.capacity(cfg, 4) == 1              # decode with 4 slots
    assert moe.capacity(cfg, 1024 * 32) == 5120   # the SSVM-head batch
    x = torch.tensor([[0.5, 2.0, 0.5, 2.0, 0.0, 0.5]])
    v, i = moe.top_k(x, 4)
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    assert i.tolist() == np.asarray(ji).tolist() == [[1, 3, 0, 2]]
    assert_allclose(v.numpy(), np.asarray(jv))


# -- whole models -----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_backbone_and_decode_step_match_jax(arch, dtype):
    jcfg, jp, tcfg, tp = _models(arch, dtype)
    tok = _tokens(4, 12, tcfg.vocab_size)
    jx, jpos = jtransformer._embed_inputs(jp, jcfg, {"tokens": tok})
    want = _f32(jtransformer.backbone(jp, jcfg, jx, jpos))
    tx, tpos = transformer._embed_inputs(tp, tcfg, {"tokens": _t(tok)})
    got = _f32(transformer.backbone(tp, tcfg, tx, tpos).float())
    assert got.shape == (4, 12, tcfg.d_model)
    _assert_close(got, want, dtype)

    # bf16 drifts step by step (relative L2 of the logits 1.6 %, 1.2 %,
    # 2.3 % over three OLMoE steps), so it compares the first step.
    jcache = jregistry.init_cache(jcfg, 4, 16)
    tcache = registry.init_cache(tcfg, 4, 16, "cpu")
    for pos in range(3 if dtype == "f32" else 1):
        step = tok[:, pos:pos + 1]
        jlog, jcache = jregistry.decode_step(jp, jcfg, jcache,
                                             jnp.asarray(step), jnp.int32(pos))
        tlog, tcache = registry.decode_step(tp, tcfg, tcache, _t(step), pos)
        assert tlog.shape == (4, 1, tcfg.vocab_size)
        _assert_close(_f32(tlog.float()), _f32(jlog), dtype)
    name = "moe_layers" if tcfg.moe else "layers"
    _assert_close(_f32(tcache[name][0].float()), _f32(jcache[name][0]), dtype)


def test_prefill_logits_match_jax():
    jcfg, jp, tcfg, tp = _models("qwen2-0.5b")
    tok = _tokens(3, 9, tcfg.vocab_size, seed=4)
    want = _f32(jregistry.prefill(jp, jcfg, {"tokens": jnp.asarray(tok)}))
    got = registry.prefill(tp, tcfg, {"tokens": _t(tok)}).numpy()
    assert got.shape == (3, 1, tcfg.vocab_size)
    assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_server_generates_the_reference_tokens():
    jcfg, jp, tcfg, tp = _models("olmoe-1b-7b")
    r = np.random.RandomState(0)
    prompts = [r.randint(0, tcfg.vocab_size, size=int(n))
               for n in r.randint(1, 6, size=6)]
    prompts[3] = prompts[0].copy()                 # a repeated request
    jserver = jserve.Server(jcfg, jp, slots=4, max_seq=64)
    jreqs = [jserve.Request(i, p, 5 + i % 3) for i, p in enumerate(prompts)]
    pending, jdone = list(jreqs), []
    while pending or any(jserver.active):
        while pending and jserver.add(pending[0]):
            pending.pop(0)
        jdone += jserver.decode_round()
    tserver = serve.Server(tcfg, tp, slots=4, max_seq=64, device="cpu")
    tdone = tserver.serve([serve.Request(i, p, 5 + i % 3)
                           for i, p in enumerate(prompts)])
    assert [q.rid for q in tdone] == [q.rid for q in jdone]
    assert [q.out for q in tdone] == [q.out for q in jdone]
    assert tserver.pos == jserver.pos == tserver.rounds


def test_tagging_task_is_the_examples():
    tok, gold, mask = tagging_task(128, n=48, L=12)
    want = np.random.RandomState(0).randint(0, 128, (48, 12))
    assert (tok == want).all() and (gold == want % 5).all() and mask.all()
    assert tok.dtype == gold.dtype == np.int32


@pytest.mark.parametrize("arch", ARCHS)
def test_ssvm_head_trace_matches_jax(arch):
    """backbone_chain_problem + 3 Solver iterations on the example's task.

    The task's random tokens, not ``_tokens``: with 23 sequences sharing a
    first token, their states are equal in exact arithmetic but differ in
    the last bits after the first layer, in each package differently, and
    an over-capacity expert then keeps other members of the tie group
    (ROADMAP C)."""
    jcfg, jp, tcfg, tp = _models(arch)
    tok, gold, mask = tagging_task(tcfg.vocab_size, n=48, L=12)
    mask[5, 9:] = False
    n, tags = tok.shape[0], 5
    jprob = jhead.backbone_chain_problem(jcfg, jp, jnp.asarray(tok),
                                         jnp.asarray(gold),
                                         jnp.asarray(mask), tags)
    tprob = backbone_chain_problem(tcfg, tp, tok, gold, mask, tags,
                                   device="cpu")
    assert tprob.d == jprob.d == tags * tcfg.d_model + tags * tags
    assert_allclose(tprob.data["x"].numpy(), np.asarray(jprob.data["x"]),
                    rtol=1e-4, atol=1e-4)
    kw = dict(lam=1.0 / n, algo="mpbcfw", max_iters=3, cap=16)
    jr = JSolver(jprob, JRunConfig(cost_model=JCostModel(oracle_cost=0.5),
                                   **kw)).run()
    tr = Solver(tprob, RunConfig(cost_model=CostModel(oracle_cost=0.5),
                                 **kw)).run()
    assert len(tr.trace) == len(jr.trace) == 3
    for a, b in zip(jr.trace, tr.trace):
        assert (b.n_exact, b.n_approx, b.approx_passes) == (
            a.n_exact, a.n_approx, a.approx_passes)
        assert_allclose(b.dual, a.dual, rtol=1e-4)
        assert_allclose(b.primal, a.primal, rtol=1e-4)


# -- parameters, conversion, entry points -------------------------------------

def test_bf16_parameters_round_trip_through_convert():
    jcfg, jp, tcfg, tp = _models("olmoe-1b-7b", "bf16")
    host = jax.device_get(jp)
    assert tp["embedding"].dtype == torch.bfloat16
    assert tp["moe_layers"]["moe"]["router"].dtype == torch.float32
    back = convert.lm_params_to_numpy(tp)
    jl = jax.tree_util.tree_leaves(host)
    tl = common.leaves(back)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert b.dtype == np.float32 and (np.asarray(a, np.float32) == b).all()
    with pytest.raises(ValueError, match="keys"):
        convert.lm_params_from_numpy({"embedding": host["embedding"]}, tcfg,
                                     "cpu")


def test_full_olmoe_spec_count_matches_reference():
    cfg = configs.get_config("olmoe-1b-7b")
    n = cfg.param_count()
    jn = sum(math.prod(s.shape) for s in jax.tree_util.tree_leaves(
        jregistry.param_specs(jconfigs.get_config("olmoe-1b-7b")),
        is_leaf=lambda x: isinstance(x, jcommon.ParamSpec)))
    assert n == jn
    assert abs(n - 6.9e9) / 6.9e9 < 0.02, n
    specs = common.leaves(registry.param_specs(cfg))
    assert specs[0].shape == (cfg.vocab_size, cfg.d_model)


def test_configs_match_the_reference():
    for arch in ARCHS:
        for full in (True, False):
            get = "get_config" if full else "reduced_config"
            a = getattr(jconfigs, get)(arch)
            b = getattr(configs, get)(arch)
            for f in dataclasses.fields(b):
                if f.name != "dtype":
                    assert getattr(b, f.name) == getattr(a, f.name), f.name
            assert b.dtype == torch.bfloat16


def test_init_params_rule_and_generator():
    cfg = configs.reduced_config("qwen2-0.5b")
    g = torch.Generator("cpu")
    g.manual_seed(0)
    p = common.init_params(registry.param_specs(cfg), g, "cpu")
    assert (p["layers"]["attn"]["bq"] == 0).all()
    assert (p["final_norm"] == 1).all() and p["final_norm"].dtype == cfg.dtype
    w = p["layers"]["attn"]["wq"].float()
    assert abs(float(w.std()) - 0.02) < 0.002
    g.manual_seed(0)
    again = common.init_params(registry.param_specs(cfg), g, "cpu")
    assert torch.equal(again["embedding"], p["embedding"])


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.reduced_config("olmoe-1b-7b")
    g = torch.Generator("cpu")
    with pytest.raises(RuntimeError, match="no CUDA"):
        common.init_params(registry.param_specs(cfg), g)
    p = common.init_params(registry.param_specs(cfg), g, "cpu")
    tok = np.zeros((2, 3), np.int32)
    with pytest.raises(RuntimeError, match="no CUDA"):
        backbone_chain_problem(cfg, p, tok, tok, tok == 0, 5)
    with pytest.raises(RuntimeError, match="no CUDA"):
        serve.Server(cfg, p)
    with pytest.raises(RuntimeError, match="no CUDA"):
        registry.init_cache(cfg, 2, 8)
    with pytest.raises(RuntimeError, match="no CUDA"):
        serve.main(["--arch", "olmoe-1b-7b"])


def test_unported_configs_raise_naming_the_roadmap():
    """No family or arch is left unported: every reference arch resolves
    in the port, full and reduced, with the reference's parameter count
    and family, and an unknown arch raises as in the reference."""
    assert set(configs.ARCHS) == set(jconfigs.ARCHS)
    families = set()
    for arch in jconfigs.ARCHS:
        for get in ("get_config", "reduced_config"):
            cfg, jcfg = getattr(configs, get)(arch), getattr(jconfigs,
                                                             get)(arch)
            assert cfg.family == jcfg.family
            assert cfg.param_count() == jcfg.param_count(), (arch, get)
        families.add(cfg.family)
    assert families == {"dense", "moe", "vlm", "hybrid", "ssm", "audio"}
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("gpt-5")


def test_serve_main_runs_on_the_cpu(capsys):
    serve.main(["--arch", "qwen2-0.5b", "--requests", "3", "--max-new", "4",
                "--slots", "2", "--device", "cpu"])
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out

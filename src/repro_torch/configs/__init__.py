"""Model configs of the ported architectures (one module per arch), the
input-shape cells (:mod:`.shapes`) and the paper's scenarios
(:mod:`.paper`).

A copy of ``repro/configs/__init__.py``'s ``ARCHS``, ``get_config``,
``long_context_overrides`` and ``reduced_config``: every arch of the
reference, all six families (dense, moe, vlm, hybrid, ssm, audio).
"""
import dataclasses
import importlib

from .shapes import SHAPES, ShapeCell, supported_shapes  # noqa: F401

ARCHS = {
    "deepseek-v3-671b": "deepseek_v3_671b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "zamba2-7b": "zamba2_7b",
    "qwen2-0.5b": "qwen2_0_5b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "qwen2.5-14b": "qwen2_5_14b",
    "minitron-8b": "minitron_8b",
    "whisper-base": "whisper_base",
    "xlstm-125m": "xlstm_125m",
    "internvl2-76b": "internvl2_76b",
}


def get_config(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[name]}")
    return mod.CONFIG


def long_context_overrides(name: str) -> dict:
    """The arch's long-context config overrides (zamba2-7b: a 4096-key
    sliding window on its shared attention)."""
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[name]}")
    return getattr(mod, "LONG_CONTEXT_OVERRIDES", {})


def reduced_config(name: str):
    """CI-sized config of the same family: every structural feature (MoE,
    MLA, MTP, GQA, qkv bias, tied embeddings, the vision stub, the hybrid
    groups and tail, the xLSTM groups and tail, the encoder-decoder) at a
    small width, depth and vocab; the reference's rule."""
    cfg = get_config(name)
    kw = dict(
        num_layers=min(cfg.num_layers, 4), d_model=64, num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads
        < cfg.num_heads else 4,
        head_dim=16 if cfg.head_dim else 0, d_ff=96 if cfg.d_ff else 0,
        vocab_size=128,
    )
    if cfg.moe:
        kw.update(num_experts=8, experts_per_token=2, moe_d_ff=32,
                  first_dense_layers=min(cfg.first_dense_layers, 1))
    if cfg.mla:
        kw.update(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                  qk_rope_dim=8, v_head_dim=16, head_dim=0)
    if cfg.family == "hybrid":
        kw.update(num_layers=5, attn_every=2, ssm_state=16, num_heads=2,
                  num_kv_heads=2, head_dim=0)
    if cfg.xlstm:
        kw.update(num_layers=5, slstm_every=2, num_heads=2, head_dim=0)
    if cfg.encdec:
        kw.update(encoder_layers=2, encoder_seq=12)
    if cfg.vision_tokens:
        kw.update(vision_tokens=4)
    return dataclasses.replace(cfg, **kw)

"""internvl2-76b [vlm]: InternViT frontend STUBBED (input_specs provides
patch embeddings); InternLM2-76B-style LLM backbone [arXiv:2404.16821].

80L d_model=8192 64H (kv=8) d_ff=28672 vocab=128256; 256 vision tokens.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm", num_layers=80, d_model=8192,
    num_heads=64, num_kv_heads=8, d_ff=28672, vocab_size=128256,
    vision_tokens=256,
)

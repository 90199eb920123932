"""olmoe-1b-7b [moe]: 64 experts top-8 [arXiv:2409.02060].

16L d_model=2048 16H (kv=16) d_ff(expert)=1024 vocab=50304.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe", num_layers=16, d_model=2048,
    num_heads=16, num_kv_heads=16, d_ff=1024, vocab_size=50304,
    moe=True, num_experts=64, experts_per_token=8, moe_d_ff=1024,
    capacity_factor=1.25,
)

"""deepseek-v3-671b [moe]: MLA, 1 shared + 256 routed top-8 experts, MTP.

61L d_model=7168 128H d_ff(expert)=2048 vocab=129280 [arXiv:2412.19437].
First 3 layers dense (d_ff=18432, per the release); MLA ranks q=1536,
kv=512, nope/rope head dims 128/64, v_head 128.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe", num_layers=61, d_model=7168,
    num_heads=128, num_kv_heads=128, d_ff=18432, vocab_size=129280,
    moe=True, num_experts=256, experts_per_token=8, moe_d_ff=2048,
    num_shared_experts=1, first_dense_layers=3, capacity_factor=1.0,
    mla=True, q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128,
    qk_rope_dim=64, v_head_dim=128, mtp=True,
)

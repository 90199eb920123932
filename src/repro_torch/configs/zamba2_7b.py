"""zamba2-7b [hybrid]: Mamba2 backbone + shared attention blocks
[arXiv:2411.15242].

81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000 ssm_state=64; the
shared attention+MLP block is applied every 6 mamba layers.  Sub-quadratic
(runs long_500k; the shared block switches to a 4096 sliding window there).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid", num_layers=81, d_model=3584,
    num_heads=32, num_kv_heads=32, d_ff=14336, vocab_size=32000,
    ssm_state=64, attn_every=6, subquadratic=True,
)

# long_500k override: windowed shared attention keeps the cell sub-quadratic
LONG_CONTEXT_OVERRIDES = {"sliding_window": 4096}

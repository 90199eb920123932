"""minitron-8b [dense]: width-pruned nemotron [arXiv:2407.14679].

32L d_model=4096 32H (kv=8) d_ff=16384 vocab=256000.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b", family="dense", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, d_ff=16384, vocab_size=256000,
)

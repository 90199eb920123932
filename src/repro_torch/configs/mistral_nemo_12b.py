"""mistral-nemo-12b [dense]: 128k-context GQA
[hf:mistralai/Mistral-Nemo-Base-2407].

40L d_model=5120 32H (kv=8) head_dim=128 d_ff=14336 vocab=131072.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b", family="dense", num_layers=40, d_model=5120,
    num_heads=32, num_kv_heads=8, head_dim=128, d_ff=14336,
    vocab_size=131072, rope_theta=1e6,
)

"""xlstm-125m [ssm]: sLSTM + mLSTM blocks [arXiv:2405.04517].

12L d_model=768 4H d_ff=0 (no FFN; blocks carry their own projections)
vocab=50304.  Fully recurrent => runs long_500k.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm", num_layers=12, d_model=768,
    num_heads=4, num_kv_heads=4, d_ff=0, vocab_size=50304,
    xlstm=True, slstm_every=4, subquadratic=True,
)

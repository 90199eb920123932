"""whisper-base [audio]: encoder-decoder backbone; conv frontend STUBBED
(input_specs provides precomputed frame embeddings) [arXiv:2212.04356].

6L enc + 6L dec, d_model=512 8H (kv=8) d_ff=2048 vocab=51865; 1500 audio
frames per example.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio", num_layers=6, d_model=512,
    num_heads=8, num_kv_heads=8, d_ff=2048, vocab_size=51865,
    encdec=True, encoder_layers=6, encoder_seq=1500,
)

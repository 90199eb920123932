"""The assigned input-shape set (same for every LM-family architecture).

``decode_*`` / ``long_*`` lower ``serve_step`` (one token against a
seq_len-deep cache), not ``train_step``.  ``long_500k`` requires
sub-quadratic attention and only runs for cfg.subquadratic archs.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def supported_shapes(cfg) -> list:
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        out.append("long_500k")
    return out

"""The reference's matrix products, in float32 or in TF32.

The configurations state float32 with TF32 off (PyTorch's default for
matrix products).  The control of ``correct`` is the reference one step
below that: TF32, whose products round both operands to 10 mantissa bits
(round to nearest, ties to even) and accumulate in float32.  The
reference routes every product that the port runs as a matrix product
(``torch.matmul`` / ``@``) through :func:`matmul_for`; dot products of the
line search stay float32, as on the card.  ``float32-via-float64`` is
another float32 rounding of the same products, for telling what rounding
alone moves from what a lower precision moves.
"""
from __future__ import annotations

import numpy as np

PRECISIONS = ("float32", "tf32", "float32-via-float64")


def to_tf32(a: np.ndarray) -> np.ndarray:
    """``a`` (float32) rounded to TF32's 10 mantissa bits, as float32."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    r = (u + np.uint32(0x0FFF) + ((u >> np.uint32(13)) & np.uint32(1))
         ) & np.uint32(0xFFFFE000)
    return r.view(np.float32)


def matmul_for(precision: str):
    """The product ``a @ b`` in ``precision`` (float32 operands)."""
    if precision == "float32":
        return lambda a, b: np.matmul(a, b)
    if precision == "tf32":
        return lambda a, b: np.matmul(to_tf32(a), to_tf32(b))
    if precision == "float32-via-float64":
        # A second float32 rounding of the same products (accumulated in
        # float64, rounded once): a witness of what rounding alone moves.
        return lambda a, b: np.matmul(np.asarray(a, np.float64),
                                      np.asarray(b, np.float64)
                                      ).astype(np.float32)
    raise ValueError(f"unknown precision {precision!r}; one of {PRECISIONS}")

"""CUDA kernel wrapper: the grouped SwiGLU expert FFN of the MoE layers.

Replaces ``repro/kernels/moe_ffn.py::moe_ffn``.  The kernel
(``csrc/moe_ffn.cu``) computes ``y[e] = (silu(x[e] wg[e]) * (x[e] wu[e]))
wd[e]`` for every expert with fp32 sums, ``h`` rounded to ``wd``'s type
and kept in shared memory (the ``(E, C, F)`` activations never reach
device memory), and ``y`` in ``xs``'s type.  bfloat16 runs on the tensor
cores (``wmma`` bf16 tiles), float32 on fp32 FMAs.  Compute-bound at the
backbone's shape, memory-bound at the one-token decode shape.  See the
source for the design.

This module always launches the kernel: :mod:`repro_torch.kernels.ops`
routes CPU tensors to the plain version before they reach it.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

# Kernel launches since the last reset (repro_torch.kernels.ops).
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Shared memory a CTA may use on Hopper (227 KB of the SM's 256 KB).
SMEM_LIMIT = 232448
# The kernels' tiles (csrc/moe_ffn.cu): 64-wide tiles; 32 deep on the
# fp32-FMA path, 64 deep (rows padded to 72) on the tensor-core path.
_TILE, _DEPTH, _MMA_LD, _SCRATCH_LD = 64, 32, 72, 68
_SIGNATURE = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5 + \
    [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _lib():
    lib = _build.load("moe_ffn")
    fn = lib.moe_ffn_launch
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURE
        fn.restype = ctypes.c_int
    return lib


def smem_bytes(mma: bool, bc: int, F: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one CTA at row tile ``bc`` and width F.

    FMA path: the staged x chunk and two weight chunks in fp32, and ``h``
    (bc, F).  Tensor-core path: ``h`` (bc, F padded to 64, + 8), the x
    chunk and two weight chunks in bf16, and two fp32 scratch tiles."""
    if mma:
        fp = -(-F // _TILE) * _TILE
        return (2 * (bc * (fp + 8) + bc * _MMA_LD + 2 * 64 * _MMA_LD)
                + 4 * 2 * bc * _SCRATCH_LD)
    item = torch.finfo(dtype).bits // 8
    return 4 * (bc * (_DEPTH + 1) + 2 * _DEPTH * _TILE) + item * bc * F


def plan(C: int, F: int, dtype: torch.dtype):
    """``(mma, bc)``: bfloat16 runs on the tensor cores with 64 capacity
    rows per CTA (32 for C <= 32, the decode shape), float32 (and a bf16 F
    too wide for the tensor-core tiles) on fp32 FMAs with 32 rows (8 for
    C <= 8 or a wide F).  Raises if nothing fits in shared memory."""
    options = []
    if dtype == torch.bfloat16:
        options += [(True, bc) for bc in ((32,) if C <= 32 else (64, 32))]
    options += [(False, bc) for bc in ((8,) if C <= 8 else (32, 8))]
    for mma, bc in options:
        if smem_bytes(mma, bc, F, dtype) <= SMEM_LIMIT:
            return mma, bc
    raise ValueError(f"moe_ffn: F={F} too wide for shared memory "
                     f"({smem_bytes(False, 8, F, dtype)} B at 8 rows)")


def moe_ffn(xs: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
            wd: torch.Tensor) -> torch.Tensor:
    """xs (E, C, D); wg, wu (E, D, F); wd (E, F, D), one dtype (float32 or
    bfloat16), contiguous, on the current CUDA device -> (E, C, D)."""
    global launches
    if xs.device.type != "cuda":
        raise ValueError(f"moe_ffn kernel needs CUDA tensors, got "
                         f"{xs.device}")
    if xs.dim() != 3 or wg.dim() != 3 or wu.dim() != 3 or wd.dim() != 3:
        raise ValueError("moe_ffn: xs (E, C, D), wg/wu (E, D, F), "
                         "wd (E, F, D)")
    E, C, D = xs.shape
    F = wg.shape[2]
    if (tuple(wg.shape) != (E, D, F) or tuple(wu.shape) != (E, D, F)
            or tuple(wd.shape) != (E, F, D)):
        raise ValueError(f"moe_ffn: shapes {tuple(xs.shape)}, "
                         f"{tuple(wg.shape)}, {tuple(wu.shape)}, "
                         f"{tuple(wd.shape)} disagree")
    if xs.dtype not in _DTYPES:
        raise ValueError(f"moe_ffn: dtype {xs.dtype} (float32 or bfloat16)")
    for name, t in (("xs", xs), ("wg", wg), ("wu", wu), ("wd", wd)):
        if t.dtype != xs.dtype or t.device != xs.device:
            raise ValueError(f"moe_ffn: {name} must be {xs.dtype} on "
                             f"{xs.device}")
        if not t.is_contiguous():
            raise ValueError(f"moe_ffn: {name} must be contiguous")
    if xs.device.index != torch.cuda.current_device():
        raise ValueError(f"moe_ffn: tensors on {xs.device}, but the current "
                         f"device is {torch.cuda.current_device()}")
    y = torch.empty_like(xs)
    if E == 0 or C == 0 or D == 0:
        return y
    if F == 0:
        return y.zero_()
    mma, bc = plan(C, F, xs.dtype)
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    rc = _lib().moe_ffn_launch(
        _DTYPES[xs.dtype], int(mma), bc, xs.data_ptr(), wg.data_ptr(),
        wu.data_ptr(), wd.data_ptr(), y.data_ptr(), E, C, D, F, stream)
    launches += 1
    _build.check(rc, "moe_ffn")
    return y

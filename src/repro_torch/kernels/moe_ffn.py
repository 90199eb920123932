"""CUDA kernel wrapper: the grouped SwiGLU expert FFN of the MoE layers.

Replaces ``repro/kernels/moe_ffn.py::moe_ffn``.  Computes ``y[e] =
(silu(x[e] wg[e]) * (x[e] wu[e])) wd[e]`` for every expert with fp32 sums,
``h`` rounded to ``wd``'s type and ``y`` in ``xs``'s type
(``csrc/moe_ffn.cu``).  bfloat16 with D and F multiples of 8 runs on the
tensor cores: two ``wgmma`` GEMM launches fed by TMA rings, gate-and-up
with the ``silu`` epilogue into an ``(E, C, F)`` bf16 scratch ``h``, then
down.  float32, and bfloat16 shapes TMA cannot describe, run on fp32 FMAs
with ``h`` in shared memory.  Compute-bound at the backbone's shape,
memory-bound at the one-token decode shape.  A call counts as one launch
whichever path it takes.  See the source for the design.

This module always launches the kernel: :mod:`repro_torch.kernels.ops`
routes CPU tensors to the plain version before they reach it.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ._build import SMEM_LIMIT

# Kernel launches since the last reset (repro_torch.kernels.ops).
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The fp32-FMA kernel's tiles (csrc/moe_ffn.cu): 64 wide, 32 deep.
_TILE, _DEPTH = 64, 32
# The tensor-core pair's capacity rows per CTA.
WGMMA_ROWS = 128
# Its CTA (csrc/moe_ffn.cu): a producer and two consumer warpgroups, a ring
# of 4 stages of 48 KB (an A box of 128 x 64 and four 64 x 64 B boxes, bf16)
# beside 1 KB of alignment slack and a full and an empty mbarrier a stage;
# each consumer's wgmma tile is 64 rows by a 64-column B box, 64 deep a stage.
WGMMA_THREADS = 384
WGMMA_STAGE = 128 * 64 * 2 + 4 * 64 * 64 * 2
WGMMA_SMEM = 4 * WGMMA_STAGE + 1024 + 2 * 4 * 8
WGMMA_TILE = (64, 64, 64)
FMA_THREADS = 256
# Builds that keep local memory, each with its reason: the checker's rule
# H004 (repro_torch/analysis/kernels.py) waives these and no other.
SPILL_WAIVERS = {
    "moe_ffn_kernel<__nv_bfloat16, 8, 1>":
        "8 B of spill stores and loads a thread at 40 registers (nvcc "
        "12.9's choice, far below the 255 cap) in the bf16 FMA fallback "
        "at 8 rows, which runs only where TMA cannot describe the shape "
        "(D or F not a multiple of 8): no model config's",
}
_SIGNATURE = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6 + \
    [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _lib():
    lib = _build.load("moe_ffn")
    fn = lib.moe_ffn_launch
    if fn.argtypes is None:
        lib.moe_ffn_init.restype = ctypes.c_int
        _build.check(lib.moe_ffn_init(), "moe_ffn (init)")
        fn.argtypes = _SIGNATURE
        fn.restype = ctypes.c_int
    return lib


def smem_bytes(bc: int, F: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one fp32-FMA CTA at row tile ``bc`` and
    width F: the staged x chunk and two weight chunks in fp32, and ``h``
    (bc, F) in the input type."""
    item = torch.finfo(dtype).bits // 8
    return 4 * (bc * (_DEPTH + 1) + 2 * _DEPTH * _TILE) + item * bc * F


def plan(C: int, D: int, F: int, dtype: torch.dtype):
    """``(path, rows)``: ``("wgmma", 128)`` for bfloat16 with D and F
    multiples of 8 (TMA's 16-byte strides); otherwise ``("fma", bc)``, 32
    capacity rows per CTA (8 for C <= 8 or a wide F).  Raises if the FMA
    kernel's ``h`` does not fit in shared memory."""
    if dtype == torch.bfloat16 and D % 8 == 0 and F % 8 == 0:
        return "wgmma", WGMMA_ROWS
    for bc in ((8,) if C <= 8 else (32, 8)):
        if smem_bytes(bc, F, dtype) <= SMEM_LIMIT:
            return "fma", bc
    raise ValueError(f"moe_ffn: F={F} too wide for shared memory "
                     f"({smem_bytes(8, F, dtype)} B at 8 rows)")


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
    path, bc = plan(C, D, F, xs.dtype)
    # The tensor-core pair's h scratch: (E, C, F) bf16, written by the
    # first launch and read by the second.
    h = (torch.empty((E, C, F), dtype=xs.dtype, device=xs.device)
         if path == "wgmma" else None)
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    rc = _lib().moe_ffn_launch(
        _DTYPES[xs.dtype], int(path == "wgmma"), bc, xs.data_ptr(),
        wg.data_ptr(), wu.data_ptr(), wd.data_ptr(), y.data_ptr(),
        h.data_ptr() if h is not None else None, E, C, D, F, stream)
    launches += 1
    _build.check(rc, "moe_ffn")
    return y

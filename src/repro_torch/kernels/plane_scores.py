"""CUDA kernel wrapper: working-set plane scoring (the approximate oracle).

Replaces ``repro/kernels/plane_scores.py::plane_scores``.  The kernel
(``csrc/plane_scores.cu``) computes ``scores[r] = <planes[r], w> +
offsets[r]`` with one warp per row, in the order that ``plane_select`` and
``approx_pass`` also reduce a row (so the three agree bit for bit), reading
strided views in place.  On the main path (``mpbcfw-gram``) it makes each
insert's Gram row, ``planes[i, :, :-1]`` of the plane cache against the new
plane (:func:`repro_torch.cache.ops.row_dots`), inside the exact step's
captured CUDA graph.  Bytes bound the work (1 MB at 64 x 4004, 0.31 us);
the order contract leaves each row one warp's dependent chain of FMAs
behind one DRAM round trip, so :func:`plan` spreads a block's rows over
the card, one per CTA, and the kernel keeps a whole row's loads in
flight.  See the source for the design.

This module always launches the kernel: :mod:`repro_torch.kernels.ops`
routes CPU tensors to the plain version before they reach it.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

# Kernel launches since the last reset (repro_torch.kernels.ops).
launches = 0

SMS = 132                   # streaming multiprocessors of an H100 SXM
ROWS_PER_CTA = (1, 2, 4, 8)
CHUNK = 1024                # columns a ring slot holds (csrc kChunk)

_SIGNATURE = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_void_p]


def plan(n: int) -> Tuple[int, int]:
    """``(rows per CTA, ring stages)`` for ``n`` rows: the fewest rows per
    CTA whose CTAs fit on the card's SMs at once (one row each for a
    64-row cache block), else 8 for the flat multi-block calls; each
    warp's ring holds 4 chunks of 1024 columns up to 2 rows per CTA, 2
    above (``csrc/plane_scores.cu``)."""
    rows = next((r for r in ROWS_PER_CTA if -(-n // r) <= SMS),
                ROWS_PER_CTA[-1])
    return rows, 4 if rows <= 2 else 2


def smem_bytes(rows: int, stages: int) -> int:
    """Dynamic shared memory of a launch (csrc/plane_scores.cu
    ``smem_bytes``): each of ``rows`` warps a ring of ``stages`` slots,
    each a chunk of p and one of w."""
    return 4 * rows * stages * 2 * CHUNK


def _lib():
    lib = _build.load("plane_scores")
    fn = lib.plane_scores_launch
    if fn.argtypes is None:
        lib.plane_scores_init.restype = ctypes.c_int
        _build.check(lib.plane_scores_init(), "plane_scores (init)")
        fn.argtypes = _SIGNATURE
        fn.restype = ctypes.c_int
    return lib


def plane_scores(planes: torch.Tensor, w: torch.Tensor,
                 offsets: torch.Tensor) -> torch.Tensor:
    """``(N, d)`` planes (unit column stride, any row stride), ``(d,)``
    contiguous ``w``, ``(N,)`` offsets (any stride) -> ``(N,)`` float32."""
    global launches
    if planes.device.type != "cuda":
        raise ValueError(f"plane_scores kernel needs CUDA tensors, got "
                         f"{planes.device}")
    if planes.dim() != 2 or w.dim() != 1 or offsets.dim() != 1:
        raise ValueError("plane_scores: planes (N, d), w (d,), offsets (N,)")
    n, d = planes.shape
    if w.shape[0] != d or offsets.shape[0] != n:
        raise ValueError(f"plane_scores: shapes {tuple(planes.shape)}, "
                         f"{tuple(w.shape)}, {tuple(offsets.shape)} disagree")
    for name, t in (("planes", planes), ("w", w), ("offsets", offsets)):
        if t.dtype != torch.float32 or t.device != planes.device:
            raise ValueError(f"plane_scores: {name} must be float32 on "
                             f"{planes.device}")
    if d > 1 and (planes.stride(1) != 1 or w.stride(0) != 1):
        raise ValueError("plane_scores: planes columns and w must be "
                         "unit-stride")
    if planes.device.index != torch.cuda.current_device():
        raise ValueError(f"plane_scores: tensors on {planes.device}, but "
                         f"the current device is "
                         f"{torch.cuda.current_device()}")
    out = torch.empty((n,), dtype=torch.float32, device=planes.device)
    if n == 0:
        return out
    rows, stages = plan(n)
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    rc = _lib().plane_scores_launch(
        planes.data_ptr(), planes.stride(0), w.data_ptr(), offsets.data_ptr(),
        offsets.stride(0), out.data_ptr(), n, d, rows, stages, stream)
    launches += 1
    _build.check(rc, "plane_scores")
    return out

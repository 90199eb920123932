"""CUDA kernel wrapper: fused masked score-and-select over the plane cache.

Replaces ``repro/kernels/plane_select.py::plane_select``.  The kernel
(``csrc/plane_select.cu``) computes, for each selected cache row, the
best valid slot's score ``<planes[r, j], w> + offsets[r, j]`` and the first
slot attaining it, reading only valid slots.  It takes the cache's strided
views ``planes[..., :-1]`` and ``planes[..., -1]`` in place, plus an
optional ``rows`` vector: block ``b`` reads cache row ``rows[b]``, so the
gather of a permutation of blocks is fused into the kernel's loads.
Memory-bound on the valid slots' bytes.  See the source for the design.

This module always launches the kernel: :mod:`repro_torch.kernels.ops`
routes CPU tensors to the plain version before they reach it.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

# Kernel launches since the last reset (repro_torch.kernels.ops).
launches = 0

# One float of shared memory per slot, within the 48 KB a block gets
# without opting in.
MAX_CAP = 48 * 1024 // 4

_P, _L, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
    ctypes.c_float
_SIGNATURE = [_P, _L, _L, _P, _P, _L, _L, _P, _L, _L, _P, _I, _I, _I, _I,
              _F, _P, _P, _P]


def _lib():
    lib = _build.load("plane_select")
    fn = lib.plane_select_launch
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURE
        fn.restype = ctypes.c_int
    return lib


def plane_select(planes: torch.Tensor, w: torch.Tensor,
                 offsets: torch.Tensor, valid: torch.Tensor,
                 rows: Optional[torch.Tensor] = None, *, neg: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(n, cap, d)`` planes (unit column stride, any row and slot
    strides), ``(d,)`` contiguous ``w``, ``(n, cap)`` offsets and bool
    ``valid`` (any strides), optional ``(k,)`` contiguous int64 ``rows``
    in ``[0, n)`` -> ``(best (k,) float32, idx (k,) int32)``; ``k = n``
    without ``rows``.  A row with no valid slot gives ``(neg, 0)``."""
    global launches
    if planes.device.type != "cuda":
        raise ValueError(f"plane_select kernel needs CUDA tensors, got "
                         f"{planes.device}")
    if planes.dim() != 3 or w.dim() != 1 or offsets.dim() != 2 \
            or valid.dim() != 2:
        raise ValueError("plane_select: planes (n, cap, d), w (d,), "
                         "offsets (n, cap), valid (n, cap)")
    n, cap, d = planes.shape
    if w.shape[0] != d or tuple(offsets.shape) != (n, cap) \
            or tuple(valid.shape) != (n, cap):
        raise ValueError(f"plane_select: shapes {tuple(planes.shape)}, "
                         f"{tuple(w.shape)}, {tuple(offsets.shape)}, "
                         f"{tuple(valid.shape)} disagree")
    if not 1 <= cap <= MAX_CAP:
        raise ValueError(f"plane_select: cap={cap} slots; the kernel holds "
                         f"1 to {MAX_CAP} scores in shared memory")
    checks = [("planes", planes, torch.float32), ("w", w, torch.float32),
              ("offsets", offsets, torch.float32),
              ("valid", valid, torch.bool)]
    if rows is not None:
        checks.append(("rows", rows, torch.int64))
    for name, t, dtype in checks:
        if t.dtype != dtype or t.device != planes.device:
            raise ValueError(f"plane_select: {name} must be {dtype} on "
                             f"{planes.device}")
    if d > 1 and (planes.stride(2) != 1 or w.stride(0) != 1):
        raise ValueError("plane_select: planes columns and w must be "
                         "unit-stride")
    if rows is not None and (rows.dim() != 1 or not rows.is_contiguous()):
        raise ValueError("plane_select: rows must be a contiguous (k,) "
                         "vector")
    if planes.device.index != torch.cuda.current_device():
        raise ValueError(f"plane_select: tensors on {planes.device}, but "
                         f"the current device is "
                         f"{torch.cuda.current_device()}")
    k = n if rows is None else rows.shape[0]
    best = torch.empty((k,), dtype=torch.float32, device=planes.device)
    idx = torch.empty((k,), dtype=torch.int32, device=planes.device)
    if k == 0:
        return best, idx
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    rc = _lib().plane_select_launch(
        planes.data_ptr(), planes.stride(0), planes.stride(1), w.data_ptr(),
        offsets.data_ptr(), offsets.stride(0), offsets.stride(1),
        valid.data_ptr(), valid.stride(0), valid.stride(1),
        None if rows is None else rows.data_ptr(), k, n, cap, d, float(neg),
        best.data_ptr(), idx.data_ptr(), stream)
    launches += 1
    _build.check(rc, "plane_select")
    return best, idx

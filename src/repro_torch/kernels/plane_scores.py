"""CUDA kernel wrapper: working-set plane scoring (the approximate oracle).

Replaces ``repro/kernels/plane_scores.py::plane_scores``.  The kernel
(``csrc/plane_scores.cu``) computes ``scores[r] = <planes[r], w> +
offsets[r]`` with one warp per row, reading strided views in place: the
main path hands it ``planes[i, :, :-1]`` and ``planes[i, :, -1]`` of the
plane cache, rows of ``d+1`` floats.  Memory-bound; at the main-path shape
(64 x 4004) it is bound by launch latency.  See the source for the design.

This module always launches the kernel: :mod:`repro_torch.kernels.ops`
routes CPU tensors to the plain version before they reach it.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

# Kernel launches since the last reset (repro_torch.kernels.ops).
launches = 0

_SIGNATURE = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
              ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _lib():
    lib = _build.load("plane_scores")
    fn = lib.plane_scores_launch
    if fn.argtypes is None:
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
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    rc = _lib().plane_scores_launch(
        planes.data_ptr(), planes.stride(0), w.data_ptr(), offsets.data_ptr(),
        offsets.stride(0), out.data_ptr(), n, d, stream)
    launches += 1
    _build.check(rc, "plane_scores")
    return out

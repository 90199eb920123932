"""CUDA kernel wrapper: the plane Gram matrix ``G = P Pᵀ`` (paper Sec. 3.5).

Replaces ``repro/kernels/gram.py::gram``.  The kernel (``csrc/gram.cu``)
computes ``G[a, b] = <P[a], P[b]>`` in fp32 on FMAs, one 64 x 64 output
tile per CTA over the upper triangle, each entry written to both halves
from one register, so ``G`` is exactly symmetric.  It reads row-strided
views in place: the gram path hands it ``planes[i, :, :-1]`` of the plane
cache, rows of ``d+1`` floats.  Compute-bound at large ``N``, launch-bound
at one block (64 x 4004).  See the source for the design.

As in the reference, no training step calls it: the cache keeps its Gram
blocks row by row on insertion (:func:`repro_torch.cache.ops.insert`);
this kernel recomputes whole blocks, which is how the gram leaf of a run
is checked against its invariant ``G_i = P_i P_iᵀ``.

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
              ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _lib():
    lib = _build.load("gram")
    fn = lib.gram_launch
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURE
        fn.restype = ctypes.c_int
    return lib


def gram(planes: torch.Tensor) -> torch.Tensor:
    """``(N, d)`` float32 planes (unit column stride, any row stride) ->
    ``(N, N)`` float32 ``G[a, b] = <planes[a], planes[b]>``."""
    global launches
    if planes.device.type != "cuda":
        raise ValueError(f"gram kernel needs a CUDA tensor, got "
                         f"{planes.device}")
    if planes.dim() != 2 or planes.dtype != torch.float32:
        raise ValueError(f"gram: planes must be (N, d) float32, got "
                         f"{tuple(planes.shape)} {planes.dtype}")
    n, d = planes.shape
    if d > 1 and planes.stride(1) != 1:
        raise ValueError("gram: planes columns must be unit-stride")
    if planes.device.index != torch.cuda.current_device():
        raise ValueError(f"gram: planes on {planes.device}, but the current "
                         f"device is {torch.cuda.current_device()}")
    out = torch.empty((n, n), dtype=torch.float32, device=planes.device)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    rc = _lib().gram_launch(planes.data_ptr(), planes.stride(0),
                            out.data_ptr(), n, d, stream)
    launches += 1
    _build.check(rc, "gram")
    return out

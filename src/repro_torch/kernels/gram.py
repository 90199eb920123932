"""CUDA kernel wrapper: the plane Gram matrix ``G = P Pᵀ`` (paper Sec. 3.5).

Replaces ``repro/kernels/gram.py::gram``.  The kernel (``csrc/gram.cu``)
computes ``G[a, b] = <P[a], P[b]>`` in fp32 on FMAs over the upper
triangle of output tiles, each entry written to both halves from one
register, so ``G`` is exactly symmetric.  It reads row-strided views in
place: the gram path hands it ``planes[i, :, :-1]`` of the plane cache,
rows of ``d+1`` floats.  Operations bound it at large ``N``.  At one block
(64 x 4004) one 64 x 64 tile ran on one SM of 132, bound by latency;
:func:`plan` now cuts such a block into three 32 x 32 tiles (the fourth is
the mirror) and splits each tile's K range over a thread-block cluster of
up to 16 CTAs, which add their partials in rank order through distributed
shared memory, so the result still depends on ``(N, d)`` and the inputs
alone.  See the source
for the design.

As in the reference, no training step calls it: the cache keeps its Gram
blocks row by row on insertion (:func:`repro_torch.cache.ops.insert`);
this kernel recomputes whole blocks, which is how the gram leaf of a run
is checked against its invariant ``G_i = P_i P_iᵀ``.

This module always launches the kernel: :mod:`repro_torch.kernels.ops`
routes CPU tensors to the plain version before they reach it.
"""
from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from . import _build

# Kernel launches since the last reset (repro_torch.kernels.ops).
launches = 0

TILES = (32, 128)  # output tile edges csrc/gram.cu builds
SMS = 132        # streaming multiprocessors of an H100 SXM
K_STEP = 32      # columns per staged panel (csrc/gram.cu kK)
MAX_SPLIT = 16   # the largest cluster H100 places (non-portable)
STAGES = 3       # cp.async ring depth (csrc/gram.cu kStages)
THREADS = 256    # threads per CTA at either tile

_SIGNATURE = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_void_p]


def _triangle(n: int, tile: int) -> int:
    t = -(-n // tile)
    return t * (t + 1) // 2


def plan(n: int, d: int) -> Tuple[int, int]:
    """``(tile, split)`` for an ``(n, d)`` Gram matrix, from the shape
    alone.  128-tiles (8 x 8 entries a thread) once their upper triangle
    fills the card's SMs, with no split; else 32-tiles, each tile's K
    range split over ``split`` CTAs of one cluster: the smallest power of
    two that fills the card, at most :data:`MAX_SPLIT` and at most one CTA
    per K step."""
    if _triangle(n, 128) >= SMS:
        return 128, 1
    tiles, steps = _triangle(n, 32), -(-d // K_STEP)
    split = 1
    while (split * 2 <= min(MAX_SPLIT, steps)
           and tiles * split < SMS):
        split *= 2
    return 32, split


def smem_bytes(tile: int) -> int:
    """Dynamic shared memory of a CTA (csrc/gram.cu ``Shape<tile>::kSmem``):
    :data:`STAGES` stages of an A and a B panel, each :data:`K_STEP`
    columns per thread group (four groups at 32-tiles, one at 128) of
    ``tile + 4`` floats."""
    groups = 4 if tile == 32 else 1
    return 4 * STAGES * 2 * K_STEP * groups * (tile + 4)


def k_ranges(d: int, split: int) -> List[Tuple[int, int]]:
    """The columns ``[k0, k1)`` that cluster rank r = 0..split-1 sums:
    K steps ``[r*steps//split, (r+1)*steps//split)``, as the kernel
    computes them."""
    steps = -(-d // K_STEP)
    return [(K_STEP * (r * steps // split),
             min(d, K_STEP * ((r + 1) * steps // split)))
            for r in range(split)]


def _lib():
    lib = _build.load("gram")
    fn = lib.gram_launch
    if fn.argtypes is None:
        lib.gram_init.restype = ctypes.c_int
        _build.check(lib.gram_init(), "gram (init)")
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
    tile, split = plan(n, d)
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    rc = _lib().gram_launch(planes.data_ptr(), planes.stride(0),
                            out.data_ptr(), n, d, tile, split, stream)
    launches += 1
    _build.check(rc, "gram")
    return out

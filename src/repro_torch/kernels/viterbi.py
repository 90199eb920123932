"""CUDA kernel wrapper: whole-sequence masked Viterbi decode.

Replaces ``repro/kernels/viterbi.py::viterbi_step`` and the
``viterbi_decode_batch`` scan around it with one launch per batch: one
thread block per sequence runs the forward max-plus DP with the
transition table in shared memory, then the backtrace
(``csrc/viterbi.cu``).  Each row's labels equal
``repro/core/oracles/chain.py::viterbi_decode`` on that row.  Bound by
latency and the L-step dependence, not by bytes.

The chain max-oracle launches it with ``B = 1`` for every exact-oracle
call and with ``B = n`` for the batched evaluation oracle.  This module
always launches the kernel: :mod:`repro_torch.kernels.ops` routes CPU
tensors to the plain version before they reach it.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

# Kernel launches since the last reset (repro_torch.kernels.ops).
launches = 0

# One block holds the C x C table and two score rows in the 48 KB of
# shared memory a block gets without opting in, and one thread per label.
SMEM_BYTES = 48 * 1024
MAX_LABELS = max(c for c in range(1, 1025)
                 if (c * c + 2 * c) * 4 <= SMEM_BYTES)

_SIGNATURE = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_void_p]


def _lib():
    lib = _build.load("viterbi")
    fn = lib.viterbi_decode_launch
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURE
        fn.restype = ctypes.c_int
    return lib


def viterbi_decode(unary: torch.Tensor, trans: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """``unary (B, L, C)`` float32, ``trans (C, C)`` float32, ``mask (B, L)``
    bool, all contiguous on one CUDA device -> ``(B, L)`` int32 labels."""
    global launches
    if unary.device.type != "cuda":
        raise ValueError(f"viterbi_decode kernel needs CUDA tensors, got "
                         f"{unary.device}")
    if unary.dim() != 3 or trans.dim() != 2 or mask.dim() != 2:
        raise ValueError("viterbi_decode: unary (B, L, C), trans (C, C), "
                         "mask (B, L)")
    B, L, C = unary.shape
    if tuple(trans.shape) != (C, C) or tuple(mask.shape) != (B, L) or L < 1:
        raise ValueError(f"viterbi_decode: shapes {tuple(unary.shape)}, "
                         f"{tuple(trans.shape)}, {tuple(mask.shape)} disagree")
    if C > MAX_LABELS:
        raise ValueError(f"viterbi_decode: C={C} labels exceed the "
                         f"{MAX_LABELS} one block's shared memory holds")
    for name, t, dtype in (("unary", unary, torch.float32),
                           ("trans", trans, torch.float32),
                           ("mask", mask, torch.bool)):
        if t.dtype != dtype or t.device != unary.device:
            raise ValueError(f"viterbi_decode: {name} must be {dtype} on "
                             f"{unary.device}")
        if not t.is_contiguous():
            raise ValueError(f"viterbi_decode: {name} must be contiguous")
    if unary.device.index != torch.cuda.current_device():
        raise ValueError(f"viterbi_decode: tensors on {unary.device}, but "
                         f"the current device is "
                         f"{torch.cuda.current_device()}")
    labels = torch.empty((B, L), dtype=torch.int32, device=unary.device)
    if B == 0:
        return labels
    back = torch.empty((B, L - 1, C), dtype=torch.int32, device=unary.device)
    stream = torch.cuda.current_stream(unary.device).cuda_stream
    rc = _lib().viterbi_decode_launch(
        unary.data_ptr(), trans.data_ptr(), mask.data_ptr(), back.data_ptr(),
        labels.data_ptr(), B, L, C, stream)
    launches += 1
    _build.check(rc, "viterbi_decode")
    return labels

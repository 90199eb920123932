"""CUDA kernel wrapper: one whole approximate pass of MP-BCFW per launch.

The port's own kernel: the reference runs the pass as ``lax.scan`` over
blocks inside the ``lax.while_loop`` of ``repro/core/mpbcfw.py``.  The
kernel (``csrc/approx_pass.cu``) walks a device permutation of block ids
in one CTA, keeping ``phi`` and the average in shared memory, and updates
the dual state, the cache's activity stamps and the approximate-track
average in place; in the Sec-3.5 mode it runs ``steps`` Gram recurrences
per block.  A device ``go`` flag gates the launch, so passes can be queued
behind the slope rule's on-device decision.  Latency-bound (a sequential
chain of block-wide reductions).  See the source for the design.

This module always launches the kernel: :func:`repro_torch.core.mpbcfw.
run_pass` routes CPU tensors to the plain version
(:func:`repro_torch.core.mpbcfw.eager_pass`) before they reach it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import _build

# Kernel launches since the last reset (repro_torch.kernels.ops).
launches = 0

# Shared memory a CTA may use on Hopper (227 KB of the SM's 256 KB).
SMEM_LIMIT = 232448

_SIGNATURE = [ctypes.c_void_p] * 9 + [ctypes.c_longlong] + \
    [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + [ctypes.c_longlong,
                                                 ctypes.c_void_p]


def _lib():
    lib = _build.load("approx_pass")
    fn = lib.approx_pass_launch
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURE
        fn.restype = ctypes.c_int
        lib.approx_pass_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.approx_pass_smem_bytes.restype = ctypes.c_longlong
    return lib


def inverse_lam(lam: float) -> float:
    """``fl32(1 / lam)``, the reciprocal taken in double and rounded once:
    the factor PyTorch's CUDA division by a Python scalar multiplies with
    (checked bit for bit on an H100 for n = 3 ... 6877, ``lam = 1/n``), so
    ``w = -phi*/lam`` is bit-equal to the eager ``weights_of`` on the
    card."""
    return float(np.float32(1.0 / lam))


def approx_pass(phi: torch.Tensor, phi_i: torch.Tensor, bar: torch.Tensor,
                planes: torch.Tensor, valid: torch.Tensor,
                last_active: torch.Tensor, perm: torch.Tensor, *,
                lam: float, k0: int, outer_it: int,
                gram: Optional[torch.Tensor] = None,
                steps: Optional[int] = None,
                go: Optional[torch.Tensor] = None) -> None:
    """One approximate pass over ``perm`` in place (see
    :func:`repro_torch.kernels.ops.approx_pass`)."""
    global launches
    dev = phi.device
    if dev.type != "cuda":
        raise ValueError(f"approx_pass kernel needs CUDA tensors, got {dev}")
    n, cap, d1 = planes.shape
    if (tuple(phi.shape) != (d1,) or tuple(bar.shape) != (d1,)
            or tuple(phi_i.shape) != (n, d1)
            or tuple(valid.shape) != (n, cap)
            or tuple(last_active.shape) != (n, cap) or perm.dim() != 1):
        raise ValueError(
            f"approx_pass: shapes phi {tuple(phi.shape)}, phi_i "
            f"{tuple(phi_i.shape)}, bar {tuple(bar.shape)}, planes "
            f"{tuple(planes.shape)}, valid {tuple(valid.shape)}, "
            f"last_active {tuple(last_active.shape)}, perm "
            f"{tuple(perm.shape)} disagree")
    want = [("phi", phi, torch.float32), ("phi_i", phi_i, torch.float32),
            ("bar", bar, torch.float32), ("planes", planes, torch.float32),
            ("valid", valid, torch.bool),
            ("last_active", last_active, torch.int32),
            ("perm", perm, torch.int64)]
    if steps is not None:
        if gram is None or tuple(gram.shape) != (n, cap, cap):
            raise ValueError("approx_pass: the Sec-3.5 mode needs the "
                             "(n, cap, cap) Gram leaf")
        if steps < 1:
            raise ValueError(f"approx_pass: steps must be >= 1, got {steps}")
        want.append(("gram", gram, torch.float32))
    if go is not None:
        if go.numel() != 1:
            raise ValueError("approx_pass: go must be a one-element flag")
        want.append(("go", go, torch.bool))
    for name, t, dtype in want:
        if t.dtype != dtype or t.device != dev:
            raise ValueError(f"approx_pass: {name} must be {dtype} on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"approx_pass: {name} must be contiguous")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"approx_pass: tensors on {dev}, but the current "
                         f"device is {torch.cuda.current_device()}")
    if perm.numel() == 0:
        return
    lib = _lib()
    nsteps = 0 if steps is None else int(steps)
    smem = lib.approx_pass_smem_bytes(d1 - 1, cap, nsteps)
    if smem > SMEM_LIMIT:
        raise ValueError(f"approx_pass: d={d1 - 1}, cap={cap} need {smem} B "
                         f"of shared memory (limit {SMEM_LIMIT})")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.approx_pass_launch(
        phi.data_ptr(), phi_i.data_ptr(), bar.data_ptr(), planes.data_ptr(),
        valid.data_ptr(), last_active.data_ptr(),
        gram.data_ptr() if steps is not None else None, perm.data_ptr(),
        go.data_ptr() if go is not None else None, n, perm.numel(), cap,
        d1 - 1, nsteps, int(outer_it), float(lam), inverse_lam(lam),
        int(k0), stream)
    launches += 1
    _build.check(rc, "approx_pass")

"""CUDA kernel wrapper: one whole approximate pass of MP-BCFW per launch.

The port's own kernel: the reference runs the pass as ``lax.scan`` over
blocks inside the ``lax.while_loop`` of ``repro/core/mpbcfw.py``.  The
kernel (``csrc/approx_pass.cu``) walks a device permutation of block ids
in one CTA, keeping ``phi`` and the average on chip, and updates the dual
state, the cache's activity stamps and the approximate-track average in
place; in the Sec-3.5 mode it runs ``steps`` Gram recurrences per block.
Each block's phi_i row, valid plane rows and Gram leaf are staged in
shared memory by bulk copies (the TMA engine) while the block before it
computes, as :func:`plan` lays out.  A device ``go`` flag gates the
launch, so passes can be queued behind the slope rule's on-device
decision.  The averaging count advances by ``k_stride`` per block (1 on
one device; S on a rank of the shard engine's S, whose blocks are visited
in step with the other ranks').  In the plain mode an optional ``gap``
vector takes each visited block's gap estimate (the gap policies' input), from one more
dot product per block on an idle warp.  Latency-bound (a sequential
chain of per-block reductions).  See the source for the design.

Shapes the staged kernel cannot hold (``d + 1`` past :data:`MAX_D1`, a
layout past shared memory, Sec-3.5 caps past :data:`MAX_SEC35_CAP`) take
the wide plan (``Plan.wide``): the same pass by another kernel of the same
source, with phi, the average and the per-slot lists in device memory (a
scratch of :func:`wide_scratch_words` this module allocates), so every d
and cap the reference's pass takes runs on the card.

This module always launches the kernel: :func:`repro_torch.core.mpbcfw.
run_pass` routes CPU tensors to the plain version
(:func:`repro_torch.core.mpbcfw.eager_pass`) before they reach it.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _build
from ._build import SMEM_LIMIT

# Kernel launches since the last reset (repro_torch.kernels.ops).
launches = 0


# The kernel's threads, the elements of the average each holds in
# registers in csrc/approx_pass.cu's builds (a launch takes the fewest that
# cover d + 1), and the most.
THREADS = 512
PER_THREAD = (8, 16, 24, 40)
MAX_D1 = PER_THREAD[-1] * THREADS
# The staged Sec-3.5 build holds 8 slots per lane of one warp.
MAX_SEC35_CAP = 8 * 32
# The wide kernel's shared memory: 4 floats of per-block scalars.
WIDE_SMEM = 16

# Builds that keep local memory, each with its reason: the checker's rule
# H004 (repro_torch/analysis/kernels.py) waives these and no other.  At
# 512 threads a thread has at most 128 registers; the builds for d + 1
# past 8192 hold 24 or 40 elements of the average in registers, and the
# Sec-3.5 ones also the Gram recurrence's scalars.  Measured on an H100
# (nvcc 12.9): 8 B, and 16 and 48 B a thread in Sec-3.5 mode.
_WIDE_D = ("holds 24 or 40 floats of the average a thread beside the "
           "pass's state at the 128-register cap of 512 threads; only "
           "launches past d = 8192")
SPILL_WAIVERS = {
    "approx_pass_kernel<40, false, false, false>": _WIDE_D,
    "approx_pass_kernel<24, true, false, false>": _WIDE_D + " (Sec-3.5)",
    "approx_pass_kernel<24, true, false, true>": _WIDE_D + " (Sec-3.5)",
    "approx_pass_kernel<40, true, false, false>": _WIDE_D + " (Sec-3.5)",
    "approx_pass_kernel<40, true, false, true>": _WIDE_D + " (Sec-3.5)",
}

_SIGNATURE = [ctypes.c_void_p] * 10 + [ctypes.c_longlong] + \
    [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + [ctypes.c_longlong] * 2 + \
    [ctypes.c_int] * 2 + [ctypes.c_void_p]
_WIDE_SIGNATURE = _SIGNATURE[:-3] + [ctypes.c_void_p] * 2


class Plan(NamedTuple):
    """One launch's staging: ``rows`` valid plane rows staged per buffer,
    blocks staged ``distance`` ahead (1: two buffers, the next block's
    copies in flight while this one computes; 0: one buffer, filled just
    before its block), and the ``smem_bytes`` of shared memory.  ``wide``:
    the wide plan (nothing staged, phi and the average in device
    memory)."""
    rows: int
    distance: int
    smem_bytes: int
    wide: bool = False


def _slot(length: int) -> int:
    """Words of a slot that takes ``length`` floats at any 4-byte offset,
    rounded out to 16 bytes (csrc/approx_pass.cu ``slot_words``)."""
    return (length + 6 + 3) // 4 * 4


def _words(d1: int, cap: int, steps: int, rows: int, nbuf: int) -> int:
    """Shared-memory words of csrc/approx_pass.cu's ``make_layout``: block
    ids (8 x 2), two mbarriers (4), row pointers (2 cap), scalars (8),
    averaging weights (4), a, b, beta, the offsets and the mix list
    (5 cap), four valid-slot lists (4 (2 cap + 1)), phi (d+1), all
    rounded up to 16 bytes; then per buffer a slot for the phi_i row and
    for each of ``rows`` plane rows and, in the Sec-3.5 mode, one for the
    Gram leaf."""
    fixed = 16 + 4 + 2 * cap + 8 + 4 + 5 * cap + 4 * (2 * cap + 1) + d1
    fixed = (fixed + 3) // 4 * 4
    per_buf = _slot(d1) * (1 + rows) + (_slot(cap * cap) if steps > 0
                                        else 0)
    return fixed + nbuf * per_buf


def wide_scratch_words(cap: int) -> int:
    """4-byte words of the wide plan's device scratch (csrc/approx_pass.cu
    ``wide_scratch``): a block's valid-slot list (positions, list, count,
    2 cap + 1), then a, b, beta, the offsets and the mix list (5 cap)."""
    return (2 * cap + 1) + 5 * cap


def plan(d: int, cap: int, steps: int = 0) -> Plan:
    """The launch plan for ``d``-dimensional planes, ``cap`` slots per
    block and ``steps`` Gram recurrences (0: the plain pass), from the
    shape alone.  The staged kernel where it holds the shape (``d + 1 <=``
    :data:`MAX_D1`, a Sec-3.5 cap of at most :data:`MAX_SEC35_CAP`, and
    one buffer beside the fixed part within :data:`SMEM_LIMIT`): two
    buffers whenever two fit, each with as many rows (at most ``cap``) as
    then fit; else one buffer.  Every other shape takes the wide plan.
    Raises ``ValueError`` only for ``d < 1``, ``cap < 1`` or ``steps <
    0``."""
    if d < 1 or cap < 1 or steps < 0:
        raise ValueError(f"approx_pass: no plan for d={d}, cap={cap}, "
                         f"steps={steps}")
    d1 = d + 1
    if d1 <= MAX_D1 and (steps == 0 or cap <= MAX_SEC35_CAP):
        for nbuf in (2, 1):
            base = 4 * _words(d1, cap, steps, 0, nbuf)
            if base <= SMEM_LIMIT:
                rows = min(cap, (SMEM_LIMIT - base) // (4 * nbuf * _slot(d1)))
                return Plan(rows, nbuf - 1,
                            4 * _words(d1, cap, steps, rows, nbuf))
    return Plan(0, 0, WIDE_SMEM, wide=True)


def _lib():
    lib = _build.load("approx_pass")
    fn = lib.approx_pass_launch
    if fn.argtypes is None:
        lib.approx_pass_init.restype = ctypes.c_int
        _build.check(lib.approx_pass_init(), "approx_pass (init)")
        lib.approx_pass_smem_bytes.argtypes = [ctypes.c_int] * 5
        lib.approx_pass_smem_bytes.restype = ctypes.c_longlong
        lib.approx_pass_wide_scratch_words.argtypes = [ctypes.c_int]
        lib.approx_pass_wide_scratch_words.restype = ctypes.c_longlong
        lib.approx_pass_wide_smem_bytes.argtypes = []
        lib.approx_pass_wide_smem_bytes.restype = ctypes.c_longlong
        lib.approx_pass_wide_launch.argtypes = _WIDE_SIGNATURE
        lib.approx_pass_wide_launch.restype = ctypes.c_int
        fn.argtypes = _SIGNATURE
        fn.restype = ctypes.c_int
    return lib


def inverse_lam(lam: float) -> float:
    """``fl32(1 / lam)``, the reciprocal taken in double and rounded once:
    the factor PyTorch's CUDA division by a Python scalar multiplies with
    (checked bit for bit on an H100 for n = 3 ... 6877, ``lam = 1/n``), so
    ``w = -phi*/lam`` is bit-equal to the eager ``weights_of`` on the
    card."""
    return float(np.float32(1.0 / lam))  # repro: allow[R004] host float lam


def approx_pass(phi: torch.Tensor, phi_i: torch.Tensor, bar: torch.Tensor,
                planes: torch.Tensor, valid: torch.Tensor,
                last_active: torch.Tensor, perm: torch.Tensor, *,
                lam: float, k0: int, outer_it: int,
                gram: Optional[torch.Tensor] = None,
                steps: Optional[int] = None,
                go: Optional[torch.Tensor] = None,
                gap: Optional[torch.Tensor] = None,
                k_stride: int = 1) -> None:
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
    if gap is not None:
        if steps is not None:
            raise ValueError("approx_pass: the gap output is the plain "
                             "mode's; the Sec-3.5 mode has none")
        if tuple(gap.shape) != (n,):
            raise ValueError(f"approx_pass: gap must be ({n},), got "
                             f"{tuple(gap.shape)}")
        want.append(("gap", gap, torch.float32))
    for name, t, dtype in want:
        if t.dtype != dtype or t.device != dev:
            raise ValueError(f"approx_pass: {name} must be {dtype} on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"approx_pass: {name} must be contiguous")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"approx_pass: tensors on {dev}, but the current "
                         f"device is {torch.cuda.current_device()}")
    if k_stride < 1:
        raise ValueError(f"approx_pass: k_stride must be >= 1, got "
                         f"{k_stride}")
    if perm.numel() == 0:
        return
    nsteps = 0 if steps is None else int(steps)
    how = plan(d1 - 1, cap, nsteps)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (phi.data_ptr(), phi_i.data_ptr(), bar.data_ptr(),
            planes.data_ptr(), valid.data_ptr(), last_active.data_ptr(),
            gram.data_ptr() if steps is not None else None, perm.data_ptr(),
            go.data_ptr() if go is not None else None,
            gap.data_ptr() if gap is not None else None, n, perm.numel(), cap,
            d1 - 1, nsteps, int(outer_it),
            float(lam),  # repro: allow[R004] host float lam
            inverse_lam(lam),
            int(k0), int(k_stride))
    if how.wide:
        # Freed on return: the caching allocator hands it out again only
        # to work queued on this stream behind the pass.
        scratch = torch.empty((wide_scratch_words(cap),), dtype=torch.int32,
                              device=dev)
        rc = lib.approx_pass_wide_launch(*args, scratch.data_ptr(), stream)
    else:
        rc = lib.approx_pass_launch(*args, how.rows, how.distance + 1,
                                    stream)
    launches += 1
    _build.check(rc, "approx_pass")

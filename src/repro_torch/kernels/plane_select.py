"""CUDA kernel wrapper: fused masked score-and-select over the plane cache.

Replaces ``repro/kernels/plane_select.py::plane_select``.  The kernel
(``csrc/plane_select.cu``) computes, for each selected cache row, the
best valid slot's score ``<planes[r, j], w> + offsets[r, j]`` and the first
slot attaining it, reading only valid slots.  It takes the cache's strided
views ``planes[..., :-1]`` and ``planes[..., -1]`` in place, plus an
optional ``rows`` vector: block ``b`` reads cache row ``rows[b]``, so the
gather of a permutation of blocks is fused into the kernel's loads.
Memory-bound on the valid slots' bytes.  A CTA packs its rows' valid
slots onto its warps, and each warp keeps its next plane in flight by a
bulk copy into shared memory, as :func:`plan` lays out.  See the source
for the design.

This module always launches the kernel: :mod:`repro_torch.kernels.ops`
routes CPU tensors to the plain version before they reach it.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build
from ._build import SMEM_LIMIT

# Kernel launches since the last reset (repro_torch.kernels.ops).
launches = 0

SMS = 132              # streaming multiprocessors of an H100 SXM
MAX_ROWS = 32          # selected rows per CTA (csrc/plane_select.cu kMaxRows)
MAX_CHUNK = 4096       # columns a ring slot holds; wider rows go in chunks
# Rows per CTA are cut until the grid has this many CTAs per SM, so that
# while one CTA reads its row indices and validity others stream planes.
CTAS_PER_SM = 8
# Warps per CTA and ring slots per warp, fixed in the kernel
# (csrc/plane_select.cu kWarps, kStages).
WARPS, STAGES = 2, 3

_P, _L, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
    ctypes.c_float
_SIGNATURE = [_P, _L, _L, _P, _P, _L, _L, _P, _L, _L, _P, _I, _I, _I, _I,
              _F, _P, _P, _I, _I, _I, _P]


class Plan(NamedTuple):
    """One launch: ``rows`` selected rows per CTA, ``chunk`` columns per
    staged copy (a multiple of 32), ``w_shared`` (w staged in shared
    memory, else read through L1) and the ``smem_bytes`` of shared
    memory."""
    rows: int
    chunk: int
    w_shared: bool
    smem_bytes: int


def _round4(x: int) -> int:
    return (x + 3) // 4 * 4


def smem_bytes(rows: int, chunk: int, d: int, cap: int,
               w_shared: bool) -> int:
    """Shared memory of csrc/plane_select.cu's ``make_layout``: each
    warp's ring of :data:`STAGES` slots of ``min(d, chunk) + 6`` floats
    (rounded to 16 bytes), w's slot if staged, one mbarrier per ring slot
    and one for w, the rows' cache indices, a pair list and one value per
    pair (``rows * cap`` each), each row's first pair and first invalid
    slot, and the validity bytes."""
    words = WARPS * STAGES * _round4(min(d, chunk) + 6)
    words += _round4(d + 6) if w_shared else 0
    words += 2 * (WARPS * STAGES + 1) + 2 * rows + 2 * rows * cap
    words += 2 * rows + 1 + (rows * cap + 3) // 4
    return 4 * _round4(words)


def chunk_of(d: int) -> int:
    """Columns per staged copy: a whole row up to :data:`MAX_CHUNK`
    columns, else the row cut into equal chunks of a multiple of 32."""
    pieces = max(1, -(-d // MAX_CHUNK))
    per = -(-d // pieces)
    return max(32, -(-per // 32) * 32)


def _max_cap() -> int:
    """The most slots one row per CTA holds at the smallest width (d = 1),
    below the kernel's 16-bit slot field."""
    lo, hi = 1, (1 << 16) - 1
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if smem_bytes(1, 32, 1, mid, False) <= SMEM_LIMIT:
            lo = mid
        else:
            hi = mid - 1
    return lo


MAX_CAP = _max_cap()


def plan(k: int, cap: int, d: int) -> Plan:
    """The launch plan for ``k`` selected rows of ``cap`` slots of
    ``d``-wide planes, from the shape alone (the launch sits inside the
    pipelined engine's dispatch, so it never reads valid counts).  The
    most rows per CTA, a power of two up to :data:`MAX_ROWS`, that still
    leaves :data:`CTAS_PER_SM` CTAs per SM (one row for small ``k``), and
    no more than shared memory holds; w staged in shared memory where it
    fits beside them.  Raises ``ValueError`` for a ``cap`` or ``d`` the
    kernel cannot hold."""
    if not 1 <= cap <= MAX_CAP:
        raise ValueError(f"plane_select: cap={cap} slots; the kernel holds "
                         f"1 to {MAX_CAP} in shared memory")
    if not 0 <= d < 2 ** 31 - MAX_CHUNK:
        raise ValueError(f"plane_select: d={d} columns; the kernel takes "
                         f"0 to {2 ** 31 - MAX_CHUNK - 1}")
    chunk = chunk_of(d)
    rows = MAX_ROWS
    while rows > 1 and (-(-k // rows) < CTAS_PER_SM * SMS or smem_bytes(
            rows, chunk, d, cap, False) > SMEM_LIMIT):
        rows //= 2
    need = smem_bytes(rows, chunk, d, cap, False)
    if need > SMEM_LIMIT:
        raise ValueError(f"plane_select: cap={cap}, d={d} need {need} B of "
                         f"shared memory (limit {SMEM_LIMIT})")
    w_shared = smem_bytes(rows, chunk, d, cap, True) <= SMEM_LIMIT
    return Plan(rows, chunk, w_shared,
                smem_bytes(rows, chunk, d, cap, w_shared))


def _lib():
    lib = _build.load("plane_select")
    fn = lib.plane_select_launch
    if fn.argtypes is None:
        lib.plane_select_init.restype = ctypes.c_int
        _build.check(lib.plane_select_init(), "plane_select (init)")
        lib.plane_select_smem_bytes.argtypes = [ctypes.c_int] * 5
        lib.plane_select_smem_bytes.restype = ctypes.c_longlong
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
    how = plan(k, cap, d)
    best = torch.empty((k,), dtype=torch.float32, device=planes.device)
    idx = torch.empty((k,), dtype=torch.int32, device=planes.device)
    if k == 0:
        return best, idx
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    rc = _lib().plane_select_launch(
        planes.data_ptr(), planes.stride(0), planes.stride(1), w.data_ptr(),
        offsets.data_ptr(), offsets.stride(0), offsets.stride(1),
        valid.data_ptr(), valid.stride(0), valid.stride(1),
        None if rows is None else rows.data_ptr(), k, n, cap, d,
        float(neg),  # repro: allow[R004] host sentinel
        best.data_ptr(), idx.data_ptr(), how.rows, how.chunk,
        int(how.w_shared), stream)
    launches += 1
    _build.check(rc, "plane_select")
    return best, idx

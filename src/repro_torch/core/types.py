"""Core value types of the MP-BCFW optimizer (PyTorch port).

The containers mirror ``repro/core/types.py``.  Conventions follow the
paper:

  * a *plane* is a vector ``phi in R^{d+1}``; ``phi[:d]`` is the linear part
    (``phi_star``) and ``phi[d]`` is the offset (``phi_circ``),
  * the dual objective is ``F(phi) = -||phi_star||^2 / (2 lam) + phi_circ``,
  * ``w = -phi_star / lam`` recovers the primal weight vector.

Unlike JAX arrays, the tensors in these containers are updated in place
by the passes (:mod:`repro_torch.core.mpbcfw`): the plane cache is
gigabytes at paper size and is never copied.  Counters the host already
knows (oracle calls, averaging steps, the outer iteration) are Python
ints, so reading them never waits for the device.
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional

import numpy as np
import torch


class BCFWState(NamedTuple):
    """Dual state of (MP-)BCFW.

    Attributes:
      phi_i:    (n, d+1) per-block planes (convex combinations of data planes).
      phi:      (d+1,)   running sum of ``phi_i``.
      n_exact:  exact oracle calls so far.
      n_approx: approximate (cached) oracle calls so far.
    """

    phi_i: torch.Tensor
    phi: torch.Tensor
    n_exact: int
    n_approx: int


class AveragingState(NamedTuple):
    """Two-track weighted averaging (paper Sec. 3.6)."""

    bar_exact: torch.Tensor   # (d+1,)
    bar_approx: torch.Tensor  # (d+1,)
    k_exact: int
    k_approx: int


class SSVMProblem(NamedTuple):
    """A structural SVM training problem in plane form.

    ``oracle(w, batch) -> (B, d+1)`` is the max-oracle over a batch of
    examples: ``batch`` is ``data`` with every leaf sliced along its
    leading dimension (one example is a batch of one).  It returns, per
    example, ``argmax_{phi^{iy}} <phi, [w 1]>`` over the label space.  The
    batched form replaces the reference's ``vmap``.
    """

    n: int
    d: int
    data: Any
    oracle: Callable[[torch.Tensor, Any], torch.Tensor]
    meta: Any = None
    spec: Any = None


class PassStats(NamedTuple):
    """Telemetry returned by one optimization pass (for the slope rule)."""

    dual: torch.Tensor   # F(phi) after the pass, a () float32 tensor
    n_exact: int         # cumulative exact oracle calls
    n_approx: int        # cumulative approximate calls


class SlopeClock(NamedTuple):
    """Device timing state of the slope rule (paper Sec. 3.4).

    All fields are () float32 tensors, so the rule's arithmetic is the
    reference's float32 arithmetic, operation for operation.
    """

    t0: torch.Tensor          # iteration start time
    f0: torch.Tensor          # dual at iteration start
    t: torch.Tensor           # time of the latest recorded checkpoint
    plane_cost: torch.Tensor  # cost charged per cached plane per pass


class ObsMetrics(NamedTuple):
    """Cache counters of one outer iteration, read with its stats."""

    ttl_evicted: Any      # planes dropped by TTL eviction
    lru_evicted: Any      # planes overwritten by LRU insert
    occupancy: Any        # total cached planes (after the exact pass)
    nonempty_blocks: Any  # blocks with >= 1 cached plane
    # Gap-policy extras (None unless the engine tracks per-block gaps):
    gap_total: Any = None    # () f32 sum of visited blocks' gap estimates
    #                          after the exact pass
    gap_sampled: Any = None  # blocks the sampler scheduled (host int)


class ApproxBatchStats(NamedTuple):
    """Telemetry of one batch of approximate passes.

    Entries past ``passes_run`` are zero.  As in the reference,
    ``passes_run`` and ``more`` are device values, read with the rest in
    the batch's one host sync (see
    :func:`repro_torch.core.mpbcfw.slope_batched_loop`); ``blocks`` is a
    host int, the blocks per pass, which the host counters are charged
    with after that sync (:func:`repro_torch.core.mpbcfw.count_passes`).
    """

    duals: Any        # (B,) f32  dual value after pass k
    times: Any        # (B,) f32  slope-clock time after pass k
    planes: Any       # (B,) i32  cached planes scored by pass k
    ran: Any          # (B,) bool pass k executed (prefix mask)
    passes_run: Any   # ()   i32  number of executed passes
    f_entry: Any      # ()   f32  dual on entry (after the exact pass)
    more: Any         # ()   bool the rule still wanted another pass
    ws_total: Any     # ()   i32  total cached planes on entry
    metrics: Optional[ObsMetrics] = None
    blocks: int = 0   # blocks per pass (host)


def block_ids(perm) -> List[int]:
    """Block ids of a host permutation (numpy array, list or CPU tensor)."""
    return [int(i) for i in np.asarray(perm).reshape(-1)]


def row_of(t: torch.Tensor, i) -> torch.Tensor:
    """Row ``i`` of ``t``: a view for a host int; a copy for a (1,) int64
    device tensor (a captured block step reads its block on the device)."""
    if isinstance(i, torch.Tensor):
        return t.index_select(0, i.reshape(1))[0]
    return t[i]


def set_row(t: torch.Tensor, i, value: torch.Tensor) -> None:
    """``t[i] = value`` in place, ``i`` as in :func:`row_of`."""
    if isinstance(i, torch.Tensor):
        t.index_copy_(0, i.reshape(1), value.unsqueeze(0))
    else:
        t[i].copy_(value)


def upload(a, device=None, dtype: Optional[torch.dtype] = None, *,
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Values (a numpy array, a list or a tensor) as a tensor on
    ``device`` in ``dtype`` (default: their own); with ``out``, copied
    into ``out``'s leading rows instead (in its device and dtype) and
    ``out`` returned.

    The dispatch path's host-to-device upload (the specs' problem data is
    copied once at set-up, blocking).  To a CUDA device a host source
    is pinned first and the copy enqueued with ``non_blocking=True``: a
    copy from pageable memory waits for the device, a host sync that no
    ledger counts.  A CPU destination keeps the plain, blocking copy."""
    if out is not None:
        device, dtype = out.device, out.dtype
    device = torch.device(device)
    src = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))
    if dtype is not None and src.dtype != dtype:
        src = src.to(dtype)     # where the values are
    to_card = device.type == "cuda"
    if to_card and src.device.type == "cpu":
        src = src.pin_memory()
    if out is None:
        return src.to(device, non_blocking=to_card)
    out[:src.shape[0]].copy_(src, non_blocking=to_card)
    return out


def index_tensor(ids, device) -> torch.Tensor:
    """Block ids (numpy array, list or tensor) as an int64 tensor on
    ``device`` (:func:`upload`: no host sync on CUDA)."""
    return upload(ids, device, torch.int64)

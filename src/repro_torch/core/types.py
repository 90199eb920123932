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

from typing import Any, Callable, NamedTuple, Optional

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


class ApproxBatchStats(NamedTuple):
    """Telemetry of one batch of approximate passes.

    Entries past ``passes_run`` are zero.  ``passes_run`` and ``more`` are
    host values: the port's pass loop reads the continue flag after every
    pass (see :func:`repro_torch.core.mpbcfw.slope_batched_loop`).
    """

    duals: Any        # (B,) f32  dual value after pass k
    times: Any        # (B,) f32  slope-clock time after pass k
    planes: Any       # (B,) i32  cached planes scored by pass k
    ran: Any          # (B,) bool pass k executed (prefix mask)
    passes_run: int   # number of executed passes
    f_entry: Any      # ()   f32  dual on entry (after the exact pass)
    more: bool        # the rule still wanted another pass
    ws_total: Any     # ()   i32  total cached planes on entry
    metrics: Optional[ObsMetrics] = None

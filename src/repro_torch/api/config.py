"""Run configuration and trace/result value types (PyTorch port).

The fields of ``repro/api/config.py`` that the ported ``mpbcfw`` path
reads; a later slice adds the rest with the engines that consume them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from ..core.selection import CostModel


@dataclass
class RunConfig:
    lam: float
    algo: str = "mpbcfw"
    cap: int = 64           # hard cap N (paper: "very large"; memory bound)
    ttl: int = 10           # T, plane time-to-live in outer iterations
    max_iters: int = 50
    max_approx_passes: int = 1000   # M (paper: large; slope rule governs)
    approx_batch: int = 64  # approximate passes per batch
    seed: int = 0
    cost_model: Optional["CostModel"] = None  # None => wall clock
    gap_tol: Optional[float] = None   # stop once duality gap <= gap_tol
    time_budget: Optional[float] = None  # stop once clock.now() >= budget


@dataclass
class TraceRow:
    iteration: int
    n_exact: int
    n_approx: int
    time: float
    primal: float
    dual: float
    gap: float
    primal_avg: float       # primal at the averaged iterate (Sec. 3.6)
    ws_mean: float          # mean working-set size over the iteration
    approx_passes: int      # approximate passes this iteration (Fig. 6)
    host_syncs: int = 1     # device->host syncs in the control loop
    dispatches: int = 1     # engine calls in the control loop
    cache_hit_rate: float = 0.0   # fraction of blocks with >= 1 plane
    planes_evicted: int = 0       # TTL + LRU evictions this iteration
    oracle_share: float = 1.0     # modeled share of time in the exact pass


@dataclass
class RunResult:
    trace: List[TraceRow] = field(default_factory=list)
    w: Optional[np.ndarray] = None
    w_avg: Optional[np.ndarray] = None

"""Run configuration and trace/result value types (PyTorch port).

The fields of ``repro/api/config.py``, in its order.  ``mesh`` is a
:class:`repro_torch.launch.mesh.DataMesh` (one rank of a
``torch.distributed`` group) where the reference takes a JAX mesh.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple, TYPE_CHECKING

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
    gram_steps: int = 10    # repeats per block for the Sec-3.5 scheme
    seed: int = 0
    cost_model: Optional["CostModel"] = None  # None => wall clock
    mesh: Optional[Any] = None   # mpbcfw-shard*: 1-D data mesh, a
    #                              launch.mesh.DataMesh (None => a mesh of
    #                              the default process group, on the
    #                              problem's device)
    tau: Optional[int] = None    # mpbcfw-shard*: tau-nice chunk size
    #                              (None => #shards; must divide n)
    gap_tol: Optional[float] = None   # stop once duality gap <= gap_tol
    time_budget: Optional[float] = None  # stop once clock.now() >= budget
    policies: Optional[Tuple[str, ...]] = None  # repro_torch.policy bundle
    #                         names (one sampling + one eviction + one
    #                         oracle policy); None keeps the engine's own
    gap_frac: float = 0.5   # gap-topk: fraction of blocks whose exact
    #                         oracle runs per iteration (k = max(1,
    #                         round(gap_frac * n)))
    gap_temperature: float = 2.0  # gap-topk gumbel temperature: 1 =
    #                         proportional, > 1 flatter, < 1 greedier
    gap_floor: float = 0.1  # gap-topk min-probability floor, relative to
    #                         the mean gap over seen blocks


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
    oracle_overlap: float = 0.0   # async: hidden share of the oracle time
    # Gap-policy columns (engines tracking per-block duality gaps; the
    # defaults are what the other engines report):
    gap_total: Optional[float] = None  # sum of visited blocks' gap
    #                               estimates after the exact pass
    gap_sampled: int = 0          # blocks the sampling policy scheduled
    #                               for the exact pass this iteration


@dataclass
class RunResult:
    trace: List[TraceRow] = field(default_factory=list)
    w: Optional[np.ndarray] = None
    w_avg: Optional[np.ndarray] = None

"""Automatic pass-selection rule (paper Sec. 3.4), sync ledger, cost model.

After each approximate pass, compare

  * slope_last = dF of the last approximate pass / its runtime, with
  * slope_iter = dF since the beginning of the current outer iteration
                 (including the exact pass) / total runtime of the iteration.

If slope_last < slope_iter, end the iteration and do an exact pass next.

The criterion exists in two forms that share the same algebra:
:func:`slope_continue` on host floats (:class:`IterationTracker`) and
:func:`slope_continue_t` on () float32 tensors, which the pass loop of
:mod:`repro_torch.core.mpbcfw` evaluates on the device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, List, Sequence

import torch

_EPS = 1e-12


def slope_continue(f0: float, t0: float, f_prev: float, t_prev: float,
                   f_last: float, t_last: float) -> bool:
    """The paper's slope criterion on one (prev, last) checkpoint pair."""
    dt_last = max(t_last - t_prev, _EPS)
    dt_iter = max(t_last - t0, _EPS)
    slope_last = (f_last - f_prev) / dt_last
    slope_iter = (f_last - f0) / dt_iter
    return slope_last >= slope_iter


def slope_continue_t(f0, t0, f_prev, t_prev, f_last, t_last) -> torch.Tensor:
    """Tensor twin of :func:`slope_continue`: () float32 inputs, () bool."""
    dt_last = torch.clamp_min(t_last - t_prev, _EPS)
    dt_iter = torch.clamp_min(t_last - t0, _EPS)
    return (f_last - f_prev) / dt_last >= (f_last - f0) / dt_iter


def attribute_wall_time(elapsed: float,
                        weights: Sequence[float]) -> List[float]:
    """Split one measured duration over passes pro-rata by cost weight;
    degenerate weights fall back to a uniform split."""
    if not weights:
        return []
    total = float(sum(weights))
    if total <= 0.0:
        return [elapsed / len(weights)] * len(weights)
    return [elapsed * float(w) / total for w in weights]


@dataclass
class IterationTracker:
    """Tracks (time, dual) checkpoints within one outer iteration."""

    t0: float = 0.0
    f0: float = 0.0
    history: List[tuple] = field(default_factory=list)  # [(t, f), ...]

    def start(self, t: float, f: float) -> None:
        self.t0, self.f0 = t, f
        self.history = [(t, f)]

    def record(self, t: float, f: float) -> None:
        self.history.append((t, f))

    def record_batch(self, ts: Iterable[float], fs: Iterable[float]) -> None:
        for t, f in zip(ts, fs):
            self.record(float(t), float(f))

    def continue_approx(self) -> bool:
        if len(self.history) < 2:
            return True
        t_prev, f_prev = self.history[-2]
        t_last, f_last = self.history[-1]
        return slope_continue(self.f0, self.t0, f_prev, t_prev,
                              f_last, t_last)


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_host(x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_host(x) for x in tree)
    return tree


@dataclass
class SyncLedger:
    """Control-loop synchronization telemetry.

    Counts device->host round-trips (``host_syncs``) and program
    dispatches; ``collectives`` stays 0 on one device.  Only :meth:`sync`
    blocks.
    """

    host_syncs: int = 0
    collectives: int = 0
    dispatches: int = 0

    def counts(self) -> tuple:
        """Snapshot ``(host_syncs, collectives, dispatches)``."""
        return (self.host_syncs, self.collectives, self.dispatches)

    def sync(self, tree):
        """Fetch ``tree`` to the host (one blocking round-trip), counted.

        Tensors become numpy arrays; NamedTuples and tuples keep their
        structure; other leaves pass through.
        """
        self.host_syncs += 1
        return _to_host(tree)

    def dispatched(self, n: int = 1) -> None:
        self.dispatches += n


@dataclass
class CostModel:
    """Deterministic time source for simulation and tests.

    Models a max-oracle costing ``oracle_cost`` seconds per call and an
    approximate step costing ``plane_cost`` per cached plane.
    """

    oracle_cost: float = 1.0
    plane_cost: float = 1e-3
    now: float = 0.0

    def exact_pass(self, n_calls: int) -> float:
        self.now += self.oracle_cost * n_calls
        return self.now

    def approx_pass(self, total_planes: int) -> float:
        self.now += self.plane_cost * max(total_planes, 1)
        return self.now

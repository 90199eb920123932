"""Pluggable stopping criteria for :class:`repro_torch.api.Solver`.

A criterion is any object with ``should_stop(ctx) -> bool``; the solver
asks its criteria before each outer iteration, so ``MaxIters(k)`` admits
exactly ``k`` iterations.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Protocol, runtime_checkable

from .config import TraceRow


@dataclass(frozen=True)
class StopContext:
    """What a criterion may look at before iteration ``iteration`` runs."""

    iteration: int                 # index of the iteration about to run
    last_row: Optional[TraceRow]   # telemetry of the previous iteration
    elapsed: float                 # clock.now(): wall or CostModel seconds


@runtime_checkable
class StoppingCriterion(Protocol):
    def should_stop(self, ctx: StopContext) -> bool: ...


@dataclass(frozen=True)
class MaxIters:
    limit: int

    def should_stop(self, ctx: StopContext) -> bool:
        return ctx.iteration >= self.limit


@dataclass(frozen=True)
class StopOnGap:
    """Stop once the duality gap reaches ``tol`` (NaN never stops)."""

    tol: float

    def should_stop(self, ctx: StopContext) -> bool:
        return (ctx.last_row is not None
                and ctx.last_row.gap <= self.tol)


@dataclass(frozen=True)
class WallTimeBudget:
    """Stop once the run clock (wall or CostModel seconds, evaluation
    excluded) reaches ``budget``."""

    budget: float

    def should_stop(self, ctx: StopContext) -> bool:
        return ctx.elapsed >= self.budget

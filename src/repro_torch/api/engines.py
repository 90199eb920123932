"""Execution engines and their registry (PyTorch port).

An engine owns the passes of one optimizer family and is driven by
:class:`repro_torch.api.Solver` through a fixed seam: ``init_state``,
``outer_iteration``, ``continue_passes``, ``read_stats``, ``evaluate``
and ``extract``, plus a :class:`~repro_torch.core.selection.SyncLedger`.

This slice ports :class:`FusedEngine` as ``mpbcfw``.  Every other
algorithm name raises :class:`~repro_torch.api.errors.UnsupportedConfigError`
(not yet ported).
"""
from __future__ import annotations

from typing import Callable, Dict

from ..core import mpbcfw
from ..core.averaging import extract as extract_average
from ..core.selection import SyncLedger
from ..core.ssvm import weights_of
from ..core.types import SSVMProblem
from .config import RunConfig
from .errors import UnsupportedConfigError

class FusedEngine:
    """Single-device MP-BCFW engine (:func:`repro_torch.core.mpbcfw
    .outer_iteration`).  ``outer_iteration`` enqueues the iteration's
    device work; the slope rule's per-pass flag reads and ``read_stats``
    are the host syncs, all counted on ``ledger``."""

    def __init__(self, problem: SSVMProblem, lam: float):
        self.problem = problem
        self.lam = float(lam)
        self.ledger = SyncLedger()

    def init_state(self, cap: int) -> mpbcfw.MPState:
        return mpbcfw.init_mp_state(self.problem, cap)

    def outer_iteration(self, mp, perm, perms, clock, *, ttl: int):
        self.ledger.dispatched()
        return mpbcfw.outer_iteration(self.problem, mp, perm, perms, clock,
                                      lam=self.lam, ttl=ttl,
                                      ledger=self.ledger)

    def continue_passes(self, mp, perms, clock):
        """Overflow batch of approximate passes (only when an iteration
        runs more than ``approx_batch`` passes)."""
        self.ledger.dispatched()
        return mpbcfw.multi_approx_pass(mp, perms, clock, lam=self.lam,
                                        ledger=self.ledger)

    def read_stats(self, stats):
        return self.ledger.sync(stats)

    def evaluate(self, mp):
        """``(primal, dual, primal)``: ``mpbcfw`` reports no averaged
        primal (the averages are kept; ``extract`` returns them)."""
        from .solver import evaluate_objectives
        return evaluate_objectives(self.problem, mp.inner.phi, None,
                                   self.lam)

    def extract(self, mp):
        w = weights_of(mp.inner.phi, self.lam).cpu().numpy()
        w_avg = weights_of(extract_average(mp.avg, self.lam),
                           self.lam).cpu().numpy()
        return w, w_avg


EngineFactory = Callable[[SSVMProblem, RunConfig], FusedEngine]

_REGISTRY: Dict[str, EngineFactory] = {
    "mpbcfw": lambda problem, cfg: FusedEngine(problem, cfg.lam),
}


def algorithms():
    """The algorithm names the port runs."""
    return tuple(_REGISTRY)


def engine_factory(name: str) -> EngineFactory:
    factory = _REGISTRY.get(name)
    if factory is None:
        raise UnsupportedConfigError(
            f"algorithm {name!r} is not yet ported to repro_torch; "
            f"ported: {algorithms()}")
    return factory


def validate_config(cfg: RunConfig) -> None:
    """Reject configs the ported engine cannot run."""
    if cfg.approx_batch < 1:
        raise UnsupportedConfigError(
            "approx_batch must be >= 1 (use max_approx_passes=0 to "
            "disable approximate passes)")
    if cfg.ttl < 1:
        raise UnsupportedConfigError(
            f"ttl must be >= 1 (planes must survive at least the iteration "
            f"that inserted them), got {cfg.ttl}")
    if cfg.gap_tol is not None and cfg.gap_tol < 0.0:
        raise UnsupportedConfigError(
            f"gap_tol must be >= 0, got {cfg.gap_tol}")

"""Oracle policies: when to stop trusting the cache and recall the oracle
(PyTorch port of ``repro/policy/oracle.py``).

The one shipped policy is the paper's geometric slope rule (Sec. 3.4,
parameter ``M``): :func:`repro_torch.core.selection.slope_continue_t`,
the function the engines apply without a bundle, so the default bundle's
stopping decisions are bit-identical.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..core.selection import slope_continue_t
from .base import register_policy


@dataclass(frozen=True)
class SlopeOracle:
    """Run another approximate pass while its dual-progress slope beats
    ``M`` times the whole-iteration slope (paper Sec. 3.4)."""

    name: str = "slope"

    @staticmethod
    def continue_fn(f0, t0, f, t, f_new, t_new):
        return slope_continue_t(f0, t0, f, t, f_new, t_new)


def _slope_factory(cfg, n: int) -> SlopeOracle:
    del cfg, n
    return SlopeOracle()


register_policy("slope", "oracle", _slope_factory)

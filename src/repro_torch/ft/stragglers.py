"""Straggler mitigation for tau-nice and pipelined MP-BCFW.

The paper's approximate oracle doubles as a fault-tolerance path: a block
whose exact oracle misses its deadline (a slow node, a preemption) folds
its best cached plane instead, a step that is still monotone in the dual
and costs O(|W_i| d).  Training never waits for the slowest oracle.

:func:`fallback_planes` is that path for all sampled blocks at once: one
``plane_select`` launch over their cache rows.
:func:`simulate_oracle_outcomes` models per-block oracle latencies
(lognormal, with a straggler tail) against a deadline; it is host numpy
and draws exactly the numbers ``repro/ft/stragglers.py`` draws from the
same ``RandomState``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.distributed import fallback_planes  # noqa: F401


@dataclass(frozen=True)
class StragglerPolicy:
    deadline_factor: float = 3.0     # deadline = factor * median latency
    straggler_prob: float = 0.02     # chance a node is pathologically slow
    straggler_scale: float = 20.0    # tail multiplier
    sigma: float = 0.3               # lognormal spread of healthy nodes


def simulate_oracle_outcomes(n_blocks: int, policy: StragglerPolicy,
                             rng: np.random.RandomState):
    """Returns (done_mask, latencies): done[b] = oracle finished in time."""
    lat = np.exp(rng.randn(n_blocks) * policy.sigma)
    slow = rng.rand(n_blocks) < policy.straggler_prob
    lat = np.where(slow, lat * policy.straggler_scale, lat)
    deadline = np.median(lat) * policy.deadline_factor
    return lat <= deadline, lat

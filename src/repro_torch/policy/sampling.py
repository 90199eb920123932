"""Sampling policies: which blocks the exact pass spends the oracle on
(PyTorch port of ``repro/policy/sampling.py``).

The exact max-oracle call is the scarce resource (the paper's premise),
so the sampler decides where the oracle budget goes.
:class:`UniformSampling` is the paper's (and BCFW's, arXiv:1207.4747)
uniform permutation; :class:`GapSampling` is Osokin et al.'s
gap-proportional rule (arXiv:1605.09346): sample blocks with probability
proportional to their duality-gap estimates.

Sampling without replacement proportional to the gaps is a gumbel-top-k:
perturb ``log gap_i`` with i.i.d. Gumbel noise and take the top ``k``.
The logits and the top-k run on the cache's device, with nothing read
back; the noise is drawn on the host (:func:`gumbel_noise`) and moved
with one non-blocking copy, so one seed gives one schedule on the card
and on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core.types import upload
from .base import register_policy


def gumbel_noise(seed: int, n: int) -> torch.Tensor:
    """(n,) float32 standard Gumbel noise on the CPU from the host seed
    ``seed``: ``-log(-log(u))`` of uniforms ``u`` drawn by a CPU
    ``torch.Generator``, clamped below at the smallest normal float32
    (``jax.random.gumbel``'s ``minval``).  A CPU generator's stream is
    the same whatever device the schedule runs on."""
    gen = torch.Generator().manual_seed(int(seed))
    u = torch.rand((n,), generator=gen, dtype=torch.float32)
    u = torch.clamp_min(u, float(np.finfo(np.float32).tiny))
    return -torch.log(-torch.log(u))


@dataclass(frozen=True)
class UniformSampling:
    """Visit every block once, in the solver's uniform permutation:
    ``schedule`` returns ``perm`` untouched, so the default bundle runs
    what the engines run without one."""

    name: str = "uniform"
    needs_gap: bool = False
    needs_key: bool = False

    def schedule(self, cache, perm, key: Optional[int]):
        del cache, key
        return perm


@dataclass(frozen=True)
class GapSampling:
    """Gap-proportional sampling without replacement (gumbel-top-k).

    Draws ``k`` distinct blocks with probabilities proportional to their
    gap estimates: the top ``k`` of ``log(max(gap, floor * ref)) /
    temperature`` plus Gumbel noise, where ``ref`` is the mean gap over
    the blocks seen so far.  Blocks never visited hold
    :data:`repro_torch.cache.GAP_UNSEEN` and take the logit ``1e9``, above
    every seen block at any temperature; ``1e9`` plus any Gumbel draw
    rounds back to ``1e9`` in float32, so they tie, and the top-k keeps
    tied blocks in index order (a stable descending sort, as
    ``jax.lax.top_k`` orders ties): the first iterations sweep the data
    in block order.  ``floor`` keeps a converged (or stale) block
    samplable relative to the mean gap; ``temperature`` 1 is exact
    gap-proportional sampling, above 1 flatter, below 1 greedier.  See
    the reference's class for the tuning note.
    """

    k: int
    floor: float = 0.1
    temperature: float = 2.0
    name: str = "gap-topk"
    needs_gap: bool = True
    needs_key: bool = True

    def schedule(self, cache, perm, key: Optional[int]) -> torch.Tensor:
        """(k,) int64 block ids on the cache's device, from the gap vector
        and the noise of seed ``key``; nothing is read on the host."""
        del perm
        from ..cache import GAP_UNSEEN
        gap = cache.gap
        dev = gap.device
        seen = gap < GAP_UNSEEN * 0.5
        pos = torch.where(seen, torch.clamp_min(gap, 0.0), 0.0)
        n_seen = torch.clamp_min(seen.to(torch.float32).sum(), 1.0)
        ref = pos.sum() / n_seen
        ref = torch.where(ref > 0.0, ref, 1.0)
        w = torch.maximum(pos, self.floor * ref)
        # A true division by a device scalar (PyTorch's CUDA division by
        # a Python number multiplies by its rounded reciprocal).
        temp = torch.full((), float(np.float32(max(self.temperature, 1e-6))),
                          dtype=torch.float32, device=dev)
        logits = torch.where(seen, torch.log(w) / temp, 1e9)
        noise = upload(gumbel_noise(key, gap.shape[0]), dev)
        order = torch.sort(logits + noise, descending=True, stable=True)[1]
        return order[:self.k]


def _uniform_factory(cfg, n: int) -> UniformSampling:
    del cfg, n
    return UniformSampling()


def _gap_factory(cfg, n: int) -> GapSampling:
    from ..api.errors import UnsupportedConfigError
    frac = getattr(cfg, "gap_frac", 0.5)
    if not (0.0 < frac <= 1.0):
        raise UnsupportedConfigError(
            f"gap_frac={frac!r} out of range: the gap-topk sampler needs "
            "0 < gap_frac <= 1 (fraction of blocks per exact pass)")
    temp = getattr(cfg, "gap_temperature", 2.0)
    floor = getattr(cfg, "gap_floor", 0.1)
    if temp <= 0.0:
        raise UnsupportedConfigError(
            f"gap_temperature={temp!r} must be > 0 (1 = proportional, "
            "> 1 = flatter/exploratory, < 1 = greedier)")
    if floor <= 0.0:
        raise UnsupportedConfigError(
            f"gap_floor={floor!r} must be > 0 (the min-probability floor "
            "keeps converged blocks samplable)")
    return GapSampling(k=max(1, round(frac * n)), floor=floor,
                       temperature=temp)


register_policy("uniform", "sampling", _uniform_factory)
register_policy("gap-topk", "sampling", _gap_factory)

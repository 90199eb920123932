"""Multi-Plane Block-Coordinate Frank-Wolfe (paper Alg. 3), PyTorch port.

The algorithm interleaves

  * **exact passes**: one true max-oracle call per block; the returned
    plane joins the block's working set (LRU-capped), and
  * **approximate passes**: BCFW steps against the cached planes only
    (``H~_i(w) = max_{phi in W_i} <phi, [w 1]>``), costing O(|W_i| d) each.

The reference fuses one outer iteration into one XLA program
(``lax.scan`` over blocks, ``lax.while_loop`` over passes).  Here a pass
is a host loop over the blocks of the host permutation; every step is
device work enqueued without blocking (no ``.item()``: slots stay index
tensors).  The slope rule (Sec. 3.4) is computed on the device in float32
exactly as in the reference, and the host reads its continue flag once
per approximate pass: one counted host sync per pass, where the
reference has none (ROADMAP C).

State tensors are updated in place (see :mod:`repro_torch.core.types`).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import cache as plane_cache
from ..cache import CacheLayout, PlaneCache
from .averaging import init_averaging, update_average
from .bcfw import block_update
from .selection import SyncLedger, slope_continue_t
from .ssvm import dual_value, init_state, weights_of
from .types import (ApproxBatchStats, AveragingState, BCFWState, ObsMetrics,
                    SlopeClock, SSVMProblem)


class MPState(NamedTuple):
    """Full MP-BCFW state: dual state + plane cache + averaging."""

    inner: BCFWState
    cache: PlaneCache
    avg: AveragingState
    outer_it: int  # outer-iteration counter (for TTL)


def _example(problem: SSVMProblem, i: int):
    """Block ``i`` as a batch of one (views, no copies)."""
    return {k: v[i:i + 1] for k, v in problem.data.items()}


def _blocks(perm) -> Sequence[int]:
    """Block ids of a host permutation (numpy array, list or CPU tensor)."""
    return [int(i) for i in np.asarray(perm).reshape(-1)]


def exact_pass(problem: SSVMProblem, mp: MPState, perm,
               lam: float) -> MPState:
    """Paper Alg. 3 step 3: BCFW pass with the real oracle + plane caching."""
    st, c, av = mp.inner, mp.cache, mp.avg
    blocks = _blocks(perm)
    for i in blocks:
        w = weights_of(st.phi, lam)
        phi_hat = problem.oracle(w, _example(problem, i))[0]
        st, _ = block_update(st, i, phi_hat, lam)
        c = plane_cache.insert(c, i, phi_hat, mp.outer_it)
        av = update_average(av, st.phi, exact=True)
    st = st._replace(n_exact=st.n_exact + len(blocks))
    return MPState(inner=st, cache=c, avg=av, outer_it=mp.outer_it)


def approx_pass(problem: Optional[SSVMProblem], mp: MPState, perm,
                lam: float) -> MPState:
    """Paper Alg. 3 step 4: BCFW pass against the cached planes only."""
    del problem  # the approximate pass never touches the data
    st, c, av = mp.inner, mp.cache, mp.avg
    blocks = _blocks(perm)
    for i in blocks:
        w = weights_of(st.phi, lam)
        phi_hat, slot, _ = plane_cache.approx_oracle(c, i, w)
        st, _ = block_update(st, i, phi_hat, lam)
        # A plane is "active" if the (approximate) oracle returned it.
        c = plane_cache.mark_active(c, i, slot, mp.outer_it)
        av = update_average(av, st.phi, exact=False)
    st = st._replace(n_approx=st.n_approx + len(blocks))
    return MPState(inner=st, cache=c, avg=av, outer_it=mp.outer_it)


def begin_iteration(mp: MPState, ttl: int) -> MPState:
    """TTL eviction + outer-iteration increment (paper Sec. 3.4, N/T)."""
    it = mp.outer_it + 1
    return mp._replace(cache=plane_cache.evict_stale(mp.cache, it, ttl),
                       outer_it=it)


def make_slope_clock(t0, f0, t, plane_cost, device) -> SlopeClock:
    """The device timing state of the slope rule (() float32 tensors)."""
    def f32(x: float) -> torch.Tensor:
        return torch.tensor(x, dtype=torch.float32, device=device)
    return SlopeClock(t0=f32(t0), f0=f32(f0), t=f32(t),
                      plane_cost=f32(plane_cost))


def slope_batched_loop(carry, perms, clock: SlopeClock, *,
                       step: Callable, f_entry: torch.Tensor,
                       cost: torch.Tensor, planes_per_pass: torch.Tensor,
                       ledger: SyncLedger, run_all: bool = False):
    """Up to ``len(perms)`` passes governed by the slope rule.

    ``step(carry, perm) -> (carry, f_new)`` runs one pass.  The rule is
    the reference's float32 arithmetic on device tensors (``t + cost``
    accumulated in float32); the host reads the continue flag once per
    pass through ``ledger``.  ``run_all`` disables the rule (no reads).
    Returns ``(carry, t_end, stats)``.
    """
    n_batch = len(perms)
    dev = f_entry.device
    duals = torch.zeros((n_batch,), dtype=torch.float32, device=dev)
    times = torch.zeros((n_batch,), dtype=torch.float32, device=dev)
    planes = torch.zeros((n_batch,), dtype=torch.int32, device=dev)
    t, f, k, more = clock.t, f_entry, 0, True
    while more and k < n_batch:
        carry, f_new = step(carry, perms[k])
        t_new = t + cost
        cont = slope_continue_t(clock.f0, clock.t0, f, t, f_new, t_new)
        duals[k] = f_new
        times[k] = t_new
        planes[k] = planes_per_pass
        t, f, k = t_new, f_new, k + 1
        more = True if run_all else bool(ledger.sync(cont))
    stats = ApproxBatchStats(
        duals=duals, times=times, planes=planes,
        ran=torch.arange(n_batch, device=dev) < k, passes_run=k,
        f_entry=f_entry, more=more, ws_total=planes_per_pass)
    return carry, t, stats


def multi_approx_pass(mp: MPState, perms, clock: SlopeClock, *, lam: float,
                      ledger: Optional[SyncLedger] = None,
                      run_all: bool = False
                      ) -> Tuple[MPState, SlopeClock, ApproxBatchStats]:
    """Up to ``len(perms)`` approximate passes under the slope rule.

    A stopped loop runs no further pass, so the result equals exactly
    ``passes_run`` sequential :func:`approx_pass` applications.
    """
    ledger = SyncLedger() if ledger is None else ledger
    f_entry = dual_value(mp.inner.phi, lam)
    # Approximate passes never insert or evict planes, so the per-pass
    # cost, Theta(sum_i |W_i|), is constant across the batch.
    total_planes = plane_cache.sizes(mp.cache).sum().to(torch.int32)
    cost = clock.plane_cost * torch.clamp_min(total_planes, 1).to(
        torch.float32)

    def step(state: MPState, perm):
        state = approx_pass(None, state, perm, lam)
        return state, dual_value(state.inner.phi, lam)

    mp, t, stats = slope_batched_loop(
        mp, perms, clock, step=step, f_entry=f_entry, cost=cost,
        planes_per_pass=total_planes, ledger=ledger, run_all=run_all)
    zero = torch.zeros((), dtype=torch.int32, device=f_entry.device)
    metrics = ObsMetrics(ttl_evicted=zero, lru_evicted=zero,
                         occupancy=total_planes,
                         nonempty_blocks=mp.cache.nonempty_blocks)
    return mp, clock._replace(t=t), stats._replace(metrics=metrics)


def outer_iteration(problem: SSVMProblem, mp: MPState, perm, perms,
                    clock: SlopeClock, *, lam: float, ttl: int,
                    ledger: Optional[SyncLedger] = None,
                    run_all: bool = False):
    """One MP-BCFW outer iteration: TTL eviction, the exact pass, and the
    slope-ruled batch of approximate passes.

    ``clock.f0`` is re-seeded on the device from the dual at iteration
    entry; the host supplies ``clock.t`` (the modeled exact-pass cost) and
    ``clock.plane_cost``.  Returns ``(mp, clock, stats)``.
    """
    occ0 = mp.cache.occupancy                 # before eviction
    mp = begin_iteration(mp, ttl)
    occ1 = mp.cache.occupancy                 # after eviction
    clock = clock._replace(f0=dual_value(mp.inner.phi, lam))
    mp = exact_pass(problem, mp, perm, lam)
    occ2 = mp.cache.occupancy                 # after the insert scan
    mp, clock, stats = multi_approx_pass(mp, perms, clock, lam=lam,
                                         ledger=ledger, run_all=run_all)
    # Eviction accounting, on the device: TTL dropped occ0-occ1 planes;
    # the exact pass inserted one plane per visited block, so the LRU
    # overwrites are the inserts that did not grow the cache.
    n_inserts = len(perm)
    metrics = stats.metrics._replace(ttl_evicted=occ0 - occ1,
                                     lru_evicted=occ1 + n_inserts - occ2)
    return mp, clock, stats._replace(metrics=metrics)


def init_mp_state(problem: SSVMProblem, cap: Union[int, CacheLayout],
                  device=None) -> MPState:
    """Fresh MP-BCFW state on ``device`` (default: where the data lives)."""
    if device is None:
        device = next(iter(problem.data.values())).device
    layout = cap if isinstance(cap, CacheLayout) else CacheLayout(cap=int(cap))
    return MPState(inner=init_state(problem, device),
                   cache=plane_cache.init(layout, problem.n, problem.d,
                                          device),
                   avg=init_averaging(problem.d, device),
                   outer_it=0)

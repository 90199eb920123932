"""Multi-Plane Block-Coordinate Frank-Wolfe (paper Alg. 3), PyTorch port.

The algorithm interleaves

  * **exact passes**: one true max-oracle call per block; the returned
    plane joins the block's working set (LRU-capped), and
  * **approximate passes**: BCFW steps against the cached planes only
    (``H~_i(w) = max_{phi in W_i} <phi, [w 1]>``), costing O(|W_i| d) each.

The reference fuses one outer iteration into one XLA program
(``lax.scan`` over blocks, ``lax.while_loop`` over passes).  Here the
exact pass is one block step per block of the host permutation, the
block read on the device (:func:`exact_step`): a plain loop on the CPU,
and on CUDA one replay per block of the step's captured CUDA graph
(:mod:`repro_torch.core.graphs`), nothing read on the host (no
``.item()``: slots stay index tensors).  An approximate pass is one
launch of the ``approx_pass`` kernel over a device permutation (on the
CPU its plain version, :func:`eager_pass`), and a batch of passes is
enqueued whole: each pass is gated on the device by the slope rule's flag (Sec.
3.4), computed in float32 exactly as in the reference.  Nothing is read
on the host until the engine reads the batch's stats: one sync per
dispatch, as in the reference.

A cache with Gram blocks (``CacheLayout(gram=True)``, engine
``mpbcfw-gram``) switches the approximate passes to the Sec-3.5
multi-step scheme (:mod:`repro_torch.core.gram`, the same kernel in its
other mode); its insertions refresh the Gram rows inside
:func:`repro_torch.cache.ops.insert`.

The pipelined variant (``mpbcfw-async``) splits an outer iteration into
an oracle program and a cache program (:func:`async_oracle_program`,
:func:`async_cache_program`); see the section at the end of this module.

A :class:`repro_torch.policy.PolicyBundle` (``policies``) replaces the
baked-in decisions: its eviction policy runs instead of the TTL rule, its
sampler turns the host permutation into the exact pass's schedule (the
gap sampler's on the device, read by the captured step through its
control buffers), and its oracle policy replaces the slope rule.  A cache
with a gap vector (``CacheLayout(track_gap=True)``) has it written by the
exact step (the true block gap) and by every approximate pass (the
cache's underestimate).

State tensors are updated in place (see :mod:`repro_torch.core.types`).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from .. import cache as plane_cache
from ..cache import CacheLayout, PlaneCache
from ..kernels import ops as kops
from .averaging import average_step, init_averaging, weight_table
from . import bcfw
from .bcfw import block_update
from .distributed import (fallback_planes, fold_planes, parallel_oracles,
                          state_tensors)
from .gram import multi_step_block_update
from .graphs import StepControl, StepGraphs, load_control
from .selection import slope_continue_t
from .ssvm import dual_value, init_state, weights_of
from .types import (ApproxBatchStats, AveragingState, BCFWState, ObsMetrics,
                    SlopeClock, SSVMProblem, block_ids, index_tensor,
                    upload)


class MPState(NamedTuple):
    """Full MP-BCFW state: dual state + plane cache + averaging."""

    inner: BCFWState
    cache: PlaneCache
    avg: AveragingState
    outer_it: int  # outer-iteration counter (for TTL)


def exact_step(problem: SSVMProblem, mp: MPState, ctl: StepControl,
               lam: float) -> None:
    """One exact block step, in place, with the block read on the device:
    BCFW's step (:func:`repro_torch.core.bcfw.block_step`: the spec's
    oracle at ``w = -phi*/lam`` on block ``ctl.ids[cursor]``, the line
    search and an exact-track averaging step with the pass's weights), then
    the cache insert (LRU slot, Gram row) stamped ``ctl.it``, which reads
    nothing the averaging step writes, and, with a gap vector, the block's
    true gap at the step's ``w`` (:func:`repro_torch.cache.update_gap`).
    Advances the cursor.  The body of :func:`exact_pass`'s loop, and of its
    captured graph on CUDA."""
    i, phi_hat, gap = bcfw.block_step(problem, mp.inner, mp.avg.bar_exact,
                                      ctl, lam,
                                      with_gap=mp.cache.gap is not None)
    plane_cache.insert(mp.cache, i, phi_hat, ctl.it)
    plane_cache.update_gap(mp.cache, i, gap)
    ctl.cursor.add_(1)


def exact_pass(problem: SSVMProblem, mp: MPState, perm, lam: float, *,
               graphs: StepGraphs) -> MPState:
    """Paper Alg. 3 step 3: BCFW pass with the real oracle + plane caching,
    over the blocks of ``perm``: a host permutation, or an int64 tensor on
    the state's device (a sampler's schedule, never read on the host).

    One :func:`exact_step` per block: a plain loop on the CPU; on CUDA one
    replay per block of the step's captured graph, kept in ``graphs`` (an
    engine's :class:`~repro_torch.core.graphs.StepGraphs`).  The host
    counters ``n_exact`` and ``k_exact`` advance by the pass's length.
    """
    if not isinstance(perm, torch.Tensor):
        perm = np.asarray(  # repro: allow[R004] host permutation
            perm, np.int64).reshape(-1)
    m = len(perm)
    ctl = graphs.control("exact", state_tensors(mp) + tuple(
        problem.data.values()), (lam, problem.oracle), m, problem.d)
    load_control(ctl, perm, k0=mp.avg.k_exact, it=mp.outer_it)
    graphs.run("exact", "exact", lambda: exact_step(problem, mp, ctl, lam),
               m)
    return mp._replace(
        inner=mp.inner._replace(n_exact=mp.inner.n_exact + m),
        avg=mp.avg._replace(k_exact=mp.avg.k_exact + m))


def eager_pass(phi: torch.Tensor, phi_i: torch.Tensor, bar: torch.Tensor,
               planes: torch.Tensor, valid: torch.Tensor,
               last_active: torch.Tensor, perm: torch.Tensor, *, lam: float,
               k0: int, outer_it: int, gram: Optional[torch.Tensor] = None,
               steps: Optional[int] = None,
               go: Optional[torch.Tensor] = None,
               gap: Optional[torch.Tensor] = None,
               k_stride: int = 1) -> None:
    """One approximate pass over the blocks of ``perm``, in place, as a
    loop of per-block device ops: the plain version of the ``approx_pass``
    kernel (:func:`repro_torch.kernels.ops.approx_pass`, same arguments),
    which runs the same pass in one launch.

    Without ``steps``, each block takes its best cached plane at
    ``w = -phi*/lam`` (:func:`repro_torch.cache.ops.approx_oracle`), the
    exact line search step (:func:`repro_torch.core.bcfw.block_update`)
    and marks the plane active at ``outer_it``; with ``steps`` (and the
    Gram leaf) it runs the Sec-3.5 recurrences
    (:func:`repro_torch.core.gram.multi_step_block_update`) and stamps the
    planes they picked.  After each block, one averaging step of ``bar``
    with ``k = k0 + k_stride * position``.  A false ``go`` flag leaves
    everything untouched (on the CPU reading it is no device sync).  In
    the plain mode a ``gap`` vector takes each block's gap estimate: the
    chosen plane's score minus ``<phi_i, [w 1]>`` of the row before its
    update, clamped at 0 (:func:`repro_torch.cache.update_gap`).  The
    host counters are the caller's (:func:`count_passes`).
    """
    if go is not None and not bool(go):
        return
    if gap is not None and steps is not None:
        raise ValueError("eager_pass: the gap output is the plain mode's; "
                         "the Sec-3.5 mode has none")
    cache = PlaneCache(planes=planes, valid=valid, last_active=last_active,
                       gram=gram, gap=gap)
    st = BCFWState(phi_i=phi_i, phi=phi, n_exact=0, n_approx=0)
    ids = block_ids(perm.cpu())  # repro: allow[R004] plain version, CPU only
    weights = upload(weight_table(int(k0), len(ids), int(k_stride)),
                     phi.device)
    scratch = torch.empty_like(phi)
    for pos, i in enumerate(ids):
        if steps is None:
            w = weights_of(phi, lam)
            phi_hat, slot, score = plane_cache.approx_oracle(cache, i, w)
            # The cache's gap underestimate (H~_i <= H_i): the best cached
            # plane's score minus the current iterate's.
            g = (score - bcfw.plane_score(phi_i[i], w) if gap is not None
                 else None)
            block_update(st, i, phi_hat, lam)
            # A plane is "active" if the (approximate) oracle returned it.
            plane_cache.mark_active(cache, i, slot, outer_it)
            plane_cache.update_gap(cache, i, g)
        else:
            new_phi_i, new_phi, won = multi_step_block_update(
                planes[i], valid[i], gram[i], phi, phi_i[i], lam, steps)
            phi.copy_(new_phi)
            phi_i[i].copy_(new_phi_i)
            plane_cache.mark_active_where(cache, i, won, outer_it)
        average_step(bar, phi, weights[pos], scratch)


def run_pass(mp: MPState, perm: torch.Tensor, lam: float,
             steps: Optional[int] = None, *, k0: Optional[int] = None,
             go: Optional[torch.Tensor] = None, k_stride: int = 1) -> None:
    """One approximate pass over the blocks of ``perm`` (an int64 tensor on
    the state's device), in place: one ``approx_pass`` kernel launch on
    CUDA, its plain version :func:`eager_pass` on the CPU.  ``steps`` runs
    the Sec-3.5 scheme over the cache's Gram blocks.  ``k0`` is the
    averaging count at pass start (default: the state's), advancing by
    ``k_stride`` per block; a false ``go``
    flag makes the pass a no-op.  A plain pass writes the cache's gap
    vector, when it has one.  The host counters are left to the caller
    (:func:`count_passes`)."""
    c = mp.cache
    fn = eager_pass if mp.inner.phi.device.type == "cpu" else kops.approx_pass
    fn(mp.inner.phi, mp.inner.phi_i, mp.avg.bar_approx, c.planes, c.valid,
       c.last_active, perm, lam=lam,
       k0=mp.avg.k_approx if k0 is None else k0, outer_it=mp.outer_it,
       gram=c.gram if steps is not None else None, steps=steps, go=go,
       gap=c.gap if steps is None else None, k_stride=k_stride)


def count_passes(mp: MPState, passes: int, blocks: int,
                 steps: Optional[int] = None) -> MPState:
    """Charge ``passes`` approximate passes of ``blocks`` blocks to the
    host counters: ``steps`` (1 by default) approximate oracle calls and
    one averaging step per block."""
    calls = passes * blocks
    return mp._replace(
        inner=mp.inner._replace(
            n_approx=mp.inner.n_approx + calls * (steps or 1)),
        avg=mp.avg._replace(k_approx=mp.avg.k_approx + calls))


def approx_pass(problem: Optional[SSVMProblem], mp: MPState, perm,
                lam: float) -> MPState:
    """Paper Alg. 3 step 4: BCFW pass against the cached planes only, over
    the blocks of the host permutation ``perm`` (:func:`run_pass`)."""
    del problem  # the approximate pass never touches the data
    ids = index_tensor(perm, mp.inner.phi.device)
    run_pass(mp, ids, lam)
    return count_passes(mp, 1, ids.numel())


def begin_iteration(mp: MPState, ttl: int, eviction=None) -> MPState:
    """Eviction + outer-iteration increment (paper Sec. 3.4, N/T).

    ``eviction`` is an optional :class:`repro_torch.policy.EvictionPolicy`;
    None keeps the paper's TTL rule with the explicit ``ttl``.
    """
    it = mp.outer_it + 1
    cache = (plane_cache.evict_stale(mp.cache, it, ttl)
             if eviction is None else eviction.evict(mp.cache, it))
    return mp._replace(cache=cache, outer_it=it)


def make_slope_clock(t0, f0, t, plane_cost, device) -> SlopeClock:
    """The device timing state of the slope rule (() float32 tensors,
    uploaded together without a host sync)."""
    return SlopeClock(*upload(
        np.array([t0, f0, t, plane_cost], np.float32), device).unbind())


def slope_batched_loop(n_batch: int, clock: SlopeClock, *,
                       step: Callable, f_entry: torch.Tensor,
                       cost: torch.Tensor, planes_per_pass: torch.Tensor,
                       run_all: bool = False, continue_fn=None):
    """Up to ``n_batch`` passes governed by the slope rule, with no host
    read: the reference's ``lax.while_loop`` unrolled into gated passes.

    ``step(k, more) -> f_new`` runs pass ``k`` in place when the ()
    bool device flag ``more`` holds (and is a no-op otherwise) and returns
    the dual after it.  Every pass of the batch is enqueued; the flag
    ``more`` is the reference's loop condition, on the device: once the
    rule says stop, the later passes do nothing and their telemetry stays
    zero.  The rule is the reference's float32 arithmetic (``t + cost``
    accumulated in float32).  ``continue_fn`` swaps the stopping rule (an
    :class:`repro_torch.policy.OraclePolicy`'s device decision; None keeps
    the slope rule); ``run_all`` disables it.  Returns
    ``(t_end, stats)``; ``stats.passes_run`` and ``stats.more`` are device
    tensors, read with the rest of the stats in the caller's one sync.
    """
    cont_fn = slope_continue_t if continue_fn is None else continue_fn
    dev = f_entry.device
    duals = torch.zeros((n_batch,), dtype=torch.float32, device=dev)
    times = torch.zeros((n_batch,), dtype=torch.float32, device=dev)
    planes = torch.zeros((n_batch,), dtype=torch.int32, device=dev)
    passes_run = torch.zeros((), dtype=torch.int32, device=dev)
    more = torch.ones((), dtype=torch.bool, device=dev)
    t, f = clock.t, f_entry
    for k in range(n_batch):
        f_new = step(k, more)
        t_new = t + cost
        if run_all:
            cont = torch.ones((), dtype=torch.bool, device=dev)
        else:
            cont = cont_fn(clock.f0, clock.t0, f, t, f_new, t_new)
        # Only where pass k ran: the reference's loop never reaches it.
        duals[k] = torch.where(more, f_new, duals[k])
        times[k] = torch.where(more, t_new, times[k])
        planes[k] = torch.where(more, planes_per_pass, planes[k])
        t = torch.where(more, t_new, t)
        f = torch.where(more, f_new, f)
        passes_run = passes_run + more.to(torch.int32)
        more = more & cont
    stats = ApproxBatchStats(
        duals=duals, times=times, planes=planes,
        ran=torch.arange(n_batch, device=dev) < passes_run,
        passes_run=passes_run, f_entry=f_entry, more=more,
        ws_total=planes_per_pass)
    return t, stats


def multi_approx_pass(mp: MPState, perms, clock: SlopeClock, *, lam: float,
                      steps: Optional[int] = None,
                      run_all: bool = False, policies=None
                      ) -> Tuple[MPState, SlopeClock, ApproxBatchStats]:
    """Up to ``len(perms)`` approximate passes under the slope rule, with
    no host read.

    Each pass is one gated :func:`run_pass` (one ``approx_pass`` launch on
    CUDA): a stopped loop runs no further pass, so the state equals
    exactly ``passes_run`` sequential :func:`approx_pass` applications.
    The pass ``k`` of the batch starts at the averaging count ``k_approx +
    k n``, which the host knows without reading the device, since passes
    run in order.  The host counters ``n_approx`` and ``k_approx`` are
    left for :func:`count_passes` once the stats are read
    (``FusedEngine.count_passes``).  A cache with Gram blocks runs the
    Sec-3.5 scheme, ``steps`` updates per block (required there, unread
    without Gram blocks).  ``policies`` (a bundle) supplies the stopping
    rule, its oracle policy's ``continue_fn``.
    """
    f_entry = dual_value(mp.inner.phi, lam)
    # Approximate passes never insert or evict planes, so the per-pass
    # cost, Theta(sum_i |W_i|), is constant across the batch.
    total_planes = plane_cache.sizes(mp.cache).sum().to(torch.int32)
    cost = clock.plane_cost * torch.clamp_min(total_planes, 1).to(
        torch.float32)

    use_gram = mp.cache.gram is not None
    if use_gram and steps is None:
        raise ValueError("a cache with Gram blocks needs the step count")
    dev_perms = index_tensor(perms, f_entry.device)
    blocks = dev_perms.shape[-1] if len(perms) else 0

    def step(k: int, go: torch.Tensor):
        run_pass(mp, dev_perms[k], lam, steps if use_gram else None,
                 k0=mp.avg.k_approx + k * blocks, go=go)
        return dual_value(mp.inner.phi, lam)

    t, stats = slope_batched_loop(
        len(perms), clock, step=step, f_entry=f_entry, cost=cost,
        planes_per_pass=total_planes, run_all=run_all,
        continue_fn=None if policies is None else policies.oracle.continue_fn)
    zero = torch.zeros((), dtype=torch.int32, device=f_entry.device)
    metrics = ObsMetrics(ttl_evicted=zero, lru_evicted=zero,
                         occupancy=total_planes,
                         nonempty_blocks=mp.cache.nonempty_blocks)
    return mp, clock._replace(t=t), stats._replace(metrics=metrics,
                                                   blocks=blocks)


def exact_schedule(policies, cache: PlaneCache, perm, key: Optional[int]):
    """The blocks the exact oracle visits: ``perm``, or the bundle's
    sampler's schedule of it (``key``: the iteration's seed)."""
    if policies is None:
        return perm
    return policies.sampling.schedule(cache, perm, key)


def outer_iteration(problem: SSVMProblem, mp: MPState, perm, perms,
                    clock: SlopeClock, *, lam: float, ttl: int,
                    graphs: StepGraphs, steps: Optional[int] = None,
                    run_all: bool = False, policies=None,
                    key: Optional[int] = None):
    """One MP-BCFW outer iteration: eviction, the exact pass (its captured
    step kept in ``graphs``), and the slope-ruled batch of approximate
    passes (``steps`` per block with Gram blocks).

    ``clock.f0`` is re-seeded on the device from the dual at iteration
    entry; the host supplies ``clock.t`` (the modeled exact-pass cost) and
    ``clock.plane_cost``.  ``policies`` (a
    :class:`repro_torch.policy.PolicyBundle`) replaces the baked-in
    decisions: its eviction policy runs instead of the TTL rule, its
    sampler turns ``perm`` into the exact pass's schedule (``key`` is the
    iteration's host-drawn seed, for samplers that declared
    ``needs_key``), and its oracle policy replaces the slope rule.  None,
    and the default uniform/ttl-lru/slope bundle, run what the engines run
    without a bundle.  With a gap vector the stats' metrics carry
    ``gap_total`` (the post-exact-pass sum over visited blocks, on the
    device) and ``gap_sampled`` (the schedule's length).  Returns ``(mp,
    clock, stats)``.
    """
    eviction = None if policies is None else policies.eviction
    occ0 = mp.cache.occupancy                 # before eviction
    mp = begin_iteration(mp, ttl, eviction=eviction)
    occ1 = mp.cache.occupancy                 # after eviction
    clock = clock._replace(f0=dual_value(mp.inner.phi, lam))
    perm = exact_schedule(policies, mp.cache, perm, key)
    mp = exact_pass(problem, mp, perm, lam, graphs=graphs)
    occ2 = mp.cache.occupancy                 # after the insert scan
    gap_fields = {}
    if mp.cache.gap is not None:
        # The gap mass over visited blocks after the exact pass (unseen
        # blocks hold GAP_UNSEEN and are left out).
        gap = mp.cache.gap
        gap_fields = dict(
            gap_total=torch.where(gap < plane_cache.GAP_UNSEEN, gap,
                                  0.0).sum(),
            gap_sampled=len(perm))
    mp, clock, stats = multi_approx_pass(mp, perms, clock, lam=lam,
                                         steps=steps, run_all=run_all,
                                         policies=policies)
    # Eviction accounting, on the device: eviction dropped occ0-occ1
    # planes; the exact pass inserted one plane per visited block, so the
    # LRU overwrites are the inserts that did not grow the cache.
    n_inserts = len(perm)
    metrics = stats.metrics._replace(ttl_evicted=occ0 - occ1,
                                     lru_evicted=occ1 + n_inserts - occ2,
                                     **gap_fields)
    return mp, clock, stats._replace(metrics=metrics)


def init_mp_state(problem: SSVMProblem, cap: Union[int, CacheLayout],
                  device=None) -> MPState:
    """Fresh MP-BCFW state on ``device`` (default: where the data lives);
    ``cap`` is a capacity or a :class:`CacheLayout` (Gram blocks on/off)."""
    if device is None:
        device = next(iter(problem.data.values())).device
    layout = cap if isinstance(cap, CacheLayout) else CacheLayout(cap=int(cap))
    return MPState(inner=init_state(problem, device),
                   cache=plane_cache.init(layout, problem.n, problem.d,
                                          device),
                   avg=init_averaging(problem.d, device),
                   outer_it=0)


# ---------------------------------------------------------------------------
# Pipelined MP-BCFW (``mpbcfw-async``): two programs per outer iteration.
#
#   * :func:`async_oracle_program` -- the exact max-oracle of every block,
#     all at the stale iteration-entry ``w``: one batched oracle call, so
#     the chain oracle decodes all n blocks in one Viterbi launch.
#   * :func:`async_cache_program` -- eviction, the monotone fold-in of the
#     *previous* iteration's oracle results (straggler blocks fold their
#     best cached plane instead, from one batched ``plane_select``), and
#     the slope-ruled batch of approximate passes.
#
# Neither reads the other's outputs, so on CUDA the engine runs the oracle
# on a side stream while the cache program runs on the main one; their
# results meet in the next iteration's pending buffer.
# ---------------------------------------------------------------------------


class PendingOracle(NamedTuple):
    """Oracle results dispatched at iteration t and folded at t+1.

    Attributes:
      ids:    (k,) int64 host array: the blocks whose oracles ran.
      planes: (k, d+1) float32 tensor: their planes at the stale ``w``.
      done:   (k,) bool host array: the result arrived by its deadline;
              a missed block folds its cached fallback (``repro_torch.ft``).
      live:   False until the first dispatch: nothing folds.
    """

    ids: np.ndarray
    planes: torch.Tensor
    done: np.ndarray
    live: bool


class AsyncMPState(NamedTuple):
    """Pipelined MP-BCFW state: the MP-BCFW state and the pending buffer."""

    mp: MPState
    pending: PendingOracle

    @property
    def inner(self) -> BCFWState:
        """The wrapped dual state, so ``state.inner.phi`` and
        ``state.inner.n_exact`` read alike for every engine's state."""
        return self.mp.inner


def init_pending(n: int, d: int, device) -> PendingOracle:
    """Empty pending buffer (``live=False``: nothing folds)."""
    return PendingOracle(
        ids=np.zeros((n,), np.int64),
        planes=torch.zeros((n, d + 1), dtype=torch.float32, device=device),
        done=np.zeros((n,), bool), live=False)


def init_async_state(problem: SSVMProblem, cap: Union[int, CacheLayout],
                     device=None) -> AsyncMPState:
    mp = init_mp_state(problem, cap, device)
    return AsyncMPState(mp=mp, pending=init_pending(
        problem.n, problem.d, mp.inner.phi.device))


def async_oracle_program(problem: SSVMProblem, w: torch.Tensor, perm
                         ) -> Tuple[np.ndarray, torch.Tensor]:
    """The oracle half of the pipelined iteration.

    The exact max-oracle of every block of ``perm`` at the one stale ``w``
    (the caller's snapshot of the iteration-entry weights): one batched
    oracle call over the gathered examples.  Reads nothing the cache
    program writes.  ``perm`` is the iteration's schedule
    (:func:`exact_schedule`), which the engine takes at iteration entry:
    the reference's oracle program schedules from the entry cache, and
    here the cache program updates the cache in place before this program
    is enqueued.  Returns ``(ids, planes)``.
    """
    ids = np.asarray(  # repro: allow[R004] host schedule
        perm, np.int64).reshape(-1)
    return ids, parallel_oracles(problem, w, ids)


def async_cache_program(mp: MPState, pending: PendingOracle, perms,
                        clock: SlopeClock, *, lam: float, ttl: int,
                        graphs: StepGraphs,
                        after_fold: Optional[Callable[[], None]] = None,
                        policies=None):
    """The cache half of the pipelined iteration.

    TTL eviction, the fold-in of ``pending`` (straggler blocks fold their
    best cached plane at the *current* ``w``, batched), then the
    slope-ruled approximate passes: :func:`outer_iteration` with the exact
    pass replaced by the fold (its captured steps kept in ``graphs``).
    ``after_fold()`` is called once the fold is enqueued, before the
    passes: the engine enqueues the next oracle program there, so that on
    the card it runs beside the fold.  ``clock.f0`` is seeded before the fold,
    so the slope rule's chord includes its gain.  ``policies`` supplies the
    eviction policy and the stopping rule; the fold writes no gap (as in
    the reference), the approximate passes do when the cache has a gap
    vector.  Returns ``(mp, clock, stats)``.
    """
    eviction = None if policies is None else policies.eviction
    occ0 = mp.cache.occupancy                 # before eviction
    mp = begin_iteration(mp, ttl, eviction=eviction)
    occ1 = mp.cache.occupancy                 # after eviction
    clock = clock._replace(f0=dual_value(mp.inner.phi, lam))
    fbp = fbs = None
    if pending.live:
        w = weights_of(mp.inner.phi, lam)
        fbp, fbs, _ = fallback_planes(mp.cache, pending.ids, w)
    mp = fold_planes(mp, pending.ids, pending.planes, fbp, fbs,
                     pending.done, lam, live=pending.live, graphs=graphs)
    occ2 = mp.cache.occupancy                 # after the fold's inserts
    if after_fold is not None:
        after_fold()
    mp, clock, stats = multi_approx_pass(mp, perms, clock, lam=lam,
                                         policies=policies)
    # Eviction accounting (cf. outer_iteration): the fold inserts one plane
    # per arrived block (fallbacks only refresh activity), when live.
    n_inserts = int(np.sum(pending.done)) if pending.live else 0
    metrics = stats.metrics._replace(ttl_evicted=occ0 - occ1,
                                     lru_evicted=occ1 + n_inserts - occ2)
    return mp, clock, stats._replace(metrics=metrics)

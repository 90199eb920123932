"""The multi-device MP-BCFW engine on ``torch.distributed``: sharded
approximate passes and tau-nice exact epochs (PyTorch port of
``repro/shard/engine.py``).

See the package docstring for the layout and the communication pattern.
The engine enqueues its device work and never reads the device except
in :meth:`ShardEngine.read` and :meth:`ShardEngine.read_stats`, so a
caller can assert "one host sync per outer iteration" off the
:class:`~repro_torch.core.selection.SyncLedger`.  Every host decision is
made from host values every rank shares (the host permutations, drawn
from one seed) or from reduced scalars, which the backends hand every
rank bit for bit: the ranks enqueue the same collectives in the same
order.

Module-level ``sharded_*`` functions mirror the single-device API; they
keep one :class:`ShardEngine` per (problem, mesh, lam) in a bounded LRU.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np
import torch

from .. import cache as plane_cache
from ..cache import CacheLayout
from ..core import distributed, mpbcfw
from ..core.averaging import average_step, init_averaging, weight_table
from ..core.bcfw import block_update
from ..core.graphs import StepGraphs
from ..core.mpbcfw import MPState
from ..core.selection import SyncLedger
from ..core.ssvm import dual_value, weights_of
from ..core.types import (ApproxBatchStats, BCFWState, ObsMetrics,
                          SlopeClock, SSVMProblem, index_tensor, upload)
from . import layout
from .telemetry import CollectiveTrace


def local_schedules(perms, lo: int, n_local: int) -> np.ndarray:
    """Each rank's subsequence of global visit orders, as local ids.

    ``perms`` is a ``(B, n)`` host array of permutations (a CPU tensor is
    taken too); each holds exactly ``n_local`` ids of the range ``[lo, lo
    + n_local)``.  They are kept in visit order, so one rank walks exactly
    ``perms``.  Computed on the host, from the host permutations every
    rank shares: no device read (the reference sorts masked positions on
    the device, ``_local_schedule``)."""
    p = np.asarray(perms, np.int64)  # repro: allow[R004] host permutations
    p = p.reshape(-1, p.shape[-1]) if p.size else p.reshape(0, n_local)
    mask = (p >= lo) & (p < lo + n_local)
    return p[mask].reshape(p.shape[0], n_local) - lo


class ShardEngine:
    """Multi-device MP-BCFW passes over one (problem, mesh, lam).

    The state follows :mod:`repro_torch.shard.layout`: build it with
    :meth:`init_state` (or :meth:`place` an existing global state).
    ``ledger`` counts host syncs, dispatches and the runtime collectives
    of the reference's sites; ``collectives`` holds the per-section sites
    (:class:`~repro_torch.shard.telemetry.CollectiveTrace`).  At S > 1
    the tau-nice fold and the pipelined oracle move blocks' rows between
    ranks: those gathers are counted in ``gathers`` and
    ``gather_bytes``, not in the ledger (the reference's fold is
    GSPMD-level, and its trace counts only its explicit sites).  The
    exact step and the fold replay captured CUDA graphs on the card
    (``graphs``)."""

    def __init__(self, problem: SSVMProblem, mesh, *, lam: float,
                 axis: str = "data", use_gram: bool = False,
                 gram_steps: int = 10, policies=None):
        self.problem = problem
        self.mesh = mesh
        self.lam = float(lam)
        self.axis = axis
        self.use_gram = bool(use_gram)
        self.gram_steps = int(gram_steps)
        self.policies = policies
        self.track_gap = policies is not None and policies.needs_gap
        if self.track_gap and self.use_gram:
            raise ValueError(
                "gap-tracking policies are not supported with the gram "
                "(Sec-3.5) pass body: the multi-step scheme does not "
                "expose per-visit scores to fold into the gap vector")
        self.n_shards = layout.validate_layout(problem.n, mesh, axis)
        self.n_local = problem.n // self.n_shards
        self.lo, self.hi = layout.block_range(problem.n, mesh)
        data_dev = next(iter(problem.data.values())).device
        if data_dev != mesh.device:
            raise ValueError(f"the problem's data is on {data_dev}, the "
                             f"mesh's rank on {mesh.device}")
        self.ledger = SyncLedger()
        self.collectives = CollectiveTrace()
        self.graphs = StepGraphs()
        self.gathers = 0
        self.gather_bytes = 0

    # -- state management ---------------------------------------------------

    def init_state(self, cap: int) -> MPState:
        """A fresh state of this rank: its ``n_local`` blocks' rows."""
        lay = CacheLayout(cap=cap, gram=self.use_gram, axis=self.axis,
                          track_gap=self.track_gap)
        dev, d = self.mesh.device, self.problem.d
        inner = BCFWState(
            phi_i=torch.zeros((self.n_local, d + 1), dtype=torch.float32,
                              device=dev),
            phi=torch.zeros((d + 1,), dtype=torch.float32, device=dev),
            n_exact=0, n_approx=0)
        return MPState(inner=inner,
                       cache=plane_cache.init(lay, self.n_local, d, dev),
                       avg=init_averaging(d, dev), outer_it=0)

    def place(self, mp: MPState) -> MPState:
        """This rank's part of a global state (copies)."""
        return layout.place_mp_state(mp, self.mesh, self.axis)

    def gather(self, mp: MPState) -> MPState:
        """The global state (collective: every rank calls it)."""
        return layout.gather_mp_state(mp, self.mesh)

    def begin_iteration(self, mp: MPState, ttl: int) -> MPState:
        self.ledger.dispatched()
        return mpbcfw.begin_iteration(mp, ttl)

    # -- sync points (the only blocking calls) ------------------------------

    def read(self, tree):
        """Fetch any device value(s) to the host: one counted sync."""
        return self.ledger.sync(tree)

    def read_stats(self, stats: ApproxBatchStats, extra=None):
        """Fetch a multi-pass program's stats (the iteration's one sync)
        and charge its runtime collectives to the ledger: the setup sites
        plus the per-pass sites times the passes that ran.  ``extra``
        rides the same read; returns ``stats``, or ``(stats, extra)``."""
        got = self.ledger.sync(stats if extra is None else (stats, extra))
        st = got if extra is None else got[0]
        passes = int(st.passes_run)
        self.ledger.collected(
            self.setup_psums + passes * self.psums_per_approx_pass,
            nbytes=self.collectives.bytes_of("multi_approx", "setup")
            + passes * self.collectives.bytes_of("multi_approx", "pass"))
        return st if extra is None else got

    @property
    def psums_per_approx_pass(self) -> int:
        """Collectives per approximate pass of the multi-pass program."""
        return self.collectives.count("multi_approx", "pass")

    @property
    def setup_psums(self) -> int:
        return self.collectives.count("multi_approx", "setup")

    # -- approximate passes -------------------------------------------------

    def _multi(self, mp: MPState, perms, clock: SlopeClock, evt,
               run_all: bool):
        """The slope-ruled batch of sharded approximate passes, in place.

        ``evt`` is this rank's ``(ttl_evicted, lru_evicted)`` partial sums
        (() int32 tensors), which ride the setup all-reduce with the
        occupancy counts (and, with a gap vector, the gap mass as a
        float32 5-vector).  Each pass is one gated ``approx_pass`` launch
        over the rank's blocks in ``perm``'s visit order, from the shared
        stale ``phi``, its averaging count advancing by S per block, then
        one all-reduce of ``[delta, bar / S]``: at S = 1 the running
        ``phi`` is kept exactly (``phi + (red[0] - delta)``), at S > 1 the
        S walks are recombined damped, ``phi + red[0] / S`` and ``phi_i0
        + (phi_i - phi_i0) / S``.  A pass the rule gated off still issues
        its all-reduce and leaves the state as it was."""
        mesh, lam, S = self.mesh, self.lam, self.n_shards
        n = self.problem.n
        trace = self.collectives
        trace.begin("multi_approx")
        inner, cache, avg = mp.inner, mp.cache, mp.avg
        dev = inner.phi.device
        f_entry = dual_value(inner.phi, lam)
        local_planes = cache.occupancy
        local_nonempty = cache.nonempty_blocks
        with trace.section("setup"):
            if self.track_gap:
                # The gap mass rides the same reduction as float32 (the
                # counts stay exact far below 2^24).
                gap_local = torch.where(cache.gap < plane_cache.GAP_UNSEEN,
                                        cache.gap, 0.0).sum()
                packed = torch.stack([local_planes.float(),
                                      local_nonempty.float(),
                                      evt[0].float(), evt[1].float(),
                                      gap_local])
                trace.all_reduce(packed, mesh, tag="setup")
                counts = packed[:4].to(torch.int32)
                total_planes = counts[0]
                metrics = ObsMetrics(ttl_evicted=counts[2],
                                     lru_evicted=counts[3],
                                     occupancy=counts[0],
                                     nonempty_blocks=counts[1],
                                     gap_total=packed[4])
            else:
                packed = torch.stack([local_planes, local_nonempty,
                                      evt[0], evt[1]]).to(torch.int32)
                trace.all_reduce(packed, mesh, tag="setup")
                total_planes = packed[0]
                metrics = ObsMetrics(ttl_evicted=packed[2],
                                     lru_evicted=packed[3],
                                     occupancy=packed[0],
                                     nonempty_blocks=packed[1])
        cost = clock.plane_cost * torch.clamp_min(total_planes, 1).to(
            torch.float32)
        scheds = index_tensor(local_schedules(perms, self.lo, self.n_local),
                              dev)
        steps = self.gram_steps if self.use_gram else None
        phi, phi_i, bar = inner.phi, inner.phi_i, avg.bar_approx

        def step(k: int, go: torch.Tensor):
            with trace.section("pass"):
                entry = phi.clone()
                phi_i0 = phi_i.clone() if S > 1 else None
                mpbcfw.run_pass(mp, scheds[k], lam, steps,
                                k0=avg.k_approx + k * n, go=go, k_stride=S)
                delta = phi - entry
                red = trace.all_reduce(torch.stack([delta, bar / S]), mesh,
                                       tag="pass")
                if S == 1:
                    # red[0] == delta: the sequential running phi, exactly.
                    phi.add_(red[0] - delta)
                    bar.copy_(red[1])
                else:
                    phi.copy_(torch.where(go, entry + red[0] / S, entry))
                    phi_i.copy_(torch.where(
                        go, phi_i0 + (phi_i - phi_i0) / S, phi_i0))
                    bar.copy_(torch.where(go, red[1], bar))
            return dual_value(phi, lam)

        t, stats = mpbcfw.slope_batched_loop(
            len(scheds), clock, step=step, f_entry=f_entry, cost=cost,
            planes_per_pass=total_planes, run_all=run_all,
            continue_fn=(None if self.policies is None
                         else self.policies.oracle.continue_fn))
        trace.commit()
        return mp, clock._replace(t=t), stats._replace(metrics=metrics,
                                                       blocks=n)

    def multi_approx_pass(self, mp: MPState, perms, clock: SlopeClock, *,
                          run_all: bool = False
                          ) -> Tuple[MPState, SlopeClock, ApproxBatchStats]:
        """The sharded twin of :func:`repro_torch.core.mpbcfw
        .multi_approx_pass`: enqueued without a read; pair it with
        :meth:`read_stats`.  The host counters are left for
        :func:`repro_torch.core.mpbcfw.count_passes` (``blocks = n``)."""
        zero = torch.zeros((), dtype=torch.int32, device=mp.inner.phi.device)
        self.ledger.dispatched()
        return self._multi(mp, perms, clock, (zero, zero), run_all)

    def approx_pass(self, mp: MPState, perm) -> MPState:
        """One sharded approximate pass (no stopping rule), counted."""
        clock = mpbcfw.make_slope_clock(0.0, 0.0, 0.0, 0.0,
                                        mp.inner.phi.device)
        mp, _, _ = self.multi_approx_pass(
            mp, np.asarray(  # repro: allow[R004] host permutation
                perm, np.int64)[None], clock, run_all=True)
        return mpbcfw.count_passes(mp, 1, self.problem.n,
                                   self.gram_steps if self.use_gram
                                   else None)

    # -- tau-nice (exact) pass ----------------------------------------------

    def _fold_gathered(self, mp: MPState, ids: np.ndarray, ok: np.ndarray,
                       w: torch.Tensor,
                       planes: Optional[torch.Tensor] = None) -> MPState:
        """Fold ``ids`` (global ids, distinct) at S > 1.

        One packed all-reduce moves what each block's fold reads to every
        rank: its oracle plane (``planes`` given on every rank, else each
        rank computes its share, :func:`~repro_torch.core.distributed
        .local_block_ids`), and from its owner its ``phi_i`` row and its
        fallback (plane and slot, from one ``plane_select`` over the
        owner's rows).  A row is non-zero on one rank only, so the sum is
        that rank's row exactly.  Every rank then replays the same fold on
        the replicated ``phi`` and exact-track average (each step the
        reference's ``block_update`` and averaging step), and writes back
        only the rows it owns: the ``phi_i`` row, and the cache insert
        (arrived) or activity stamp (straggler)."""
        mesh, lam = self.mesh, self.lam
        inner, cache, avg = mp.inner, mp.cache, mp.avg
        dev, d1 = inner.phi.device, inner.phi.shape[0]
        m = len(ids)
        own = (ids >= self.lo) & (ids < self.hi)
        width = (2 if planes is not None else 3) * d1 + 1
        buf = torch.zeros((m, width), dtype=torch.float32, device=dev)
        o = 0
        if planes is None:
            mine = distributed.local_block_ids(ids, mesh)
            share = self.problem.oracle(
                w, distributed.gather_examples(self.problem, mine))
            k = len(mine)
            buf[mesh.rank * k:(mesh.rank + 1) * k, :d1] = share
            o = d1
        if own.any():
            own_rows = ids[own] - self.lo
            fbp, fbs, _ = distributed.fallback_planes(cache, own_rows, w)
            at = index_tensor(np.flatnonzero(own), dev)
            buf[at, o:o + d1] = inner.phi_i.index_select(
                0, index_tensor(own_rows, dev))
            buf[at, o + d1:o + 2 * d1] = fbp
            buf[at, o + 2 * d1] = fbs.to(torch.float32)
        mesh.all_reduce(buf)
        self.gathers += 1
        self.gather_bytes += buf.numel() * buf.element_size()
        if planes is None:
            planes = buf[:, :d1]
        rows = buf[:, o:o + d1].clone()
        fb_planes = buf[:, o + d1:o + 2 * d1]
        fb_slots = buf[:, o + 2 * d1].to(torch.int64)
        st = BCFWState(phi_i=rows, phi=inner.phi, n_exact=0, n_approx=0)
        weights = upload(weight_table(avg.k_exact, m), dev)
        scratch = torch.empty_like(inner.phi)
        for b in range(m):
            plane = planes[b] if ok[b] else fb_planes[b]
            block_update(st, b, plane, lam)
            if own[b]:
                li = int(ids[b]) - self.lo
                inner.phi_i[li].copy_(rows[b])
                if ok[b]:
                    plane_cache.insert(cache, li, plane, mp.outer_it)
                else:
                    plane_cache.mark_active(cache, li, fb_slots[b:b + 1],
                                            mp.outer_it)
            average_step(avg.bar_exact, inner.phi, weights[b], scratch)
        n_ok = int(ok.sum())
        return mp._replace(
            inner=inner._replace(n_exact=inner.n_exact + n_ok,
                                 n_approx=inner.n_approx + m - n_ok),
            avg=avg._replace(k_exact=avg.k_exact + m))

    def _epoch(self, mp: MPState, chunk_ids: np.ndarray,
               done: np.ndarray) -> MPState:
        """The tau-nice epoch: per chunk, its oracles at the chunk's stale
        ``w`` (``tau / S`` per rank), the batched cached fallback of its
        blocks at the same ``w`` and the sequential fold.  At S = 1 every
        block is local and nothing is gathered (the port's
        :func:`~repro_torch.core.distributed.tau_chunk`: B3 at B = tau,
        B2 on the chunk's rows, the fold's captured steps)."""
        for ids, ok in zip(chunk_ids, done):
            if self.n_shards == 1:
                mp = distributed.tau_chunk(self.problem, mp, ids, ok,
                                           self.lam, graphs=self.graphs)
            else:
                w = weights_of(mp.inner.phi, self.lam)
                mp = self._fold_gathered(mp, ids, ok, w)
        return mp

    def _chunk_args(self, perm, tau: int, done):
        n = self.problem.n
        if n % tau:
            raise ValueError(f"n={n} not divisible by tau={tau}")
        if tau % self.n_shards:
            raise ValueError(
                f"tau={tau} not divisible by {self.n_shards} shards")
        chunk_ids = np.asarray(  # repro: allow[R004] host permutation
            perm, np.int64).reshape(-1, tau)
        if done is None:
            done = np.ones(chunk_ids.shape, bool)
        else:
            done = np.asarray(  # repro: allow[R004] host done mask
                done, bool).reshape(chunk_ids.shape)
        return chunk_ids, done

    def tau_nice_pass(self, mp: MPState, perm, tau: int,
                      done=None) -> MPState:
        """One tau-nice epoch over the host permutation ``perm``: ``n /
        tau`` chunks, stragglers (``done`` False, a host mask) folding
        their cached fallback.  Enqueued, no host sync."""
        chunk_ids, done = self._chunk_args(perm, tau, done)
        self.ledger.dispatched()
        return self._epoch(mp, chunk_ids, done)

    # -- one outer iteration: one dispatch ----------------------------------

    def outer_iteration(self, mp: MPState, perm, approx_perms,
                        clock: SlopeClock, *, tau: int, ttl: int,
                        done=None, run_all: bool = False,
                        key: Optional[int] = None):
        """Eviction, the exact epoch and the slope-ruled approximate
        batch, enqueued as one dispatch; ``clock.f0`` is re-seeded from
        the dual at iteration entry.  ``tau == 1`` with no stragglers runs
        the sequential exact pass (the single-device captured exact step,
        which makes a world-size-1 run equal ``mpbcfw`` bit for bit);
        otherwise the tau-nice epoch.  ``key`` seeds a keyed sampler's
        schedule (sequential path only).  Read the stats with
        :meth:`read_stats`: the iteration's one host sync."""
        chunk_ids, done_arr = self._chunk_args(perm, tau, done)
        sequential = tau == 1 and done is None
        policies = self.policies
        sampled = policies is not None and policies.sampling.needs_key
        if sampled and not sequential:
            raise ValueError(
                "sampling policies need the sequential (tau=1, no "
                "straggler) exact pass: the sampled schedule replaces "
                "the uniform chunk permutation")
        self.ledger.dispatched()
        occ0 = mp.cache.occupancy
        mp = mpbcfw.begin_iteration(
            mp, ttl, eviction=None if policies is None else policies.eviction)
        occ1 = mp.cache.occupancy
        clock = clock._replace(f0=dual_value(mp.inner.phi, self.lam))
        ids = chunk_ids.reshape(-1)
        if sampled:
            ids = policies.sampling.schedule(mp.cache, ids, key)
        if sequential:
            mp = mpbcfw.exact_pass(self.problem, mp, ids, self.lam,
                                   graphs=self.graphs)
        else:
            mp = self._epoch(mp, chunk_ids, done_arr)
        # One insert per visited block of this rank (a straggler counts as
        # one too, as in the reference's accounting).
        inserts = len(ids) if sampled else self.n_local
        evt = (occ0 - occ1, occ1 + inserts - mp.cache.occupancy)
        mp, clock, stats = self._multi(mp, approx_perms, clock, evt, run_all)
        if sampled:
            stats = stats._replace(metrics=stats.metrics._replace(
                gap_sampled=len(ids)))
        return mp, clock, stats

    # -- the pipelined oracle (mpbcfw-shard-async) ---------------------------

    def async_oracle_pass(self, phi: torch.Tensor, perm):
        """The exact oracles of the host permutation ``perm`` at ``w =
        -phi*/lam``: ``n / S`` per rank, gathered (at S > 1) so that every
        rank holds ``(ids, planes (n, d+1))``.  Folded by the next
        :meth:`async_cache_pass`."""
        self.ledger.dispatched()
        w = weights_of(phi, self.lam)
        ids = np.asarray(  # repro: allow[R004] host permutation
            perm, np.int64).reshape(-1)
        if self.n_shards == 1:
            return mpbcfw.async_oracle_program(self.problem, w, ids)
        planes = distributed.parallel_oracles(self.problem, w, ids,
                                              self.mesh)
        self.gathers += 1
        self.gather_bytes += planes.numel() * planes.element_size()
        return ids, planes

    def async_cache_pass(self, mp: MPState, pending, perms,
                         clock: SlopeClock, *, ttl: int,
                         run_all: bool = False):
        """The cache half: eviction, the fold of the pending oracle
        results (stragglers fold their best cached plane at the current
        ``w``), and the sharded approximate batch, with the serial
        engines' accounting and collectives.  Enqueued, no host sync."""
        policies = self.policies
        self.ledger.dispatched()
        occ0 = mp.cache.occupancy
        mp = mpbcfw.begin_iteration(
            mp, ttl, eviction=None if policies is None else policies.eviction)
        occ1 = mp.cache.occupancy
        clock = clock._replace(f0=dual_value(mp.inner.phi, self.lam))
        inserts = 0
        if pending.live:
            ids = np.asarray(  # repro: allow[R004] host block ids
                pending.ids, np.int64)
            done = np.asarray(  # repro: allow[R004] host done mask
                pending.done, bool)
            w = weights_of(mp.inner.phi, self.lam)
            if self.n_shards == 1:
                fbp, fbs, _ = distributed.fallback_planes(mp.cache, ids, w)
                mp = distributed.fold_planes(
                    mp, ids, pending.planes, fbp, fbs, done, self.lam,
                    graphs=self.graphs)
            else:
                mp = self._fold_gathered(mp, ids, done, w,
                                         planes=pending.planes)
            inserts = int(np.sum(done & (ids >= self.lo) & (ids < self.hi)))
        evt = (occ0 - occ1, occ1 + inserts - mp.cache.occupancy)
        return self._multi(mp, perms, clock, evt, run_all)


# -- module-level API (engine cache) ----------------------------------------

# Identity-keyed LRU of recently used engines.  Bounded: each entry pins a
# problem, a mesh and captured graphs.  Long-lived callers should hold a
# ShardEngine themselves.
_ENGINE_CACHE_SIZE = 8
_ENGINES: "OrderedDict[tuple, ShardEngine]" = OrderedDict()


def _engine(problem: SSVMProblem, mesh, lam: float,
            axis: str) -> ShardEngine:
    key = (id(problem.oracle), id(problem.data), id(mesh),
           float(lam),  # repro: allow[R004] host float lam
           axis)
    eng = _ENGINES.get(key)
    if eng is None:
        eng = _ENGINES[key] = ShardEngine(problem, mesh, lam=lam, axis=axis)
    _ENGINES.move_to_end(key)
    while len(_ENGINES) > _ENGINE_CACHE_SIZE:
        _ENGINES.popitem(last=False)
    return eng


def sharded_approx_pass(problem: SSVMProblem, mp: MPState, perm, *,
                        lam: float, mesh, axis: str = "data") -> MPState:
    """One approximate pass over all blocks, sharded over ``mesh``."""
    return _engine(problem, mesh, lam, axis).approx_pass(mp, perm)


def sharded_multi_approx_pass(problem: SSVMProblem, mp: MPState, perms,
                              clock: SlopeClock, *, lam: float, mesh,
                              run_all: bool = False, axis: str = "data"):
    """Slope-ruled batch of approximate passes, sharded over ``mesh``."""
    return _engine(problem, mesh, lam, axis).multi_approx_pass(
        mp, perms, clock, run_all=run_all)


def sharded_tau_nice_pass(problem: SSVMProblem, mp: MPState, perm, *,
                          lam: float, tau: int, mesh, done=None,
                          axis: str = "data") -> MPState:
    """One tau-nice epoch, oracles split over ``mesh``'s ranks."""
    return _engine(problem, mesh, lam, axis).tau_nice_pass(mp, perm, tau,
                                                           done)

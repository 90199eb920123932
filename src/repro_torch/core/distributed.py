"""Tau-nice MP-BCFW: oracles at a shared stale ``w``, sequential fold-in
(PyTorch port of ``repro/core/distributed.py``).

Sample ``tau`` distinct blocks, evaluate their max-oracles at the same
stale ``w``, then fold the returned planes in one at a time with exact
line search at the current ``phi``.  Every returned plane is a genuine
data plane whatever ``w`` produced it, so each fold is monotone in F.

Straggler mitigation (:mod:`repro_torch.ft`): a host ``done`` mask marks
the oracle results that arrived in time; a missing block folds its best
cached plane instead, from one batched :func:`fallback_planes` call over
all sampled blocks (one ``plane_select`` launch that reads the sampled
rows of the cache in place).

The fold updates the state in place and branches on the host, per block,
on ``done`` (a numpy bool array) and ``live`` (a Python bool): the
reference's ``jnp.where`` over both branches becomes one of two block
steps taken, each a captured CUDA graph on the card
(:mod:`repro_torch.core.graphs`).
:func:`host_tau_nice_pass` is the single-device chunk loop; the shard
engine (:mod:`repro_torch.shard`) runs the same chunk body on each rank
of a data mesh, the oracles split over the ranks
(:func:`parallel_oracles` with a mesh).
"""
from __future__ import annotations

import functools
import itertools
from typing import TYPE_CHECKING, Any, Optional

import numpy as np
import torch

from .. import cache as plane_cache
from .averaging import average_step
from .bcfw import block_update
from .graphs import StepControl, StepGraphs, load_control
from .ssvm import weights_of
from .types import SSVMProblem, index_tensor

if TYPE_CHECKING:
    from .mpbcfw import MPState


def gather_examples(problem: SSVMProblem, block_ids):
    """The examples of ``block_ids`` as one batch (copies)."""
    device = next(iter(problem.data.values())).device
    idx = index_tensor(block_ids, device)
    return {k: v[idx] for k, v in problem.data.items()}


def local_block_ids(block_ids, mesh) -> np.ndarray:
    """This rank's share of ``block_ids`` (a host array of ``tau`` ids):
    the contiguous ``tau / S`` of them at its rank, as the reference's
    ``P('data')`` sharding of the ids gives each device."""
    ids = np.asarray(  # repro: allow[R004] host block ids
        block_ids, np.int64).reshape(-1)
    if len(ids) % mesh.size:
        raise ValueError(f"{len(ids)} blocks do not split over "
                         f"{mesh.size} ranks")
    m = len(ids) // mesh.size
    return ids[mesh.rank * m:(mesh.rank + 1) * m]


def parallel_oracles(problem: SSVMProblem, w: torch.Tensor, block_ids,
                     mesh: Optional[Any] = None) -> torch.Tensor:
    """The max-oracles of ``block_ids`` at one shared ``w``: ``(tau, d+1)``
    planes.  Without a mesh, one batched oracle call; with a
    :class:`~repro_torch.launch.mesh.DataMesh`, each rank runs its
    ``tau / S`` of them (:func:`local_block_ids`; the data is replicated,
    so any rank can) and one all-gather hands every rank all ``tau``."""
    if mesh is None:
        return problem.oracle(w, gather_examples(problem, block_ids))
    mine = local_block_ids(block_ids, mesh)
    planes = problem.oracle(w, gather_examples(problem, mine))
    return mesh.all_gather(planes).reshape(-1, planes.shape[-1])


def fallback_planes(ws, block_ids, w: torch.Tensor):
    """Best cached plane of every sampled block at one shared stale ``w``.

    Returns ``(planes (tau, d+1), slots (tau,) int32, scores (tau,))`` from
    one :func:`repro_torch.cache.approx_oracle_all` call that reads the
    sampled rows in place (the reference gathers a sub-cache first).  A
    block with an empty cache gets the zero (ground-truth) plane and slot
    0, which still gives a monotone fold step.  Re-exported as
    ``repro_torch.ft.fallback_planes``.
    """
    rows = index_tensor(block_ids, ws.planes.device)
    return plane_cache.approx_oracle_all(ws, w, rows=rows)


def state_tensors(mp: MPState):
    """Every tensor a block step reads or writes in the dual state, the
    cache (its Gram leaf and gap vector when it has them) and the
    exact-track average: the key of its captured graph."""
    c = mp.cache
    return (mp.inner.phi, mp.inner.phi_i, mp.avg.bar_exact, c.planes,
            c.valid, c.last_active) + tuple(
                t for t in (c.gram, c.gap) if t is not None)


def fold_step(mp: MPState, ctl: StepControl, lam: float, *,
              arrived: bool) -> None:
    """One fold-in step, in place, with the block read on the device: block
    ``ctl.ids[cursor]`` takes its oracle plane ``ctl.planes[cursor]``
    (``arrived``) and caches it, or its fallback ``ctl.fb_planes[cursor]``
    and stamps the slot ``ctl.fb_slots[cursor]``; then an exact-track
    averaging step.  Advances the cursor.  The two bodies of
    :func:`fold_planes`' loop, and of its captured graphs on CUDA."""
    st, ws = mp.inner, mp.cache
    i = ctl.block()
    at = ctl.cursor
    plane = (ctl.planes if arrived else ctl.fb_planes).index_select(0, at)[0]
    block_update(st, i, plane, lam)
    if arrived:
        plane_cache.insert(ws, i, plane, ctl.it)
    else:
        plane_cache.mark_active(ws, i, ctl.fb_slots.index_select(0, at),
                                ctl.it)
    average_step(mp.avg.bar_exact, st.phi, ctl.weight(), ctl.scratch)
    ctl.cursor.add_(1)


def fold_planes(mp: MPState, block_ids, planes: torch.Tensor,
                fb_planes: Optional[torch.Tensor],
                fb_slots: Optional[torch.Tensor], done, lam: float, *,
                graphs: StepGraphs, live: Optional[bool] = None) -> MPState:
    """Fold ``tau`` candidate planes into the dual state, in order.

    Block ``block_ids[b]`` folds its oracle plane ``planes[b]`` when
    ``done[b]`` (and caches it), else its fallback ``fb_planes[b]`` (and
    marks its slot ``fb_slots[b]`` active; an empty cache marks slot 0,
    as the reference does).  Each step is an exact line search at the
    current ``phi``, then an exact-track averaging step
    (:func:`fold_step`).  ``n_exact`` counts the arrived blocks and
    ``n_approx`` the others.

    ``done`` is a host bool array and ``live`` a host bool: ``live=False``
    returns ``mp`` unchanged (the pipeline's first iteration has nothing
    to fold).  The fallback arguments may be None when every block
    arrived.  The host picks each block's body from ``done``: on the CPU a
    plain loop, on CUDA one replay per block of that body's captured
    graph, kept in ``graphs`` (an engine's or a pass's
    :class:`~repro_torch.core.graphs.StepGraphs`).  The
    reference's choice of scatter strategy (``CacheLayout.fold_scatter``)
    has no counterpart: the port folds in place.
    """
    if live is not None and not live:
        return mp
    ids = np.asarray(  # repro: allow[R004] host block ids
        block_ids, np.int64).reshape(-1)
    done = np.asarray(  # repro: allow[R004] host done mask
        done, dtype=bool).reshape(-1)
    if done.shape[0] != len(ids):
        raise ValueError(f"fold_planes: {done.shape[0]} done flags for "
                         f"{len(ids)} blocks")
    ctl = graphs.control("fold", state_tensors(mp), (lam,), len(ids),
                        mp.inner.phi.shape[0] - 1, fold=True)
    load_control(ctl, ids, k0=mp.avg.k_exact, it=mp.outer_it, planes=planes,
                 fb_planes=fb_planes, fb_slots=fb_slots)
    flags = done.tolist()  # repro: allow[R004] host done mask
    for arrived, run in itertools.groupby(flags):
        name = "arrived" if arrived else "straggler"
        graphs.run("fold", name, functools.partial(
            fold_step, mp, ctl, lam, arrived=arrived), len(list(run)))
    n_ok = int(done.sum())
    return mp._replace(
        inner=mp.inner._replace(n_exact=mp.inner.n_exact + n_ok,
                                n_approx=mp.inner.n_approx + len(ids) - n_ok),
        avg=mp.avg._replace(k_exact=mp.avg.k_exact + len(ids)))


def tau_chunk(problem: SSVMProblem, mp: MPState, ids, ok, lam: float, *,
              graphs: StepGraphs) -> MPState:
    """One tau-nice chunk: the oracles of ``ids`` at the chunk's stale
    ``w``, the batched cached fallback at the same ``w``, and the fold (its
    steps kept in ``graphs``)."""
    w = weights_of(mp.inner.phi, lam)
    planes = parallel_oracles(problem, w, ids)
    fbp, fbs, _ = fallback_planes(mp.cache, ids, w)
    return fold_planes(mp, ids, planes, fbp, fbs, ok, lam, graphs=graphs)


def host_tau_nice_pass(problem: SSVMProblem, mp: MPState, perm, lam: float,
                       tau: int, done=None) -> MPState:
    """One tau-nice epoch over ``perm``: ``n // tau`` chunks in order.

    ``done`` is an optional ``(n // tau, tau)`` host bool array of oracle
    arrivals per chunk (default: all arrive).  The chunks' fold steps
    share one :class:`~repro_torch.core.graphs.StepGraphs`, so on the card
    each body is captured once per epoch.
    """
    perm = np.asarray(perm).reshape(-1)  # repro: allow[R004] host permutation
    n = perm.shape[0]
    if tau < 1 or n % tau:
        raise ValueError(f"host_tau_nice_pass: perm length {n} is not a "
                         f"multiple of tau={tau}")
    graphs = StepGraphs()
    for c in range(n // tau):
        ids = perm[c * tau:(c + 1) * tau]
        ok = np.ones((tau,), bool) if done is None else done[c]
        mp = tau_chunk(problem, mp, ids, ok, lam, graphs=graphs)
    return mp

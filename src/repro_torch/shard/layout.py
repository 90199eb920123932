"""Placement of the MP-BCFW state over the ranks of a data mesh (PyTorch
port of ``repro/shard/layout.py``).

Blocks, and with them ``phi_i`` and every leaf of the plane cache, are
partitioned over the mesh axis: rank ``r`` of S holds the contiguous
range ``[r * n_local, (r + 1) * n_local)``, the reference's ``lo =
axis_index * n_local``.  The O(d) state (``phi``, the averaging tracks)
and the host counters are replicated.  :func:`mp_state_specs` is the one
spec tree: :func:`place_mp_state` slices a global state by it, and
:func:`gather_mp_state` is its inverse (checkpoints hold the global
arrays, as a single-device run writes them).
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import cache as plane_cache
from ..cache import CacheLayout
from ..core.mpbcfw import MPState
from ..core.types import AveragingState, BCFWState


def validate_layout(n: int, mesh, axis: str = "data") -> int:
    """Check the mesh carries ``axis`` and that its size divides ``n``
    blocks; returns the shard count.  Ragged shards are refused, as in
    the reference."""
    if axis not in mesh.axis_names:
        raise ValueError(
            f"mesh axes {mesh.axis_names} do not include {axis!r}; build "
            "one with repro_torch.launch.mesh.make_data_mesh")
    n_shards = mesh.shape[axis]
    if n % n_shards != 0:
        raise ValueError(
            f"n={n} blocks not divisible by {n_shards} shards on "
            f"axis {axis!r}")
    return n_shards


def block_range(n: int, mesh) -> Tuple[int, int]:
    """This rank's block range ``[lo, hi)`` of ``n`` blocks."""
    n_local = n // mesh.size
    return mesh.rank * n_local, (mesh.rank + 1) * n_local


def mp_state_specs(axis: str = "data", *, gram: bool = False,
                   track_gap: bool = False) -> MPState:
    """The spec tree of an :class:`~repro_torch.core.mpbcfw.MPState`: per
    leaf a tuple of axis names, one per dimension (None: replicated);
    ``()`` for the host counters.  ``gram`` and ``track_gap`` select the
    cache's leaves."""
    return MPState(
        inner=BCFWState(phi_i=(axis, None), phi=(None,), n_exact=(),
                        n_approx=()),
        cache=plane_cache.partition_specs(
            CacheLayout(gram=gram, axis=axis, track_gap=track_gap)),
        avg=AveragingState(bar_exact=(None,), bar_approx=(None,),
                           k_exact=(), k_approx=()),
        outer_it=())


def place_mp_state(mp: MPState, mesh, axis: str = "data") -> MPState:
    """A global state's part on this rank, on the mesh's device: the
    rank's rows of ``phi_i`` and of every cache leaf, copies of the
    replicated tensors (never views of ``mp``'s)."""
    n = mp.inner.phi_i.shape[0]
    validate_layout(n, mesh, axis)
    lo, hi = block_range(n, mesh)
    dev = mesh.device

    def rep(t):
        return t.to(dev, copy=True)

    return MPState(
        inner=mp.inner._replace(phi_i=rep(mp.inner.phi_i[lo:hi]),
                                phi=rep(mp.inner.phi)),
        cache=plane_cache.block_slice(mp.cache, lo, hi, dev),
        avg=mp.avg._replace(bar_exact=rep(mp.avg.bar_exact),
                            bar_approx=rep(mp.avg.bar_approx)),
        outer_it=mp.outer_it)


def gather_mp_state(mp: MPState, mesh) -> MPState:
    """The global state of a sharded one: every rank's rows gathered (one
    all-gather per partitioned leaf, on every rank), the replicated leaves
    as they are.  At world size 1 the state itself."""
    if mesh.size == 1:
        return mp

    def full(t):
        g = mesh.all_gather(t)
        return g.reshape((-1,) + tuple(t.shape[1:]))

    return mp._replace(
        inner=mp.inner._replace(phi_i=full(mp.inner.phi_i)),
        cache=plane_cache.PlaneCache(*(None if t is None else full(t)
                                       for t in mp.cache)))


def place_tree(tree, mesh, axis: str = "data"):
    """Place an engine state restored from global arrays: an
    :class:`MPState` (or the ``mp`` of a pipelined state) by
    :func:`place_mp_state`, every other tensor moved to the mesh's
    device."""
    if isinstance(tree, MPState):
        return place_mp_state(tree, mesh, axis)
    if isinstance(tree, torch.Tensor):
        return tree.to(mesh.device)
    if hasattr(tree, "_fields"):
        return type(tree)(*(place_tree(v, mesh, axis) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(place_tree(v, mesh, axis) for v in tree)
    return tree

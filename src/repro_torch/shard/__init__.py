"""repro_torch.shard: the multi-device MP-BCFW engine on
``torch.distributed`` (PyTorch port of ``repro/shard``).

Layout
------
The engine partitions the *block* dimension over the ranks of a 1-D data
mesh (:class:`repro_torch.launch.mesh.DataMesh`, axis ``'data'``), one
process per rank, each driving one device, and replicates everything
that is O(d):

  =====================  ======================  =======================
  state                  shape on each rank      placement
  =====================  ======================  =======================
  ``inner.phi_i``        ``(n/S, d+1)``          rows ``[r n/S, (r+1) n/S)``
  ``cache.planes``       ``(n/S, cap, d+1)``     the same rows
  ``cache.valid/last_*`` ``(n/S, cap)``          the same rows
  ``cache.gram``         ``(n/S, cap, cap)``     the same rows
  ``cache.gap``          ``(n/S,)``              the same rows
  ``inner.phi`` / ``w``  ``(d+1,)``              replicated
  ``avg.*``, counters    ``(d+1,)`` / host ints  replicated
  the problem's data     all ``n`` examples      replicated
  =====================  ======================  =======================

The specs come from :func:`repro_torch.cache.partition_specs` through
:func:`mp_state_specs`; :func:`place_mp_state` slices a global state to
a rank, and checkpoints hold the gathered global arrays, so either
package resumes them at any world size
(:func:`repro_torch.checkpoint.restore_resharded`).

Communication pattern
---------------------
An approximate pass runs each rank's blocks, in the permutation's visit
order, as one ``approx_pass`` launch from the shared stale ``phi``, its
averaging count advancing by S per block.  **Exactly one all-reduce per
pass** carries ``[delta, bar / S]``; one more before the first pass packs
the cached-plane count, the non-empty blocks and the eviction counters
(and, with a gap vector, the gap mass) for the slope rule and the trace.
Recombination is damped at S > 1: every block step is scaled by 1/S, so
the state is the mean of the S walks and the dual never decreases (F is
concave).  At S = 1 it is exactly the sequential update, so a
world-size-1 run equals the single-device engine bit for bit.  The slope
rule runs on the device on reduced values, which every rank holds bit for
bit, so every rank enqueues the same passes and collectives; the host
permutations come from one seed on every rank.

A tau-nice epoch folds ``n / tau`` chunks: per chunk, the oracles at the
chunk's stale ``w`` (``tau / S`` per rank), the batched fallback of its
blocks (``plane_select`` on each owner's rows) and a sequential fold with
exact line search.  At S > 1 one packed all-reduce per chunk hands every
rank the chunk's planes and its blocks' ``phi_i`` rows and fallbacks; each
rank replays the same fold and keeps the rows it owns.  At S = 1 nothing
is gathered.  The tau = 1, no-straggler epoch is the sequential exact
pass (the single-device captured exact step).

:meth:`ShardEngine.outer_iteration` enqueues a whole outer iteration
(eviction, the exact epoch, the approximate batch) as one dispatch; the
host reads it once.  It backs the ``mpbcfw-shard``, ``-shard-avg``,
``-shard-tau`` and ``-shard-gram`` engines of :mod:`repro_torch.api`,
and ``mpbcfw-gram`` and ``mpbcfw-gap`` given ``RunConfig.mesh``;
``mpbcfw-shard-async`` splits it into the oracle program
(:meth:`ShardEngine.async_oracle_pass`) and the cache program
(:meth:`ShardEngine.async_cache_pass`).

Backends: NCCL on the card, gloo on the CPU.  One card runs world size 1;
several ranks run as processes, each with its device (or the CPU).
"""
from .engine import (ShardEngine, sharded_approx_pass,  # noqa: F401
                     sharded_multi_approx_pass, sharded_tau_nice_pass)
from .layout import (gather_mp_state, mp_state_specs,  # noqa: F401
                     place_mp_state, validate_layout)

__all__ = [
    "ShardEngine", "sharded_approx_pass", "sharded_multi_approx_pass",
    "sharded_tau_nice_pass", "mp_state_specs", "gather_mp_state",
    "place_mp_state", "validate_layout",
]

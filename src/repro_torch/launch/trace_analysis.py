"""Collectives by loop placement, loop trip counts and the card's roofline
peaks of a traced eager step: the PyTorch port's counterpart of
``repro/launch/hlo_analysis.py``.

The reference parses a compiled HLO module: a collective inside a
``while`` body runs once per trip but is written once, so it lands in the
``in_loop`` buckets (one trip's bytes) and the static buckets keep the
collectives outside every loop; ``while_trip_counts`` greps the trip
counts from the loop conditions.  An eager torch step has no while ops:
its layer loops are Python loops that run every trip.  So the port marks
the loops that are ``lax.scan`` / ``lax.map`` in the reference with
:func:`loop`, a drop-in for ``range(trips)``, and a :class:`LoopTracer`
(active in this thread while the dry-run's counter traces a step) keeps
them on a stack:

  * a collective issued in a trip of an outermost marked loop, or by the
    backward of an autograd node that trip made (the node's sequence
    number lies in the trip's range, as the reference's backward scan is a
    while loop of its own), is an in-loop collective of that trip; every
    other one is static;
  * the per-trip bucket is one trip of each entry of an outermost loop
    (what the HLO's body-once text gives, loops nested in it included);
    every later trip must issue the same kinds and bytes, and where one
    does not, :attr:`CollectiveStats.uneven` names the loop and the trip
    instead of averaging;
  * :meth:`LoopTracer.trip_counts` gives each marked loop's trip count once
    per loop site, in the order the trace first enters them.

A loop entered while the autograd engine runs a node (the remat
recompute of a layer in the backward) is not marked again: its ops belong
to the node's trip.  The layer loops follow the reference's probe switch
(``models.common.set_probe_unroll``): unrolled, they are not loops, as in
the reference's probes; the time and chunk loops stay loops either way.

The card's peaks (:data:`PEAK_FLOPS`, :data:`HBM_BW`, :data:`LINK_BW`, the
counterpart of the reference's ``ICI_BW``) and :func:`roofline_terms` live
here, as the reference keeps its chip's here: one NVIDIA H100 80GB HBM3
SXM at its 700 W limit, dense, no sparsity: 989 TFLOP/s bf16, 3.35 TB/s
HBM, 450 GB/s of NVLink 4 per direction.
"""
from __future__ import annotations

import bisect
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

#: The card the bound is for, and its datasheet peaks.
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
PEAK_FLOPS = 989e12        # bf16 dense FLOP/s per card
HBM_BW = 3.35e12           # bytes/s per card
LINK_BW = 450e9            # NVLink 4, bytes/s per direction per card

#: ``while_trip_counts`` keeps at most this many sites, as the record's.
MAX_TRIP_COUNTS = 32


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float,
                   chips: int) -> dict:
    """The three roofline times in seconds (per step, per card):
    ``flops`` and ``hbm_bytes`` per card (the dry-run's local ops),
    ``coll_bytes`` the card's collective traffic over one NVLink
    direction."""
    del chips
    return {
        "compute_s": flops / PEAK_FLOPS,
        "memory_s": hbm_bytes / HBM_BW,
        "collective_s": coll_bytes / LINK_BW,
    }


def _add(bucket: Dict[str, int], kind: str, n: int) -> None:
    bucket[kind] = bucket.get(kind, 0) + n


@dataclass
class CollectiveStats:
    """Collective ops of one traced step, split by loop placement.

    ``bytes_by_kind`` / ``count_by_kind`` cover the ops outside every
    marked loop; ``in_loop_bytes_by_kind`` / ``in_loop_count_by_kind`` one
    trip of each outermost loop entry (the caller owns the trip-count
    multiplier), as the reference's fields.  The port also keeps
    ``loops``: each outermost entry's name, trips and per-trip buckets;
    ``uneven``: each trip whose collectives differ from its loop's first
    trip; and ``all_trips_*``: every collective the step issued."""

    bytes_by_kind: Dict[str, int] = field(default_factory=dict)
    count_by_kind: Dict[str, int] = field(default_factory=dict)
    in_loop_bytes_by_kind: Dict[str, int] = field(default_factory=dict)
    in_loop_count_by_kind: Dict[str, int] = field(default_factory=dict)
    loops: List[dict] = field(default_factory=list)
    uneven: List[dict] = field(default_factory=list)
    all_trips_bytes_by_kind: Dict[str, int] = field(default_factory=dict)
    all_trips_count_by_kind: Dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        """Bytes of the collectives outside every loop."""
        return sum(self.bytes_by_kind.values())

    @property
    def total_in_loop_bytes(self) -> int:
        """Bytes of one trip of each loop's collectives."""
        return sum(self.in_loop_bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        """All collective op sites, loop placement ignored (a loop's
        collectives once)."""
        return (sum(self.count_by_kind.values())
                + sum(self.in_loop_count_by_kind.values()))

    @property
    def total_all_trips_bytes(self) -> int:
        """Bytes of every collective of the step, each trip's."""
        return sum(self.all_trips_bytes_by_kind.values())


_LOCAL = threading.local()


def _sequence_nr() -> int:
    """The sequence number the next autograd node made here will take."""
    return torch._C._autograd._get_sequence_nr()


class LoopTracer:
    """The marked loops of one traced step and the placement of each
    collective in them (see the module docstring).  Active in this thread
    inside ``with tracer:``."""

    def __init__(self):
        self.sites: Dict[str, int] = {}       # name -> first entry's trips
        self.entries: List[Tuple[str, int]] = []   # outermost (name, trips)
        self._stack: List[str] = []
        self._trip: Optional[Tuple[int, int]] = None   # (entry, trip)
        self._starts: List[int] = []          # trip ranges of node numbers
        self._ranges: List[Tuple[int, int, int, int]] = []
        # (kind, bytes, placement): placement None (static) or (entry, trip)
        self.collectives: List[Tuple[str, int, Optional[Tuple[int, int]]]] \
            = []

    def __enter__(self) -> "LoopTracer":
        self._outer = getattr(_LOCAL, "tracer", None)
        _LOCAL.tracer = self
        return self

    def __exit__(self, *exc) -> None:
        _LOCAL.tracer = self._outer

    def _loop(self, name: str, trips: int):
        self.sites.setdefault(name, trips)
        outer = not self._stack
        entry = len(self.entries)
        if outer:
            self.entries.append((name, trips))
        self._stack.append(name)
        try:
            for i in range(trips):
                if outer:
                    self._trip, start = (entry, i), _sequence_nr()
                yield i
                if outer:
                    self._ranges.append((start, _sequence_nr(), entry, i))
                    self._starts.append(start)
        finally:
            self._stack.pop()
            if outer:
                self._trip = None

    def placement(self) -> Optional[Tuple[int, int]]:
        """The (entry, trip) the op being run belongs to, or None: the
        current trip in the forward; in the backward, the trip whose range
        holds the running node's sequence number."""
        if self._trip is not None:
            return self._trip
        node = torch._C._current_autograd_node()
        if node is None:
            return None
        seq = node._sequence_nr()
        i = bisect.bisect_right(self._starts, seq) - 1
        if i >= 0:
            start, end, entry, trip = self._ranges[i]
            if start <= seq < end:
                return entry, trip
        return None

    def record(self, kind: str, nbytes: int) -> None:
        """One collective of ``nbytes`` result bytes, placed now."""
        self.collectives.append((kind, int(nbytes), self.placement()))

    def trip_counts(self) -> List[int]:
        """Each marked loop site's trip count, in the order the trace first
        entered them, at most :data:`MAX_TRIP_COUNTS`."""
        return list(self.sites.values())[:MAX_TRIP_COUNTS]

    def stats(self) -> CollectiveStats:
        """The recorded collectives by loop placement."""
        out = CollectiveStats()
        trips: Dict[Tuple[int, int], Tuple[dict, dict]] = {}
        for kind, nb, where in self.collectives:
            _add(out.all_trips_bytes_by_kind, kind, nb)
            _add(out.all_trips_count_by_kind, kind, 1)
            if where is None:
                _add(out.bytes_by_kind, kind, nb)
                _add(out.count_by_kind, kind, 1)
            else:
                b, c = trips.setdefault(where, ({}, {}))
                _add(b, kind, nb)
                _add(c, kind, 1)
        for entry, (name, n) in enumerate(self.entries):
            first_b, first_c = trips.get((entry, 0), ({}, {}))
            out.loops.append({"loop": name, "trips": n,
                              "bytes_by_kind": dict(first_b),
                              "count_by_kind": dict(first_c)})
            for kind, nb in first_b.items():
                _add(out.in_loop_bytes_by_kind, kind, nb)
                _add(out.in_loop_count_by_kind, kind, first_c[kind])
            for i in range(1, n):
                b, c = trips.get((entry, i), ({}, {}))
                if (b, c) != (first_b, first_c):
                    out.uneven.append({"loop": name, "entry": entry,
                                       "trip": i, "bytes_by_kind": dict(b),
                                       "count_by_kind": dict(c)})
        return out


def active_tracer() -> Optional[LoopTracer]:
    return getattr(_LOCAL, "tracer", None)


def loop(name: str, trips: int, marked: bool = True):
    """``range(trips)``, marked as the loop ``name`` while a
    :class:`LoopTracer` is active in this thread (``for l in loop("x",
    n):``).  ``marked=False`` (a layer loop under the probe switch), a
    loop of no trips and a loop the autograd engine re-runs (a remat
    recompute) are plain ranges."""
    tracer = active_tracer()
    if tracer is None or not marked or trips <= 0 \
            or torch._C._current_autograd_node() is not None:
        return range(trips)
    return tracer._loop(name, int(trips))

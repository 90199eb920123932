"""Host-side metric instruments and the run registry (a copy of
``repro/obs/metrics.py``, which the port does not import).

The instruments are plain Python: they ingest host scalars that the
control loop already read (a :class:`~repro_torch.api.config.TraceRow`,
a served round's latency), never a device tensor, so the registry adds
no host sync, dispatch or kernel launch to the paths it observes.

Snapshots are JSON-ready dicts; :meth:`MetricsRegistry.load` restores
one.  A checkpoint carries the snapshot as its manifest's ``metrics``
(:meth:`repro_torch.api.Solver.save`), and a run's JSONL as its
``summary`` record (:class:`repro_torch.obs.RunRecorder`).
"""
from __future__ import annotations

import math
from typing import Dict, Optional


class Counter:
    """Monotone accumulator (events, calls, bytes)."""

    kind = "counter"

    def __init__(self) -> None:
        self.value: float = 0

    def inc(self, n: float = 1) -> None:
        if n < 0:
            raise ValueError(f"Counter.inc({n}): counters only go up")
        self.value += n

    def snapshot(self) -> dict:
        return {"kind": self.kind, "value": self.value}

    def load(self, snap: dict) -> None:
        self.value = snap.get("value", 0)


class Gauge:
    """Last-written value (dual, gap, hit rate, occupancy)."""

    kind = "gauge"

    def __init__(self) -> None:
        self.value: Optional[float] = None

    def set(self, v: float) -> None:
        self.value = v

    def snapshot(self) -> dict:
        return {"kind": self.kind, "value": self.value}

    def load(self, snap: dict) -> None:
        self.value = snap.get("value")


# Power-of-two bucket upper bounds spanning microseconds to hours when
# values are seconds, and 1..~1e6 when values are counts — one fixed
# geometry so histograms merge/diff across runs without rebucketing.
_BUCKETS = tuple(2.0 ** e for e in range(-20, 21))


class Histogram:
    """Fixed-geometry log2 histogram with count/sum/min/max.

    Bounded memory (41 buckets), mergeable across runs, and good enough
    for the p50/p99 summaries of the serving path.
    """

    kind = "histogram"

    def __init__(self) -> None:
        self.counts = [0] * (len(_BUCKETS) + 1)
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v: float) -> None:
        v = float(v)
        if math.isnan(v):
            return
        idx = 0
        while idx < len(_BUCKETS) and v > _BUCKETS[idx]:
            idx += 1
        self.counts[idx] += 1
        self.count += 1
        self.total += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def quantile(self, q: float) -> Optional[float]:
        """Upper bucket bound at quantile ``q`` (None while empty)."""
        if self.count == 0:
            return None
        target = q * self.count
        seen = 0
        for idx, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                return (_BUCKETS[idx] if idx < len(_BUCKETS)
                        else float("inf"))
        return _BUCKETS[-1]

    def snapshot(self) -> dict:
        return {"kind": self.kind, "counts": list(self.counts),
                "count": self.count, "total": self.total,
                "min": self.min, "max": self.max}

    def load(self, snap: dict) -> None:
        counts = snap.get("counts", [])
        self.counts = (list(counts) + [0] * (len(_BUCKETS) + 1)
                       )[:len(_BUCKETS) + 1]
        self.count = snap.get("count", 0)
        self.total = snap.get("total", 0.0)
        self.min = snap.get("min")
        self.max = snap.get("max")


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Named instruments of one run, with TraceRow ingestion built in."""

    def __init__(self) -> None:
        self._metrics: Dict[str, object] = {}
        self._last_row = None

    def _get(self, name: str, cls):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls()
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} is a {type(m).__name__}, "
                            f"not a {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def names(self):
        return sorted(self._metrics)

    # -- TraceRow ingestion (the canonical per-iteration update) -----------

    def observe_row(self, row, *, collectives: int = 0,
                    collective_bytes: int = 0) -> None:
        """Fold one :class:`~repro_torch.api.config.TraceRow` into the series.

        ``row`` fields are host scalars already paid for by the
        iteration's single sync; ``collectives``/``collective_bytes`` are
        the iteration's ledger deltas (zero on single-device engines).
        """
        prev = self._last_row
        self.counter("iterations").inc()
        self.counter("oracle_calls").inc(
            max(row.n_exact - (prev.n_exact if prev else 0), 0))
        self.counter("approx_calls").inc(
            max(row.n_approx - (prev.n_approx if prev else 0), 0))
        self.counter("host_syncs").inc(row.host_syncs)
        self.counter("dispatches").inc(row.dispatches)
        self.counter("collectives").inc(max(collectives, 0))
        self.counter("collective_bytes").inc(max(collective_bytes, 0))
        self.counter("planes_evicted").inc(
            max(getattr(row, "planes_evicted", 0), 0))
        self.gauge("dual").set(row.dual)
        self.gauge("gap").set(row.gap)
        self.gauge("cache_hit_rate").set(
            getattr(row, "cache_hit_rate", 0.0))
        self.gauge("oracle_share").set(getattr(row, "oracle_share", 1.0))
        self.gauge("ws_mean").set(row.ws_mean)
        dt = row.time - (prev.time if prev else 0.0)
        if dt >= 0.0:
            self.histogram("iteration_time").observe(dt)
        self.histogram("approx_passes").observe(row.approx_passes)
        self._last_row = row

    # -- persistence --------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-ready state of every instrument (checkpoint manifest /
        the run summary record)."""
        return {name: m.snapshot() for name, m in self._metrics.items()}

    def load(self, snap: Optional[dict]) -> None:
        """Resume a snapshot (inverse of :meth:`snapshot`); unknown kinds
        are ignored so old code can read newer manifests."""
        for name, entry in (snap or {}).items():
            cls = _KINDS.get(entry.get("kind"))
            if cls is not None:
                self._get(name, cls).load(entry)

"""Serving telemetry: the per-round dispatch ledger and the instruments
(PyTorch port of ``repro/serve/metrics.py``).

:class:`ServeLedger` is the assertion surface, like
:class:`repro_torch.core.selection.SyncLedger` for training: it counts
what the serving design promises, exactly one dispatch of the bucket's
program and one host sync per round.  :class:`ServeMetrics` is the
observation surface (latency histograms, queue depth, request and label
counters) on the plain-Python
:class:`repro_torch.obs.metrics.MetricsRegistry`, so it adds nothing to
the device work of a round.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..obs.metrics import MetricsRegistry


@dataclass
class ServeLedger:
    """Round-structure assertions for the serving loop.

    The batcher brackets every round with :meth:`begin_round` /
    :meth:`commit_round`; ``commit_round`` raises unless the round
    performed exactly one dispatch, so an engine that decodes per request
    or dispatches twice cannot pass silently.  :meth:`sync` is the only
    place the loop fetches device results.
    """

    rounds: int = 0
    dispatches: int = 0
    host_syncs: int = 0
    _open: bool = field(default=False, repr=False)
    _round_dispatches: int = field(default=0, repr=False)

    def begin_round(self) -> None:
        if self._open:
            raise RuntimeError("ServeLedger: round already open "
                               "(begin_round without commit_round)")
        self._open = True
        self._round_dispatches = 0

    def dispatched(self, n: int = 1) -> None:
        self.dispatches += n
        if self._open:
            self._round_dispatches += n

    def sync(self, labels: torch.Tensor) -> np.ndarray:
        """Copy the round's labels to the host: its one blocking device ->
        host copy, counted."""
        self.host_syncs += 1
        return labels.cpu().numpy()

    def commit_round(self) -> None:
        if not self._open:
            raise RuntimeError("ServeLedger: commit_round without "
                               "begin_round")
        if self._round_dispatches != 1:
            raise RuntimeError(
                f"ServeLedger: round performed {self._round_dispatches} "
                "dispatches; the serving contract is exactly one "
                "fixed-shape program dispatch per round")
        self._open = False
        self.rounds += 1

    def counts(self) -> tuple:
        """``(rounds, dispatches, host_syncs)``."""
        return (self.rounds, self.dispatches, self.host_syncs)


class ServeMetrics:
    """Serving instruments on a :class:`MetricsRegistry`.

    Latencies are recorded in seconds (the registry's fixed log2 buckets
    span microseconds to hours).
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None else \
            MetricsRegistry()

    def observe_request(self, latency_s: float, labels: int) -> None:
        self.registry.counter("serve_requests").inc()
        self.registry.counter("serve_labels").inc(max(int(labels), 0))
        self.registry.histogram("serve_latency").observe(latency_s)

    def observe_round(self, *, batch: int, fill: float, round_s: float,
                      bucket) -> None:
        del bucket  # per-bucket series would unbound the name space
        self.registry.counter("serve_rounds").inc()
        self.registry.histogram("serve_round_time").observe(round_s)
        self.registry.histogram("serve_batch_fill").observe(fill)
        self.registry.histogram("serve_batch_size").observe(batch)

    def set_queue_depth(self, depth: int) -> None:
        self.registry.gauge("serve_queue_depth").set(int(depth))

    def latency_quantile(self, q: float) -> Optional[float]:
        """Upper-bound latency (seconds) at quantile ``q``."""
        return self.registry.histogram("serve_latency").quantile(q)

    def snapshot(self) -> dict:
        return self.registry.snapshot()

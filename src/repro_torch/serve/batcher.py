"""Length-bucketed continuous batching for structured decode (PyTorch
port of ``repro/serve/batcher.py``).

:class:`StructuredServer` admits requests into per-bucket FIFO queues
(bucket = the engine's :meth:`~repro_torch.serve.engine.DecodeEngine
.shape_key` rounded up to a coarse grid), and every :meth:`step` serves
one bucket with one dispatch of that bucket's fixed-shape program (one
CUDA-graph replay on the card).  Short batches are padded with filler
rows so the batch shape never changes and the bucket's graph is reused.
Rows decode independently, so fillers and padding do not change any
served labeling, which equals the model's per-example ``spec.decode``.

Round structure is asserted: :class:`~repro_torch.serve.metrics
.ServeLedger` brackets each round and raises unless it dispatched
exactly once, and its :meth:`~repro_torch.serve.metrics.ServeLedger.sync`
is the round's one device -> host copy.  Latency, queue and throughput
series ride :class:`~repro_torch.serve.metrics.ServeMetrics`.  A
:class:`~repro_torch.obs.RunRecorder` passed as ``recorder`` gets the
reference's trace: a ``serve:<spec>`` meta record, one ``serve_request``
event per request and one host-timebase ``serve_round`` span per round,
all from host values read after the round's one sync.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from .engine import DecodeEngine, ShapeKey, decode_engine_for
from .export import ServableModel
from .metrics import ServeLedger, ServeMetrics


@dataclass
class ServeRequest:
    """One admitted decode request and, after its round, the result."""

    rid: int
    example: Any                      # host-side example (dict of arrays)
    key: ShapeKey                     # true shape signature
    bucket: ShapeKey                  # padded bucket geometry
    t_submit: float
    t_done: Optional[float] = None
    labels: Optional[np.ndarray] = None

    @property
    def latency(self) -> float:
        if self.t_done is None:
            raise RuntimeError(f"request {self.rid} not served yet")
        return self.t_done - self.t_submit


def bucket_key(key: ShapeKey, granularity: int = 4) -> ShapeKey:
    """Round each variable dim up to a multiple of ``granularity``.

    Coarse buckets trade a little padding compute for program reuse: the
    number of captured programs is bounded by the number of occupied grid
    points, not by the number of distinct request shapes.
    """
    g = max(int(granularity), 1)
    return tuple(-(-max(int(k), 1) // g) * g for k in key)


class StructuredServer:
    """Round-based batched serving of one :class:`ServableModel`.

    Drive it with ``submit`` + ``step`` / ``drain``, or ``serve`` a list.
    ``clock`` is injectable so tests can run on a virtual clock.
    ``recorder`` (a :class:`~repro_torch.obs.RunRecorder`) records the
    rounds and requests.
    """

    def __init__(self, model: ServableModel, *, batch_size: int = 8,
                 bucket_granularity: int = 4,
                 engine: Optional[DecodeEngine] = None,
                 metrics: Optional[ServeMetrics] = None,
                 recorder=None, clock=time.perf_counter):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.model = model
        self.engine = engine if engine is not None \
            else decode_engine_for(model)
        self.batch_size = int(batch_size)
        self.granularity = int(bucket_granularity)
        self.ledger = ServeLedger()
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self.recorder = recorder
        self.clock = clock
        self._rid = itertools.count()
        # bucket -> FIFO of waiting requests; round scheduling picks the
        # bucket holding the oldest head-of-line request (no bucket
        # starves).
        self._queues: Dict[ShapeKey, List[ServeRequest]] = {}
        if self.recorder is not None:
            self.recorder.open_custom(
                algo=f"serve:{type(self.model.spec).__name__}",
                n=self.batch_size, d=self.model.d,
                engine_budgets={"dispatches_per_round": 1,
                                "host_syncs_per_round": 1})

    # -- admission ----------------------------------------------------------

    @property
    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def submit(self, example: Any, t: Optional[float] = None) -> int:
        """Admit one example; returns its request id."""
        key = self.engine.shape_key(example)
        bucket = bucket_key(key, self.granularity)
        req = ServeRequest(rid=next(self._rid), example=example, key=key,
                           bucket=bucket,
                           t_submit=self.clock() if t is None else t)
        self._queues.setdefault(bucket, []).append(req)
        self.metrics.set_queue_depth(self.pending)
        return req.rid

    # -- the round loop ------------------------------------------------------

    def _pick_bucket(self) -> Optional[ShapeKey]:
        oldest, pick = None, None
        for bucket, q in self._queues.items():
            if q and (oldest is None or q[0].rid < oldest):
                oldest, pick = q[0].rid, bucket
        return pick

    def step(self) -> List[ServeRequest]:
        """Serve one round: one bucket, one dispatch, one sync.

        Returns the completed requests of the round ([] when idle).
        """
        bucket = self._pick_bucket()
        if bucket is None:
            return []
        queue = self._queues[bucket]
        reqs = queue[: self.batch_size]
        del queue[: len(reqs)]
        if not queue:
            del self._queues[bucket]

        t0 = self.clock()
        padded = [self.engine.pad(r.example, bucket) for r in reqs]
        # Filler rows keep the batch shape fixed so the bucket's program
        # is reused; rows decode independently, so fillers cannot perturb
        # the real rows.
        padded.extend([padded[-1]] * (self.batch_size - len(padded)))
        batch = self.engine.stack(padded)

        self.ledger.begin_round()
        out = self.engine.decode(batch)
        self.ledger.dispatched()
        labels = self.ledger.sync(out)
        self.ledger.commit_round()

        t1 = self.clock()
        for i, req in enumerate(reqs):
            req.labels = np.asarray(self.engine.unpad(labels[i], req.key))
            req.t_done = t1
            self.metrics.observe_request(req.latency, req.labels.size)
            if self.recorder is not None:
                self.recorder.event("serve_request", t=t1, rid=req.rid,
                                    latency=req.latency,
                                    labels=int(req.labels.size))
        self.metrics.observe_round(
            batch=len(reqs), fill=len(reqs) / self.batch_size,
            round_s=t1 - t0, bucket=bucket)
        self.metrics.set_queue_depth(self.pending)
        if self.recorder is not None:
            self.recorder.span_record("serve_round", t0, t1,
                                      timebase="host",
                                      bucket=list(bucket),
                                      batch=len(reqs),
                                      slots=self.batch_size)
        return reqs

    def drain(self) -> List[ServeRequest]:
        """Run rounds until every admitted request is served."""
        done: List[ServeRequest] = []
        while self.pending:
            done.extend(self.step())
        return done

    # -- convenience ---------------------------------------------------------

    def serve(self, examples: List[Any]) -> List[np.ndarray]:
        """Batch-serve a list of examples, results in submission order."""
        rids = [self.submit(ex) for ex in examples]
        by_rid = {r.rid: r for r in self.drain()}
        return [by_rid[rid].labels for rid in rids]

"""Batched fixed-shape decode engines: one captured program per bucket
(PyTorch port of ``repro/serve/engine.py``).

A :class:`DecodeEngine` turns a :class:`~repro_torch.serve.export
.ServableModel` into the serving hot path: :meth:`DecodeEngine.decode`
runs one fixed-shape program over a padded ``(B, ...)`` batch of host
arrays.  Where the reference gets one compiled program per bucket from
``jax.jit``, the port captures one CUDA graph per batch signature (the
bucket's shapes at the server's batch size) at that bucket's first round
(:class:`repro_torch.core.graphs._Graph`, which counts the kernel
launches of every replay).  Each round copies its batch into the graph's
static input buffers, one pinned non-blocking copy per leaf, and replays
the graph once.  On a CPU model the program runs eagerly: the plain
version.  On CUDA there is no eager path; a capture or replay that fails
raises.

Engines ship for the three bundled specs.  Each scores every row of the
bucket as a batch of one (``spec.scores``: the loss-augmented unaries or
class scores), then runs the spec's structured max on the whole bucket
(``spec.decode_scores``):

  * :class:`ChainDecodeEngine` -- Viterbi in B3, the hand-written kernel
    (:func:`repro_torch.kernels.ops.viterbi_decode`), once per round;
  * :class:`MulticlassDecodeEngine` -- the argmax over the class scores;
  * :class:`GraphDecodeEngine` -- the batched red-black ICM sweeps.

Third-party specs plug in through :func:`register_decode_engine`; specs
without an engine fall back to :class:`VmapDecodeEngine`, the spec's own
batched decode (the port's specs decode a ``(B, ...)`` batch, so nothing
is mapped; the name is the reference's).

The padding hooks (:meth:`DecodeEngine.shape_key`, :meth:`~DecodeEngine.pad`,
:meth:`~DecodeEngine.unpad`) define the bucket geometry the batcher
slots requests into.  Padded positions carry ``mask=False``, which the
decoders ignore, and rows decode independently, so a served labeling is
the per-example decode's.  One difference to the reference: a float32
matmul rounds a row's sums differently with the number of rows batched
with it (CPU and card), hence the scores row by row.  A row padded to its
bucket is still a longer matmul than the unpadded example's; on the CPU
that can move a score's last bit, and the labels are checked equal to
the per-example decode's (ROADMAP §C).  The reference's ``program()``
(what analysis rule J008 traces) waits for the contract checker (ROADMAP
§A item 7).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple, Type

import numpy as np
import torch

from ..api.oracle import OracleSpec
from ..core.graphs import _Graph
from ..core.types import upload
from ..kernels import ops as kops
from .export import ServableModel

ShapeKey = Tuple[int, ...]


def _pad_axis0(a: np.ndarray, target: int, fill) -> np.ndarray:
    a = np.asarray(a)
    if a.shape[0] == target:
        return a
    # np.full + slice assign, not np.pad: this runs per leaf per request
    # on the serving hot path and np.pad is ~10x slower on small arrays.
    out = np.full((target,) + a.shape[1:], fill, a.dtype)
    out[: a.shape[0]] = a
    return out


class _BucketProgram:
    """One batch signature's captured decode: static input buffers on the
    card, the CUDA graph that decodes them, and its output buffer.

    What a capture cannot record is made first: this thread's cuBLAS
    handle and the engine's hand-written kernels (built, loaded,
    initialised).  Nothing of the body runs before the capture, so every
    kernel launch the run counts is a replay's."""

    def __init__(self, engine: "DecodeEngine", w: torch.Tensor,
                 batch: Dict[str, np.ndarray]):
        self.inputs = {
            k: torch.empty(v.shape, device=w.device,
                           dtype=torch.from_numpy(v[:0]).dtype)
            for k, v in batch.items()}
        self.labels: Optional[torch.Tensor] = None

        def body():
            self.labels = engine._decode_batch(w, self.inputs)
        with torch.cuda.device(w.device):
            torch.cuda.current_blas_handle()
        kops.load(*engine.kernels)
        self.graph = _Graph(body, w.device)

    def run(self, batch: Dict[str, np.ndarray]) -> torch.Tensor:
        for k, v in batch.items():
            upload(v, out=self.inputs[k])
        self.graph.replay()
        return self.labels


class DecodeEngine:
    """Base engine: owns the model and its per-bucket programs.

    Subclasses implement the spec-specific hooks; :meth:`decode` and
    :meth:`stack` are shared.  ``decode`` is one dispatch (one graph
    replay on the card), which :class:`~repro_torch.serve.metrics
    .ServeLedger` asserts per round.  ``programs`` holds the captured
    graphs by batch signature; ``replays`` counts their replays.
    ``kernels`` names the hand-written kernels the program launches
    (:mod:`repro_torch.kernels.ops`), loaded before a capture.
    """

    kernels: Tuple[str, ...] = ()

    def __init__(self, model: ServableModel):
        self.model = model
        self.spec: OracleSpec = model.spec
        self.programs: Dict[tuple, _BucketProgram] = {}
        self.replays = 0
        self._captured_w: Optional[torch.Tensor] = None

    # -- spec-specific hooks ------------------------------------------------

    def shape_key(self, example: Any) -> ShapeKey:
        """The example's variable-shape signature (bucketing key); ``()``
        for fixed-shape tasks."""
        raise NotImplementedError

    def pad(self, example: Any, key: ShapeKey) -> Dict[str, np.ndarray]:
        """Pad one example (host arrays) up to bucket geometry ``key``."""
        raise NotImplementedError

    def unpad(self, labels: np.ndarray, key: ShapeKey) -> np.ndarray:
        """Slice one decoded row back to the request's true shape."""
        raise NotImplementedError

    def _decode_batch(self, w: torch.Tensor,
                      batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The fixed-shape program: ``(w, batch of tensors) -> labels``."""
        raise NotImplementedError

    # -- driver surface -----------------------------------------------------

    def stack(self, examples: List[Dict[str, np.ndarray]]
              ) -> Dict[str, np.ndarray]:
        """Stack padded host examples into one host batch."""
        return {k: np.stack([ex[k] for ex in examples]) for k in examples[0]}

    def decode(self, batch: Dict[str, np.ndarray]) -> torch.Tensor:
        """One dispatch of the bucket's program on a host batch: eager on
        a CPU model; on the card one replay of the graph captured for the
        batch's signature (captured now if it is new).  The labels on the
        card are the graph's output buffer, which the next replay of the
        same bucket overwrites."""
        w = self.model.w
        if w.device.type == "cpu":
            return self._decode_batch(
                w, {k: torch.from_numpy(v) for k, v in batch.items()})
        if self._captured_w is not w:        # the graphs bake in w
            self.programs.clear()
            self._captured_w = w
        sig = tuple((k, v.shape, v.dtype.str) for k, v in batch.items())
        program = self.programs.get(sig)
        if program is None:
            program = self.programs[sig] = _BucketProgram(self, w, batch)
        labels = program.run(batch)
        self.replays += 1
        return labels


class VmapDecodeEngine(DecodeEngine):
    """Generic fallback: the spec's own batched decode.

    Correct for any spec whose decode takes a ``(B, ...)`` batch and
    decodes its rows independently, over fixed-shape examples; specs with
    variable-shape examples subclass it and override the padding hooks.
    """

    def shape_key(self, example: Any) -> ShapeKey:
        return ()

    def pad(self, example: Any, key: ShapeKey) -> Dict[str, np.ndarray]:
        return {k: np.asarray(v) for k, v in example.items()}

    def unpad(self, labels: np.ndarray, key: ShapeKey) -> np.ndarray:
        return labels

    def _decode_batch(self, w, batch):
        return self.spec.decode(w, batch)


class _RowScoredEngine(VmapDecodeEngine):
    """The bundled specs' program: the spec's scores (``spec.scores``, the
    decode's only sums over features) of each row as a batch of one, then
    one batched ``spec.decode_scores``.  A ``(B, ...) @ (f, C)`` matmul
    rounds a row's scores by the rows batched with it, and a served
    labeling must be the per-example decode's; the structured max that
    follows works on each row alone in a fixed order."""

    def _decode_batch(self, w, batch):
        rows = next(iter(batch.values())).shape[0]
        scores = torch.cat([
            self.spec.scores(w, {k: v[i:i + 1] for k, v in batch.items()})
            for i in range(rows)])
        return self.spec.decode_scores(w, scores, batch)


class MulticlassDecodeEngine(_RowScoredEngine):
    """Argmax over each row's ``C`` class scores."""


class ChainDecodeEngine(_RowScoredEngine):
    """Batched loss-augmented Viterbi: each row's unaries, then one launch
    of B3 (``kernels/csrc/viterbi.cu``) at ``(B, L_bucket, C)`` on the
    card, with the padded tails masked."""

    kernels = ("viterbi_decode",)

    def shape_key(self, example: Any) -> ShapeKey:
        return (int(np.asarray(example["x"]).shape[0]),)

    def pad(self, example: Any, key: ShapeKey) -> Dict[str, np.ndarray]:
        (L,) = key
        return {
            "x": _pad_axis0(np.asarray(example["x"], np.float32), L, 0.0),
            "y": _pad_axis0(np.asarray(example["y"], np.int32), L, 0),
            "mask": _pad_axis0(np.asarray(example["mask"], bool), L, False),
        }

    def unpad(self, labels: np.ndarray, key: ShapeKey) -> np.ndarray:
        return labels[: key[0]]


class GraphDecodeEngine(_RowScoredEngine):
    """Batched red-black ICM over each row's unaries.  Node and edge
    padding (``mask``/``edge_mask`` false) is score-neutral, which keeps
    mixed-size graphs bucketable."""

    def shape_key(self, example: Any) -> ShapeKey:
        return (int(np.asarray(example["x"]).shape[0]),
                int(np.asarray(example["edges"]).shape[0]))

    def pad(self, example: Any, key: ShapeKey) -> Dict[str, np.ndarray]:
        L, E = key
        return {
            "x": _pad_axis0(np.asarray(example["x"], np.float32), L, 0.0),
            "y": _pad_axis0(np.asarray(example["y"], np.int32), L, 0),
            "mask": _pad_axis0(np.asarray(example["mask"], bool), L, False),
            "edges": _pad_axis0(np.asarray(example["edges"], np.int32),
                                E, 0),
            "edge_mask": _pad_axis0(np.asarray(example["edge_mask"], bool),
                                    E, False),
            "color": _pad_axis0(np.asarray(example["color"], np.int32),
                                L, 0),
        }

    def unpad(self, labels: np.ndarray, key: ShapeKey) -> np.ndarray:
        return labels[: key[0]]


# ---------------------------------------------------------------------------
# Registry: spec class -> engine factory (+ a canonical tiny trace case)


_ENGINES: Dict[Type[OracleSpec],
               Callable[[ServableModel], DecodeEngine]] = {}
_TRACE_CASES: Dict[str, Callable[[], Tuple[ServableModel, Any]]] = {}


def register_decode_engine(
        spec_cls: Type[OracleSpec],
        factory: Callable[[ServableModel], DecodeEngine],
        *, trace_case: Optional[Callable[[], Tuple[ServableModel, Any]]]
        = None, trace_label: Optional[str] = None) -> None:
    """Register the serving backend for a spec class, with an optional
    ``trace_case`` building a tiny ``(ServableModel, padded batch)`` pair
    (the input set of the reference's rule J008)."""
    _ENGINES[spec_cls] = factory
    if trace_case is not None:
        _TRACE_CASES[trace_label or spec_cls.__name__] = trace_case


def unregister_decode_engine(spec_cls: Type[OracleSpec],
                             trace_label: Optional[str] = None) -> None:
    _ENGINES.pop(spec_cls, None)
    _TRACE_CASES.pop(trace_label or spec_cls.__name__, None)


def decode_engine_for(model: ServableModel) -> DecodeEngine:
    """The registered engine for ``model.spec``: exact class first, then
    the MRO, then the :class:`VmapDecodeEngine` fallback."""
    for cls in type(model.spec).__mro__:
        factory = _ENGINES.get(cls)
        if factory is not None:
            return factory(model)
    return VmapDecodeEngine(model)


def serve_trace_cases() -> List[Tuple[str, DecodeEngine, Any]]:
    """``(label, engine, batch)`` for every registered engine with a
    trace case."""
    out = []
    for label in sorted(_TRACE_CASES):
        model, batch = _TRACE_CASES[label]()
        out.append((label, decode_engine_for(model), batch))
    return out


# -- canonical tiny trace cases for the bundled specs (CPU models) ----------


def _zeros_model(spec, data) -> ServableModel:
    return ServableModel(spec, torch.zeros((spec.dim(data),),
                                           dtype=torch.float32))


def _chain_trace_case():
    from ..core.oracles.chain import ChainSpec
    from ..data import synthetic

    spec = ChainSpec(num_labels=3)
    X, Y, M = synthetic.ocr_like(n=2, f=4, num_labels=3, mean_len=5,
                                 max_len=6, seed=0)
    model = _zeros_model(spec, {"x": X})
    engine = ChainDecodeEngine(model)
    exs = [{"x": X[i], "y": Y[i], "mask": M[i]} for i in range(2)]
    key = (X.shape[1],)
    return model, engine.stack([engine.pad(ex, key) for ex in exs])


def _multiclass_trace_case():
    from ..core.oracles.multiclass import MulticlassSpec
    from ..data import synthetic

    spec = MulticlassSpec(num_classes=3)
    x, y = synthetic.usps_like(n=2, f=4, num_classes=3, seed=0)
    model = _zeros_model(spec, {"x": x})
    engine = MulticlassDecodeEngine(model)
    exs = [{"x": x[i], "y": y[i]} for i in range(2)]
    return model, engine.stack([engine.pad(ex, ()) for ex in exs])


def _graph_trace_case():
    from ..core.oracles.graph import GraphSpec
    from ..data import synthetic

    spec = GraphSpec(num_sweeps=2)
    X, Y, M, E, EM, C = synthetic.horseseg_like(n=2, grid=(2, 3), f=4,
                                                seed=0)
    model = _zeros_model(spec, {"x": X})
    engine = GraphDecodeEngine(model)
    exs = [{"x": X[i], "y": Y[i], "mask": M[i], "edges": E[i],
            "edge_mask": EM[i], "color": C[i]} for i in range(2)]
    key = (X.shape[1], E.shape[1])
    return model, engine.stack([engine.pad(ex, key) for ex in exs])


def _register_builtin_engines() -> None:
    from ..core.oracles.chain import ChainSpec
    from ..core.oracles.graph import GraphSpec
    from ..core.oracles.multiclass import MulticlassSpec

    register_decode_engine(ChainSpec, ChainDecodeEngine,
                           trace_case=_chain_trace_case,
                           trace_label="chain")
    register_decode_engine(MulticlassSpec, MulticlassDecodeEngine,
                           trace_case=_multiclass_trace_case,
                           trace_label="multiclass")
    register_decode_engine(GraphSpec, GraphDecodeEngine,
                           trace_case=_graph_trace_case,
                           trace_label="graph")


_register_builtin_engines()

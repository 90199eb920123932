"""repro_torch.serve: batched structured-prediction serving (PyTorch port
of ``repro/serve``).

Train -> serve with the same decoder: a :class:`ServableModel` packages
``(OracleSpec, w)``, a registered :class:`DecodeEngine` runs one
fixed-shape program per padding bucket (one captured CUDA graph on the
card), and :class:`StructuredServer` runs the length-bucketed round loop
with one dispatch and one host sync per round (asserted by
:class:`ServeLedger`).

    model = solver.servable()
    model.save(CheckpointManager(path))
    server = StructuredServer(ServableModel.load(CheckpointManager(path)))
    labels = server.serve(examples)
"""
from .export import (ServableModel, register_servable_spec, spec_kind,
                     servable_spec_kinds, unregister_servable_spec)
from .engine import (ChainDecodeEngine, DecodeEngine, GraphDecodeEngine,
                     MulticlassDecodeEngine, VmapDecodeEngine,
                     decode_engine_for, register_decode_engine,
                     serve_trace_cases, unregister_decode_engine)
from .batcher import ServeRequest, StructuredServer, bucket_key
from .metrics import ServeLedger, ServeMetrics

__all__ = [
    "ServableModel", "register_servable_spec", "unregister_servable_spec",
    "servable_spec_kinds", "spec_kind",
    "DecodeEngine", "VmapDecodeEngine", "ChainDecodeEngine",
    "MulticlassDecodeEngine", "GraphDecodeEngine",
    "register_decode_engine", "unregister_decode_engine",
    "decode_engine_for", "serve_trace_cases",
    "StructuredServer", "ServeRequest", "bucket_key",
    "ServeLedger", "ServeMetrics",
]

"""repro_torch.obs: the observability layer of the port (the reference's
``repro/obs``, whose JSONL files the two packages share).

  * :class:`MetricsRegistry`: counters / gauges / histograms fed from host
    scalars the control loop already read;
  * :class:`RunRecorder`: spans, events and rows written as JSONL, installed
    by ``Solver(..., recorder=RunRecorder(path))`` or
    ``StructuredServer(..., recorder=...)``; it adds no host sync, dispatch
    or kernel launch;
  * the schema (:func:`validate_record`, :func:`validate_file`), the run
    summary and diff, and the Chrome-trace/Perfetto export;
  * the CLI, ``python -m repro_torch.obs``.
"""
from .metrics import Counter, Gauge, Histogram, MetricsRegistry  # noqa: F401
from .recorder import RunRecorder  # noqa: F401
from .schema import SCHEMA_VERSION, validate_file, validate_record  # noqa: F401
from .summary import (diff_runs, load_run, summarize,  # noqa: F401
                      summarize_run)
from .trace_export import export_chrome_trace, to_chrome_trace  # noqa: F401

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "RunRecorder",
    "SCHEMA_VERSION", "validate_record", "validate_file",
    "load_run", "summarize", "summarize_run", "diff_runs",
    "to_chrome_trace", "export_chrome_trace",
]

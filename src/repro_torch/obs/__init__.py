"""repro_torch.obs: the metric instruments and their registry.  The
recorder, schema, summary and trace export wait for ROADMAP §A item 5."""
from .metrics import Counter, Gauge, Histogram, MetricsRegistry  # noqa: F401

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]

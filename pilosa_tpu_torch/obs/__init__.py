"""Observability — logger, metrics, tracing (SURVEY §2.9/§5).

The port's copies of the JAX package's leaf planes: the leveled logger
with its nop default (``logger``), the central metrics registry
(``metrics``: the same metric names and label sets, so a scrape reads
the same), per-query spans (``tracing``: the same span names), the
flight recorder (``flight``), named fault points (``faults``) and the
resource-leak auditor (``testhook``).  They keep their own environment
names (``PILOSA_TPU_FLIGHT``, ``PILOSA_TPU_FAULT_SPEC``,
``PILOSA_TPU_TESTHOOK``): these configure observability and fault
injection, never a device path.  A process that imports both packages
holds two registries.
"""

from pilosa_tpu_torch.obs.logger import Logger, NopLogger, StderrLogger, new_logger
from pilosa_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    registry,
)
from pilosa_tpu_torch.obs.tracing import (
    NopTracer,
    ProfiledSpan,
    RecordingTracer,
    Span,
    TraceContext,
    Tracer,
    capture_context,
    get_tracer,
    set_tracer,
    span_into,
    start_span,
)

__all__ = [
    "Logger",
    "NopLogger",
    "StderrLogger",
    "new_logger",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "registry",
    "Tracer",
    "NopTracer",
    "RecordingTracer",
    "Span",
    "ProfiledSpan",
    "TraceContext",
    "capture_context",
    "span_into",
    "get_tracer",
    "set_tracer",
    "start_span",
]

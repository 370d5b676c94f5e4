"""Observability for the QUIP serving stack: spans, metrics, provenance.

See docs/observability.md.  Gates: ``QUIPT_TRACE`` / ``QUIPT_TRACE_CLOCK``
(span recording), ``QUIPT_EXPLAIN`` (impute provenance); both off by
default with a zero-allocation no-op path.
"""

from repro_torch.obs.metrics import MetricsRegistry, build_service_metrics
from repro_torch.obs.provenance import (
    ProvenanceRecorder,
    render_explain,
    resolve_explain,
)
from repro_torch.obs.trace import (
    NULL_SPAN,
    NULL_TRACER,
    Span,
    TRACE_CLOCKS,
    Tracer,
    resolve_tracer,
)

__all__ = [
    "MetricsRegistry",
    "NULL_SPAN",
    "NULL_TRACER",
    "ProvenanceRecorder",
    "Span",
    "TRACE_CLOCKS",
    "Tracer",
    "build_service_metrics",
    "render_explain",
    "resolve_explain",
    "resolve_tracer",
]

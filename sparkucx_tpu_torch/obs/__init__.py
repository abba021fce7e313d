"""Unified observability plane: distributed tracing glue, the
process-wide metrics registry, and the always-on flight recorder.

Port of ``sparkucx_tpu/obs``.

Three legs, one import surface:

* ``utils/trace.py`` grew real trace/span ids and the bounded event ring;
  this package adds the cross-executor parts — TRACE_PULL merging
  (``transport/tpu.py::export_trace``) rides on :func:`merge_events`.
* :class:`MetricsRegistry` — transports/stores/services register providers;
  one typed snapshot, Prometheus text exposition, served over the peer wire
  (METRICS_PULL) and an optional local HTTP scrape endpoint
  (``spark.shuffle.tpu.obs.metricsPort``).
* :class:`FlightRecorder` — keeps the trace ring warm even with tracing off
  and auto-dumps a postmortem bundle (trace tail + metrics snapshot +
  membership epoch) on TransportError, elastic recovery, and chaos faults.
"""

from sparkucx_tpu_torch.obs.metrics import MetricSample, MetricsRegistry, start_http_server
from sparkucx_tpu_torch.obs.recorder import FlightRecorder

__all__ = [
    "MetricSample",
    "MetricsRegistry",
    "FlightRecorder",
    "start_http_server",
]

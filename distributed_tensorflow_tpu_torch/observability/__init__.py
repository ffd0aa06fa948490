"""Telemetry of the port: journal, metrics, spans, tracing, gang
aggregation and the live exporter.

Counterpart of ``distributed_tensorflow_tpu/observability/``, with its
module names and public names. The reference's instrumentation was stdout
alone (``tfdist_between.py:98-110``):

- :mod:`~.journal`: a typed append-only JSONL event stream
  (``<logdir>/events.jsonl``), rank/world/run tagged, optionally rotated;
  every structured stdout line is rendered FROM one of its events;
- :mod:`~.format`: the event → line renderers;
- :mod:`~.metrics`: counters, gauges and fixed-edge histograms with
  Prometheus text and journal snapshots;
- :mod:`~.spans`: chrome-trace host spans whose dispatch flavour refuses to
  close without a device-to-host value fetch;
- :mod:`~.tracing`: trace ids that join the events of one operation;
- :mod:`~.aggregate`: N ranks' journals merged into one timeline with a
  track a journal;
- :mod:`~.exporter`: live ``/metrics`` and ``/healthz`` over the standard
  library's HTTP server.

Importing the package imports no ``torch`` (only a span's fetch touches a
tensor, through the tensor's own methods), so the reader side runs on a
machine without it. The device half of the telemetry is
``utils/profiler.py``; tfevents summaries are ``utils/summary.py``.
"""

from distributed_tensorflow_tpu_torch.observability import aggregate, tracing
from distributed_tensorflow_tpu_torch.observability.exporter import MetricsExporter
from distributed_tensorflow_tpu_torch.observability.format import emit_line, render
from distributed_tensorflow_tpu_torch.observability.journal import (
    EventJournal,
    NullJournal,
    append_event,
    configure,
    configure_from_env,
    emit,
    get_journal,
    journal_segments,
    rank_journal_path,
    read_events,
)
from distributed_tensorflow_tpu_torch.observability.metrics import (
    LATENCY_EDGES_S,
    TIME_MS_EDGES,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from distributed_tensorflow_tpu_torch.observability.spans import (
    DispatchSpan,
    SpanRecorder,
    chrome_trace,
    force_host,
)

__all__ = [
    "EventJournal",
    "NullJournal",
    "MetricsExporter",
    "aggregate",
    "append_event",
    "configure",
    "configure_from_env",
    "emit",
    "get_journal",
    "journal_segments",
    "rank_journal_path",
    "read_events",
    "tracing",
    "emit_line",
    "render",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "LATENCY_EDGES_S",
    "TIME_MS_EDGES",
    "DispatchSpan",
    "SpanRecorder",
    "chrome_trace",
    "force_host",
]

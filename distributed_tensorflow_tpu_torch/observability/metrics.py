"""Process-local metrics registry: counters, gauges, histograms.

Counterpart of ``distributed_tensorflow_tpu/observability/metrics.py``; the
Prometheus text and the snapshot are byte-for-byte the JAX package's for
the same observations. The trainers record ``step_time_ms``,
``epochs_total`` and, for the LM's dp and DiLoCo modes, the communication
counters. Two exports:

- :meth:`MetricsRegistry.prometheus_text`, the Prometheus text exposition
  format (served live by :mod:`~.exporter`);
- :meth:`MetricsRegistry.flush_to`, one ``metrics`` snapshot event into the
  journal.

Histograms have FIXED bucket edges and preallocated integer counts:
``observe`` is a bisect and two adds; quantiles are estimated at read time.
Standard library only.
"""

from __future__ import annotations

import math
from bisect import bisect_left

# Default latency edges (seconds): 1 ms → ~2 min, roughly ×2 per bucket.
LATENCY_EDGES_S = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 120.0,
)

# Millisecond edges for step and dispatch times, from a fused kernel's µs
# steps to multi-second dispatches.
TIME_MS_EDGES = (
    0.001, 0.01, 0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 5000.0, 30000.0,
)


def _fmt(v: float) -> str:
    """Prometheus float rendering: integers without the trailing .0."""
    f = float(v)
    if f != f:  # NaN
        return "NaN"
    if f in (math.inf, -math.inf):
        return "+Inf" if f > 0 else "-Inf"
    return repr(int(f)) if f == int(f) else repr(f)


class Counter:
    """Monotone counter."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: dict | None = None):
        self.name = name
        self.labels = dict(labels or {})
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {n})")
        self.value += n


class Gauge:
    """Set-to-current-value instrument."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: dict | None = None):
        self.name = name
        self.labels = dict(labels or {})
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n


class Histogram:
    """Fixed-edge histogram. ``counts[i]`` holds observations ≤
    ``edges[i]`` exclusive of lower buckets; ``counts[-1]`` is the
    overflow (+Inf) bucket. ``observe`` never allocates."""

    __slots__ = ("name", "labels", "edges", "counts", "sum", "count")

    def __init__(
        self, name: str, edges=LATENCY_EDGES_S, labels: dict | None = None
    ):
        edges = tuple(float(e) for e in edges)
        if not edges or list(edges) != sorted(set(edges)):
            raise ValueError(
                f"histogram {name} needs strictly increasing edges, "
                f"got {edges}"
            )
        self.name = name
        self.labels = dict(labels or {})
        self.edges = edges
        self.counts = [0] * (len(edges) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.edges, v)] += 1
        self.sum += v
        self.count += 1

    def quantile(self, q: float) -> float:
        """Bucket-upper-bound estimate of the ``q``-quantile (the usual
        Prometheus-style read: exact enough for SLO eyeballing, cheap
        enough for a report tool). Overflow observations report the top
        edge."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self.count == 0:
            return float("nan")
        target = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target and c:
                return self.edges[min(i, len(self.edges) - 1)]
        return self.edges[-1]


class MetricsRegistry:
    """Get-or-create instrument registry. One per component (trainer,
    gang, server); ``snapshot``/``prometheus_text``/``flush_to`` read the
    whole family."""

    def __init__(self):
        self._metrics: dict = {}  # (name, label-items) -> instrument

    @staticmethod
    def _key(name: str, labels: dict | None):
        return (name, tuple(sorted((labels or {}).items())))

    def _get(self, cls, name, labels, **kw):
        key = self._key(name, labels)
        inst = self._metrics.get(key)
        if inst is None:
            inst = cls(name, labels=labels, **kw)
            self._metrics[key] = inst
        elif not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(inst).__name__}, requested {cls.__name__}"
            )
        return inst

    def counter(self, name: str, labels: dict | None = None) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, labels: dict | None = None) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(
        self, name: str, edges=LATENCY_EDGES_S, labels: dict | None = None
    ) -> Histogram:
        return self._get(Histogram, name, labels, edges=edges)

    def __iter__(self):
        return iter(self._metrics.values())

    # -- export ------------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-ready state of every instrument (the journal's ``metrics``
        event payload)."""
        out: dict = {}
        for m in self._metrics.values():
            entry: dict = {"labels": m.labels} if m.labels else {}
            if isinstance(m, Histogram):
                entry.update(
                    type="histogram",
                    edges=list(m.edges),
                    counts=list(m.counts),
                    sum=m.sum,
                    count=m.count,
                )
            else:
                entry.update(
                    type="counter" if isinstance(m, Counter) else "gauge",
                    value=m.value,
                )
            out.setdefault(m.name, []).append(entry)
        return out

    def prometheus_text(self) -> str:
        """The Prometheus text exposition format (histograms as cumulative
        ``_bucket{le=...}`` series plus ``_sum``/``_count``)."""
        by_name: dict = {}
        for m in self._metrics.values():
            by_name.setdefault(m.name, []).append(m)
        lines: list[str] = []
        for name in sorted(by_name):
            family = by_name[name]
            kind = (
                "histogram"
                if isinstance(family[0], Histogram)
                else "counter" if isinstance(family[0], Counter) else "gauge"
            )
            lines.append(f"# TYPE {name} {kind}")
            for m in family:
                base = self._labelstr(m.labels)
                if isinstance(m, Histogram):
                    cum = 0
                    for edge, c in zip(m.edges, m.counts):
                        cum += c
                        le = self._labelstr({**m.labels, "le": _fmt(edge)})
                        lines.append(f"{name}_bucket{le} {cum}")
                    le = self._labelstr({**m.labels, "le": "+Inf"})
                    lines.append(f"{name}_bucket{le} {m.count}")
                    lines.append(f"{name}_sum{base} {_fmt(m.sum)}")
                    lines.append(f"{name}_count{base} {m.count}")
                else:
                    lines.append(f"{name}{base} {_fmt(m.value)}")
        return "\n".join(lines) + ("\n" if lines else "")

    @staticmethod
    def _labelstr(labels: dict) -> str:
        if not labels:
            return ""
        inner = ",".join(
            f'{k}="{str(v)}"' for k, v in sorted(labels.items())
        )
        return "{" + inner + "}"

    def flush_to(self, journal, **tags) -> dict:
        """Emit the snapshot as one ``metrics`` journal event."""
        return journal.emit("metrics", metrics=self.snapshot(), **tags)

"""Host-side trace spans: chrome-trace loadable, barrier-honest.

Counterpart of ``distributed_tensorflow_tpu/observability/spans.py``.
``utils/profiler.py`` answers "what did the DEVICE do"; these spans answer
"what did the HOST wait for" (a dispatch until its fetch, a graph trace, a
profiler window), in the chrome trace event format, so a span export loads
in Perfetto or ``chrome://tracing`` beside a device trace.

CUDA launches are asynchronous: a launch returns before the card has run
it, so the only end-of-execution barrier a span can trust is a
device-to-host VALUE fetch. A :meth:`SpanRecorder.dispatch` span therefore
**refuses to close** until :meth:`~DispatchSpan.fetch` has brought a value
to the host; timing a dispatch without the fetch raises instead of
recording the enqueue time. Generic host work uses
:meth:`SpanRecorder.span`, which has no such requirement.

Importing this imports no ``torch``: a tensor is fetched through its own
``.detach().cpu()``, and numpy is imported only when an array is fetched.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time


def force_host(value):
    """Materialize ``value`` on the host — the trustworthy execution
    barrier. A tensor is copied to the host (``.detach().cpu()``, which
    waits for the work that produced it) and comes back as numpy; other
    arrays through ``__array__``; Python/0-d scalars through ``float``.
    ``None`` is refused: a dispatch that produced nothing fetchable has
    nothing to prove it ran."""
    if value is None:
        raise ValueError(
            "dispatch fetch needs a value produced by the dispatch "
            "(device tensor or scalar); got None"
        )
    if hasattr(value, "detach") and hasattr(value, "cpu"):
        return value.detach().cpu().numpy()
    if hasattr(value, "__array__"):
        import numpy as np

        return np.asarray(value)
    if isinstance(value, (list, tuple)):
        return type(value)(force_host(v) for v in value)
    return float(value)


class DispatchSpan:
    """An open dispatch span. ``fetch(value)`` is the only way to close
    it cleanly: it performs the D2H materialization and stamps the span's
    end time AT the fetch — the honest dispatch+execute window."""

    def __init__(self, recorder: "SpanRecorder", name: str, args: dict):
        self._rec = recorder
        self.name = name
        self.args = args
        self._t0 = recorder._now()
        self._t_fetch = None

    def fetch(self, value):
        host = force_host(value)
        self._t_fetch = self._rec._now()
        return host

    @property
    def fetched(self) -> bool:
        return self._t_fetch is not None


class SpanRecorder:
    """In-memory span sink with chrome-trace export and optional journal
    mirroring (each closed span also lands as a ``span`` event, so
    ``obs_report`` can rebuild the trace from ``events.jsonl`` alone).
    Keeps at most ``max_spans`` (oldest dropped, ``dropped`` counts them)
    so a long-lived server cannot grow without bound."""

    def __init__(self, journal=None, *, max_spans: int = 100_000):
        self.journal = journal
        self.max_spans = int(max_spans)
        # deque(maxlen=...): O(1) eviction — a list's front-delete would
        # memmove the whole buffer per span once a long-lived server
        # reaches the cap.
        self.spans: collections.deque = collections.deque(maxlen=self.max_spans)
        self.dropped = 0
        self._wall0 = time.time()
        self._perf0 = time.perf_counter()

    def _now(self) -> float:
        return time.perf_counter() - self._perf0

    def _record(
        self, name: str, cat: str, t0: float, t1: float, args: dict
    ) -> dict:
        span = {
            "name": name,
            "cat": cat,
            "ts_us": t0 * 1e6,
            "dur_us": max(t1 - t0, 0.0) * 1e6,
            "wall_ts": self._wall0 + t0,
            "tid": threading.get_ident() & 0xFFFF,
        }
        if args:
            span["args"] = dict(args)
        if len(self.spans) == self.max_spans:
            self.dropped += 1  # deque maxlen evicts the oldest on append
        self.spans.append(span)
        if self.journal is not None:
            self.journal.emit(
                "span",
                name=name,
                cat=cat,
                ts_us=span["ts_us"],
                dur_us=span["dur_us"],
                **({"args": span["args"]} if args else {}),
            )
        return span

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "host", **args):
        """Generic host span (compile, checkpoint I/O, scheduler work)."""
        t0 = self._now()
        try:
            yield
        finally:
            self._record(name, cat, t0, self._now(), args)

    @contextlib.contextmanager
    def dispatch(self, name: str, **args):
        """A device-dispatch span. The body MUST call ``fetch(value)`` on
        something the dispatch produced; exiting without it raises
        RuntimeError: without a D2H fetch the span would time the enqueue,
        not the execution. The span's end is the fetch completion time."""
        sp = DispatchSpan(self, name, args)
        try:
            yield sp
        except BaseException:
            # The dispatch died: record what we know, never mask the error.
            self._record(
                name, "dispatch", sp._t0, self._now(),
                {**args, "error": True},
            )
            raise
        if not sp.fetched:
            raise RuntimeError(
                f"dispatch span {name!r} closed without a D2H fetch: call "
                "span.fetch(<value the dispatch produced>) before exiting "
                "— timing without a value fetch measures the enqueue, not "
                "the execution"
            )
        self._record(
            name, "dispatch", sp._t0, sp._t_fetch, {**args, "barrier": "d2h"}
        )

    def mark(self) -> float:
        """A start-of-dispatch timestamp for :meth:`dispatch_fetch` —
        take it immediately before issuing the dispatch."""
        return self._now()

    def dispatch_fetch(self, name: str, value, *, start: float | None = None,
                       **args):
        """One-call dispatch span for straight-line code: materializes
        ``value`` on the host (the D2H barrier — this call CANNOT record
        without fetching, same honesty guarantee as :meth:`dispatch`) and
        records the span from ``start`` (a :meth:`mark` taken before the
        dispatch; default: now, i.e. fetch-wait only). Returns the host
        value, so it drops in where a ``.cpu()`` fetch was."""
        t0 = self._now() if start is None else float(start)
        host = force_host(value)
        self._record(
            name, "dispatch", t0, self._now(), {**args, "barrier": "d2h"}
        )
        return host

    # -- export ------------------------------------------------------------

    def chrome_trace(self) -> dict:
        return chrome_trace(self.spans)

    def export_chrome_trace(self, path: str) -> str:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.chrome_trace(), f)
        return path


def chrome_trace(spans) -> dict:
    """Span dicts (recorder-shaped OR ``span`` journal events) → the
    chrome trace event format Perfetto loads. Complete ("X") events with
    microsecond ts/dur, one process, tids preserved when present."""
    pid = os.getpid()
    events = []
    for s in spans:
        events.append(
            {
                "name": s.get("name", "?"),
                "cat": s.get("cat", "host"),
                "ph": "X",
                "ts": float(s.get("ts_us", 0.0)),
                "dur": float(s.get("dur_us", 0.0)),
                "pid": int(s.get("pid", pid)),
                "tid": int(s.get("tid", 0)),
                "args": dict(s.get("args", {})),
            }
        )
    return {"traceEvents": events, "displayTimeUnit": "ms"}

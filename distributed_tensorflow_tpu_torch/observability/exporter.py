"""Live telemetry endpoint: ``/metrics`` (Prometheus text) and ``/healthz``.

Counterpart of ``distributed_tensorflow_tpu/observability/exporter.py``: a
standard-library ``ThreadingHTTPServer`` on a daemon thread, bound to
127.0.0.1, serving

- ``GET /metrics``: ``MetricsRegistry.prometheus_text()`` at scrape time
  (the hot loop mutates the instruments in place, so a scrape sees current
  values);
- ``GET /healthz``: a JSON liveness document, ``uptime_s`` plus whatever
  the component's ``health_fn`` reports. It answers 200 while the process
  is up; the content carries the judgement.

Nothing listens unless a caller starts one. ``port=0`` binds an ephemeral
port (:meth:`MetricsExporter.start` returns the bound one). The handler
thread only reads the registry and calls ``health_fn``.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class MetricsExporter:
    """Background ``/metrics`` + ``/healthz`` endpoint over one registry.

    ``health_fn() -> dict`` contributes the component-specific half of
    the health document; exceptions inside it degrade to an ``"error"``
    field rather than a dead endpoint (a monitoring surface must not
    take the serving process down — or go dark — because one gauge
    read raced a shutdown)."""

    def __init__(
        self,
        metrics,
        *,
        port: int = 0,
        host: str = "127.0.0.1",
        health_fn=None,
    ):
        self.metrics = metrics
        self.health_fn = health_fn
        self._host = host
        self._want_port = int(port)
        self._httpd = None
        self._thread = None
        self._t0 = time.time()

    @property
    def port(self) -> int | None:
        """The bound port (None until :meth:`start`)."""
        return None if self._httpd is None else self._httpd.server_address[1]

    @property
    def url(self) -> str | None:
        return (
            None
            if self._httpd is None
            else f"http://{self._host}:{self.port}"
        )

    def start(self) -> int:
        """Bind and serve on a daemon thread; returns the bound port.
        Idempotent (a second start returns the live port)."""
        if self._httpd is not None:
            return self.port
        exporter = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
                if self.path.split("?")[0] == "/metrics":
                    body = exporter.metrics.prometheus_text().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif self.path.split("?")[0] == "/healthz":
                    body = json.dumps(exporter._health()).encode()
                    ctype = "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # scrapes must not spam stdout
                pass

        self._httpd = ThreadingHTTPServer(
            (self._host, self._want_port), _Handler
        )
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="dtf-metrics-exporter",
            daemon=True,
        )
        self._thread.start()
        return self.port

    def _health(self) -> dict:
        doc = {"status": "ok", "uptime_s": round(time.time() - self._t0, 3)}
        if self.health_fn is not None:
            try:
                doc.update(self.health_fn() or {})
            except Exception as exc:  # noqa: BLE001 — see class docstring
                doc["error"] = f"{type(exc).__name__}: {exc}"
        return doc

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            self._thread = None

    def __enter__(self) -> "MetricsExporter":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

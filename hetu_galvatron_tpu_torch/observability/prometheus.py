"""Prometheus text-format exposition over the metrics registry.

Port of ``hetu_galvatron_tpu/observability/prometheus.py``
(``prometheus_text`` :62, ``MetricsHTTPServer`` :93). A stdlib-only
``/metrics`` and ``/healthz`` HTTP endpoint (``http.server``, no new
dependencies) so a scraper can watch a supervised run live instead of
tailing its JSONL stream. Off by default — ``supervisor.metrics_port`` (or
a direct :class:`MetricsHTTPServer`) turns it on; port 0 binds an
ephemeral port (tests).

Mapping to the text exposition format
(https://prometheus.io/docs/instrumenting/exposition_formats/):

* names are sanitized (``serve/ttft_ms`` -> ``serve_ttft_ms``; Prometheus
  names admit ``[a-zA-Z0-9_:]`` only),
* counters render as ``<name>_total``,
* gauges render as-is,
* histograms render the summary convention: ``<name>_count``,
  ``<name>_sum``, and ``{quantile="0.5|0.9|0.99"}`` sample lines (the
  registry keeps percentile snapshots, not buckets).

The handler snapshots under the GET, so a scrape observes a consistent
view; it never blocks the training loop (the registry's hot path is a dict
lookup + float op, and snapshots read plain attributes).
"""

from __future__ import annotations

import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

from hetu_galvatron_tpu_torch.observability.registry import (
    MetricsRegistry,
    get_registry,
)

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_RE = re.compile(r"[^a-zA-Z0-9_]")


def sanitize_name(name: str) -> str:
    out = _NAME_RE.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labels_str(labels: Dict[str, str], extra: str = "") -> str:
    parts = [f'{_LABEL_RE.sub("_", k)}="{_escape(str(v))}"'
             for k, v in sorted(labels.items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def prometheus_text(registry: Optional[MetricsRegistry] = None) -> str:
    """Render every metric in the registry as Prometheus text format."""
    reg = registry if registry is not None else get_registry()
    lines = []
    typed = set()

    def head(name: str, kind: str) -> None:
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} {kind}")

    for m in reg.metrics():
        name = sanitize_name(m.name)
        if m.kind == "counter":
            head(f"{name}_total", "counter")
            lines.append(f"{name}_total{_labels_str(m.labels)} {m.value}")
        elif m.kind == "gauge":
            head(name, "gauge")
            lines.append(f"{name}{_labels_str(m.labels)} {m.value}")
        elif m.kind == "histogram":
            snap = m.snapshot()
            head(name, "summary")
            for q, key in (("0.5", "p50"), ("0.9", "p90"), ("0.99", "p99")):
                quantile = 'quantile="%s"' % q
                lines.append(f"{name}{_labels_str(m.labels, quantile)} "
                             f"{snap[key]}")
            lines.append(f"{name}_sum{_labels_str(m.labels)} {m.total}")
            lines.append(f"{name}_count{_labels_str(m.labels)} {m.count}")
    return "\n".join(lines) + "\n"


class MetricsHTTPServer:
    """Background ``/metrics`` endpoint over one registry.

    ``start()`` binds (port 0 = ephemeral; the bound port is returned and
    kept in ``.port``) and serves from a daemon thread; ``stop()`` is
    idempotent. Binding failures raise at ``start()`` — a launcher that
    asked for a metrics port wants to hear the port is taken, not serve
    silently unscrapeable. The endpoint is unauthenticated, so the
    default bind is loopback-only; pass ``host="0.0.0.0"`` to expose it to
    an external scraper.

    ``/healthz`` answers liveness probes (load generators, k8s) with a
    tiny JSON body — 200 + uptime and last-step age — so probes never
    pay for (or depend on) the full text exposition. A loop calls
    :meth:`note_step` each step; ``health_fn`` lets a host process
    merge extra fields into the response (guarded: a failing hook
    reports itself instead of breaking the probe)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 port: int = 0, host: str = "127.0.0.1",
                 health_fn: Optional[Callable[[], Dict[str, Any]]] = None):
        self._registry = registry
        self.host = host
        self.port = port
        self.health_fn = health_fn
        self._t_start: Optional[float] = None
        self._last_step_t: Optional[float] = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def note_step(self) -> None:
        """Mark one unit of forward progress (engine/train step); the
        ``/healthz`` ``last_step_age_s`` field reads this."""
        self._last_step_t = time.monotonic()

    def health(self) -> Dict[str, Any]:
        now = time.monotonic()
        payload: Dict[str, Any] = {
            "status": "ok",
            "uptime_s": (now - self._t_start
                         if self._t_start is not None else 0.0),
            "last_step_age_s": (now - self._last_step_t
                                if self._last_step_t is not None else None),
        }
        if self.health_fn is not None:
            try:
                payload.update(self.health_fn() or {})
            except Exception as e:  # noqa: BLE001 — probe must stay alive
                payload["health_fn_error"] = f"{type(e).__name__}: {e}"
        return payload

    @property
    def registry(self) -> MetricsRegistry:
        return (self._registry if self._registry is not None
                else get_registry())

    def start(self) -> int:
        if self._httpd is not None:
            return self.port
        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                route = self.path.split("?")[0]
                if route == "/healthz":
                    body = json.dumps(server.health()).encode()
                    ctype = "application/json"
                elif route in ("/metrics", "/"):
                    body = prometheus_text(server.registry).encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # scrapes must not spam stdout
                pass

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._t_start = time.monotonic()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="metrics-http")
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

"""Prometheus-style scrape endpoint over a :class:`MetricsRegistry`.

Stdlib-only (``http.server``), one daemon thread, ephemeral-port
friendly.  Started by ``python -m repro.cluster.node --metrics-port N``;
``GET /metrics`` (or ``/``) returns the text exposition.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .metrics import MetricsRegistry

__all__ = ["MetricsHTTPServer"]

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsHTTPServer:
    """Serve ``registry.render_prometheus()`` at ``/metrics``.

    ``port=0`` binds an ephemeral port; read it back via ``.port``.
    """

    def __init__(self, registry: MetricsRegistry, host: str = "127.0.0.1",
                 port: int = 0):
        self.registry = registry

        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                if self.path.split("?")[0] not in ("/", "/metrics"):
                    self.send_error(404)
                    return
                body = outer.registry.render_prometheus().encode()
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # keep node stdout parseable
                pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.host, self.port = self._server.server_address[:2]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="metrics-httpd", daemon=True)
        self._thread.start()

    @property
    def address(self):
        return (self.host, self.port)

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)

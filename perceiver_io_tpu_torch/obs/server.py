"""Stdlib scrape surface: ``/metrics`` + ``/healthz`` + ``/slo`` on a thread
(counterpart of ``perceiver_io_tpu/obs/server.py``).

The registry exports Prometheus text and the SLO report exports JSON; what
was missing is the *endpoint* — the thing a Prometheus scraper, a load
balancer's health check, or a human with curl actually hits while a serving
process runs. :class:`ObsServer` is a ``http.server`` thread (stdlib only,
zero new dependencies — the same constraint as every obs consumer):

- ``GET /metrics`` — ``MetricsRegistry.to_prometheus()`` text exposition
  (cumulative ``_bucket{le=...}`` + ``+Inf`` + ``_sum``/``_count`` per
  histogram, so standard ``histogram_quantile`` PromQL works against it);
- ``GET /healthz`` — liveness JSON (status, uptime, metric count), merged
  with an optional ``health=`` provider's dict — the serving front end
  publishes circuit-breaker state / queue depth / drain status here;
- ``GET /slo`` — ``obs.slo.build_slo_report`` over the run directory's
  live event stream: the per-request TTFT/TPOT/queue-wait aggregate as of
  *now*, which is what an SLO dashboard or the multi-tenant road's
  per-tenant gate polls; ``GET /slo?tenant=acme`` narrows the report to
  one tenant's tenant-stamped rows (an unknown query parameter is a 400 —
  the endpoint takes real parameters, so it parses them; an unknown
  tenant is an empty report, not an error). The stream is ingested
  **incrementally** — the
  server remembers each shard's byte offset and parses only appended
  complete lines per scrape (events.jsonl is append-only; a shrunken shard
  resets the cache), so a 15s poll against a million-request run costs the
  tail, not a full-file reparse in the serving host's handler thread.

Reads are safe against a concurrently-appending writer (only complete
lines are consumed — the torn tail stays pending). Bind ``port=0`` to get
an ephemeral port (tests, parallel runs); the server is a context manager
and daemon-threaded, so a crashing run never hangs on it.
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional


class ObsServer:
    """Serving-observability scrape endpoint (see module docstring).

    :param registry: an ``obs.metrics.MetricsRegistry`` for ``/metrics``
        (None: the default process-wide registry).
    :param run_dir: the run directory whose event stream backs ``/slo``
        (None: ``/slo`` answers 404).
    :param health: optional zero-arg callable whose dict is merged into the
        ``/healthz`` body AFTER the defaults — a serving front end passes
        ``RequestFrontEnd.health`` so the endpoint reports circuit-breaker
        state, queue depth and drain status (and may override ``status``:
        a load balancer stops routing to a draining or breaker-open
        process). A raising provider degrades to ``health_error`` in the
        body — the liveness answer itself must never fail.
    """

    def __init__(
        self,
        registry=None,
        run_dir: Optional[str] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        health=None,
    ):
        if registry is None:
            from perceiver_io_tpu_torch.obs.metrics import default_registry

            registry = default_registry()
        self.registry = registry
        self.run_dir = run_dir
        self.health = health
        self.host = host
        self.port = int(port)  # rebound to the real port by start()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._t0 = time.time()
        # /slo incremental-ingestion state: per-shard byte offset of the
        # last complete line consumed + the request rows seen so far
        self._slo_lock = threading.Lock()
        self._slo_offsets: Dict[str, int] = {}
        self._slo_requests: List[dict] = []

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "ObsServer":
        if self._httpd is not None:
            return self
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: N802 — silence stderr
                pass

            def do_GET(self):  # noqa: N802 — http.server API
                server._handle(self)

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="obs-server", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def __enter__(self) -> "ObsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- routing ------------------------------------------------------------

    def _handle(self, req: BaseHTTPRequestHandler) -> None:
        from urllib.parse import parse_qs, urlparse

        parsed = urlparse(req.path)
        path = parsed.path.rstrip("/") or "/"
        query = parse_qs(parsed.query, keep_blank_values=True)
        try:
            if path == "/metrics":
                body = self.registry.to_prometheus().encode()
                self._respond(
                    req, 200, body, "text/plain; version=0.0.4; charset=utf-8"
                )
            elif path == "/healthz":
                body = {
                    "status": "ok",
                    "uptime_s": round(time.time() - self._t0, 3),
                    "n_metrics": len(self.registry),
                    "run_dir": self.run_dir,
                }
                if self.health is not None:
                    try:
                        body.update(dict(self.health()))
                    except Exception as e:  # noqa: BLE001 — liveness must answer
                        body["health_error"] = repr(e)
                self._json(req, 200, body)
            elif path == "/slo":
                # /slo takes real parameters, so its query string is PARSED,
                # not ignored: an unknown parameter is a caller bug (400),
                # never silently the unfiltered report
                unknown = sorted(k for k in query if k != "tenant")
                if unknown:
                    self._json(req, 400, {
                        "error": f"unknown query parameter(s) {unknown}",
                        "params": ["tenant"],
                    })
                else:
                    tenant = query["tenant"][-1] if "tenant" in query else None
                    self._json(req, *self._slo(tenant=tenant))
            else:
                self._json(req, 404, {"error": f"unknown path {path!r}",
                                      "paths": ["/metrics", "/healthz", "/slo"]})
        except Exception as e:  # noqa: BLE001 — a scrape must never crash the server
            try:
                self._json(req, 500, {"error": repr(e)})
            except OSError:
                pass  # client went away mid-error; nothing to do

    def _slo(self, tenant: Optional[str] = None):
        if self.run_dir is None:
            return 404, {"error": "no run_dir configured for /slo"}
        from perceiver_io_tpu_torch.obs.slo import build_slo_report

        with self._slo_lock:
            self._ingest_request_rows()
            rows = self._slo_requests
            if tenant is not None:
                rows = [r for r in rows if r.get("tenant") == tenant]
            report = build_slo_report(rows)
        if report is None:
            body = {"n_requests": 0, "note": "no request events yet"}
            if tenant is not None:
                body["tenant"] = tenant
                body["note"] = f"no request events for tenant {tenant!r}"
            return 200, body
        if tenant is not None:
            report["tenant"] = tenant
        return 200, report

    def _ingest_request_rows(self) -> None:
        """Advance the per-shard offsets and collect newly appended
        ``request`` rows (caller holds ``_slo_lock``). Only complete lines
        are consumed — a torn tail stays pending for the next scrape; a
        shard that SHRANK (rotation, truncation) resets the whole cache."""
        from perceiver_io_tpu_torch.obs.events import event_shards

        shards = event_shards(self.run_dir)
        try:
            shrunk = any(
                os.path.getsize(p) < self._slo_offsets.get(p, 0) for p in shards
            )
        except OSError:
            shrunk = True
        if shrunk:
            self._slo_offsets.clear()
            self._slo_requests.clear()
        for path in shards:
            offset = self._slo_offsets.get(path, 0)
            try:
                with open(path, "rb") as f:
                    f.seek(offset)
                    chunk = f.read()
            except OSError:
                continue
            last_nl = chunk.rfind(b"\n")
            if last_nl < 0:
                continue
            for line in chunk[:last_nl].split(b"\n"):
                if not line.strip():
                    continue
                try:
                    row = json.loads(line)
                except (json.JSONDecodeError, UnicodeDecodeError):
                    continue
                if isinstance(row, dict) and row.get("event") == "request":
                    self._slo_requests.append(row)
            self._slo_offsets[path] = offset + last_nl + 1

    @staticmethod
    def _respond(req, status: int, body: bytes, content_type: str) -> None:
        req.send_response(status)
        req.send_header("Content-Type", content_type)
        req.send_header("Content-Length", str(len(body)))
        req.end_headers()
        req.wfile.write(body)

    def _json(self, req, status: int, obj) -> None:
        self._respond(
            req, status, (json.dumps(obj, indent=1, default=str) + "\n").encode(),
            "application/json",
        )

"""The fleet's single front door: tenant-keyed HTTP routing (the port's
copy of ``das4whales_tpu.fleet.router``).

``FleetRouter`` is a thin stdlib proxy over the supervisor's ownership
table. A client talks to ONE address for the whole fleet:

``GET /picks/<tenant>?...``
    Proxied to the tenant's current owner. Cursor semantics survive
    migration by construction — cursors index the tenant's manifest,
    which lives at the stable fleet-level outdir and moves with the
    tenant — so a subscriber that reconnects after a migration window
    resumes from its last cursor with no gaps and no duplicates.
``POST /ingest/<tenant>``
    Forwarded to the current owner with bounded retry, exponential
    backoff and jitter (``faults.Backoff``), honouring a 429's or 503's
    ``Retry-After``; ownership is re-resolved per attempt, so a push
    that raced a migration lands on the new owner instead of failing.
``GET /fleet``
    The supervisor's status table (workers, assignments, migrations).
``GET /metrics``
    The router's own registry plus every live worker's exposition with
    a ``worker="<name>"`` label injected into each sample line.
``GET /livez`` / ``GET /readyz``
    Router liveness; readiness is "at least one worker up".

During a migration window (or while a tenant's worker is being
replaced) tenant routes answer **503 + Retry-After** instead of
hanging — the client owns the retry, with an explicit hint.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler
from urllib.parse import urlparse

from ..faults import Backoff
from ..service.api import RETRY_AFTER_S, _NamedThreadingHTTPServer
from ..telemetry import metrics
from ..utils.log import get_logger

log = get_logger("das4whales_tpu_torch.fleet.router")

_c_retries = metrics.counter(
    "das_fleet_router_retries_total",
    "router-side retries of proxied requests, by route and reason "
    "(429 backpressure, 503 migration window, connection error)",
    ("route", "reason"),
)

#: headers the ingest proxy forwards verbatim
_INGEST_HEADERS = ("X-DAS-Shape", "X-DAS-Dtype", "X-DAS-Name",
                   "Content-Type")


def _inject_worker_label(text: str, worker: str) -> list:
    """Prometheus sample lines with ``worker="<name>"`` injected (HELP/
    TYPE comments dropped — the router's aggregation is a scrape
    surface, not a registry merge)."""
    out = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        head = line.split(" ", 1)[0]
        if "{" in head:
            name, rest = line.split("{", 1)
            out.append(f'{name}{{worker="{worker}",{rest}')
        else:
            parts = line.split(" ", 1)
            if len(parts) == 2:
                out.append(f'{parts[0]}{{worker="{worker}"}} {parts[1]}')
            else:
                out.append(line)
    return out


class FleetRouter:
    """One HTTP server fronting a :class:`FleetSupervisor`."""

    def __init__(self, supervisor, host: str = "127.0.0.1", port: int = 0,
                 ingest_deadline_s: float = 15.0):
        self.sup = supervisor
        self.ingest_backoff = Backoff(base_s=0.05, factor=2.0, jitter=0.25,
                                      cap_s=1.0,
                                      deadline_s=ingest_deadline_s)
        router = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: D401, N802
                log.debug("http: " + fmt, *args)

            def _send(self, code, body, ctype="application/json",
                      extra=None):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (extra or {}).items():
                    self.send_header(k, str(v))
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, code, payload, extra=None):
                self._send(code, (json.dumps(payload) + "\n").encode(),
                           extra=extra)

            def do_GET(self):  # noqa: N802
                try:
                    router._get(self)
                except BrokenPipeError:
                    pass
                except Exception as exc:  # noqa: BLE001 — keep serving
                    log.warning("router GET %s failed: %s", self.path, exc)
                    try:
                        self._send_json(500, {"error": str(exc)})
                    except Exception:  # noqa: BLE001
                        pass

            def do_POST(self):  # noqa: N802
                try:
                    router._post(self)
                except Exception as exc:  # noqa: BLE001
                    log.warning("router POST %s failed: %s", self.path, exc)
                    try:
                        self._send_json(500, {"error": str(exc)})
                    except Exception:  # noqa: BLE001
                        pass

        self._server = _NamedThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "FleetRouter":
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="fleet-router",
            daemon=True)
        self._thread.start()
        log.info("router up at %s", self.url)
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    # -- routes ------------------------------------------------------------

    def _get(self, h) -> None:
        url = urlparse(h.path)
        parts = [p for p in url.path.split("/") if p]
        if url.path == "/livez":
            h._send_json(200, {"ok": True})
        elif url.path == "/readyz":
            up = [w.name for w in self.sup.workers() if w.up]
            h._send_json(200 if up else 503,
                         {"ok": bool(up), "workers_up": up})
        elif url.path == "/fleet":
            h._send_json(200, self.sup.status())
        elif url.path == "/metrics":
            h._send(200, self._aggregate_metrics().encode(),
                    ctype="text/plain; version=0.0.4")
        elif len(parts) == 2 and parts[0] == "picks":
            self._proxy_picks(h, parts[1], url.query)
        else:
            h._send_json(404, {"error": f"no route {url.path}"})

    def _post(self, h) -> None:
        parts = [p for p in urlparse(h.path).path.split("/") if p]
        if len(parts) == 2 and parts[0] == "ingest":
            self._proxy_ingest(h, parts[1])
        else:
            h._send_json(404, {"error": f"no route {h.path}"})

    # -- proxying ----------------------------------------------------------

    def _unavailable(self, h, tenant: str) -> None:
        h._send_json(503, {
            "error": f"tenant {tenant!r} is migrating or its worker is "
                     "being replaced; retry",
        }, extra={"Retry-After": RETRY_AFTER_S})

    def _proxy_picks(self, h, tenant: str, query: str) -> None:
        """One-shot proxy: no retry loop — a long-poll subscriber owns
        its own resume cursor, so the cheap correct answer to any
        hiccup is 503 + Retry-After and a client reconnect."""
        if tenant not in self.sup.tenant_names():
            h._send_json(404, {"error": f"unknown tenant {tenant!r}"})
            return
        w = self.sup.owner(tenant)
        if w is None:
            self._unavailable(h, tenant)
            return
        wait_s = 0.0
        for kv in query.split("&"):
            if kv.startswith("wait_s="):
                try:
                    wait_s = float(kv.split("=", 1)[1])
                except ValueError:
                    pass
        target = f"{w.url}/picks/{tenant}" + (f"?{query}" if query else "")
        try:
            with urllib.request.urlopen(target, timeout=wait_s + 10.0) as resp:
                body = resp.read()
                extra = {}
                if "X-DAS-Cursor" in resp.headers:
                    extra["X-DAS-Cursor"] = resp.headers["X-DAS-Cursor"]
                h._send(resp.status, body,
                        ctype=resp.headers.get("Content-Type",
                                               "application/x-ndjson"),
                        extra=extra)
        except urllib.error.HTTPError as exc:
            h._send(exc.code, exc.read())
        except (urllib.error.URLError, OSError, TimeoutError):
            _c_retries.inc(route="picks", reason="conn")
            self._unavailable(h, tenant)

    def _proxy_ingest(self, h, tenant: str) -> None:
        """Bounded-retry forward to the CURRENT owner: backoff with
        jitter per attempt, Retry-After honoured on 429/503, ownership
        re-resolved per attempt so a migration mid-stream lands the
        push on the new owner."""
        if tenant not in self.sup.tenant_names():
            h._send_json(404, {"error": f"unknown tenant {tenant!r}"})
            return
        n = int(h.headers.get("Content-Length", 0))
        body = h.rfile.read(n)
        headers = {k: h.headers[k] for k in _INGEST_HEADERS
                   if h.headers.get(k)}
        last_status, last_body = 503, b'{"error": "no attempt"}\n'
        for delay in self.ingest_backoff.delays(key=tenant):
            w = self.sup.owner(tenant)
            if w is None:
                _c_retries.inc(route="ingest", reason="migrating")
                time.sleep(delay)
                continue
            req = urllib.request.Request(
                f"{w.url}/ingest/{tenant}", data=body, method="POST",
                headers=headers)
            try:
                with urllib.request.urlopen(req, timeout=10.0) as resp:
                    h._send(resp.status, resp.read())
                    return
            except urllib.error.HTTPError as exc:
                last_status, last_body = exc.code, exc.read()
                if exc.code not in (429, 503):
                    # a real client error (400 bad block, 404) is the
                    # caller's to fix — never retried
                    h._send(exc.code, last_body)
                    return
                retry_after = exc.headers.get("Retry-After")
                reason = "backpressure" if exc.code == 429 else "window"
                _c_retries.inc(route="ingest", reason=reason)
                if retry_after is not None:
                    try:
                        delay = max(delay, float(retry_after))
                    except ValueError:
                        pass
            except (urllib.error.URLError, OSError, TimeoutError):
                _c_retries.inc(route="ingest", reason="conn")
            time.sleep(delay)
        h._send(last_status if last_status in (429, 503) else 503,
                last_body, extra={"Retry-After": RETRY_AFTER_S})

    # -- aggregation -------------------------------------------------------

    def _aggregate_metrics(self) -> str:
        """The router's own registry (fleet gauges/counters, HELP/TYPE
        intact) plus each live worker's samples labelled by worker."""
        out = [metrics.prometheus_text().rstrip("\n")]
        for w in self.sup.workers():
            if not w.up:
                continue
            try:
                with urllib.request.urlopen(f"{w.url}/metrics", timeout=5.0) as resp:
                    text = resp.read().decode("utf-8", errors="replace")
            except (urllib.error.URLError, OSError, TimeoutError):
                continue
            out.extend(_inject_worker_label(text, w.name))
        return "\n".join(out) + "\n"

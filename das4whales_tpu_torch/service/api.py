"""The served surface: picks streams, metrics, probes, live ingest (the
port's copy of ``das4whales_tpu.service.api``).

Pure stdlib (``http.server``); the handler threads read snapshots and
manifests only and never touch a CUDA tensor. Endpoints:

``GET /livez`` / ``GET /readyz``
    ``telemetry.probes`` verdicts as 200/503 + JSON detail. ``/readyz``
    additionally carries ``slo_burning`` (tenants burning their error
    budget) and ``quality_drifting`` as detail — informational, never a
    503.
``GET /slo``
    Per-tenant serving-SLO verdicts (``telemetry.slo``): freshness
    target, multi-window burn rates, ``ok``/``warn``/``burning`` state,
    and the service-level burning list.
``GET /quality``
    Per-tenant science-quality rows (``telemetry.quality``): pick
    totals, SNR percentiles, noise floor / dead-channel signals and the
    EWMA drift verdicts, plus the drifting list.
``GET /metrics``
    The whole labeled registry as Prometheus text exposition 0.0.4
    (``telemetry.metrics.prometheus_text``).
``GET /tenants``
    JSON service snapshot: per-tenant disposition counts, ring depth,
    sticky rungs, DRR deficits.
``GET /picks/<tenant>?cursor=N&wait_s=S&limit=M&picks=1``
    The tenant's pick stream as NDJSON with CURSOR RESUME, backed by
    the append-only manifest: each line is one manifest record plus a
    ``cursor`` field naming the NEXT line to request, so a subscriber
    that reconnects with its last cursor misses nothing and re-reads
    nothing. ``wait_s`` long-polls: with no new records the response
    blocks up to that long before returning (possibly empty).
    ``picks=1`` embeds the pick arrays from the ``.npz`` artifact into
    each ``done`` record.
``POST /ingest/<tenant>``
    One live block (binary body, shape/dtype in headers) into the
    tenant's ring buffer. A full ring under the tenant's ``reject``
    policy answers **429** with ``Retry-After``; under ``drop_oldest``
    the push always lands (202) and the evicted block is counted as
    ``das_ingest_dropped_total{tenant}``.
``POST /drain/<tenant>?timeout_s=S``
    Gracefully drain ONE tenant: source stops, ring closes, buffered
    work resolves, counters and ``cost_card.json`` flush, settled
    manifest left complete — 200 with final counts + outdir; 404
    unknown tenant; 503 + ``Retry-After`` when the drain missed its
    deadline.
``POST /adopt``
    Register a tenant from an existing outdir. JSON body: a
    tenant-registry spec, optionally wrapped as ``{"spec": {...},
    "outdir": "..."}``. ``fsck.startup_check`` runs FIRST — 409 when
    the directory refuses (corruption), 400 on a bad spec, 200 with
    ``{pending, settled}`` counts on success.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..telemetry import metrics, probes
from ..utils import artifacts, locks
from ..utils.log import get_logger
from .ingest import IngestItem, LiveBlock

log = get_logger("das4whales_tpu_torch.service.api")

#: Retry-After seconds suggested on a 429 (reject-policy full ring).
RETRY_AFTER_S = 1


class _NamedThreadingHTTPServer(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` whose per-request handler threads carry a
    component name (``http-handler-N``) instead of ``Thread-N``, so
    traces, logs and the ``das_lock_*`` metrics attribute a slow
    subscriber to the HTTP surface."""

    _handler_seq = itertools.count()

    def process_request(self, request, client_address):
        # socketserver.ThreadingMixIn.process_request, plus a name; the
        # non-daemon ``_threads`` bookkeeping is irrelevant here — the
        # service always runs ``daemon_threads = True``
        t = threading.Thread(
            target=self.process_request_thread,
            args=(request, client_address),
            name=f"http-handler-{next(self._handler_seq)}",
            daemon=self.daemon_threads,
        )
        t.start()


def _probe_payload(result) -> dict:
    return {"ok": bool(result), "reason": result.reason,
            "detail": result.detail}


# ---------------------------------------------------------------------------
# The per-manifest NDJSON line index
# ---------------------------------------------------------------------------

class _ManifestIndex:
    """One manifest's line-offset index: ``offsets[i]`` is the byte
    offset of line ``i``; ``offsets[-1]`` is the scan-resume offset.
    The manifest is APPEND-ONLY, so offsets never invalidate; each poll
    reads only bytes past the last indexed complete line — O(new data),
    not O(file). Memory: one int per manifest line.

    The lock is PER MANIFEST: one slow tenant's manifest read never
    serializes another tenant's NDJSON polls — and the file IO happens
    OUTSIDE the lock besides."""

    __slots__ = ("lock", "offsets")

    def __init__(self):
        self.lock = locks.new_lock("manifest-index")
        self.offsets = [0]


_indexes: dict = {}
_indexes_lock = locks.new_lock("manifest-index-registry")


def _index_for(path: str) -> _ManifestIndex:
    """The (created-once) index of one manifest path. The registry lock
    guards only the dict lookup — never any IO."""
    with _indexes_lock:
        idx = _indexes.get(path)
        if idx is None:
            idx = _indexes[path] = _ManifestIndex()
        return idx


def _extend_index(path: str) -> list:
    """Index any newly appended complete lines; returns a snapshot of
    the offsets list. Only COMPLETE (newline-terminated) lines are
    indexed: a torn final line — a crash mid-append — stays invisible
    until its rewrite completes on resume.

    The file read runs OUTSIDE the index lock: the lock brackets only
    the offset bookkeeping, so a slow disk never
    queues other subscriber threads of the same tenant. A concurrent
    extender that raced us simply discards its overlap (the guard on
    the scan-resume offset); the next poll picks up anything dropped."""
    idx = _index_for(path)
    with idx.lock:
        start = idx.offsets[-1]
    try:
        with open(path, "rb") as fh:
            fh.seek(start)
            tail = fh.read()
    except OSError:
        with idx.lock:
            return list(idx.offsets)
    # one pass with a running offset — a cold index against a week-long
    # tenant's multi-MB manifest must not re-copy the tail per line
    new = []
    pos = 0
    while True:
        nl = tail.find(b"\n", pos)
        if nl < 0:
            break
        pos = nl + 1
        new.append(start + pos)
    with idx.lock:
        if new and idx.offsets[-1] == start:
            idx.offsets.extend(new)
        return list(idx.offsets)


def _manifest_since(outdir: str, cursor: int, limit: int, wait_s: float):
    """Manifest records past line ``cursor`` (the append-only file is
    the stream). Long-polls up to ``wait_s`` when nothing is new."""
    path = os.path.join(outdir, "manifest.jsonl")
    deadline = time.monotonic() + max(0.0, wait_s)
    while True:
        idx = _extend_index(path)
        n_complete = len(idx) - 1
        recs = []
        consumed = 0
        if cursor < n_complete:
            stop = min(cursor + limit, n_complete)
            try:
                with open(path, "rb") as fh:
                    fh.seek(idx[cursor])
                    chunk = fh.read(idx[stop] - idx[cursor])
                for line in chunk.splitlines():
                    consumed += 1
                    # the shared checksum-verifying ledger parser:
                    # accepts plain and CRC-suffixed lines; a corrupt
                    # line is skipped but still advances the cursor
                    # (a poisoned record must not wedge the stream)
                    rec, _verdict = artifacts.parse_record(
                        line.decode("utf-8", errors="replace"))
                    if rec is not None:
                        recs.append(rec)
            except OSError:
                recs, consumed = [], 0   # raced a rewrite: retry below
        if recs or consumed or time.monotonic() >= deadline:
            return recs, cursor + consumed
        time.sleep(0.05)


class ServiceAPI:
    """The HTTP server bound to one running service (``runner``)."""

    def __init__(self, service, host: str = "127.0.0.1", port: int = 0):
        self.service = service
        api = self

        class Handler(BaseHTTPRequestHandler):
            # one service, many subscriber threads: ThreadingHTTPServer
            # below serves each request on its own daemon thread
            def log_message(self, fmt, *args):  # noqa: D401, N802
                log.debug("http: " + fmt, *args)

            def _send(self, code: int, body: bytes,
                      ctype: str = "application/json",
                      extra: dict | None = None) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (extra or {}).items():
                    self.send_header(k, str(v))
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, code: int, payload,
                           extra: dict | None = None) -> None:
                self._send(code, (json.dumps(payload) + "\n").encode(),
                           extra=extra)

            def do_GET(self):  # noqa: N802
                try:
                    api._get(self)
                except BrokenPipeError:   # subscriber went away mid-write
                    pass
                except Exception as exc:  # noqa: BLE001 — 500, keep serving
                    log.warning("http GET %s failed: %s", self.path, exc)
                    try:
                        self._send_json(500, {"error": str(exc)})
                    except Exception:  # noqa: BLE001
                        pass

            def do_POST(self):  # noqa: N802
                try:
                    api._post(self)
                except Exception as exc:  # noqa: BLE001
                    log.warning("http POST %s failed: %s", self.path, exc)
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

    def start(self) -> "ServiceAPI":
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="service-api",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    # -- request routing ---------------------------------------------------

    def _get(self, h) -> None:
        url = urlparse(h.path)
        parts = [p for p in url.path.split("/") if p]
        if url.path == "/livez":
            res = probes.liveness()
            h._send_json(200 if res else 503, _probe_payload(res))
        elif url.path == "/readyz":
            res = probes.readiness()
            payload = _probe_payload(res)
            # SLO burn detail rides the readiness answer: a tenant
            # burning its error budget never flips readiness — the
            # process is healthy, its latency objective is not — but the
            # operator polling /readyz sees WHO is burning
            burning = self.service.slo_burning()
            if burning:
                payload["slo_burning"] = burning
            # quality-drift detail rides the same way: a drifting
            # tenant NEVER flips readiness
            drifting = self.service.quality_drifting()
            if drifting:
                payload["quality_drifting"] = drifting
            h._send_json(200 if res else 503, payload)
        elif url.path == "/slo":
            h._send_json(200, self.service.slo_report())
        elif url.path == "/quality":
            h._send_json(200, self.service.quality_report())
        elif url.path == "/metrics":
            # burn gauges refresh at evaluation time, not per pick: a
            # scrape must see the CURRENT window (breaches aging out
            # decay the gauge even with no new picks), so evaluate
            # every tenant's SLO before rendering the exposition
            self.service.slo_report()
            h._send(200, metrics.prometheus_text().encode(),
                    ctype="text/plain; version=0.0.4")
        elif url.path == "/tenants":
            h._send_json(200, self.service.snapshot())
        elif len(parts) == 2 and parts[0] == "picks":
            self._get_picks(h, parts[1], parse_qs(url.query))
        else:
            h._send_json(404, {"error": f"no route {url.path}"})

    def _get_picks(self, h, tenant: str, q) -> None:
        t = self.service.tenant(tenant)
        if t is None:
            h._send_json(404, {"error": f"unknown tenant {tenant!r}"})
            return
        cursor = int(q.get("cursor", ["0"])[0])
        wait_s = float(q.get("wait_s", ["0"])[0])
        limit = int(q.get("limit", ["1000"])[0])
        embed = q.get("picks", ["0"])[0] not in ("0", "", "false")
        lines, cursor = _manifest_since(t.outdir, cursor, limit, wait_s)
        out = []
        next_cursor = cursor - len(lines)
        for rec in lines:
            next_cursor += 1
            rec["cursor"] = next_cursor
            if embed and rec.get("status") == "done" and rec.get("picks_file"):
                try:
                    from ..workflows.campaign import load_picks

                    rec["picks"] = {
                        name: np.asarray(pk).tolist()
                        for name, pk in load_picks(rec["picks_file"]).items()
                    }
                except OSError:
                    rec["picks"] = None
            out.append(json.dumps(rec))
        body = ("\n".join(out) + ("\n" if out else "")).encode()
        h._send(200, body, ctype="application/x-ndjson",
                extra={"X-DAS-Cursor": cursor})

    def _post(self, h) -> None:
        url = urlparse(h.path)
        parts = [p for p in url.path.split("/") if p]
        if len(parts) == 2 and parts[0] == "drain":
            self._post_drain(h, parts[1], parse_qs(url.query))
            return
        if len(parts) == 1 and parts[0] == "adopt":
            self._post_adopt(h)
            return
        if len(parts) != 2 or parts[0] != "ingest":
            h._send_json(404, {"error": f"no route {h.path}"})
            return
        t = self.service.tenant(parts[1])
        if t is None:
            h._send_json(404, {"error": f"unknown tenant {parts[1]!r}"})
            return
        try:
            shape = tuple(int(v) for v in
                          h.headers.get("X-DAS-Shape", "").split(","))
            dtype = np.dtype(h.headers.get("X-DAS-Dtype", "float32"))
            if len(shape) != 2:
                raise ValueError("X-DAS-Shape must be 'channels,samples'")
            n = int(h.headers.get("Content-Length", 0))
            raw = h.rfile.read(n)
            arr = np.frombuffer(raw, dtype=dtype).reshape(shape)
        except Exception as exc:  # noqa: BLE001 — bad payload is a 400
            h._send_json(400, {"error": f"bad block: {exc}"})
            return
        # the name is the manifest/retry/artifact identity key: un-named
        # pushes draw a per-tenant monotonic sequence (a wall-clock
        # default can collide within one millisecond)
        name = h.headers.get("X-DAS-Name") or t.next_live_name()
        block = LiveBlock(trace=arr, metadata=t.spec.live_metadata(),
                          wire=t.spec.wire)
        if t.ring.push(IngestItem(path=name, block=block)):
            h._send_json(202, {"accepted": name, "ring_depth": len(t.ring)})
        else:
            # explicit backpressure: the ring is full under the reject
            # policy (or closed during drain) — the interrogator should
            # back off and retry
            h._send_json(429, {
                "error": "ring buffer full (reject policy)"
                if not t.ring.closed else "service draining",
                "ring_depth": len(t.ring),
            }, extra={"Retry-After": RETRY_AFTER_S})

    # -- admin verbs: drain one tenant, adopt one ----------------------------

    def _post_drain(self, h, tenant: str, q) -> None:
        timeout_s = float(q.get("timeout_s", ["30"])[0])
        try:
            summary = self.service.drain_tenant(tenant, timeout_s=timeout_s)
        except KeyError:
            h._send_json(404, {"error": f"unknown tenant {tenant!r}"})
            return
        except TimeoutError as exc:
            # the drain is still in progress (retire stays queued): the
            # caller should retry, NOT conclude the tenant moved
            h._send_json(503, {"error": str(exc)},
                         extra={"Retry-After": RETRY_AFTER_S})
            return
        h._send_json(200, summary)

    def _post_adopt(self, h) -> None:
        try:
            n = int(h.headers.get("Content-Length", 0))
            body = json.loads(h.rfile.read(n) or b"{}")
            if not isinstance(body, dict):
                raise ValueError("adopt body must be a JSON object")
        except (ValueError, json.JSONDecodeError) as exc:
            h._send_json(400, {"error": f"bad adopt body: {exc}"})
            return
        spec = body.get("spec", body)
        outdir = body.get("outdir") if "spec" in body else None
        try:
            summary = self.service.adopt_tenant(spec, outdir=outdir)
        except (TypeError, ValueError) as exc:
            h._send_json(400, {"error": str(exc)})
            return
        except RuntimeError as exc:
            # fsck.startup_check refused the directory: adopting it
            # would resume over corruption — surface, do not register
            h._send_json(409, {"error": str(exc)})
            return
        h._send_json(200, summary)

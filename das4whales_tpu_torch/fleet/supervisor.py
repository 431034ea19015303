"""The fleet control plane: N shared-nothing workers, one supervisor (the
port's copy of ``das4whales_tpu.fleet.supervisor``).

``FleetSupervisor`` spawns N ``python -m das4whales_tpu_torch serve``
workers as subprocesses (each with its own outdir, port and memory share
through ``worker_env``), places tenants across them by bin-packing their
cost-card footprints, watches every worker's ``/livez`` with
consecutive-miss streaks, and recovers from a dead worker (SIGKILL,
wedge, probe-miss streak) by *resuming* its tenants on survivors from
their settled manifests: the service's drain -> resume contract and the
``fsck`` startup check are the whole recovery mechanism, and a migration
is recovery invoked on a healthy worker.

Design invariants (the JAX package's):

* **stable tenant outdirs** — every tenant's manifest and picks live in
  ``<root>/tenants/<name>``, outside any worker's directory, so the
  manifest (and with it every ``/picks`` cursor) survives a migration
  unchanged. A worker is a stateless executor over a durable tenant
  directory.
* **crash-only supervisor** — the desired-state table lives in
  ``<root>/fleet.jsonl`` through ``utils.artifacts.append_record`` (the
  torn-tail-tolerant ledger); a restarted supervisor sweeps orphan tmps,
  replays the ledger (the last ``assign`` per tenant wins), fences any
  worker pid of the previous lifetime and respawns the fleet.
* **never guesses placement** — a tenant's footprint comes from its
  ``cost_card.json`` (the priced peak and roofline wall that a previous
  serving lifetime flushed at drain), then from the declared
  ``hbm_share_gb``, then from a default ledgered as ``"unpriced"``.

Two differences from the JAX package:

* ``FleetConfig.device`` (default ``"cuda"``) is written into every
  worker's registry, where the service reads it (``ServiceConfig.device``):
  a worker without its card exits non-zero and :meth:`_wait_ready`
  names its log; nothing falls back to the CPU. The JAX package pins a
  platform through ``worker_env`` instead.
* fencing matches the supervisor's own worker command —
  ``-m das4whales_tpu_torch serve <root>/workers/<name>/registry.json`` —
  and nothing wider; the JAX package kills any pid whose command line
  contains ``das4whales_tpu``, a name every process of the port shares.

The supervisor computes nothing on a device: the workers own the card in
their own processes.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..faults import Backoff
from ..telemetry import metrics
from ..utils import artifacts
from ..utils.log import get_logger

log = get_logger("das4whales_tpu_torch.fleet.supervisor")

#: the package a worker runs (``python -m <WORKER_PACKAGE> serve``)
WORKER_PACKAGE = "das4whales_tpu_torch"

#: statuses whose last manifest record settles a file — mirrors
#: ``workflows.campaign._SETTLED_STATUSES`` (tested equal) without
#: importing the campaign module into the control plane
SETTLED_STATUSES = ("done", "quarantined")

_g_worker_up = metrics.gauge(
    "das_fleet_worker_up",
    "1 while the supervisor believes this worker serves, 0 after it is "
    "declared dead (until its replacement comes up)",
    ("worker",),
)
_g_streak = metrics.gauge(
    "das_fleet_probe_miss_streak",
    "consecutive failed /livez probes against this worker (dead at "
    "FleetConfig.dead_after)",
    ("worker",),
)
_g_tenants = metrics.gauge(
    "das_fleet_tenants",
    "tenants currently assigned to this worker",
    ("worker",),
)
_c_migrations = metrics.counter(
    "das_fleet_migrations_total",
    "tenant migrations by trigger ('rebalance': graceful drain+adopt; "
    "'failure': adoption from a dead worker's outdir)",
    ("trigger",),
)


def settled_files(outdir: str) -> set:
    """Last-record-wins settled set of one tenant manifest (the
    ``workflows.campaign.load_settled`` semantics, read through the
    shared ledger parser so the control plane stays import-light)."""
    last: Dict[str, str] = {}
    path = os.path.join(outdir, "manifest.jsonl")
    for rec in artifacts.read_records(path):
        if "path" in rec:
            last[rec["path"]] = rec.get("status", "")
    return {p for p, s in last.items() if s in SETTLED_STATUSES}


def free_port(host: str = "127.0.0.1") -> int:
    """One currently free TCP port (bind-then-close; the tiny reuse race
    is acceptable for worker spawn — a collision fails the worker's
    bind loudly and the supervisor declares it dead)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


@dataclass
class FleetConfig:
    """The fleet registry: the JAX package's keys plus ``device``."""

    tenants: List[Dict]
    root: str = "out_fleet"
    workers: int = 2
    host: str = "127.0.0.1"
    #: router port (0: ephemeral — the bound port is ``FleetRouter.port``)
    port: int = 0
    #: per-worker placement capacity in GiB (None: unbounded — placement
    #: degenerates to balanced round-robin by footprint)
    hbm_budget_gb: float | None = None
    #: footprint charged to a tenant with neither a cost card nor a
    #: declared ``hbm_share_gb`` — ledgered as ``"unpriced"``
    default_footprint_gb: float = 1.0
    health_interval_s: float = 0.5
    probe_timeout_s: float = 2.0
    #: consecutive /livez misses before a worker is declared dead
    dead_after: int = 3
    drain_timeout_s: float = 30.0
    #: deadline for a spawned worker to answer /livez
    spawn_timeout_s: float = 60.0
    #: arm the cost observatory in every worker (cards priced during
    #: serving feed the NEXT placement round)
    cost_cards: bool = True
    #: extra environment for worker subprocesses (``DAS_HBM_BUDGET_GB``
    #: shares, thread pins...); merged over os.environ
    worker_env: Dict[str, str] = field(default_factory=dict)
    #: where every worker detects: the registry's ``device`` ("cuda", the
    #: card; "cpu" the plain versions on the CPU); never a fallback
    device: str | None = "cuda"

    def __post_init__(self):
        if self.workers < 1:
            raise ValueError("fleet needs at least one worker")
        names = [t.get("name") for t in self.tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names in fleet: {names}")


_FLEET_KEYS = {f.name for f in FleetConfig.__dataclass_fields__.values()}


def load_fleet_config(path: str) -> FleetConfig:
    """Parse a JSON fleet registry (unknown keys fail loudly, the
    discipline of ``service.load_service_config``)."""
    with open(path) as fh:
        raw = json.load(fh)
    unknown = set(raw) - _FLEET_KEYS
    if unknown:
        raise ValueError(f"unknown fleet keys {sorted(unknown)}; "
                         f"known: {sorted(_FLEET_KEYS)}")
    return FleetConfig(**raw)


def is_fleet_worker(cmdline: bytes, root: str) -> bool:
    """True when a ``/proc/<pid>/cmdline`` (NUL-separated argv) runs
    ``-m das4whales_tpu_torch serve`` on a worker registry under this
    fleet's ``root`` — the supervisor's own worker command and nothing
    wider (a JAX worker, another fleet's worker or any other process of
    the port is never fenced)."""
    argv = [a.decode("utf-8", "replace") for a in cmdline.split(b"\0")]
    workers = os.path.join(os.path.abspath(root), "workers") + os.sep
    for i in range(len(argv) - 3):
        if argv[i:i + 3] == ["-m", WORKER_PACKAGE, "serve"]:
            reg = os.path.abspath(argv[i + 3])
            return reg.startswith(workers) and os.path.basename(reg) == "registry.json"
    return False


@dataclass
class _Worker:
    name: str
    port: int
    pid: int
    proc: Optional[subprocess.Popen]
    up: bool = True
    streak: int = 0

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"


class FleetSupervisor:
    """Spawn, place, watch, recover. One instance owns one fleet root.

    Lifecycle: :meth:`start` (ledger replay + worker spawn + placement
    + health loop), :meth:`migrate` (the one primitive, two triggers),
    :meth:`stop` (graceful worker SIGTERM with bounded waits). All
    public readers (:meth:`owner`, :meth:`status`) are lock-bracketed
    for the router's HTTP threads.
    """

    def __init__(self, config: FleetConfig):
        self.config = config
        self.root = config.root
        os.makedirs(os.path.join(self.root, "tenants"), exist_ok=True)
        os.makedirs(os.path.join(self.root, "workers"), exist_ok=True)
        self._ledger = os.path.join(self.root, "fleet.jsonl")
        self._lock = threading.Lock()
        self._workers: Dict[str, _Worker] = {}
        self._assign: Dict[str, str] = {}      # tenant -> worker name
        self._migrating: set = set()
        self._specs: Dict[str, Dict] = {}
        for t in config.tenants:
            spec = dict(t)
            # the stable, fleet-level tenant directory: the manifest
            # (and every cursor into it) never moves with the worker
            spec["outdir"] = os.path.join(self.root, "tenants", spec["name"])
            self._specs[spec["name"]] = spec
        self._stop = threading.Event()
        self._health_thread: Optional[threading.Thread] = None
        self._probe_backoff = Backoff(base_s=config.health_interval_s,
                                      factor=1.5, jitter=0.1,
                                      cap_s=4 * config.probe_timeout_s)

    # -- ledger ------------------------------------------------------------

    def _append(self, record: Dict) -> None:
        artifacts.append_record(self._ledger, record)

    def _replay_ledger(self) -> Dict[str, str]:
        """Crash-only startup: the last ``assign`` per tenant from the
        previous lifetime (placement affinity), after fencing any
        worker pid that survived the old supervisor."""
        affinity: Dict[str, str] = {}
        for rec in artifacts.read_records(self._ledger):
            ev = rec.get("event")
            if ev == "assign" and rec.get("tenant") in self._specs:
                affinity[rec["tenant"]] = rec.get("worker", "")
            elif ev == "worker" and rec.get("pid"):
                self._fence_pid(int(rec["pid"]))
        return affinity

    def _fence_pid(self, pid: int) -> bool:
        """SIGKILL a worker pid from a previous supervisor lifetime —
        only if its command line is still this fleet's worker command
        (:func:`is_fleet_worker`); pids recycle."""
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as fh:
                cmdline = fh.read()
        except OSError:
            return False   # gone (or no /proc): nothing to fence
        if not is_fleet_worker(cmdline, self.root):
            return False
        log.warning("fencing stale worker pid %d from a previous "
                    "supervisor lifetime", pid)
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            return False
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            try:
                with open(f"/proc/{pid}/stat", "rb") as fh:
                    # a killed child of another parent lingers as a zombie
                    if fh.read().rsplit(b")", 1)[-1].split()[0] == b"Z":
                        break
            except OSError:
                break
            time.sleep(0.02)
        return True

    # -- worker subprocesses ----------------------------------------------

    def _spawn_worker(self, name: str) -> _Worker:
        wdir = os.path.abspath(os.path.join(self.root, "workers", name))
        os.makedirs(wdir, exist_ok=True)
        port = free_port(self.config.host)
        registry = {
            "outdir": os.path.join(wdir, "out"),
            "host": self.config.host, "port": port,
            "allow_empty": True, "tenants": [],
            "device": self.config.device,
        }
        if self.config.cost_cards:
            registry["cost_cards"] = True
        regpath = os.path.join(wdir, "registry.json")
        artifacts.atomic_json(regpath, registry)
        env = dict(os.environ)
        env.update(self.config.worker_env)
        logpath = os.path.join(wdir, "worker.log")
        with open(logpath, "ab") as logfh:
            proc = subprocess.Popen(
                [sys.executable, "-m", WORKER_PACKAGE, "serve", regpath],
                stdout=logfh, stderr=subprocess.STDOUT, env=env,
            )
        w = _Worker(name=name, port=port, pid=proc.pid, proc=proc)
        self._append({"event": "worker", "name": name, "port": port,
                      "pid": proc.pid})
        _g_worker_up.set(1, worker=name)
        _g_streak.set(0, worker=name)
        log.info("worker %s: pid %d on port %d", name, proc.pid, port)
        return w

    def _wait_ready(self, w: _Worker) -> None:
        bo = Backoff(base_s=0.05, factor=1.5, jitter=0.2, cap_s=1.0,
                     deadline_s=self.config.spawn_timeout_s)
        for delay in bo.delays(key=w.name):
            if self._stop.is_set():
                return   # stop() tears the fleet down: no spare is awaited
            status, _body, _hdrs = self._req(w, "GET", "/livez")
            if status == 200:
                return
            if w.proc is not None and w.proc.poll() is not None:
                raise RuntimeError(
                    f"worker {w.name} exited rc={w.proc.returncode} "
                    f"before answering /livez (see "
                    f"{self.root}/workers/{w.name}/worker.log)")
            time.sleep(delay)
        raise RuntimeError(
            f"worker {w.name} did not answer /livez within "
            f"{self.config.spawn_timeout_s:.0f}s")

    def _req(self, w: _Worker, method: str, path: str,
             payload: Dict | None = None, timeout: float | None = None):
        """One HTTP exchange with a worker: (status, parsed-JSON-or-
        None, headers). Network/refused errors read as status 0."""
        body = (json.dumps(payload).encode() if payload is not None
                else None)
        req = urllib.request.Request(
            f"{w.url}{path}", data=body, method=method,
            headers={"Content-Type": "application/json"} if body else {},
        )
        try:
            with urllib.request.urlopen(
                    req, timeout=timeout or self.config.probe_timeout_s
            ) as resp:
                raw = resp.read()
                status, headers = resp.status, dict(resp.headers)
        except urllib.error.HTTPError as exc:
            raw, status, headers = exc.read(), exc.code, dict(exc.headers)
        except (urllib.error.URLError, OSError, TimeoutError):
            return 0, None, {}
        try:
            return status, json.loads(raw), headers
        except (ValueError, UnicodeDecodeError):
            return status, None, headers

    # -- placement ---------------------------------------------------------

    def _footprint(self, name: str) -> Dict:
        """The tenant's placement footprint — priced cost card first,
        declared share second, flagged default last (never a guess)."""
        spec = self._specs[name]
        card_path = os.path.join(spec["outdir"], "cost_card.json")
        try:
            with open(card_path) as fh:
                card = json.load(fh)
        except (OSError, ValueError):
            card = None
        if card and card.get("priced"):
            return {"tenant": name, "source": "priced",
                    "gb": card["peak_bytes"] / 2**30,
                    "predicted_wall_s": card.get("predicted_wall_s", 0.0)}
        if spec.get("hbm_share_gb") is not None:
            return {"tenant": name, "source": "declared",
                    "gb": float(spec["hbm_share_gb"]),
                    "predicted_wall_s": 0.0}
        return {"tenant": name, "source": "unpriced",
                "gb": self.config.default_footprint_gb,
                "predicted_wall_s": 0.0}

    def _place(self, tenants: List[str], affinity: Dict[str, str],
               exclude: set | None = None) -> Dict[str, str]:
        """Bin-pack ``tenants`` onto the live workers: first-fit
        decreasing by footprint onto the least-loaded fitting worker
        (ties broken by ledger affinity). ``exclude`` removes a dead
        worker from candidacy. Returns tenant -> worker name."""
        exclude = exclude or set()
        with self._lock:
            cands = [w.name for w in self._workers.values()
                     if w.up and w.name not in exclude]
            load = {n: 0.0 for n in cands}
            for t, wname in self._assign.items():
                if wname in load:
                    load[wname] += self._footprint(t)["gb"]
        if not cands:
            raise RuntimeError("no live workers to place tenants on")
        cap = self.config.hbm_budget_gb
        feet = sorted((self._footprint(t) for t in tenants),
                      key=lambda f: (-f["gb"], -f["predicted_wall_s"]))
        out: Dict[str, str] = {}
        for foot in feet:
            t = foot["tenant"]
            fitting = [n for n in cands
                       if cap is None or load[n] + foot["gb"] <= cap]
            if not fitting:
                # oversubscribed fleet: degrade to least-loaded rather
                # than refuse serving — ledgered so the operator sees it
                fitting = cands
                log.warning(
                    "tenant %s (%.2f GiB, %s) exceeds every worker's "
                    "%.2f GiB budget; placing least-loaded", t,
                    foot["gb"], foot["source"], cap)
            pref = affinity.get(t)
            fitting.sort(key=lambda n: (load[n], n != pref, n))
            out[t] = fitting[0]
            load[fitting[0]] += foot["gb"]
            self._append({"event": "placed", "tenant": t,
                          "worker": out[t], **foot})
        return out

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "FleetSupervisor":
        """Crash-only startup: sweep tmps, replay the ledger, fence
        stale pids, spawn the fleet, place + adopt every tenant, start
        the health loop."""
        artifacts.sweep_orphan_tmps(self.root)
        affinity = self._replay_ledger()
        with self._lock:
            for i in range(self.config.workers):
                w = self._spawn_worker(f"w{i}")
                self._workers[w.name] = w
        for w in self.workers():
            self._wait_ready(w)
        placement = self._place(list(self._specs), affinity)
        for tenant, wname in placement.items():
            self._adopt(tenant, wname)
        self._health_thread = threading.Thread(
            target=self._health_loop, name="fleet-health", daemon=True)
        self._health_thread.start()
        log.info("fleet up: %d worker(s), %d tenant(s)",
                 len(self.workers()), len(self._specs))
        return self

    def _adopt(self, tenant: str, wname: str) -> None:
        """POST /adopt ``tenant`` on worker ``wname`` and commit the
        assignment to the ledger + table. Raises on refusal (fsck 409,
        bad spec 400) — an un-adoptable tenant must be loud."""
        with self._lock:
            w = self._workers[wname]
        status, body, _ = self._req(
            w, "POST", "/adopt", payload={"spec": self._specs[tenant]},
            timeout=self.config.drain_timeout_s)
        if status != 200:
            raise RuntimeError(
                f"worker {wname} refused tenant {tenant!r}: "
                f"{status} {body}")
        with self._lock:
            self._assign[tenant] = wname
            self._migrating.discard(tenant)
            counts: Dict[str, int] = {}
            for n in self._assign.values():
                counts[n] = counts.get(n, 0) + 1
            for w_ in self._workers.values():
                _g_tenants.set(counts.get(w_.name, 0), worker=w_.name)
        self._append({"event": "assign", "tenant": tenant,
                      "worker": wname})

    def migrate(self, tenant: str, dst: str | None = None,
                trigger: str = "rebalance") -> Dict:
        """THE primitive: move one tenant. ``rebalance`` drains it
        gracefully on the source first; ``failure`` skips the drain (the
        source is dead and fenced) and lets the adopting worker's fsck
        startup check prove the outdir safe. During the window the
        router answers that tenant 503 + Retry-After."""
        with self._lock:
            if tenant not in self._specs:
                raise KeyError(tenant)
            src = self._assign.get(tenant)
            self._migrating.add(tenant)
            src_w = self._workers.get(src) if src else None
            cands = [w.name for w in self._workers.values()
                     if w.up and w.name != src]
        try:
            if dst is None:
                if not cands:
                    raise RuntimeError(
                        f"no live worker to receive tenant {tenant!r}")
                placed = self._place([tenant], {}, exclude={src} if src
                                     else set())
                dst = placed[tenant]
            if trigger != "failure" and src_w is not None and src_w.up:
                status, body, _ = self._req(
                    w=src_w, method="POST",
                    path=(f"/drain/{tenant}?timeout_s="
                          f"{self.config.drain_timeout_s}"),
                    timeout=self.config.drain_timeout_s + 5.0)
                if status not in (200, 404):
                    # 404: the worker already lost it (crash between
                    # ledger write and adopt) — recovery continues
                    raise RuntimeError(
                        f"drain of {tenant!r} on {src} failed: "
                        f"{status} {body}")
            self._adopt(tenant, dst)
        except Exception:
            with self._lock:
                self._migrating.discard(tenant)
            raise
        _c_migrations.inc(trigger=trigger)
        self._append({"event": "migrate", "tenant": tenant,
                      "src": src, "dst": dst, "trigger": trigger})
        log.info("migrated tenant %s: %s -> %s (%s)", tenant, src, dst,
                 trigger)
        return {"tenant": tenant, "src": src, "dst": dst,
                "trigger": trigger}

    # -- failure detection -------------------------------------------------

    def _health_loop(self) -> None:
        while not self._stop.wait(self.config.health_interval_s):
            for w in self.workers():
                if self._stop.is_set():
                    return
                if not w.up:
                    continue
                exited = w.proc is not None and w.proc.poll() is not None
                status, _b, _h = ((0, None, {}) if exited
                                  else self._req(w, "GET", "/livez"))
                if status == 200:
                    w.streak = 0
                    _g_streak.set(0, worker=w.name)
                    continue
                w.streak += 1
                _g_streak.set(w.streak, worker=w.name)
                log.warning("worker %s: /livez miss %d/%d%s", w.name,
                            w.streak, self.config.dead_after,
                            " (process exited)" if exited else "")
                if exited or w.streak >= self.config.dead_after:
                    try:
                        self._on_worker_dead(w)
                    except Exception:  # noqa: BLE001 — the loop survives
                        log.exception("recovery from dead worker %s "
                                      "failed; will retry", w.name)
                else:
                    # explicit backoff between misses: don't hammer a
                    # worker that is slow, not dead
                    time.sleep(self._probe_backoff.delay_s(
                        w.streak, key=w.name))

    def _on_worker_dead(self, w: _Worker) -> None:
        """Declare ``w`` dead: fence it (SIGKILL — a wedged process
        must not keep writing after its tenants move), resume its
        tenants on survivors, respawn a fresh spare under the same
        name."""
        log.error("worker %s declared dead (pid %d)", w.name, w.pid)
        w.up = False
        _g_worker_up.set(0, worker=w.name)
        self._append({"event": "dead", "worker": w.name, "pid": w.pid})
        if w.proc is not None:
            try:
                w.proc.kill()
                w.proc.wait(timeout=10)
            except (OSError, subprocess.TimeoutExpired):
                pass
        else:
            self._fence_pid(w.pid)
        with self._lock:
            orphans = [t for t, n in self._assign.items() if n == w.name]
        for tenant in orphans:
            self.migrate(tenant, trigger="failure")
        with self._lock:
            if self._stop.is_set():
                return
            nw = self._spawn_worker(w.name)
            self._workers[w.name] = nw
        self._wait_ready(nw)

    # -- readers (router + CLI) -------------------------------------------

    def owner(self, tenant: str) -> Optional[_Worker]:
        """The tenant's current worker, or None while it migrates (the
        router answers 503 + Retry-After on None)."""
        with self._lock:
            if tenant in self._migrating:
                return None
            wname = self._assign.get(tenant)
            if wname is None:
                return None
            w = self._workers.get(wname)
            return w if w is not None and w.up else None

    def workers(self) -> List[_Worker]:
        with self._lock:
            return list(self._workers.values())

    def tenant_names(self) -> List[str]:
        return list(self._specs)

    def status(self) -> Dict:
        with self._lock:
            return {
                "root": self.root,
                "workers": [
                    {"name": w.name, "port": w.port, "pid": w.pid,
                     "up": w.up, "streak": w.streak,
                     "tenants": sorted(t for t, n in self._assign.items()
                                       if n == w.name)}
                    for w in self._workers.values()
                ],
                "assignments": dict(self._assign),
                "migrating": sorted(self._migrating),
            }

    def wait_until_settled(self, timeout_s: float = 600.0) -> bool:
        """Block until every tenant's file list is manifest-settled
        fleet-wide (backfill mode); False on timeout."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self._stop.is_set():
                return False
            if all(set(spec.get("files", ()))
                   <= settled_files(spec["outdir"])
                   for spec in self._specs.values()):
                return True
            time.sleep(0.2)
        return False

    def stop(self) -> None:
        """Graceful fleet teardown: SIGTERM every worker (their own
        drain contract flushes manifests), bounded waits, SIGKILL
        stragglers."""
        self._stop.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=10)
        for w in self.workers():
            if w.proc is None or w.proc.poll() is not None:
                continue
            try:
                w.proc.terminate()
            except OSError:
                continue
        for w in self.workers():
            if w.proc is None:
                continue
            try:
                w.proc.wait(timeout=self.config.drain_timeout_s)
            except subprocess.TimeoutExpired:
                log.warning("worker %s ignored SIGTERM; killing", w.name)
                w.proc.kill()
                try:
                    w.proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    pass
            _g_worker_up.set(0, worker=w.name)

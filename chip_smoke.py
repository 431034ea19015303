#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from ``das4whales_tpu_torch/csrc`` with
``nvcc`` (sm_90a), then runs five phases, one summary line each, and
exits non-zero at the first failed check:

1. ``device``   the card's name and power limit (``nvidia-smi``), torch and
                CUDA versions; no CUDA device -> exit 1, nothing else runs;
2. ``build``    the ``nvcc`` build of ``csrc/fused_picks.cu`` and its seconds;
3. ``kernels``  the fused pick kernel against its plain PyTorch version on
                the card, at the main path's shapes (1024 rows x 12000
                samples, ``pack`` K=64 and ``topk`` K=256) and on edge rows;
                all five outputs must be bitwise equal; times, bound;
4. ``detect``   ``MatchedFilterDetector.detect_picks`` on the canonical OOI
                block, 22050 channels x 12000 samples at 200 Hz, raw int32
                counts, the ``fin`` bank, injected calls: one warm-up, three
                timed runs, per-stage walls from CUDA events, launches and
                syncs; every injected call must be picked on its nearest
                channel within 1 s of its arrival;
5. ``cpu_vs_card`` the port on the card against the port on the CPU at
                512 x 12000 (thresholds to rtol 1e-5, picks equal up to
                rounding knife edges), at the defaults and with the K0
                escalation and the capacity overflow forced.

Then it prints the kernel table as one JSON line, the ``nvidia-smi`` line,
and last ``{"ok": true, "device": {...}}``. It imports no JAX and nothing
of the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

#: published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and float32
#: (non-tensor-core) operations/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

CANONICAL = (22050, 12000)
SEED = 2026


def fail(msg: str) -> None:
    print(f"FAIL {msg}", flush=True)
    sys.exit(1)


def say(line: str) -> None:
    print(line, flush=True)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("device: torch.cuda.is_available() is False; this script runs on a CUDA card only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"device: nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    say(f"device: {smi_line} | torch {torch.__version__} | CUDA {torch.version.cuda} "
        f"| {torch.cuda.device_count()} device(s)")
    return smi_line


def phase_build():
    from das4whales_tpu_torch.utils import build

    path, seconds, report = build.build("fused_picks")
    ptxas = " ".join(l.strip() for l in report.splitlines() if "registers" in l or "smem" in l)
    say(f"build: csrc/fused_picks.cu -> {path.name} in {seconds:.2f} s "
        f"(nvcc sm_90a; {ptxas or 'no ptxas report'})")


def _cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _edge_rows(T: int, rng) -> tuple:
    """Rows that exercise the kernel's corner cases, as (re, im, thr)."""
    rows = []
    # plateaus: quantised values repeat in runs of equal samples
    q = np.round(np.convolve(rng.standard_normal(T + 8), np.ones(8) / 8, "same")[:T] * 3) / 3
    rows.append((q, np.zeros(T), 0.3))
    # saturated: a low threshold admits far more than K candidates
    rows.append((rng.standard_normal(T), rng.standard_normal(T), 0.05))
    # tied heights: one identical triangular peak every 20 samples
    tri = np.tile(np.concatenate([np.arange(10), np.arange(10, 0, -1)]) / 10.0, T // 20 + 1)[:T]
    rows.append((tri, np.zeros(T), 0.5))
    # all zero with a +inf threshold: no candidate, nothing selected
    rows.append((np.zeros(T), np.zeros(T), np.inf))
    # a long plateau in the middle and plateaus touching both edges
    p = 0.1 * np.abs(rng.standard_normal(T))
    p[: 50] = 5.0
    p[-50:] = 5.0
    p[T // 3 : T // 3 + 3000] = 4.0
    rows.append((p, np.zeros(T), 1.0))
    re = np.stack([r[0] for r in rows]).astype(np.float32)
    im = np.stack([r[1] for r in rows]).astype(np.float32)
    thr = np.asarray([r[2] for r in rows], np.float32)
    return re, im, thr


def _compare(a, b) -> float:
    """Bitwise equality of the five outputs; returns the max abs error
    over the finite float entries (0.0 when bitwise equal)."""
    import torch

    names = ("positions", "heights", "prominences", "selected", "saturated")
    err = 0.0
    for name, x, y in zip(names, a, b):
        if x.shape != y.shape or x.dtype != y.dtype:
            fail(f"kernels: {name} shape/dtype {tuple(x.shape)} {x.dtype} != {tuple(y.shape)} {y.dtype}")
        if x.dtype.is_floating_point:
            same = torch.equal(x.isnan(), y.isnan()) and torch.equal(
                torch.nan_to_num(x, nan=0.0), torch.nan_to_num(y, nan=0.0))
            fin = torch.isfinite(x) & torch.isfinite(y)
            if fin.any():
                err = max(err, float((x[fin] - y[fin]).abs().max()))
        else:
            same = torch.equal(x, y)
        if not same:
            bad = int((x != y).sum())
            fail(f"kernels: {name} differs from the plain version in {bad} entries")
    return err


def phase_kernels():
    import torch

    from das4whales_tpu_torch.ops import fused_picks, spectral

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    rows, T = 1024, CANONICAL[1]
    # correlogram-like rows: white noise through the Hilbert transform,
    # thresholds spread so that some rows saturate K=64 and some do not
    corr = torch.as_tensor(rng.standard_normal((rows, T)).astype(np.float32), device=dev)
    X = spectral.analytic_signal(corr)
    thr = torch.as_tensor(np.linspace(2.0, 4.5, rows).astype(np.float32), device=dev)
    out = {}
    err = 0.0
    for method, K in (("pack", 64), ("topk", 256)):
        k_out = fused_picks.picks_cuda(X, thr, K, method)
        p_out = fused_picks.picks_plain(X, thr, K, method)
        torch.cuda.synchronize()
        err = max(err, _compare(k_out, p_out))
        n_sel = int(k_out.selected.sum())
        n_sat = int(k_out.saturated.sum())
        if n_sel == 0:
            fail(f"kernels: {method} selected nothing; the comparison proves nothing")
        ms = _cuda_ms(lambda: fused_picks.picks_cuda(X, thr, K, method), 20)
        plain_ms = _cuda_ms(lambda: fused_picks.picks_plain(X, thr, K, method), 3)
        bytes_ = rows * T * 8 + rows * 4 + rows * K * 13 + rows
        bound_ms = max(bytes_ / HBM_BYTES_PER_S, rows * T * 4 / F32_OPS_PER_S) * 1e3
        out[method] = dict(K=K, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           n_sel=n_sel, n_sat=n_sat)
    # edge rows at T and at a length that is no multiple of nb = 128
    for TT in (T, T - 37):
        re, im, ethr = _edge_rows(TT, rng)
        Xe = torch.complex(torch.as_tensor(re, device=dev), torch.as_tensor(im, device=dev))
        te = torch.as_tensor(ethr, device=dev)
        for method, K in (("pack", 64), ("topk", 256)):
            err = max(err, _compare(fused_picks.picks_cuda(Xe, te, K, method),
                                    fused_picks.picks_plain(Xe, te, K, method)))
    torch.cuda.synchronize()
    pk, tk = out["pack"], out["topk"]
    say(f"kernels: fused_picks == plain, bitwise on all five outputs (max_abs_err {err}); "
        f"1024x{T} pack K=64: {pk['ms']:.4f} ms (bound {pk['bound_ms']:.4f} ms, plain "
        f"{pk['plain_ms']:.3f} ms, {pk['n_sel']} selected, {pk['n_sat']} rows saturated); "
        f"topk K=256: {tk['ms']:.4f} ms (bound {tk['bound_ms']:.4f} ms, plain "
        f"{tk['plain_ms']:.3f} ms, {tk['n_sel']} selected); edge rows at T={T} and {T - 37} equal")
    return out, err


def _scene(nx: int, ns: int, n_calls: int, seed: int):
    from das4whales_tpu_torch.io.synth import SyntheticCall, SyntheticScene

    rng = np.random.default_rng(seed)
    span = nx * 2.042
    # alternate the fin HF and LF notes, spread over the record and the cable
    notes = ({"fmin": 17.8, "fmax": 28.8, "duration": 0.68},
             {"fmin": 14.7, "fmax": 21.8, "duration": 0.78})
    calls = [
        SyntheticCall(t0=float(5.0 + k * (ns / 200.0 - 12.0) / max(1, n_calls - 1)),
                      x0_m=float(rng.uniform(0.1, 0.9) * span), amplitude=1.0,
                      **notes[k % 2])
        for k in range(n_calls)
    ]
    return SyntheticScene(nx=nx, ns=ns, noise_rms=0.05, calls=calls, seed=seed)


def _check_calls(scene, picks: dict) -> list:
    """Each injected call must be picked (by any template) on its nearest
    channel within 1 s of its arrival there; returns the misses."""
    from das4whales_tpu_torch.io.synth import call_onsets

    misses = []
    for call in scene.calls:
        ch = int(round(call.x0_m / scene.dx))
        onset = call_onsets(scene, call)[ch]
        hit = any(
            bool(np.any((p[0] == ch) & (np.abs(p[1] - onset) <= scene.fs)))
            for p in picks.values()
        )
        if not hit:
            misses.append((ch, int(onset)))
    return misses


class StageTimer:
    """Records a CUDA event at each stage boundary of one detection run."""

    def __init__(self):
        import torch

        self.torch = torch
        self.marks = []
        self.start = torch.cuda.Event(enable_timing=True)
        self.start.record()

    def __call__(self, name: str) -> None:
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((name, ev))

    def walls(self) -> dict:
        out, prev = {}, self.start
        for name, ev in self.marks:
            out[name] = out.get(name, 0.0) + prev.elapsed_time(ev)
            prev = ev
        return out


def phase_detect():
    import torch

    from das4whales_tpu_torch.io.synth import synthesize_scene, to_raw_counts
    from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector
    from das4whales_tpu_torch.ops import fused_picks

    nx, ns = CANONICAL
    t0 = time.perf_counter()
    scene = _scene(nx, ns, n_calls=6, seed=SEED)
    raw = to_raw_counts(synthesize_scene(scene), scene.metadata)
    t_scene = time.perf_counter() - t0
    t0 = time.perf_counter()
    det = MatchedFilterDetector(scene.metadata, [0, nx, 1], (nx, ns), wire="raw",
                                templates="fin")
    t_design = time.perf_counter() - t0
    if det._route() != "tiled":
        fail(f"detect: the auto route resolved to {det._route()!r}, expected 'tiled'")
    n_tiles = -(-nx // det.effective_channel_tile)
    t0 = time.perf_counter()
    x = torch.as_tensor(raw).to("cuda")
    torch.cuda.synchronize()
    t_h2d = time.perf_counter() - t0

    det.detect_picks(x)                      # warm-up: cuFFT plans, kernel load
    torch.cuda.synchronize()
    fused_picks.launches = 0                 # the main path's runs start here
    det.syncs = det.dispatches = det.escalations = 0
    walls, stages, per_run = [], [], []
    res = None
    for _ in range(3):
        before = (fused_picks.launches, det.syncs, det.dispatches)
        timer = StageTimer()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = det.detect_picks(x, stage_hook=timer)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        stages.append(timer.walls())
        per_run.append((fused_picks.launches - before[0], det.syncs - before[1],
                        det.dispatches - before[2]))
    launches = fused_picks.launches
    for k, (n_launch, n_sync, n_disp) in enumerate(per_run):
        if n_launch < n_tiles * n_disp:
            fail(f"detect: run {k} launched the pick kernel {n_launch} times in "
                 f"{n_disp} attempts, expected >= {n_tiles} each")
        # one packed fetch per attempt (+1 full transfer on capacity overflow)
        if n_sync not in (n_disp, n_disp + 1):
            fail(f"detect: run {k} made {n_sync} device->host copies for {n_disp} attempts")
    for name, p in res.picks.items():
        if p.ndim != 2 or p.shape[0] != 2:
            fail(f"detect: template {name} returned picks of shape {p.shape}")
        if not (np.all((p[0] >= 0) & (p[0] < nx)) and np.all((p[1] >= 0) & (p[1] < ns))):
            fail(f"detect: template {name} has picks outside the block")
    for name, t in res.thresholds.items():
        if not np.isfinite(t) or t <= 0:
            fail(f"detect: template {name} threshold {t}")
    misses = _check_calls(scene, res.picks)
    if misses:
        fail(f"detect: injected calls not picked on their nearest channel within 1 s: {misses}")
    med = {k: statistics.median(s[k] for s in stages) for k in stages[0]}
    say(f"detect: {nx}x{ns} raw int32, fin bank, route tiled ({n_tiles} tiles of "
        f"{det.effective_channel_tile}); median wall {statistics.median(walls) * 1e3:.1f} ms "
        f"(runs {', '.join(f'{w * 1e3:.1f}' for w in walls)} ms); stage walls (median, "
        f"CUDA events) {json.dumps({k: round(v, 3) for k, v in med.items()})} ms; "
        f"picks {json.dumps({k: int(v.shape[1]) for k, v in res.picks.items()})}; "
        f"thresholds {json.dumps({k: round(v, 6) for k, v in res.thresholds.items()})}; "
        f"escalations {det.escalations} in 3 runs; per run (kernel launches, syncs, "
        f"attempts) {[r for r in per_run]}; all {len(scene.calls)} injected calls picked; "
        f"set-up: scene {t_scene:.1f} s, design {t_design:.1f} s, H2D {t_h2d * 1e3:.1f} ms; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    try:
        _profile_detect(det, x, statistics.median(walls))
    except Exception as exc:  # noqa: BLE001 — the breakdown is optional; report, go on
        say(f"profile: not measured ({type(exc).__name__}: {exc})")
    return launches


def _profile_detect(det, x, wall_s: float) -> None:
    """One more detection run under ``torch.profiler`` (outside the counted
    runs): device time by kernel family, and the device's busy share of
    the unprofiled median wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        det.detect_picks(x)
        torch.cuda.synchronize()
    fams = {"fused_picks": 0.0, "cuFFT": 0.0, "other": 0.0}
    per_kernel = []
    n_kernels = 0
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA") and ev.key and not ev.key.startswith("cuda"):
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0.0)
            if us <= 0:
                continue
            n_kernels += ev.count
            name = ev.key.lower()
            fam = ("fused_picks" if "fused_picks" in name
                   else "cuFFT" if "fft" in name else "other")
            fams[fam] += us / 1e3
            per_kernel.append((us / 1e3, ev.count, ev.key[:70]))
    busy = sum(fams.values())
    top = sorted(per_kernel, reverse=True)[:8]
    if busy == 0.0:
        say("profile: not measured (the profiler recorded no device time)")
        return
    say(f"profile: one detect_picks under torch.profiler: device time by kernel family "
        f"{json.dumps({k: round(v, 3) for k, v in fams.items()})} ms over {n_kernels} "
        f"kernel launches; busy {busy:.3f} ms = {100 * busy / (wall_s * 1e3):.1f} % of the "
        f"unprofiled median wall {wall_s * 1e3:.1f} ms (idle share "
        f"{100 * max(0.0, 1 - busy / (wall_s * 1e3)):.1f} %); top kernels (ms, launches): "
        + "; ".join(f"{ms:.3f} x{n} {name}" for ms, n, name in top))


def phase_cpu_vs_card():
    """The port on the card against the port on the CPU, twice: at the
    defaults, and with K0 = 1 and a 256-pick capacity, which forces the
    K0 -> K = 256 ``topk`` escalation and the capacity-overflow route."""
    from das4whales_tpu_torch.io.synth import synthesize_scene, to_raw_counts
    from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector
    from das4whales_tpu_torch.utils.parity import envelopes, unexplained_differences

    nx, ns = 512, CANONICAL[1]
    scene = _scene(nx, ns, n_calls=1, seed=SEED + 1)
    raw = to_raw_counts(synthesize_scene(scene), scene.metadata)
    notes = []
    for label, k0, cap in (("defaults", None, 1 << 18), ("K0=1, capacity 256", 1, 256)):
        res, dets = {}, {}
        for dev in ("cuda", "cpu"):
            det = MatchedFilterDetector(scene.metadata, [0, nx, 1], (nx, ns), wire="raw",
                                        pick_pack_cap=cap, device=dev)
            if k0 is not None:
                det.pick_k0 = k0
            res[dev], dets[dev] = det.detect_picks(raw), det
        if k0 is not None and (dets["cuda"].escalations != 1
                               or dets["cuda"].syncs != dets["cuda"].dispatches + 1):
            fail(f"cpu_vs_card: {label}: expected one escalation and one overflow "
                 f"transfer, got {dets['cuda'].escalations} escalations, "
                 f"{dets['cuda'].syncs} syncs for {dets['cuda'].dispatches} attempts")
        env = envelopes(dets["cpu"], raw)
        n_diff = 0
        for i, name in enumerate(res["cpu"].picks):
            tg, tc = res["cuda"].thresholds[name], res["cpu"].thresholds[name]
            if not np.isclose(tg, tc, rtol=1e-5, atol=0):
                fail(f"cpu_vs_card: {label}: template {name} threshold card {tg} vs cpu {tc}")
            a, b = res["cuda"].picks[name], res["cpu"].picks[name]
            bad = unexplained_differences(a, b, env[i], tc)
            if bad:
                fail(f"cpu_vs_card: {label}: template {name}: picks differ beyond "
                     f"rounding at {bad[:10]}")
            n_diff += len({tuple(p) for p in a.T.tolist()} ^ {tuple(p) for p in b.T.tolist()})
        if _check_calls(scene, res["cuda"].picks):
            fail(f"cpu_vs_card: {label}: the injected call was not picked on the card")
        notes.append(f"{label}: picks "
                     f"{json.dumps({k: int(v.shape[1]) for k, v in res['cuda'].picks.items()})}"
                     f" on the card, {n_diff} differing")
    say(f"cpu_vs_card: {nx}x{ns}, thresholds within rtol 1e-5, differing picks all on "
        f"rounding knife edges; {'; '.join(notes)}")


def main() -> int:
    import torch

    smi_line = phase_device()
    phase_build()
    kern, err = phase_kernels()
    launches = phase_detect()
    phase_cpu_vs_card()
    pk = kern["pack"]
    print(json.dumps({"kernels": [{
        "name": "fused_picks",
        "route": "cuda",
        "source": "das4whales_tpu_torch/csrc/fused_picks.cu",
        "replaces": "das4whales_tpu/ops/pallas_picks.py:71",
        "launches": launches,
        "max_abs_err": err,
        "ms": pk["ms"],
        "plain_ms": pk["plain_ms"],
        "bound_ms": pk["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }]}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

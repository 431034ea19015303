#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's two CUDA kernels from ``das4whales_tpu_torch/csrc`` with
``nvcc`` (sm_90a), then runs eight phases, one summary line each (two for
the detector runs, with their profiles), and exits non-zero at the first
failed check; no phase's failure is caught:

1. ``device``   the card's name and power limit (``nvidia-smi``), torch and
                CUDA versions; no CUDA device -> exit 1, nothing else runs;
2. ``build``    the ``nvcc`` builds of ``csrc/fused_picks.cu`` and
                ``csrc/fused_stft.cu``, started together, each one's seconds
                and ptxas line, then both kernels' registers and spills per
                instantiation (the main launches' must not spill);
3. ``kernels``  the fused pick kernel against its plain PyTorch version on
                the card, at the main path's shapes (1024 rows x 12000
                samples, ``pack`` K=64 and ``topk`` K=256) and on edge rows
                (plateaus, ties, K and K+1 candidates, every other sample a
                maximum, T = 40); all five outputs must be bitwise equal;
                a call's time by CUDA events (the kernel table's ``ms``),
                the device time a launch (profiler, ``device_ms``) and the
                host time a call, the bound, the CTAs an SM (at least the
                design's), and the phase split of the kernel's phase-timed
                instantiation;
4. ``detect``   ``MatchedFilterDetector.detect_picks`` on the canonical OOI
                block, 22050 channels x 12000 samples at 200 Hz, raw int32
                counts, the ``fin`` bank, injected calls: one warm-up, three
                timed runs, per-stage walls from CUDA events, launches and
                syncs; every injected call must be picked on its nearest
                channel within 1 s of its arrival;
5. ``cpu_vs_card`` the port on the card against the port on the CPU at
                512 x 12000 (thresholds to rtol 1e-5, picks equal up to
                rounding knife edges), at the defaults and with the K0
                escalation and the capacity overflow forced;
6. ``stft_kernel`` the fused STFT-power kernel against its plain PyTorch
                version and against ``torch.stft`` power on the card, at the
                main path's launch (4096 x 12000, nfft 160, hop 8, centred)
                and on edge cases (1570 channels, T = 11963, center=False,
                window="ones", hop = nfft, T < nfft, spans past 48 KB at
                nfft 1024 and 2048, odd nfft 65, nfft 162 with no
                self-paired bin); each within 5e-6 * max|reference|; times
                (a call, and the device time a launch), the bound and the
                dense and folded DFT forms;
7. ``spectro``  ``SpectroEvalAdapter(MatchedFilterDetector.from_design(...),
                SpectroCorrDetector(meta))`` on the ``detect`` phase's scene,
                conditioned on the host: one warm-up, three timed runs,
                stage walls from CUDA events, 12 STFT-kernel launches and the
                device->host reads per run, a profile; every injected call
                must be picked (by either hat kernel) on its nearest channel
                within 1 s of its arrival;
8. ``spectro_cpu_vs_card`` the spectro family on the card against the CPU
                at 512 x 12000, both bandpass modes: correlograms within
                1e-4 * max|cpu|, picks equal up to rounding knife edges.

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
SMS = 132

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


KERNELS = ("fused_picks", "fused_stft")

#: the STFT kernel's instantiation at the main launch (1501 frames: R = 4
#: frames a thread; the span fits in shared memory)
STFT_MAIN_INSTANCE = (4, True)

#: the pick kernel's instantiation at the main launch (pack, untimed), and
#: the CTAs an SM its design holds for each method at the main launch's
#: row length (pack K=64, topk K=256)
PICKS_MAIN_INSTANCE = (0, False)
PICKS_CTAS_PER_SM = {"pack": 4, "topk": 3}


def ptxas_instances(report: str, kernel: str) -> dict:
    """``{template arguments: (registers, spill store bytes, spill load
    bytes)}`` for each instantiation of ``kernel`` in an ``nvcc -Xptxas -v``
    report; int arguments read as ints, bool ones as bools."""
    import re

    out, cur, spill = {}, None, (0, 0)
    for line in report.splitlines():
        m = re.search(rf"Compiling entry function '\S*{kernel}I((?:L[ib]\d+E)+)E", line)
        if m:
            cur = tuple(v == "1" if t == "b" else int(v)
                        for t, v in re.findall(r"L([ib])(\d+)E", m.group(1)))
            spill = (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur is not None:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            out[cur] = (int(m.group(1)),) + spill
            cur = None
    return out


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from das4whales_tpu_torch.utils import build

    # one nvcc per source, all started together
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        built = list(pool.map(build.build, KERNELS))
    for name, (path, seconds, report) in zip(KERNELS, built):
        ptxas = " ".join(l.strip() for l in report.splitlines() if "registers" in l or "smem" in l)
        fma = "-fmad=false" if "-fmad=false" in build.nvcc_flags(name) else "FMA contraction on"
        say(f"build: csrc/{name}.cu -> {path.name} in {seconds:.2f} s "
            f"(nvcc sm_90a, {fma}; {ptxas or 'no ptxas report'})")
    inst = ptxas_instances(built[KERNELS.index("fused_stft")][2], "fused_stft_kernel")
    if STFT_MAIN_INSTANCE not in inst:
        fail(f"build: no ptxas report for fused_stft_kernel<{STFT_MAIN_INSTANCE}>: {inst}")
    say("build: fused_stft ptxas per instantiation (R, span): " + "; ".join(
        f"R={r} {'span' if sp else 'gather'}: {regs} registers, {st} B spill stores, "
        f"{ld} B spill loads" for (r, sp), (regs, st, ld) in sorted(inst.items())))
    if any(inst[STFT_MAIN_INSTANCE][1:]):
        fail(f"build: fused_stft_kernel<{STFT_MAIN_INSTANCE}>, the main launch's, spills")
    inst = ptxas_instances(built[KERNELS.index("fused_picks")][2], "fused_picks_kernel")
    if PICKS_MAIN_INSTANCE not in inst:
        fail(f"build: no ptxas report for fused_picks_kernel<{PICKS_MAIN_INSTANCE}>: {inst}")
    say("build: fused_picks ptxas per instantiation (template arguments): " + "; ".join(
        f"{args}: {regs} registers, {st} B spill stores, {ld} B spill loads"
        for args, (regs, st, ld) in sorted(inst.items())))
    if any(inst[PICKS_MAIN_INSTANCE][1:]):
        fail(f"build: fused_picks_kernel<{PICKS_MAIN_INSTANCE}>, the main launch's, spills")


def _kernel_modules() -> dict:
    from das4whales_tpu_torch.ops import fused_picks, fused_stft

    return {"fused_picks": fused_picks, "fused_stft": fused_stft}


def zero_launches() -> None:
    """Set every kernel's launch count to 0 (just before a main path)."""
    for mod in _kernel_modules().values():
        mod.launches = 0


def read_launches() -> dict:
    return {name: mod.launches for name, mod in _kernel_modules().items()}


def _cuda_ms(fn, reps: int) -> float:
    """Time of one call of ``fn``: CUDA events around ``reps`` calls in a
    row, after one warm-up. Where the host takes longer over a call than
    the card, this is the host's time a call."""
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


def _host_us(fn, reps: int) -> float:
    """Host time of one call of ``fn`` in microseconds, over ``reps`` calls
    that are not waited for (the launch queue holds them)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def _device_ms(fn, reps: int, kernel: str) -> float:
    """Device time of one launch of ``kernel``: its CUPTI records under
    ``torch.profiler`` over ``reps`` calls of ``fn``, after one warm-up.
    Unlike CUDA events around the calls (:func:`_cuda_ms`), it leaves out
    the host's time a call where that is the longer. The mean is over the
    launches the profiler kept: it has dropped the last few records of a
    long run (17 of 20 launches of 4.6 ms each, once)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us, n = 0.0, 0
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA") and kernel in ev.key:
            t = getattr(ev, "self_device_time_total", None)
            us += t if t is not None else getattr(ev, "self_cuda_time_total", 0.0)
            n += ev.count
    if not 0 < n <= reps or us <= 0:
        fail(f"kernels: the profiler recorded {n} launches of {kernel} ({us} us) in {reps} calls")
    return us / n / 1e3


def _spikes(T: int, n: int, rng) -> np.ndarray:
    """A row of zeros with n isolated spikes of random heights in [1, 2):
    exactly n local maxima above a threshold of 0.5."""
    row = np.zeros(T)
    row[np.linspace(1, T - 2, n).round().astype(int)] = 1.0 + rng.random(n)
    return row


def _count_rows(T: int, K: int, rng) -> tuple:
    """(re, im, thr) of two rows, with exactly K and K + 1 candidates."""
    re = np.stack([_spikes(T, K, rng), _spikes(T, K + 1, rng)]).astype(np.float32)
    return re, np.zeros_like(re), np.full(2, 0.5, np.float32)


def _alternating_row(T: int, rng) -> tuple:
    """(re, im, thr) of one row whose every odd sample but the last is a
    local maximum above the threshold: T // 2 - 1 + T % 2 candidates, the
    most a row can hold."""
    re = np.zeros((1, T))
    re[0, 1::2] = 1.0 + rng.random(len(re[0, 1::2]))
    re = re.astype(np.float32)
    return re, np.zeros_like(re), np.full(1, 0.5, np.float32)


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


def _phase_split(stamps, kernel_ms: float) -> dict:
    """Per-phase figures of one phase-timed launch from its stamps
    ``[rows, 2, phases + 1]`` (``%globaltimer`` ns, ``clock64`` cycles)."""
    from das4whales_tpu_torch.ops import fused_picks

    st = stamps.cpu().numpy().astype(np.float64)
    ns, clk = np.diff(st[:, 0], axis=1), np.diff(st[:, 1], axis=1)
    cta_ns = st[:, 0, -1] - st[:, 0, 0]
    span_ns = st[:, 0, -1].max() - st[:, 0, 0].min()
    return dict(
        phases={name: (float(ns[:, k].mean()), float(ns[:, k].max()), float(clk[:, k].mean()))
                for k, name in enumerate(fused_picks.PHASES)},
        cta_mean_ns=float(cta_ns.mean()), cta_max_ns=float(cta_ns.max()),
        span_ns=float(span_ns), kernel_ms=kernel_ms,
        ghz=float(clk.sum() / ns.sum()),
        # CTAs resident on an SM, averaged over the launch's span
        resident=float(cta_ns.sum() / span_ns / SMS))


def _say_phase_split(label: str, sp: dict) -> None:
    say(f"kernels: fused_picks phase split, {label} (thread 0 of each CTA; mean / max ns "
        f"from %globaltimer, mean cycles from clock64): " + "; ".join(
            f"{name} {m:.0f} / {mx:.0f} ns ({cyc:.0f} cyc)"
            for name, (m, mx, cyc) in sp["phases"].items())
        + f"; CTA {sp['cta_mean_ns']:.0f} mean / {sp['cta_max_ns']:.0f} max ns; first start "
        f"to last end {sp['span_ns'] / 1e3:.2f} us against {sp['kernel_ms'] * 1e3:.2f} us a "
        f"launch of the timed instantiation (profiler, 20 launches); SM clock "
        f"{sp['ghz']:.3f} GHz (cycles / ns); {sp['resident']:.2f} CTAs resident an SM on "
        f"average")


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
        device_ms = _device_ms(lambda: fused_picks.picks_cuda(X, thr, K, method), 20,
                               "fused_picks")
        host_us = _host_us(lambda: fused_picks.picks_cuda(X, thr, K, method), 200)
        plain_ms = _cuda_ms(lambda: fused_picks.picks_plain(X, thr, K, method), 3)
        bytes_ = rows * T * 8 + rows * 4 + rows * K * 13 + rows
        bound_ms = max(bytes_ / HBM_BYTES_PER_S, rows * T * 4 / F32_OPS_PER_S) * 1e3
        # the phase-timed instantiation: the same outputs, then its split
        t_out, _ = fused_picks.picks_cuda_timed(X, thr, K, method)
        torch.cuda.synchronize()
        err = max(err, _compare(t_out, p_out))
        timed_ms = _device_ms(lambda: fused_picks.picks_cuda_timed(X, thr, K, method), 20,
                              "fused_picks")
        _, stamps = fused_picks.picks_cuda_timed(X, thr, K, method)
        split = _phase_split(stamps, timed_ms)
        ctas = fused_picks.ctas_per_sm(T, K, method)
        if ctas < PICKS_CTAS_PER_SM[method]:
            fail(f"kernels: fused_picks {method} K={K} fits {ctas} CTAs an SM, its design "
                 f"{PICKS_CTAS_PER_SM[method]}")
        out[method] = dict(K=K, ms=ms, device_ms=device_ms, host_us=host_us, plain_ms=plain_ms,
                           bound_ms=bound_ms,
                           n_sel=n_sel, n_sat=n_sat, timed_ms=timed_ms, split=split, ctas=ctas)
    # edge rows at T and at a length that is no multiple of nb = 128
    cases = []
    for TT in (T, T - 37):
        cases.append((f"edge rows T={TT}", _edge_rows(TT, rng), (("pack", 64), ("topk", 256))))
    for method, K in (("pack", 64), ("topk", 256)):
        cases.append((f"K and K+1 candidates ({method} K={K})", _count_rows(T, K, rng),
                      ((method, K),)))
    cases.append(("every other sample a maximum", _alternating_row(T, rng),
                  (("pack", 64), ("topk", 256))))
    short = (rng.standard_normal((3, 40)).astype(np.float32),
             rng.standard_normal((3, 40)).astype(np.float32),
             np.asarray([0.5, 1.0, 1.5], np.float32))
    cases.append(("T=40, 3 rows", short, (("pack", 64), ("topk", 256))))
    for label, (re, im, ethr), runs in cases:
        Xe = torch.complex(torch.as_tensor(re, device=dev), torch.as_tensor(im, device=dev))
        te = torch.as_tensor(ethr, device=dev)
        for method, K in runs:
            k_out = fused_picks.picks_cuda(Xe, te, K, method)
            p_out = fused_picks.picks_plain(Xe, te, K, method)
            torch.cuda.synchronize()
            err = max(err, _compare(k_out, p_out))
            if label.startswith("K and K+1"):
                want = [False, True]
                if k_out.saturated.tolist() != want:
                    fail(f"kernels: {label}: saturated {k_out.saturated.tolist()}, want {want}")
    torch.cuda.synchronize()
    pk, tk = out["pack"], out["topk"]
    say(f"kernels: fused_picks == plain, bitwise on all five outputs (max_abs_err {err}); "
        f"a call (CUDA events, 20 in a row) / device time a launch (profiler) / host time a "
        f"call: 1024x{T} pack K=64: {pk['ms']:.4f} / {pk['device_ms']:.4f} ms / "
        f"{pk['host_us']:.1f} us (bound {pk['bound_ms']:.4f} ms, plain {pk['plain_ms']:.3f} "
        f"ms, {pk['n_sel']} selected, {pk['n_sat']} rows saturated, {pk['ctas']} CTAs an "
        f"SM); topk K=256: {tk['ms']:.4f} / {tk['device_ms']:.4f} ms / {tk['host_us']:.1f} us "
        f"(bound {tk['bound_ms']:.4f} ms, plain {tk['plain_ms']:.3f} ms, {tk['n_sel']} "
        f"selected, {tk['ctas']} CTAs an SM); the timed instantiation "
        f"{pk['timed_ms']:.4f} / {tk['timed_ms']:.4f} ms of device time, equal too; cases "
        + ", ".join(c[0] for c in cases) + " equal")
    for method in ("pack", "topk"):
        _say_phase_split(f"1024x{T} {method} K={out[method]['K']}", out[method]["split"])
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
    zero_launches()                          # the main path's runs start here
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
    launches = read_launches()
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
    _profile("detect_picks", lambda: det.detect_picks(x), statistics.median(walls),
             "fused_picks")
    return launches["fused_picks"], scene, raw, det.design


def _profile(label: str, run, wall_s: float, kernel: str) -> dict:
    """One more run under ``torch.profiler`` (outside the counted runs):
    device time by kernel family (``kernel``, cuFFT, other), and the
    device's busy share of the unprofiled median wall. A profiler that
    fails or records no device time fails the phase."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    fams = {kernel: 0.0, "cuFFT": 0.0, "other": 0.0}
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
            fam = (kernel if kernel in name
                   else "cuFFT" if "fft" in name else "other")
            fams[fam] += us / 1e3
            per_kernel.append((us / 1e3, ev.count, ev.key[:70]))
    busy = sum(fams.values())
    top = sorted(per_kernel, reverse=True)[:8]
    if busy == 0.0:
        fail(f"profile: the profiler recorded no device time for {label}")
    say(f"profile: one {label} under torch.profiler: device time by kernel family "
        f"{json.dumps({k: round(v, 3) for k, v in fams.items()})} ms over {n_kernels} "
        f"kernel launches; busy {busy:.3f} ms = {100 * busy / (wall_s * 1e3):.1f} % of the "
        f"unprofiled median wall {wall_s * 1e3:.1f} ms (idle share "
        f"{100 * max(0.0, 1 - busy / (wall_s * 1e3)):.1f} %); top kernels (ms, launches): "
        + "; ".join(f"{ms:.3f} x{n} {name}" for ms, n, name in top))
    return fams


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

#: STFT of the spectro family at its defaults: 0.8 s window at 200 Hz,
#: 95 % overlap
NFFT, HOP = 160, 8
STFT_REL_TOL = 5e-6


def _stft_bounds(C: int, T: int, nfft: int, hop: int, center: bool = True) -> dict:
    """The least time the card could take for one launch: the input read
    once and the power written once over HBM, and the operations the
    function needs over the float32 rate of the CUDA cores — per frame
    the window (nfft), a real FFT (2.5 nfft log2 nfft, half the usual
    5 N log2 N of a complex one) and the power (3 per bin). ``dft_*`` is
    the earlier design's dense DFT contraction (2 operations per
    multiply-add, re and im) and ``fold_*`` the kernel's folded DFT (per
    frame (re, im) multiply-adds over taps n <= N/2 and k <= N/4 — every
    k < F for odd N — the folds u, v, the E/O pairing and the power):
    side figures, not the bound."""
    F = nfft // 2 + 1
    nf = 1 + (T // hop if center else (T - nfft) // hop)
    bytes_ = 4 * C * T + 4 * nfft * 2 * F + 4 * C * F * nf
    ops = C * nf * (nfft + 2.5 * nfft * float(np.log2(nfft)) + 3 * F)
    dft_ops = 2 * C * nf * nfft * 2 * F
    even = nfft % 2 == 0
    taps, K2 = nfft // 2 + 1, nfft // 4 + 1 if even else F
    fold_ops = C * nf * (4 * taps * K2 + 2 * (taps - 1) + (4 if even else 2) * K2 + 3 * F)
    b_ms, o_ms = bytes_ / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return {"bytes": bytes_, "ops": ops, "bytes_ms": b_ms, "ops_ms": o_ms,
            "dft_ops": dft_ops, "dft_ops_ms": dft_ops / F32_OPS_PER_S * 1e3,
            "fold_ops": fold_ops, "fold_ops_ms": fold_ops / F32_OPS_PER_S * 1e3,
            "bound_ms": max(b_ms, o_ms), "bound_by": "operations" if o_ms >= b_ms else "bytes"}


def _torch_stft_power(x, nfft: int, hop: int, window: str = "hann", center: bool = True):
    """The library yardstick: ``torch.stft`` (zero padding, as the port
    centres) and its power. Timed here only; the port never calls it."""
    import torch

    win = (torch.hann_window(nfft, periodic=True, device=x.device) if window == "hann"
           else torch.ones(nfft, device=x.device))
    s = torch.stft(x, nfft, hop, window=win, center=center, pad_mode="constant",
                   return_complex=True)
    return s.real * s.real + s.imag * s.imag


def phase_stft_kernel():
    import torch

    from das4whales_tpu_torch.ops import fused_stft

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 2)
    cases = [  # (label, C, T, nfft, hop, center, window)
        ("main 4096x12000", 4096, CANONICAL[1], NFFT, HOP, True, "hann"),
        ("ragged 1570 channels", 1570, CANONICAL[1], NFFT, HOP, True, "hann"),
        ("T=11963", 256, 11963, NFFT, HOP, True, "hann"),
        ("center=False", 256, CANONICAL[1], NFFT, HOP, False, "hann"),
        ('window="ones"', 256, CANONICAL[1], NFFT, HOP, True, "ones"),
        ("hop=nfft", 256, CANONICAL[1], NFFT, NFFT, True, "hann"),
        ("T<nfft", 3, 100, NFFT, HOP, True, "hann"),
        # spans past 48 KB of shared memory: the fold straight from x
        ("nfft=1024 hop=384", 64, CANONICAL[1], 1024, 384, True, "hann"),
        ("nfft=hop=2048", 64, CANONICAL[1], 2048, 2048, True, "hann"),
        # odd nfft (the first fold only), and nfft = 2 mod 4 (no self-paired bin)
        ("nfft=65", 256, CANONICAL[1], 65, HOP, True, "hann"),
        ("nfft=162", 256, CANONICAL[1], 162, HOP, True, "hann"),
    ]
    err, notes, main = 0.0, [], None
    for label, C, T, nfft, hop, center, window in cases:
        x = torch.as_tensor(rng.standard_normal((C, T)).astype(np.float32), device=dev)
        kw = dict(window=window, center=center)
        k = fused_stft.stft_power_cuda(x, nfft, hop, **kw)
        p = fused_stft.stft_power_plain(x, nfft, hop, **kw)
        lib = _torch_stft_power(x, nfft, hop, window, center)
        torch.cuda.synchronize()
        # centred odd nfft: torch.stft pads nfft // 2 a side and frames
        # 1 + (T - 1) // hop, one less than the port's 1 + T // hop where hop
        # divides T (that last frame reads zeros past the padding); it is
        # compared on the frames it has
        k_lib = k[..., :lib.shape[-1]] if nfft % 2 and center else k
        if k.shape != p.shape or k_lib.shape != lib.shape:
            fail(f"stft_kernel: {label}: shapes kernel {tuple(k.shape)}, plain "
                 f"{tuple(p.shape)}, torch.stft {tuple(lib.shape)}")
        if not bool(torch.isfinite(k).all()):
            fail(f"stft_kernel: {label}: non-finite kernel output")
        e_plain = float((k - p).abs().max())
        e_lib = float((k_lib - lib).abs().max())
        s_plain, s_lib = float(p.abs().max()), float(lib.abs().max())
        if e_plain > STFT_REL_TOL * s_plain or e_lib > STFT_REL_TOL * s_lib:
            fail(f"stft_kernel: {label}: max|kernel - plain| {e_plain:.3e} (limit "
                 f"{STFT_REL_TOL * s_plain:.3e}), max|kernel - torch.stft| {e_lib:.3e} "
                 f"(limit {STFT_REL_TOL * s_lib:.3e})")
        err = max(err, e_plain)
        notes.append(f"{label}: {e_plain / s_plain:.2e} / {e_lib / s_lib:.2e}")
        if main is None:
            main = dict(
                ms=_cuda_ms(lambda: fused_stft.stft_power_cuda(x, nfft, hop, **kw), 20),
                device_ms=_device_ms(lambda: fused_stft.stft_power_cuda(x, nfft, hop, **kw),
                                     20, "fused_stft"),
                plain_ms=_cuda_ms(lambda: fused_stft.stft_power_plain(x, nfft, hop, **kw), 5),
                library_ms=_cuda_ms(lambda: _torch_stft_power(x, nfft, hop, window, center), 10),
                **_stft_bounds(C, T, nfft, hop, center))
        del x, k, k_lib, p, lib
    m = main
    say(f"stft_kernel: fused_stft within {STFT_REL_TOL} * max of its plain version and of "
        f"torch.stft power on all {len(cases)} cases (relative max error plain / torch.stft: "
        f"{'; '.join(notes)}); max_abs_err vs plain {err:.3e}; 4096x12000 nfft {NFFT} hop {HOP}: "
        f"kernel {m['ms']:.4f} ms a call (device time {m['device_ms']:.4f} ms), plain {m['plain_ms']:.3f} ms, torch.stft + power "
        f"{m['library_ms']:.3f} ms; bound {m['bound_ms']:.4f} ms by {m['bound_by']} (bytes "
        f"{m['bytes']:.3e} -> {m['bytes_ms']:.4f} ms at 3.35 TB/s; FFT-form operations "
        f"{m['ops']:.3e} -> {m['ops_ms']:.4f} ms at 67 TFLOP/s f32); kernel at "
        f"{100 * m['bound_ms'] / m['ms']:.1f} % of its bound; the folded DFT this kernel "
        f"computes {m['fold_ops']:.3e} operations -> {m['fold_ops_ms']:.4f} ms (kernel at "
        f"{100 * m['fold_ops_ms'] / m['ms']:.1f} % of that floor); the dense DFT form of "
        f"the earlier design {m['dft_ops']:.3e} -> {m['dft_ops_ms']:.4f} ms")
    return main, err


def _condition_on_host(raw: np.ndarray, scale: float) -> np.ndarray:
    """The conditioned wire as the host readers produce it: demean each
    channel, scale to strain, float32 (row blocks keep the float64
    temporaries small)."""
    out = np.empty(raw.shape, np.float32)
    for lo in range(0, raw.shape[0], 2048):
        r = raw[lo : lo + 2048].astype(np.float64)
        out[lo : lo + 2048] = (r - r.mean(axis=1, keepdims=True)) * scale
    return out


def phase_spectro(scene, raw, design):
    import torch

    from das4whales_tpu_torch.eval import SpectroEvalAdapter
    from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector
    from das4whales_tpu_torch.models.spectro import FUSED_DEFAULT_BATCH, SpectroCorrDetector

    nx, ns = raw.shape
    meta = scene.metadata
    t0 = time.perf_counter()
    cond = _condition_on_host(raw, meta.scale_factor)
    t_cond = time.perf_counter() - t0
    # the detect phase's design spares a second f-k design
    prefilter = MatchedFilterDetector.from_design(design, meta, wire="conditioned")
    det = SpectroCorrDetector(meta)
    adapter = SpectroEvalAdapter(prefilter, det)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    x = torch.as_tensor(cond).to("cuda")
    del cond
    n_chunks = -(-nx // FUSED_DEFAULT_BATCH)
    want_launches = len(det.kernels) * n_chunks

    adapter(x)                                # warm-up: cuFFT plans, kernel load
    torch.cuda.synchronize()
    zero_launches()                           # the main path's runs start here
    det.syncs = det.escalations = 0
    walls, stages, per_run = [], [], []
    res = None
    for _ in range(3):
        before = (read_launches()["fused_stft"], det.syncs, det.escalations)
        timer = StageTimer()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = adapter(x, stage_hook=timer)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        stages.append(timer.walls())
        per_run.append((read_launches()["fused_stft"] - before[0], det.syncs - before[1],
                        det.escalations - before[2]))
    launches = read_launches()
    nK = len(det.kernels)
    for k, (n_launch, n_sync, n_esc) in enumerate(per_run):
        if n_launch != want_launches:
            fail(f"spectro: run {k} launched the STFT kernel {n_launch} times, expected "
                 f"{want_launches} ({nK} hat kernels x {n_chunks} chunks)")
        # a saturation check and a packed fetch per hat kernel, one more read
        # per escalation, at most one more per kernel on a capacity overflow
        if not 2 * nK + n_esc <= n_sync <= 3 * nK + n_esc:
            fail(f"spectro: run {k} made {n_sync} device->host reads with {n_esc} escalations")
    for name, p in res.picks.items():
        if p.ndim != 2 or p.shape[0] != 2:
            fail(f"spectro: kernel {name} returned picks of shape {p.shape}")
        if not (np.all((p[0] >= 0) & (p[0] < nx)) and np.all((p[1] >= 0) & (p[1] <= ns))):
            fail(f"spectro: kernel {name} has picks outside the block")
    misses = _check_calls(scene, res.picks)
    if misses:
        fail(f"spectro: injected calls not picked on their nearest channel within 1 s: {misses}")
    med = {k: statistics.median(s[k] for s in stages) for k in stages[0]}
    wall = statistics.median(walls)
    say(f"spectro: {nx}x{ns} conditioned float32, SpectroEvalAdapter(from_design prefilter, "
        f"SpectroCorrDetector defaults: window {det.win_size} s, overlap {det.overlap_pct}, "
        f"threshold {det.threshold}, kernels {'/'.join(det.kernels)}, engine "
        f"{det.stft_engine!r}, {n_chunks} chunks of {FUSED_DEFAULT_BATCH}); median wall "
        f"{wall * 1e3:.1f} ms (runs {', '.join(f'{w * 1e3:.1f}' for w in walls)} ms); stage "
        f"walls (median, CUDA events, summed over chunks) "
        f"{json.dumps({k: round(v, 3) for k, v in med.items()})} ms; per run (fused_stft "
        f"launches, device->host reads, escalations) {per_run}; picks "
        f"{json.dumps({k: int(v.shape[1]) for k, v in res.picks.items()})}; all "
        f"{len(scene.calls)} injected calls picked; host conditioning {t_cond:.1f} s; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    _profile("SpectroEvalAdapter call", lambda: adapter(x), wall, "fused_stft")
    return launches["fused_stft"]


def phase_spectro_cpu_vs_card():
    """The spectro family on the card against the CPU, in both bandpass
    modes, on one design: correlograms within 1e-4 * max|cpu|, frame-unit
    picks equal up to rounding knife edges of the correlogram."""
    import torch

    from das4whales_tpu_torch.eval import SpectroEvalAdapter
    from das4whales_tpu_torch.io.synth import synthesize_scene, to_raw_counts
    from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector
    from das4whales_tpu_torch.models.spectro import SpectroCorrDetector
    from das4whales_tpu_torch.utils.parity import unexplained_differences
    from das4whales_tpu_torch.workflows.spectrodetect import campaign_detector

    nx, ns = 512, CANONICAL[1]
    scene = _scene(nx, ns, n_calls=1, seed=SEED + 1)
    cond = _condition_on_host(to_raw_counts(synthesize_scene(scene), scene.metadata),
                              scene.metadata.scale_factor)
    notes, worst = [], 0.0
    for fused in (True, False):
        card = campaign_detector(scene.metadata, [0, nx, 1], (nx, ns), fused_bandpass=fused)
        cpu = SpectroEvalAdapter(
            MatchedFilterDetector.from_design(card.prefilter.design, scene.metadata,
                                              fused_bandpass=fused, device="cpu"),
            SpectroCorrDetector(scene.metadata, device="cpu"))
        out = {}
        for dev, ad in (("cuda", card), ("cpu", cpu)):
            out[dev] = ad.det(ad.prefilter.filter_block(cond))
        n_diff = 0
        for name, c_cpu in out["cpu"][0].items():
            c_cpu = c_cpu.numpy()
            c_card = out["cuda"][0][name].cpu().numpy()
            err = float(np.abs(c_card - c_cpu).max())
            scale = float(np.abs(c_cpu).max())
            worst = max(worst, err / scale)
            if not err <= 1e-4 * scale:
                fail(f"spectro_cpu_vs_card: fused_bandpass={fused}: kernel {name} correlograms "
                     f"differ by {err:.3e} > 1e-4 * {scale:.3e}")
            a, b = out["cuda"][1][name], out["cpu"][1][name]
            bad = unexplained_differences(a, b, c_cpu, card.det.threshold)
            if bad:
                fail(f"spectro_cpu_vs_card: fused_bandpass={fused}: kernel {name}: picks "
                     f"differ beyond rounding at {bad[:10]}")
            n_diff += len({tuple(p) for p in a.T.tolist()} ^ {tuple(p) for p in b.T.tolist()})
        if out["cuda"][2] != out["cpu"][2]:
            fail(f"spectro_cpu_vs_card: spectro_fs {out['cuda'][2]} vs {out['cpu'][2]}")
        res = card(cond)                     # the adapter itself, in sample units
        if _check_calls(scene, res.picks):
            fail(f"spectro_cpu_vs_card: fused_bandpass={fused}: the injected call was not "
                 f"picked on the card")
        notes.append(f"fused_bandpass={fused}: picks "
                     f"{json.dumps({k: int(v.shape[1]) for k, v in out['cuda'][1].items()})} on "
                     f"the card, {n_diff} differing")
        torch.cuda.synchronize()
    say(f"spectro_cpu_vs_card: {nx}x{ns}, correlograms within 1e-4 * max|cpu| (measured max "
        f"relative error {worst:.3e}), differing picks all on rounding knife edges; "
        f"{'; '.join(notes)}")


def main() -> int:
    import torch

    smi_line = phase_device()
    phase_build()
    kern, err = phase_kernels()
    launches, scene, raw, design = phase_detect()
    phase_cpu_vs_card()
    stft, stft_err = phase_stft_kernel()
    stft_launches = phase_spectro(scene, raw, design)
    del scene, raw, design
    phase_spectro_cpu_vs_card()
    pk = kern["pack"]
    print(json.dumps({"kernels": [{
        "name": "fused_picks",
        "route": "cuda",
        "source": "das4whales_tpu_torch/csrc/fused_picks.cu",
        "replaces": "das4whales_tpu/ops/pallas_picks.py:71",
        "launches": launches,
        "max_abs_err": err,
        "ms": pk["ms"],
        "device_ms": pk["device_ms"],
        "plain_ms": pk["plain_ms"],
        "bound_ms": pk["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "fused_stft",
        "route": "cuda",
        "source": "das4whales_tpu_torch/csrc/fused_stft.cu",
        "replaces": "das4whales_tpu/ops/pallas_stft.py:71",
        "launches": stft_launches,
        "max_abs_err": stft_err,
        "ms": stft["ms"],
        "device_ms": stft["device_ms"],
        "plain_ms": stft["plain_ms"],
        "bound_ms": stft["bound_ms"],
        "bound_by": stft["bound_by"],
        "library_ms": stft["library_ms"],
    }]}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

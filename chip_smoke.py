#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's two CUDA kernels from ``das4whales_tpu_torch/csrc`` with
``nvcc`` (sm_90a) and the native ingest reader from
``das4whales_tpu_torch/native/ingest.cpp`` with ``g++``, then runs twelve
phases, one summary line each (more for the detector runs, with their
profiles), and exits non-zero at the first failed check; no phase's
failure is caught:

1. ``device``   the card's name and power limit (``nvidia-smi``), torch and
                CUDA versions; no CUDA device -> exit 1, nothing else runs;
2. ``build``    the ``nvcc`` builds of ``csrc/fused_picks.cu`` and
                ``csrc/fused_stft.cu`` and the ``g++`` build of
                ``native/ingest.cpp``, started together, each one's seconds
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
                1e-4 * max|cpu|, picks equal up to rounding knife edges;
9. ``slab``     the batched ingest route at the campaign's defaults: five
                Silixa TDMS files (four 22050 x 12000, one 22050 x 11000,
                raw int32; the card's machine has no ``h5py``) written by
                the port, streamed by ``stream_batched_slabs`` (batch 4,
                pow2 buckets, the format reader, conditioned wire) into [4, 22050, 16384] slabs through
                pinned memory on a side stream, and detected by
                ``BatchedMatchedFilterDetector.dispatch_batch(...,
                with_health=True)`` in the batched and the serial mode (a
                warm-up pass, then a timed pass each); per file the picks
                must equal ``detect_picks`` on the same card (serial:
                bitwise; batched: thresholds within 1 ulp), every injected
                call be picked, the health show 0 non-finite, 0 clipped,
                rms within 1e-5 of float64 and no breach; one read per
                attempt, 44 pick launches a tile sweep (batched: per slab;
                serial: per file), peak device memory under 80 GB; in each
                mode the pick kernel against its plain version, all five
                outputs bitwise for ``pack`` K=64 and ``topk`` K=256, on
                the inputs the route gave its first and last launch of
                the first slab (batched: 4096 and 272 rows x 16384, the
                files' own thresholds), and its CTAs an SM at 16384
                samples (the design's, or as many as the shared memory
                holds); it prints
                the slab's detect wall, its stages (the health stage among
                them) and busy share, per-file read and conditioning
                seconds, the copy's ms, GB/s and bytes, the pass's wall
                against the sum of its parts, the batched pass again with
                the native reader, and the stream alone on the native
                engine, both wires (the host's read ceiling);
10. ``slab_cpu_vs_card`` the slab route on the card (batched mode) against
                the CPU (serial mode) at 512 channels, both wires, batch 2,
                a clip level, and a float32 file with 3 NaNs and 5 samples
                at the clip (on the raw wire it flushes a partial slab):
                thresholds within rtol 1e-5, picks equal up to knife
                edges, health counts equal, the float32 file alone
                breaching; ``stream_strain_blocks`` on the card against
                the host read, bit for bit; then ``BatchedSpectroDetector``
                on one slab against its adapter file by file on the card,
                its ``fused_stft`` launches counted (one a hat kernel and
                4096-channel chunk) and the kernel held against its plain
                version within 5e-6 * max on the facade's own launch
                (1024 x 16384);
11. ``campaign`` ``run_campaign_batched`` at its defaults (batch 4, pow2
                buckets, conditioned wire, the format reader, the mf
                family, health, dispatch depth 2) over the slab phase's
                five files, ``interrogator="silixa"``: every file ``done``
                at ``batched:4`` with no downshift event, 44 ``fused_picks``
                launches and one read an attempt, each file's saved picks
                bitwise the slab phase's batched picks, every injected call
                picked; then the same call again (resume) settles nothing
                and reads nothing, ``summarize_campaign`` counts 5 done and
                ``fsck_outdir`` finds nothing. It prints the pass a file,
                the bucket's design seconds, the picks-artifact and
                manifest write seconds, the peak device memory and the busy
                share of one slab of the campaign's facade (profiler);
12. ``campaign_cpu_vs_card`` both entries at 512 x 12000 on the card
                against ``device="cpu"`` (five int32 files, a corrupt and a
                NaN file; records equal file by file — status, rung,
                attempts — picks equal up to knife edges); a pinned
                ``FaultPlan``: an oom at ``batched:4`` that fits from
                ``batched:2`` (one downshift; serial mode: picks bitwise
                the fault-free run's), a corrupt file ``failed``, a NaN
                file ``quarantined``; a wedged dispatch under
                ``dispatch_deadline_s`` (``timeout`` for that file only);
                the spectro family on one slab (``fused_stft`` launches,
                picks equal to ``BatchedSpectroDetector``'s); and a design
                saved by the port and loaded again (bitwise the same
                picks).

Then it prints the kernel table as one JSON line, the ``nvidia-smi`` line,
and last ``{"ok": true, "device": {...}}``. It imports no JAX and nothing
of the JAX package. ``--only PHASE[,PHASE]`` runs the named phases after
``device`` and ``build``, for development; it prints no result line.
"""

from __future__ import annotations

import contextlib
import json
import os
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

#: an H100 SM's shared memory for resident CTAs, and what CUDA reserves of
#: it for each CTA (the occupancy calculator's sharedMemPerMultiprocessor
#: and reservedSharedMemPerBlock)
SM_SMEM_BYTES = 228 * 1024
CTA_RESERVED_SMEM = 1024


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

    from das4whales_tpu_torch.io import native
    from das4whales_tpu_torch.utils import build

    # one nvcc per source and the g++ of the native reader, all started together
    with ThreadPoolExecutor(len(KERNELS) + 1) as pool:
        ingest = pool.submit(native.build)
        built = list(pool.map(build.build, KERNELS))
        so = ingest.result()
    if not native.available():
        fail(f"build: the native ingest library {so.name} built but does not load")
    say(f"build: native/ingest.cpp -> build/native/{so.name} in {native.build_seconds:.2f} s "
        f"(g++ {' '.join(native.GXX_FLAGS)})")
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


def _compare(a, b, where: str = "kernels") -> float:
    """Bitwise equality of the five outputs; returns the max abs error
    over the finite float entries (0.0 when bitwise equal). ``where``
    names the phase in a failure."""
    import torch

    names = ("positions", "heights", "prominences", "selected", "saturated")
    err = 0.0
    for name, x, y in zip(names, a, b):
        if x.shape != y.shape or x.dtype != y.dtype:
            fail(f"{where}: {name} shape/dtype {tuple(x.shape)} {x.dtype} != {tuple(y.shape)} {y.dtype}")
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
            fail(f"{where}: {name} differs from the plain version in {bad} entries")
    return err


@contextlib.contextmanager
def _capture(mod, name: str):
    """Replace ``mod.name`` for the block by a function that forwards every
    call and keeps clones of the arguments of the first call and of the
    latest: yields ``{"n": calls, "first": (args, kw), "last": (args,
    kw)}`` (``"last"`` is the first where there was one call). The inputs
    a main path gives a kernel, held against the plain version after."""
    import torch

    orig = getattr(mod, name)
    got = {"n": 0}

    def clone(v):
        return v.clone() if isinstance(v, torch.Tensor) else v

    def spy(*args, **kw):
        rec = (tuple(clone(a) for a in args), {k: clone(v) for k, v in kw.items()})
        got["first" if got["n"] == 0 else "last"] = rec
        got["n"] += 1
        return orig(*args, **kw)

    setattr(mod, name, spy)
    try:
        yield got
    finally:
        setattr(mod, name, orig)
        if got["n"]:
            got.setdefault("last", got["first"])


def _picks_ctas_want(T: int, K: int, method: str) -> int:
    """CTAs of the pick kernel an SM must hold at rows of ``T`` samples:
    the design's (:data:`PICKS_CTAS_PER_SM`), or as many as an SM's shared
    memory holds where that is fewer (at the 16384-sample bucket the
    envelope alone takes 64 KiB a CTA, so 3 fit)."""
    from das4whales_tpu_torch.ops import fused_picks

    fit = SM_SMEM_BYTES // (fused_picks.smem_bytes(T, K, method) + CTA_RESERVED_SMEM)
    return min(PICKS_CTAS_PER_SM[method], fit)


def _picks_at_main_path(where: str, calls: dict, want_rows: dict) -> tuple:
    """The pick kernel against its plain version on the inputs a main path
    gave it (its first and last launch, from :func:`_capture`): all five
    outputs bitwise, for both methods (``pack`` K=64, ``topk`` K=256);
    and its CTAs an SM at that row length. ``want_rows`` maps ``first`` /
    ``last`` to the rows each launch must have. Returns ``(max_abs_err,
    notes)``."""
    import torch

    from das4whales_tpu_torch.ops import fused_picks

    err, notes = 0.0, []
    for which in ("first", "last"):
        (X, thr, *_), _ = calls[which]
        rows, T = X.shape
        if rows != want_rows[which]:
            fail(f"{where}: the {which} pick launch had {rows} rows, expected {want_rows[which]}")
        for method, K in (("pack", 64), ("topk", 256)):
            k_out = fused_picks.picks_cuda(X, thr, K, method)
            p_out = fused_picks.picks_plain(X, thr, K, method)
            torch.cuda.synchronize()
            err = max(err, _compare(k_out, p_out, where))
            n_sel, n_sat = int(k_out.selected.sum()), int(k_out.saturated.sum())
            if which == "first" and n_sel == 0:
                fail(f"{where}: {method} selected nothing at the first launch; the comparison "
                     "proves nothing")
            notes.append(f"{which} launch {rows}x{T} {method} K={K}: {n_sel} selected, "
                         f"{n_sat} rows saturated")
    T = calls["first"][0][0].shape[-1]
    for method, K in (("pack", 64), ("topk", 256)):
        ctas, want = fused_picks.ctas_per_sm(T, K, method), _picks_ctas_want(T, K, method)
        if ctas < want:
            fail(f"{where}: fused_picks {method} K={K} at T={T} fits {ctas} CTAs an SM, "
                 f"expected {want} ({fused_picks.smem_bytes(T, K, method)} bytes of shared "
                 f"memory a CTA)")
        notes.append(f"{method} K={K} at T={T}: {ctas} CTAs an SM (design "
                     f"{PICKS_CTAS_PER_SM[method]}, shared memory "
                     f"{fused_picks.smem_bytes(T, K, method)} bytes a CTA)")
    return err, notes


def _stft_at_main_path(where: str, calls: dict, want_shape: tuple) -> tuple:
    """The STFT kernel against its plain version on the inputs a main path
    gave it (its first and last launch, from :func:`_capture`), each
    within ``STFT_REL_TOL`` of the plain version's max. Returns
    ``(max_abs_err, relative max error, (nfft, hop))``."""
    import torch

    from das4whales_tpu_torch.ops import fused_stft

    err = rel = 0.0
    for which in ("first", "last"):
        (x, nfft, hop), kw = calls[which]
        if which == "first" and tuple(x.shape) != want_shape:
            fail(f"{where}: the {which} STFT launch took {tuple(x.shape)}, expected {want_shape}")
        k_pow = fused_stft.stft_power_cuda(x, nfft, hop, **kw)
        p_pow = fused_stft.stft_power_plain(x, nfft, hop, **kw)
        torch.cuda.synchronize()
        e, scale = float((k_pow - p_pow).abs().max()), float(p_pow.abs().max())
        if not (bool(torch.isfinite(k_pow).all()) and e <= STFT_REL_TOL * scale):
            fail(f"{where}: fused_stft at the {which} launch {tuple(x.shape)} nfft {nfft} hop "
                 f"{hop}: max|kernel - plain| {e:.3e} (limit {STFT_REL_TOL * scale:.3e})")
        err, rel = max(err, e), max(rel, e / scale)
    return err, rel, (calls["first"][0][1], calls["first"][0][2])


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


#: the slab phase's files: four canonical OOI blocks and a shorter one,
#: in one pow2 bucket of 16384 samples (22050 x 12000 and x 11000 raw int32)
SLAB_FILES = ((2026, 12000), (2028, 12000), (2029, 12000), (2030, 12000), (2031, 11000))
SLAB_BATCH = 4
SLAB_BUCKET = 16384
CARD_BYTES = 80e9


def _write_files(d, specs, nx, n_calls, float_file=None):
    """Silixa TDMS files of ``(seed, ns)`` scenes' raw int32 counts, through
    the port's writer (the card's machine has no ``h5py``, so no HDF5);
    returns ``(paths, scenes, seconds)``. ``float_file(raw)`` turns the
    last file's counts into a float32 block (written as float32)."""
    from datetime import datetime

    from das4whales_tpu_torch.io.synth import synthesize_scene, to_raw_counts
    from das4whales_tpu_torch.io.tdms import write_tdms

    t0 = time.perf_counter()
    paths, scenes = [], []
    for k, (seed, ns) in enumerate(specs):
        scene = _scene(nx, ns, n_calls=n_calls, seed=seed)
        raw = to_raw_counts(synthesize_scene(scene), scene.metadata)
        if float_file is not None and k == len(specs) - 1:
            raw = float_file(raw)
        props = {"SamplingFrequency[Hz]": float(scene.fs), "SpatialResolution[m]": float(scene.dx),
                 "FibreIndex": float(scene.n), "GaugeLength": float(scene.gauge_length),
                 "GPSTimeStamp": datetime(2021, 11, 4, 1, 59, 2 + k)}
        paths.append(write_tdms(str(d / f"file{k}_seed{seed}.tdms"), props, "Measurement",
                                {f"ch{i:05d}": raw[i] for i in range(nx)}))
        scenes.append(scene)
        del raw
    return paths, scenes, time.perf_counter() - t0


def _rms64(block: np.ndarray) -> float:
    """float64 rms of a host block, in row chunks."""
    acc = 0.0
    for lo in range(0, block.shape[0], 2048):
        r = block[lo : lo + 2048].astype(np.float64)
        acc += float(np.sum(r * r))
    return float(np.sqrt(acc / block.size))


def _within_ulp(a: float, b: float) -> bool:
    a, b = np.float32(a), np.float32(b)
    return bool(abs(a - b) <= np.spacing(max(abs(a), abs(b))))


def _slab_pass(stream, bd, with_refs=None):
    """One pass over the slab stream: dispatch + resolve each slab as it
    arrives. Returns per-slab records and the pass's wall. ``with_refs``
    (a detector) also computes each file's ``detect_picks`` reference and
    float64 rms, outside the pass's timing."""
    import torch

    from das4whales_tpu_torch.ops import fused_picks

    det = bd.det
    slabs, refs = [], []
    t0 = time.perf_counter()
    t_ref = 0.0
    t_prev = t0
    for slab in stream:
        t_got = time.perf_counter()
        before = (fused_picks.launches, det.syncs, det.dispatches, det.escalations)
        res = bd.dispatch_batch(slab.stack, n_real=slab.n_real, n_valid=slab.n_valid,
                                with_health=True).resolve()
        t_done = time.perf_counter()
        slabs.append(dict(
            res=res, n_valid=slab.n_valid, n_real=slab.n_real, index0=slab.index0,
            copies=slab.copies, wait_s=t_got - t_prev, detect_s=t_done - t_got,
            read_s=[b.read_s for b in slab.blocks], cond_s=[b.condition_s for b in slab.blocks],
            launches=fused_picks.launches - before[0], syncs=det.syncs - before[1],
            dispatches=det.dispatches - before[2], escalations=det.escalations - before[3]))
        if with_refs is not None:
            t1 = time.perf_counter()
            for j in range(slab.n_valid):
                r = with_refs.detect_picks(slab.stack[j], n_real=slab.n_real[j], with_health=True)
                refs.append((r, _rms64(np.asarray(slab.blocks[j].trace))))
            torch.cuda.synchronize()
            t_ref += time.perf_counter() - t1
        del slab
        t_prev = time.perf_counter()
    torch.cuda.synchronize()
    return slabs, refs, time.perf_counter() - t0 - t_ref


#: the slab phase's TDMS files, written once and shared with the campaign
#: phase (``slab_files``); removed at the end of the run
_SHARED: dict = {}


def slab_files() -> dict:
    """The five canonical TDMS files of the ``slab`` and ``campaign``
    phases, written on first use under ``build/``: ``{"dir", "paths",
    "scenes", "t_write", "picks"}``, where ``picks`` collects the slab
    phase's batched picks a file (trimmed to the file's samples)."""
    import tempfile
    from pathlib import Path

    if not _SHARED:
        root = Path(__file__).resolve().parent / "build"
        root.mkdir(exist_ok=True)
        d = Path(tempfile.mkdtemp(prefix="slab_files_", dir=root))
        _SHARED["dir"] = d
        paths, scenes, t_write = _write_files(d, SLAB_FILES, CANONICAL[0], n_calls=6)
        _SHARED.update(paths=paths, scenes=scenes, t_write=t_write, picks={})
    return _SHARED


def remove_slab_files() -> None:
    import shutil

    if _SHARED:
        shutil.rmtree(_SHARED["dir"], ignore_errors=True)
        _SHARED.clear()


def phase_slab():
    """The campaign's default batched route at full width: five TDMS
    files streamed into [4, 22050, 16384] slabs through pinned memory,
    detected by BatchedMatchedFilterDetector with the health stats, in
    the batched and the serial mode."""
    import torch

    from das4whales_tpu_torch.config import DataHealthConfig
    from das4whales_tpu_torch.io.stream import stream_batched_slabs
    from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector
    from das4whales_tpu_torch.ops import fused_picks
    from das4whales_tpu_torch.parallel.batch import BatchedMatchedFilterDetector, trim_picks

    t_phase = time.perf_counter()
    nx = CANONICAL[0]
    sel = [0, nx, 1]
    shared = slab_files()
    paths, scenes, t_write = shared["paths"], shared["scenes"], shared["t_write"]
    meta = scenes[0].metadata
    t0 = time.perf_counter()
    ref = MatchedFilterDetector(meta, sel, (nx, SLAB_BUCKET), templates="fin",
                                wire="conditioned")
    t_design = time.perf_counter() - t0
    tile = ref.effective_channel_tile
    n_tiles = -(-nx // tile)
    nT = ref.design.templates.shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def stream():
        return stream_batched_slabs(paths, sel, meta, batch=SLAB_BATCH, bucket="pow2",
                                    device="cuda")

    refs, out, launch_by_mode, kernel_err = None, {}, {}, 0.0
    for mode, serial in (("batched", False), ("serial", True)):
        det = MatchedFilterDetector.from_design(ref.design, meta, wire="conditioned")
        bd = BatchedMatchedFilterDetector(det, serial=serial)
        # warm-up pass: FFT plans, allocator pools; the references ride it
        _, r, _ = _slab_pass(stream(), bd, with_refs=ref if refs is None else None)
        refs = refs or r
        zero_launches()                          # the main path's timed pass starts here
        det.syncs = det.dispatches = det.escalations = 0
        slabs, _, wall = _slab_pass(stream(), bd)
        launch_by_mode[mode] = read_launches()["fused_picks"]
        # per-file checks against detect_picks on the same card
        files = [(s, j) for s in slabs for j in range(s["n_valid"])]
        if len(files) != len(SLAB_FILES) or [s["n_valid"] for s in slabs] != [4, 1]:
            fail(f"slab: {mode}: slabs of {[s['n_valid'] for s in slabs]} files, "
                 "expected a full slab of 4 and a partial slab of 1")
        health_cfg = DataHealthConfig()
        for k, (s, j) in enumerate(files):
            picks, thr, health = s["res"][j]
            rref, rms64 = refs[k]
            n_real = s["n_real"][j]
            a, b = trim_picks(picks, n_real), trim_picks(rref.picks, n_real)
            for name in b:
                if not np.array_equal(a[name], b[name]):
                    fail(f"slab: {mode}: file {k} template {name}: picks differ from "
                         f"detect_picks ({a[name].shape[1]} vs {b[name].shape[1]})")
                same = (thr[name] == rref.thresholds[name] if serial
                        else _within_ulp(thr[name], rref.thresholds[name]))
                if not same:
                    fail(f"slab: {mode}: file {k} template {name}: threshold "
                         f"{thr[name]!r} vs detect_picks {rref.thresholds[name]!r}")
            if serial and health != rref.health:
                fail(f"slab: {mode}: file {k}: health differs from detect_picks")
            if mode == "batched":
                shared["picks"][k] = a       # the campaign phase holds its picks to these
            misses = _check_calls(scenes[k], a)
            if misses:
                fail(f"slab: {mode}: file {k}: injected calls missed: {misses}")
            if health["nonfinite"] or health["clipped"]:
                fail(f"slab: {mode}: file {k}: health {health['nonfinite']} non-finite, "
                     f"{health['clipped']} clipped")
            if abs(health["rms"] - rms64) > 1e-5 * rms64:
                fail(f"slab: {mode}: file {k}: rms {health['rms']!r} vs float64 {rms64!r}")
            if health_cfg.breach(health) is not None:
                fail(f"slab: {mode}: file {k}: breach {health_cfg.breach(health)}")
        for s in slabs:
            want = n_tiles * s["dispatches"] * (s["n_valid"] if serial else 1)
            if s["syncs"] != s["dispatches"] or s["dispatches"] != 1 + s["escalations"]:
                fail(f"slab: {mode}: {s['syncs']} reads for {s['dispatches']} attempts "
                     f"({s['escalations']} escalations)")
            if s["launches"] != want:
                fail(f"slab: {mode}: {s['launches']} fused_picks launches in a slab of "
                     f"{s['n_valid']} files, expected {want}")
        # the first (full) slab again, already on the card: detect wall, stages
        first = next(stream())
        walls, stages = [], []
        for _ in range(3):
            timer = StageTimer()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bd.dispatch_batch(first.stack, n_real=first.n_real, n_valid=first.n_valid,
                              with_health=True, stage_hook=timer).resolve()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            stages.append(timer.walls())
        detect_wall = statistics.median(walls)
        n_first = first.n_valid
        med = {k: statistics.median(st[k] for st in stages) for k in stages[0]}
        fams = _profile(f"{mode} slab of {first.n_valid}", lambda: bd.dispatch_batch(
            first.stack, n_real=first.n_real, n_valid=first.n_valid,
            with_health=True).resolve(), detect_wall, "fused_picks")
        # the pick kernel on the inputs this mode gives it: the first
        # (a full tile) and the last (the ragged tile) launch of the
        # first slab, with the files' own thresholds, against its plain
        # version; these launches are not the main path's
        with _capture(fused_picks, "picks_cuda") as calls:
            bd.dispatch_batch(first.stack, n_real=first.n_real, n_valid=first.n_valid,
                              with_health=True).resolve()
        lanes = 1 if serial else n_first         # files a launch carries
        err, notes = _picks_at_main_path(f"slab: {mode}", calls, {
            "first": nT * lanes * tile, "last": nT * lanes * (nx - (n_tiles - 1) * tile)})
        kernel_err = max(kernel_err, err)
        say(f"slab: {mode}: fused_picks == plain, bitwise on all five outputs, on the "
            f"first slab's first and last launch ({calls['n']} launches in the "
            f"dispatch): {'; '.join(notes)}")
        del first, calls
        copies = [[(a.elapsed_time(b), n) for a, b, n in s["copies"]] for s in slabs]
        out[mode] = dict(slabs=slabs, wall=wall, detect_wall=detect_wall, stages=med,
                         copies=copies, busy=sum(fams.values()))
        h2d = [sum(ms for ms, _ in c) for c in copies]
        nbytes = [sum(n for _, n in c) for c in copies]
        read = [x for s in slabs for x in s["read_s"]]
        cond = [x for s in slabs for x in s["cond_s"]]
        detect = [s["detect_s"] for s in slabs]
        parts = sum(read) + sum(cond) + sum(h2d) / 1e3 + sum(detect)
        say(f"slab: {mode} (serial={serial}), {len(SLAB_FILES)} files in slabs of "
            f"{[s['n_valid'] for s in slabs]}, bucket {SLAB_BUCKET}, TDMS int32, conditioned "
            f"wire, format reader (engine='h5py'), with_health: slab detect wall (dispatch to resolve, slab on the "
            f"card, median of 3) {detect_wall * 1e3:.1f} ms (runs "
            f"{', '.join(f'{w * 1e3:.1f}' for w in walls)}) = "
            f"{detect_wall * 1e3 / n_first:.1f} ms a file; stage walls (median, CUDA "
            f"events) {json.dumps({k: round(v, 3) for k, v in med.items()})} ms, of which "
            f"health {med.get('health', 0.0):.3f} ms; device busy "
            f"{100 * out[mode]['busy'] / (detect_wall * 1e3):.1f} % of the detect wall "
            f"(profiler); per file host read s {[round(x, 3) for x in read]}, host "
            f"conditioning s {[round(x, 3) for x in cond]}; per slab H2D "
            f"{[round(x, 3) for x in h2d]} ms, "
            f"{[round(n / (ms * 1e6), 2) for n, ms in zip(nbytes, h2d)]} GB/s, bytes "
            f"{nbytes}; per slab detect (host clock, dispatch to resolve) "
            f"{[round(x * 1e3, 1) for x in detect]} ms, wait for the slab "
            f"{[round(s['wait_s'] * 1e3, 1) for s in slabs]} ms; timed pass (stream + "
            f"detect) {wall:.3f} s = {wall / len(SLAB_FILES):.3f} s a file against a sum of "
            f"parts (read + conditioning + H2D + detect) {parts:.3f} s: {parts - wall:.3f} s "
            f"hidden by overlap; per slab (fused_picks launches, reads, attempts, "
            f"escalations) {[(s['launches'], s['syncs'], s['dispatches'], s['escalations']) for s in slabs]}; "
            f"picks equal detect_picks on the card for every file "
            f"({'bitwise, thresholds equal' if serial else 'thresholds within 1 ulp'}), all "
            f"injected calls picked, health 0 non-finite, 0 clipped, rms within 1e-5 of "
            f"float64, no breach")
        del bd, det
    # the same batched pass with the native reader (engine="native": the
    # C++ fused read, demean and scale) in place of the format reader
    det = MatchedFilterDetector.from_design(ref.design, meta, wire="conditioned")
    bd = BatchedMatchedFilterDetector(det, serial=False)
    slabs, _, wall_native = _slab_pass(stream_batched_slabs(
        paths, sel, meta, batch=SLAB_BATCH, bucket="pow2", engine="native",
        device="cuda"), bd)
    files = [(s, j) for s in slabs for j in range(s["n_valid"])]
    for k, (s, j) in enumerate(files):
        misses = _check_calls(scenes[k], trim_picks(s["res"][j][0], s["n_real"][j]))
        if misses:
            fail(f"slab: native reader: file {k}: injected calls missed: {misses}")
    say(f"slab: batched, engine='native' (the C++ fused read, demean and scale): timed pass "
        f"{wall_native:.3f} s = {wall_native / len(files):.3f} s a file; host read (fused) "
        f"s {[round(x, 3) for s in slabs for x in s['read_s']]}; per slab detect "
        f"{[round(s['detect_s'] * 1e3, 1) for s in slabs]} ms, wait for the slab "
        f"{[round(s['wait_s'] * 1e3, 1) for s in slabs]} ms; all injected calls picked")
    del bd, det
    peak = torch.cuda.max_memory_allocated()
    if peak >= CARD_BYTES:
        fail(f"slab: peak device memory {peak / 1e9:.2f} GB, over the card's 80 GB")
    # the host's read ceiling: the stream alone on the native engine, the
    # raw wire (counts to the card) and the conditioned wire (the C++
    # reader's fused demean and scale)
    alone = {}
    for wire in ("raw", "conditioned"):
        t0 = time.perf_counter()
        n = 0
        for slab in stream_batched_slabs(paths, sel, meta, batch=SLAB_BATCH, bucket="pow2",
                                         wire=wire, engine="native", device="cuda"):
            n += slab.n_valid
            del slab
        torch.cuda.synchronize()
        alone[wire] = (time.perf_counter() - t0) / n
    say(f"slab: the host's read ceiling, the stream alone on the native engine (5 files "
        f"to the card): wire='raw' (int32 counts) {alone['raw']:.3f} s a file, "
        f"wire='conditioned' (the C++ fused read, demean and scale) "
        f"{alone['conditioned']:.3f} s a file; peak device memory over the phase "
        f"{peak / 2**30:.2f} GiB; files written in {t_write:.1f} s; f-k design at the "
        f"bucket shape {t_design:.1f} s (host); phase {time.perf_counter() - t_phase:.1f} s")
    return launch_by_mode, kernel_err
#: the card-vs-CPU slab files: three int32 blocks and a float32 one with
#: NaNs and samples at the clip level
SLAB_CPU_FILES = ((2027, 12000), (2032, 12000), (2033, 12000), (2034, 11000))
CLIP_COUNTS = 3000.0
N_NAN, N_CLIP = 3, 5


def _poison(raw: np.ndarray) -> np.ndarray:
    """float32 counts with N_NAN NaNs (one a channel) and N_CLIP samples at
    +-CLIP_COUNTS, all inside the record."""
    x = raw.astype(np.float32)
    for i in range(N_NAN):
        x[10 + 100 * i, 500 + 7 * i] = np.nan
    for i in range(N_CLIP):
        x[50 + 90 * i, 2000 + 11 * i] = CLIP_COUNTS * (1 if i % 2 else -1)
    return x


def phase_slab_cpu_vs_card():
    """The slab route on the card against the CPU at 512 channels, both
    wires, with the health stats and a clip level; then the spectro
    facade on one slab against its per-file adapter on the card."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from das4whales_tpu_torch.config import DataHealthConfig
    from das4whales_tpu_torch.io.stream import stream_batched_slabs, stream_strain_blocks
    from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector
    from das4whales_tpu_torch.models.spectro import FUSED_DEFAULT_BATCH
    from das4whales_tpu_torch.ops import conditioning, fused_stft
    from das4whales_tpu_torch.parallel.batch import BatchedMatchedFilterDetector, batched_detector_for
    from das4whales_tpu_torch.utils.parity import envelopes, unexplained_differences
    from das4whales_tpu_torch.workflows.spectrodetect import campaign_detector

    nx = 512
    sel = [0, nx, 1]
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    d = Path(tempfile.mkdtemp(prefix="slab_cpu_files_", dir=root))
    notes = []
    try:
        paths, scenes, _ = _write_files(d, SLAB_CPU_FILES, nx, n_calls=1, float_file=_poison)
        meta = scenes[0].metadata
        design = MatchedFilterDetector(meta, sel, (nx, SLAB_BUCKET), device="cpu").design
        for wire in ("raw", "conditioned"):
            clip = CLIP_COUNTS if wire == "raw" else 0.8 * CLIP_COUNTS * meta.scale_factor
            cfg = DataHealthConfig(clip_abs=clip)
            res, shapes = {}, {}
            for dev in ("cuda", "cpu"):
                det = MatchedFilterDetector.from_design(design, meta, wire=wire, device=dev)
                bd = BatchedMatchedFilterDetector(det)
                res[dev], shapes[dev] = [], []
                for slab in stream_batched_slabs(paths, sel, meta, batch=2, bucket="pow2",
                                                 wire=wire, device=dev):
                    shapes[dev].append((slab.n_valid, str(slab.stack.dtype)))
                    got = bd.detect_batch(slab.stack, n_real=slab.n_real, n_valid=slab.n_valid,
                                          with_health=True, health_clip=clip)
                    res[dev] += [(r, slab.stack[j].cpu(), slab.n_real[j])
                                 for j, r in enumerate(got)]
                if bd.serial is not (dev == "cpu"):
                    fail(f"slab_cpu_vs_card: the {dev} facade resolved serial={bd.serial}")
            want_shapes = ([(2, "torch.int32"), (1, "torch.int32"), (1, "torch.float32")]
                           if wire == "raw" else [(2, "torch.float32"), (2, "torch.float32")])
            if shapes["cuda"] != shapes["cpu"] or shapes["cuda"] != want_shapes:
                fail(f"slab_cpu_vs_card: {wire}: slabs {shapes}, expected {want_shapes}")
            n_diff = 0
            cpu_det = MatchedFilterDetector.from_design(design, meta, wire="conditioned",
                                                        device="cpu")
            for k, ((gp, gt, gh), block, n_real), ((cp, ct, ch), _, _) in zip(
                    range(len(paths)), res["cuda"], res["cpu"]):
                for key in ("nonfinite", "clipped", "bin_nonfinite", "bin_clipped", "bin_dead",
                            "n_samples"):
                    if gh[key] != ch[key]:
                        fail(f"slab_cpu_vs_card: {wire}: file {k}: health {key} card "
                             f"{gh[key]} vs cpu {ch[key]}")
                poisoned = k == len(paths) - 1
                if wire == "raw" and poisoned and (gh["nonfinite"], gh["clipped"]) != (N_NAN, N_CLIP):
                    fail(f"slab_cpu_vs_card: raw: the float32 file reads {gh['nonfinite']} "
                         f"non-finite and {gh['clipped']} clipped, expected {N_NAN} and {N_CLIP}")
                if (cfg.breach(gh) is not None) != poisoned or (cfg.breach(ch) is not None) != poisoned:
                    fail(f"slab_cpu_vs_card: {wire}: file {k}: breach card {cfg.breach(gh)!r}, "
                         f"cpu {cfg.breach(ch)!r}")
                x = block
                if wire == "raw":
                    x = conditioning.condition_padded(x, det._cond_scale, int(n_real))
                env = None
                for i, name in enumerate(cp):
                    a, b = gp[name], cp[name]
                    if not (np.isclose(gt[name], ct[name], rtol=1e-5, atol=0)
                            or (poisoned and np.isnan(gt[name]) and np.isnan(ct[name]))):
                        fail(f"slab_cpu_vs_card: {wire}: file {k} template {name}: threshold "
                             f"card {gt[name]} vs cpu {ct[name]}")
                    if not np.array_equal(a, b):
                        env = envelopes(cpu_det, x) if env is None else env
                        bad = unexplained_differences(a, b, env[i], ct[name])
                        if bad:
                            fail(f"slab_cpu_vs_card: {wire}: file {k} template {name}: picks "
                                 f"differ beyond rounding at {bad[:10]}")
                        n_diff += len({tuple(p) for p in a.T.tolist()}
                                      ^ {tuple(p) for p in b.T.tolist()})
                if not poisoned and _check_calls(scenes[k], gp):
                    fail(f"slab_cpu_vs_card: {wire}: file {k}: the injected call was missed")
            last = res["cuda"][-1][0][2]
            notes.append(f"{wire}: slabs {[s[0] for s in shapes['cuda']]} "
                         f"({', '.join(s[1] for s in shapes['cuda'])}), clip {clip:.4g}, the "
                         f"float32 file {last['nonfinite']} non-finite / {last['clipped']} "
                         f"clipped (breach), {n_diff} differing picks")
        # the per-block stream on the card (pinned staging from the read
        # workers, or at yield time): each block bit for bit its host read
        for wire in ("raw", "conditioned"):
            host = [np.ascontiguousarray(b.trace) for b in stream_strain_blocks(
                paths, sel, meta, wire=wire, as_numpy=True)]
            for overlap in (True, False):
                card = [b.trace for b in stream_strain_blocks(
                    paths, sel, meta, wire=wire, device="cuda", overlap_transfers=overlap)]
                same = [c.is_cuda and c.cpu().numpy().tobytes() == h.tobytes()
                        for c, h in zip(card, host)]
                if len(card) != len(host) or not all(same):
                    fail(f"slab_cpu_vs_card: stream_strain_blocks on the card, wire={wire}, "
                         f"overlap_transfers={overlap}: blocks equal to the host read {same}")
        notes.append("stream_strain_blocks on the card equal to the host read bit for bit "
                     "(both wires, with and without overlap)")
        # the spectro facade on one slab against its per-file adapter, on the card
        ad = campaign_detector(meta, sel, (nx, SLAB_BUCKET))
        bd = batched_detector_for(ad)
        slab = next(stream_batched_slabs(paths, sel, meta, batch=2, bucket="pow2"))
        zero_launches()                         # the facade's batched route starts here
        with _capture(fused_stft, "stft_power_cuda") as calls:
            got = bd.detect_batch(slab.stack, n_real=slab.n_real, n_valid=slab.n_valid)
        stft_launches = read_launches()["fused_stft"]
        rows = slab.n_valid * nx                # the facade's [n * C, T] correlogram input
        chunk = ad.det.batch_channels or FUSED_DEFAULT_BATCH
        want = len(ad.det.kernels) * -(-rows // chunk)
        if stft_launches != want:
            fail(f"slab_cpu_vs_card: the spectro facade launched fused_stft {stft_launches} "
                 f"times, expected {want} ({len(ad.det.kernels)} hat kernels x "
                 f"{-(-rows // chunk)} chunks of {rows} channels)")
        # the STFT kernel on the facade's own launches, against its plain version
        shape = (min(rows, chunk), SLAB_BUCKET)
        stft_err, rel, (nfft, hop) = _stft_at_main_path("slab_cpu_vs_card", calls, shape)
        notes.append(f"BatchedSpectroDetector: {stft_launches} fused_stft launches on the slab "
                     f"of {slab.n_valid}; fused_stft within {STFT_REL_TOL} * max of its plain "
                     f"version at the facade's first and last launch {shape} nfft {nfft} hop "
                     f"{hop} (relative max error {rel:.2e})")
        del calls
        n_diff = n_picks = 0
        for j in range(slab.n_valid):
            one = ad(slab.stack[j])
            corr = ad.det.correlograms(ad.prefilter.filter_block(slab.stack[j]))
            for name, b in one.picks.items():
                a = got[j][0][name]
                n_picks += b.shape[1]
                if np.array_equal(a, b):
                    continue
                env = corr[name].cpu().numpy()
                k_ = meta.ns / env.shape[-1]      # the adapter's frame -> sample factor
                fa, fb = (np.stack([p[0], np.round(p[1] / k_).astype(int)]) for p in (a, b))
                bad = unexplained_differences(fa, fb, env, ad.det.threshold)
                if bad:
                    fail(f"slab_cpu_vs_card: spectro facade file {j} kernel {name}: picks "
                         f"differ from the adapter beyond rounding at {bad[:10]}")
                n_diff += len({tuple(p) for p in fa.T.tolist()} ^ {tuple(p) for p in fb.T.tolist()})
        if n_picks == 0:
            fail("slab_cpu_vs_card: the spectro adapter picked nothing; the comparison proves nothing")
        del slab
        torch.cuda.synchronize()
        notes.append(f"BatchedSpectroDetector (serial={bd.serial}) on one slab of 2: "
                     f"{n_picks} adapter picks, {n_diff} differing")
        say(f"slab_cpu_vs_card: {nx} channels, files {[ns for _, ns in SLAB_CPU_FILES]} "
            f"samples, batch 2, pow2 bucket {SLAB_BUCKET}, card (batched mode) vs CPU (serial "
            f"mode): thresholds within rtol 1e-5, differing picks all on rounding knife edges, "
            f"health counts equal; {'; '.join(notes)}")
        return stft_launches, stft_err
    finally:
        shutil.rmtree(d, ignore_errors=True)



@contextlib.contextmanager
def _timing(mod, name: str, keep: bool = False):
    """Replace ``mod.name`` for the block by a function that forwards every
    call, counting the calls and summing their host seconds; with
    ``keep`` it also keeps each call's result. Yields ``{"n", "s",
    "out"}``."""
    orig = getattr(mod, name)
    got = {"n": 0, "s": 0.0, "out": []}

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = orig(*args, **kw)
        got["s"] += time.perf_counter() - t0
        got["n"] += 1
        if keep:
            got["out"].append(out)
        return out

    setattr(mod, name, timed)
    try:
        yield got
    finally:
        setattr(mod, name, orig)


@contextlib.contextmanager
def _first_slab(stream_mod):
    """Count ``stream_batched_slabs`` calls for the block and keep the host
    blocks of the first slab they yield: ``{"calls", "slab"}``."""
    orig = stream_mod.stream_batched_slabs
    got = {"calls": 0, "slab": None}

    def spy(*args, **kw):
        got["calls"] += 1
        gen = orig(*args, **kw)
        try:
            for slab in gen:
                if got["slab"] is None:
                    got["slab"] = (slab.blocks, slab.paths, slab.n_real, slab.bucket_ns)
                yield slab
        finally:
            gen.close()

    stream_mod.stream_batched_slabs = spy
    try:
        yield got
    finally:
        stream_mod.stream_batched_slabs = orig


@contextlib.contextmanager
def _pipeline_probe(cls):
    """Replace ``cls.dispatch_batch`` for the block by a function that
    forwards every call and keeps, per dispatched slab: the host seconds
    of the dispatch; CUDA events recorded just before and just after it
    on the dispatching stream (the slab's device time between them);
    the host clock at its resolve's start and its seconds; whether its
    own program had finished when its resolve started
    (``done_at_resolve``); and whether the NEXT slab's program was still
    running when its resolve started and when it returned
    (``next_busy``, a pair; None for the last slab). Yields the list of
    slabs."""
    import torch

    orig = cls.dispatch_batch
    slabs = []

    def spy(self, *args, **kw):
        k = len(slabs)
        rec = {"start": torch.cuda.Event(enable_timing=True),
               "end": torch.cuda.Event(enable_timing=True)}
        slabs.append(rec)
        rec["start"].record()
        rec["t_dispatch"] = time.perf_counter()
        handle = orig(self, *args, **kw)
        rec["dispatch_s"] = time.perf_counter() - rec["t_dispatch"]
        rec["end"].record()
        resolve = handle.resolve

        def probed():
            nxt = slabs[k + 1]["end"] if k + 1 < len(slabs) else None
            rec["t_resolve"] = time.perf_counter()
            rec["done_at_resolve"] = rec["end"].query()
            busy0 = nxt is not None and not nxt.query()
            out = resolve()
            rec["resolve_s"] = time.perf_counter() - rec["t_resolve"]
            rec["next_busy"] = None if nxt is None else (busy0, not nxt.query())
            return out

        handle.resolve = probed
        return handle

    cls.dispatch_batch = spy
    try:
        yield slabs
    finally:
        cls.dispatch_batch = orig


def _check_pipeline(where: str, slabs: list) -> str:
    """Hold a depth-2 campaign run to its pipeline's order (from
    :func:`_pipeline_probe`): slab k+1's program enqueued before slab k's
    fetch started. Returns the per-slab figures as text. How long a
    dispatch holds the host, and so whether slab k+1 still runs around
    slab k's fetch, depends on the host's pace and the launch queue: it
    is reported; :func:`_check_fetch_waits_on_its_slab` holds the fetch
    to its own slab."""
    parts = []
    for k, r in enumerate(slabs):
        dev_ms = r["start"].elapsed_time(r["end"])
        text = (f"slab {k}: dispatch {r['dispatch_s'] * 1e3:.1f} ms of host, program "
                f"{dev_ms:.1f} ms on the card (events around the dispatch), done when its "
                f"fetch started {r['done_at_resolve']}, fetch {r['resolve_s'] * 1e3:.1f} ms"
                + ("" if r["next_busy"] is None else
                   f", slab {k + 1} still running at that fetch's start, end "
                   f"{r['next_busy']}"))
        if k + 1 < len(slabs) and not slabs[k + 1]["t_dispatch"] < r["t_resolve"]:
            fail(f"{where}: slab {k + 1} was dispatched after slab {k}'s fetch started ({text})")
        parts.append(text)
    return "; ".join(parts)


def _check_fetch_waits_on_its_slab(where: str, bd, stack, **kw) -> str:
    """The pipeline's promises on one facade and slab, at depth 2: slab
    B's dispatch returns while its program still runs, and slab A's
    fetch, taken after B was queued, returns while B's kernels run (it
    waits on A's event, not on the stream). Returns the figures, with
    the host's lead: how long B ran on after its dispatch returned (the
    window the host has to settle slab A before the card idles)."""
    import torch

    torch.cuda.synchronize()
    h_a = bd.dispatch_batch(stack, **kw)
    start_b = torch.cuda.Event(enable_timing=True)
    end_b = torch.cuda.Event(enable_timing=True)
    start_b.record()
    t0 = time.perf_counter()
    h_b = bd.dispatch_batch(stack, **kw)
    t_back = time.perf_counter()
    end_b.record()
    busy_dispatched = not end_b.query()
    h_a.resolve()
    fetch_s = time.perf_counter() - t_back
    started, busy_fetched = start_b.query(), not end_b.query()
    end_b.synchronize()
    lead_s = time.perf_counter() - t_back
    h_b.resolve()
    torch.cuda.synchronize()
    text = (f"slab B's dispatch {(t_back - t0) * 1e3:.1f} ms of host against its program "
            f"{start_b.elapsed_time(end_b):.1f} ms on the card; slab A's fetch {fetch_s * 1e3:.1f} "
            f"ms; B still running after its dispatch {busy_dispatched}; B's kernels running "
            f"when A's fetch returned {started and busy_fetched}; B ran on {lead_s * 1e3:.1f} ms "
            f"after its dispatch returned (the host's lead)")
    if not busy_dispatched:
        fail(f"{where}: slab B's dispatch held the host until its program ended ({text})")
    if not (started and busy_fetched):
        fail(f"{where}: slab A's fetch did not return while slab B's kernels ran ({text})")
    return text


@contextlib.contextmanager
def _no_host_sync(cls, name: str):
    """Run every call of ``cls.name`` for the block under
    ``torch.cuda.set_sync_debug_mode("error")``: an operation inside it
    that would make the host wait on the card raises there. Yields
    ``{"n": calls, "syncs": [first line of each such error]}`` (a caller
    may swallow the error; the record stays)."""
    import torch

    orig = getattr(cls, name)
    got = {"n": 0, "syncs": []}

    def guarded(*args, **kw):
        got["n"] += 1
        torch.cuda.set_sync_debug_mode("error")
        try:
            return orig(*args, **kw)
        except RuntimeError as exc:
            if "synchroniz" in str(exc):
                got["syncs"].append(str(exc).splitlines()[0])
            raise
        finally:
            torch.cuda.set_sync_debug_mode(0)

    setattr(cls, name, guarded)
    try:
        yield got
    finally:
        setattr(cls, name, orig)


def _downshifts(outdir) -> list:
    from das4whales_tpu_torch.utils.artifacts import read_records

    return [(e["from"], e["to"]) for e in read_records(str(outdir / "manifest.jsonl"))
            if e.get("event") == "downshift"]


def phase_campaign():
    """``run_campaign_batched`` at its defaults over the slab phase's five
    canonical TDMS files, then again on the same outdir (resume)."""
    import shutil

    import torch

    from das4whales_tpu_torch import fsck
    from das4whales_tpu_torch.config import dispatch_depth_default
    from das4whales_tpu_torch.io import stream as stream_mod
    from das4whales_tpu_torch.io.stream import assemble_slab
    from das4whales_tpu_torch.parallel.batch import (BatchedMatchedFilterDetector,
                                                     batched_detector_for)
    from das4whales_tpu_torch.telemetry import metrics
    from das4whales_tpu_torch.workflows import campaign as cmod

    t_phase = time.perf_counter()
    nx = CANONICAL[0]
    sel = [0, nx, 1]
    shared = slab_files()
    paths, scenes = shared["paths"], shared["scenes"]
    meta = scenes[0].metadata
    out = shared["dir"] / "campaign_out"
    shutil.rmtree(out, ignore_errors=True)
    def slab_wall_totals():
        rows = metrics.snapshot().get("das_slab_wall_seconds", {}).get("values", [])
        return sum(r["sum"] for r in rows), sum(r["count"] for r in rows)

    before_hist = slab_wall_totals()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()                      # the campaign's main path starts here
    with _timing(cmod, "family_detector", keep=True) as design_t, \
            _timing(cmod, "_save_picks") as picks_t, \
            _timing(cmod, "_append_manifest") as manifest_t, \
            _timing(cmod.fsck, "startup_check") as fsck_t, \
            _pipeline_probe(BatchedMatchedFilterDetector) as piped, \
            _no_host_sync(BatchedMatchedFilterDetector, "dispatch_batch") as guard, \
            _first_slab(stream_mod) as first:
        t0 = time.perf_counter()
        res = cmod.run_campaign_batched(paths, sel, str(out), metadata=meta,
                                        interrogator="silixa")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_launches()["fused_picks"]
    peak = torch.cuda.max_memory_allocated()
    hist = slab_wall_totals()
    slab_walls = (hist[0] - before_hist[0], hist[1] - before_hist[1])
    if design_t["n"] != 1:
        fail(f"campaign: {design_t['n']} detectors built for one bucket")
    det = design_t["out"][0]
    attempts, reads, escalations = det.dispatches, det.syncs, det.escalations
    n_tiles = -(-nx // det.effective_channel_tile)
    recs = [(r.status, r.rung) for r in res.records]
    if recs != [("done", "batched:4")] * len(paths):
        fail(f"campaign: records {recs}; every file must be done at batched:4")
    moves = _downshifts(out)
    if moves:
        fail(f"campaign: downshift events {moves} on the canonical files")
    if attempts != 2 + escalations or reads != attempts:
        fail(f"campaign: {attempts} attempts and {reads} reads for 2 slabs "
             f"({escalations} escalations)")
    if launches != n_tiles * attempts:
        fail(f"campaign: {launches} fused_picks launches for {attempts} attempts, "
             f"expected {n_tiles} an attempt")
    if len(piped) != 2 or guard["syncs"]:
        fail(f"campaign: {len(piped)} pipelined dispatches for 2 slabs, host syncs inside "
             f"them: {guard['syncs']}")
    pipeline = _check_pipeline("campaign", piped)
    n_same = 0
    for k, rec in enumerate(res.records):
        got = cmod.load_picks(rec.picks_file)
        ref = shared["picks"].get(k)
        if ref is not None:
            for name in ref:
                if not np.array_equal(got[name], ref[name]):
                    fail(f"campaign: file {k} template {name}: saved picks differ from the "
                         f"slab phase's batched picks ({got[name].shape[1]} vs "
                         f"{ref[name].shape[1]})")
            n_same += 1
        misses = _check_calls(scenes[k], got)
        if misses:
            fail(f"campaign: file {k}: injected calls missed: {misses}")
    if shared["picks"] and n_same != len(paths):
        fail(f"campaign: {n_same} of {len(paths)} files held to the slab phase's picks")
    # resume: the same call settles nothing and reads nothing
    with _first_slab(stream_mod) as again:
        t0 = time.perf_counter()
        res2 = cmod.run_campaign_batched(paths, sel, str(out), metadata=meta,
                                         interrogator="silixa")
        resume_wall = time.perf_counter() - t0
    if [r.status for r in res2.records] != ["skipped"] * len(paths) or again["calls"]:
        fail(f"campaign: resume gave {[r.status for r in res2.records]} with "
             f"{again['calls']} streams; it must settle nothing and read nothing")
    summary = cmod.summarize_campaign(str(out))
    if summary["n_done"] != len(paths) or summary["downshifts"]:
        fail(f"campaign: summary counts {summary['n_done']} done, "
             f"{summary['downshifts']} downshifts")
    findings = fsck.fsck_outdir(str(out))
    if findings:
        fail(f"campaign: fsck found {fsck.render_findings(findings)}")
    # the device's busy share on one slab of the campaign's own facade
    blocks, spaths, n_real, bucket_ns = first["slab"]
    host = assemble_slab(blocks, spaths, 0, SLAB_BATCH, bucket_ns)
    stack = torch.from_numpy(host.stack).cuda()
    del host
    bd = batched_detector_for(det)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        bd.dispatch_batch(stack, n_real=n_real, n_valid=len(blocks), with_health=True).resolve()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    slab_wall = statistics.median(walls)
    ab = _check_fetch_waits_on_its_slab("campaign", bd, stack, n_real=n_real,
                                        n_valid=len(blocks), with_health=True)
    fams = _profile("campaign slab of 4 (the campaign's own facade)", lambda: bd.dispatch_batch(
        stack, n_real=n_real, n_valid=len(blocks), with_health=True).resolve(),
        slab_wall, "fused_picks")
    del stack, bd
    t_design = design_t["s"]
    per_file = (wall - t_design) / len(paths)
    writes = picks_t["s"] + manifest_t["s"]
    say(f"campaign: run_campaign_batched at its defaults (batch 4, bucket pow2, conditioned "
        f"wire, engine='h5py' (the TDMS format reader), family 'mf', health, dispatch depth "
        f"{dispatch_depth_default()}), "
        f"interrogator 'silixa', {len(paths)} files of {nx} channels "
        f"({', '.join(str(ns) for _, ns in SLAB_FILES)} samples): wall {wall:.3f} s, of which "
        f"the bucket's design {t_design:.3f} s (one bucket of {SLAB_BUCKET}); pass "
        f"{per_file:.3f} s a file (wall less design, over {len(paths)} files; the slab phase's "
        f"timed pass is its yardstick); {slab_walls[1]} slabs, their resolve walls (each "
        f"slab's wait on its packed read, behind the pipelined dispatch; "
        f"das_slab_wall_seconds) sum {slab_walls[0]:.3f} s; the depth-2 pipeline (no host "
        f"sync inside a dispatch, set_sync_debug_mode): {pipeline}; two dispatches of the "
        f"campaign's first slab back to back: {ab}; picks "
        f"artifacts {picks_t['n']} writes {picks_t['s']:.4f} s, manifest {manifest_t['n']} "
        f"appends {manifest_t['s']:.4f} s, startup check {fsck_t['s']:.4f} s: the campaign's "
        f"own writes {writes:.4f} s = {100 * writes / (wall - t_design):.2f} % of the pass; "
        f"fused_picks launches {launches} over {attempts} attempts ({n_tiles} an "
        f"attempt), {reads} reads, {escalations} escalations; peak device memory "
        f"{peak / 2**30:.2f} GiB; downshift events {len(moves)}; every file done at "
        f"batched:4, {n_same} files' saved picks bitwise the slab phase's batched picks, "
        f"every injected call picked; resume {resume_wall:.3f} s: {len(paths)} skipped, 0 "
        f"streams; summarize_campaign {summary['n_done']} done; fsck_outdir clean; one slab "
        f"of the campaign's facade {slab_wall * 1e3:.1f} ms (runs "
        f"{', '.join(f'{w * 1e3:.1f}' for w in walls)}), device busy "
        f"{100 * sum(fams.values()) / (slab_wall * 1e3):.1f} %; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    shutil.rmtree(out, ignore_errors=True)
    return launches


#: the card-vs-CPU campaign files: 512 channels x 12000 samples, int32
#: (seeds), a float32 one with NaNs and a garbage file
CAMPAIGN_CPU_FILES = ((2040, 12000), (2041, 12000), (2042, 12000), (2043, 12000),
                      (2044, 12000))


def _compare_campaigns(label, card, cpu, cpu_det, blocks, scenes, records=True):
    """Two campaigns: with ``records``, file, status, rung and attempts
    equal record for record; the files done in both: picks equal up to
    rounding knife edges and every injected call picked. Returns the
    count of differing picks."""
    from das4whales_tpu_torch.utils.parity import envelopes, unexplained_differences
    from das4whales_tpu_torch.workflows.campaign import load_picks

    a = [(r.path, r.status, r.rung, r.attempts) for r in card.records]
    b = [(r.path, r.status, r.rung, r.attempts) for r in cpu.records]
    if records and a != b:
        fail(f"campaign_cpu_vs_card: {label}: records differ: {a} vs {b}")
    n_diff = 0
    for k, (ra, rb) in enumerate(zip(card.records, cpu.records)):
        if ra.status != "done" or rb.status != "done" or ra.path != rb.path:
            continue
        pa, pb = load_picks(ra.picks_file), load_picks(rb.picks_file)
        env = None
        for i, name in enumerate(pb):
            if np.array_equal(pa[name], pb[name]):
                continue
            with np.load(rb.picks_file) as z:
                thr = float(z["thresholds"][i])
            env = envelopes(cpu_det, blocks[ra.path]) if env is None else env
            bad = unexplained_differences(pa[name], pb[name], env[i], thr)
            if bad:
                fail(f"campaign_cpu_vs_card: {label}: file {k} template {name}: picks "
                     f"differ beyond rounding at {bad[:10]}")
            n_diff += len({tuple(p) for p in pa[name].T.tolist()}
                          ^ {tuple(p) for p in pb[name].T.tolist()})
        scene = scenes.get(ra.path)
        if scene is not None and _check_calls(scene, pa):
            fail(f"campaign_cpu_vs_card: {label}: file {k}: the injected call was missed")
    return n_diff


def phase_campaign_cpu_vs_card():
    """Both campaign entries on the card against the CPU at 512 channels,
    then the resilience contract on the card: an oom that downshifts once,
    a corrupt file, a NaN file, a wedged dispatch under the watchdog, the
    spectro family on one slab and a design checkpoint."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from das4whales_tpu_torch import faults
    from das4whales_tpu_torch.io.stream import stream_batched_slabs
    from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector
    from das4whales_tpu_torch.models.spectro import FUSED_DEFAULT_BATCH
    from das4whales_tpu_torch.ops import fused_stft
    from das4whales_tpu_torch.parallel.batch import (BatchedMatchedFilterDetector,
                                                     batched_detector_for, trim_picks)
    from das4whales_tpu_torch.utils.checkpoint import save_design
    from das4whales_tpu_torch.workflows.planner import MatchedFilterProgram
    from das4whales_tpu_torch.workflows import campaign as cmod
    from das4whales_tpu_torch.workflows.spectrodetect import campaign_detector

    nx = 512
    sel = [0, nx, 1]
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    d = Path(tempfile.mkdtemp(prefix="campaign_cpu_files_", dir=root))
    notes = []
    t_phase = time.perf_counter()
    try:
        clean, scenes_l, _ = _write_files(d, CAMPAIGN_CPU_FILES, nx, n_calls=1)
        (d / "nan").mkdir()
        nan_path, _, _ = _write_files(d / "nan", ((2045, 12000),), nx, n_calls=1,
                                      float_file=_poison)
        (d / "bad.tdms").write_bytes(b"TDSm garbage, not a TDMS segment " * 32)
        meta = scenes_l[0].metadata
        scenes = dict(zip(clean, scenes_l))
        files = clean[:2] + [str(d / "bad.tdms")] + clean[2:3] + nan_path + clean[3:]
        design = MatchedFilterDetector(meta, sel, (nx, SLAB_BUCKET), device="cpu").design
        dpath = save_design(str(d / "design_16384"), design)
        cpu_det = MatchedFilterDetector.from_design(design, meta, device="cpu")
        blocks = {}
        for slab in stream_batched_slabs(clean, sel, meta, batch=1, bucket="pow2", as_numpy=True):
            blocks[slab.paths[0]] = slab.stack[0]
        kw = dict(metadata=meta, interrogator="silixa", design=dpath)

        def run(entry, out, **extra):
            return entry(files if "files" not in extra else extra.pop("files"), sel,
                         str(d / out), **kw, **extra)

        # 1. both entries, card against CPU, record for record
        res = {}
        pf_design = MatchedFilterDetector(meta, sel, (nx, 12000), device="cpu").design
        for dev in ("cuda", "cpu"):
            # on the card, no pipelined dispatch may make the host wait
            with _no_host_sync(BatchedMatchedFilterDetector, "dispatch_batch") as g_b, \
                    _no_host_sync(MatchedFilterProgram, "dispatch") as g_f:
                res[("batched", dev)] = run(cmod.run_campaign_batched, f"b_{dev}", device=dev)
                res[("file", dev)] = cmod.run_campaign(
                    files, sel, str(d / f"f_{dev}"), metadata=meta, interrogator="silixa",
                    detector=MatchedFilterDetector.from_design(pf_design, meta, device=dev))
            if dev != "cuda":
                continue
            if g_b["syncs"] or g_f["syncs"] or not g_b["n"] or not g_f["n"]:
                fail(f"campaign_cpu_vs_card: pipelined dispatches on the card: batched "
                     f"{g_b['n']}, per-file {g_f['n']}; host syncs inside them "
                     f"{g_b['syncs'] + g_f['syncs']}")
            notes.append(f"pipelined dispatches on the card without a host sync: {g_b['n']} "
                         f"batched, {g_f['n']} per-file")
        want = ["done", "done", "failed", "done", "quarantined", "done", "done"]
        for route in ("batched", "file"):
            got = [r.status for r in res[(route, "cuda")].records]
            if got != want:
                fail(f"campaign_cpu_vs_card: {route}: statuses {got}, expected {want}")
            det_for = cpu_det if route == "batched" else MatchedFilterDetector.from_design(
                pf_design, meta, device="cpu")
            blk = blocks if route == "batched" else {
                p: b[:, :12000] for p, b in blocks.items()}
            n_diff = _compare_campaigns(route, res[(route, "cuda")], res[(route, "cpu")],
                                        det_for, blk, scenes)
            notes.append(f"run_campaign{'_batched' if route == 'batched' else ''} card vs "
                         f"CPU: records equal (file, status, rung, attempts: "
                         f"{[(r.status, r.rung) for r in res[(route, 'cuda')].records]}), "
                         f"{n_diff} differing picks, all on knife edges")
        # 2. the chaos plan: an oom at batched:4 (fits from batched:2), a
        # corrupt file, a NaN file — serial mode (each file its own program,
        # so the picks are bitwise at every B) and the default batched mode
        name = os.path.basename
        pinned = {
            name(clean[0]): faults.FaultSpec("oom", "dispatch", 10**9, ("batched", 2)),
            name(clean[2]): faults.FaultSpec("truncated", "read", 10**9),
            name(clean[4]): faults.FaultSpec("nan", "read", 10**9),
        }
        for mode, serial in (("serial", True), ("batched", False)):
            free = cmod.run_campaign_batched(clean, sel, str(d / f"free_{mode}"), serial=serial,
                                             **kw)
            plan = faults.FaultPlan(7, rate=0.0, pinned=pinned)
            hurt = cmod.run_campaign_batched(clean, sel, str(d / f"chaos_{mode}"),
                                             serial=serial, fault_plan=plan, **kw)
            got = [(r.status, r.rung) for r in hurt.records]
            want_c = [("done", "batched:2"), ("done", "batched:2"), ("failed", ""),
                      ("done", "batched:2"), ("quarantined", "batched:2")]
            moves = _downshifts(d / f"chaos_{mode}")
            if got != want_c or moves != [("batched:4", "batched:2")]:
                fail(f"campaign_cpu_vs_card: chaos ({mode}): records {got}, downshifts "
                     f"{moves}; expected {want_c} and one batched:4 -> batched:2")
            same = all(
                np.array_equal(cmod.load_picks(h.picks_file)[t], cmod.load_picks(f.picks_file)[t])
                for h, f in zip(hurt.records, free.records) if h.status == "done"
                for t in cmod.load_picks(f.picks_file))
            if serial and not same:
                fail("campaign_cpu_vs_card: chaos (serial): the downshifted picks differ "
                     "from the fault-free run")
            if not same:
                _compare_campaigns(f"chaos ({mode}) vs fault-free", hurt, free, cpu_det,
                                   blocks, scenes, records=False)
            notes.append(f"chaos ({mode} mode): one oom at batched:4 -> one downshift to "
                         f"batched:2, a corrupt file failed, a NaN file quarantined; picks "
                         f"{'bitwise equal to' if same else 'within knife edges of'} the "
                         f"fault-free run")
        # 3. the watchdog: a wedged dispatch times out that file only
        plan = faults.FaultPlan(0, rate=0.0, hang_s=4.0, pinned={
            name(clean[1]): faults.FaultSpec("hang_dispatch", "dispatch", 10**9)})
        t0 = time.perf_counter()
        hung = cmod.run_campaign_batched(clean[:4], sel, str(d / "hang"), fault_plan=plan,
                                         dispatch_deadline_s=2.0, **kw)
        got = [(r.status, r.rung) for r in hung.records]
        if got != [("done", "file"), ("timeout", "file"), ("done", "file"), ("done", "file")]:
            fail(f"campaign_cpu_vs_card: watchdog: records {got}; the wedged slab's files "
                 "run one by one at the per-file rung, the wedged one times out")
        notes.append(f"watchdog (dispatch_deadline_s 2.0, a 4.0 s wedge): "
                     f"{[(r.status, r.rung) for r in hung.records]} in "
                     f"{time.perf_counter() - t0:.1f} s")
        # 4. the spectro family on one slab: fused_stft launches (each held
        # against its plain version on the campaign's own inputs), the
        # facade's picks
        sfiles = clean[:2]
        ad = campaign_detector(meta, sel, (nx, 12000))
        rows = len(sfiles) * nx              # the facade's [n * C, T] correlogram input
        chunk = ad.det.batch_channels or FUSED_DEFAULT_BATCH
        want = len(ad.det.kernels) * -(-rows // chunk)
        zero_launches()                      # the spectro campaign's main path starts here
        with _capture(fused_stft, "stft_power_cuda") as calls:
            sres = cmod.run_campaign_batched(sfiles, sel, str(d / "spectro"), family="spectro",
                                             batch=2, metadata=meta, interrogator="silixa")
        stft_launches = read_launches()["fused_stft"]
        if [(r.status, r.rung) for r in sres.records] != [("done", "batched:2")] * 2:
            fail(f"campaign_cpu_vs_card: spectro: {[(r.status, r.rung) for r in sres.records]}")
        if stft_launches != want:
            fail(f"campaign_cpu_vs_card: the spectro campaign launched fused_stft "
                 f"{stft_launches} times, expected {want} ({len(ad.det.kernels)} hat kernels x "
                 f"{-(-rows // chunk)} chunks of {rows} channels)")
        shape = (min(rows, chunk), 12000)
        stft_err, rel, (nfft, hop) = _stft_at_main_path("campaign_cpu_vs_card: spectro", calls,
                                                        shape)
        del calls
        bd = batched_detector_for(ad)
        slab = next(stream_batched_slabs(sfiles, sel, meta, batch=2, bucket="exact"))
        facade = bd.detect_batch(slab.stack, n_real=slab.n_real, n_valid=slab.n_valid)
        for k, rec in enumerate(sres.records):
            got = cmod.load_picks(rec.picks_file)
            ref = trim_picks(facade[k][0], slab.n_real[k])
            for t in ref:
                if not np.array_equal(got[t], ref[t]):
                    fail(f"campaign_cpu_vs_card: spectro: file {k} kernel {t}: the "
                         "campaign's picks differ from the facade's")
        del slab
        notes.append(f"spectro campaign: 2 files done at batched:2, {stft_launches} fused_stft "
                     f"launches (as expected), fused_stft within {STFT_REL_TOL} * max of its "
                     f"plain version at the campaign's first and last launch {shape} nfft "
                     f"{nfft} hop {hop} (relative max error {rel:.2e}), picks equal to "
                     f"BatchedSpectroDetector's")
        # 5. a design checkpoint saved by the port and loaded again: the
        # same files (so the same slabs) as the card's batched run of 1.
        det = MatchedFilterDetector.from_design(design, meta)
        dpath2 = save_design(str(d / "design_again"), det.design)
        again = cmod.run_campaign_batched(files, sel, str(d / "design_again_out"),
                                          metadata=meta, interrogator="silixa", design=dpath2)
        base = res[("batched", "cuda")]
        if [(r.status, r.rung) for r in again.records] != [(r.status, r.rung) for r in base.records]:
            fail(f"campaign_cpu_vs_card: checkpoint run: {[r.status for r in again.records]}")
        for r, b_ in zip(again.records, base.records):
            if r.status != "done":
                continue
            a, b = cmod.load_picks(r.picks_file), cmod.load_picks(b_.picks_file)
            if any(not np.array_equal(a[t], b[t]) for t in b):
                fail("campaign_cpu_vs_card: the reloaded design's picks differ")
        notes.append("a design saved by the port and loaded again: bitwise the same picks")
        torch.cuda.synchronize()
        say(f"campaign_cpu_vs_card: {nx} channels x 12000 samples, 5 int32 files, a corrupt and "
            f"a NaN file, batch 4, pow2 bucket {SLAB_BUCKET}: {'; '.join(notes)}; phase "
            f"{time.perf_counter() - t_phase:.1f} s")
        return stft_launches, stft_err
    finally:
        shutil.rmtree(d, ignore_errors=True)


def main(argv: list) -> int:
    import torch

    if argv[:1] == ["--only"]:
        # a development run of the named phases after device and build, e.g.
        # --only campaign,campaign_cpu_vs_card; it prints no result line
        phase_device()
        phase_build()
        try:
            for name in argv[1].split(","):
                globals()[f"phase_{name}"]()
        finally:
            remove_slab_files()
        return 0
    if argv:
        fail(f"unknown arguments {argv}; run with none, or --only PHASE[,PHASE]")
    smi_line = phase_device()
    phase_build()
    kern, err = phase_kernels()
    launches, scene, raw, design = phase_detect()
    phase_cpu_vs_card()
    stft, stft_err = phase_stft_kernel()
    stft_launches = phase_spectro(scene, raw, design)
    del scene, raw, design
    phase_spectro_cpu_vs_card()
    try:
        slab_launches, slab_picks_err = phase_slab()
        slab_stft_launches, slab_stft_err = phase_slab_cpu_vs_card()
        campaign_launches = phase_campaign()
    finally:
        remove_slab_files()
    campaign_stft_launches, campaign_stft_err = phase_campaign_cpu_vs_card()
    pk = kern["pack"]
    print(json.dumps({"kernels": [{
        "name": "fused_picks",
        "route": "cuda",
        "source": "das4whales_tpu_torch/csrc/fused_picks.cu",
        "replaces": "das4whales_tpu/ops/pallas_picks.py:71",
        "launches": launches,
        "launches_by_path": {"detect": launches, "slab_batched": slab_launches["batched"],
                             "slab_serial": slab_launches["serial"],
                             "campaign": campaign_launches},
        "max_abs_err": max(err, slab_picks_err),
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
        "launches_by_path": {"spectro": stft_launches, "slab_spectro": slab_stft_launches,
                             "campaign_spectro": campaign_stft_launches},
        "max_abs_err": max(stft_err, slab_stft_err, campaign_stft_err),
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
    sys.exit(main(sys.argv[1:]))

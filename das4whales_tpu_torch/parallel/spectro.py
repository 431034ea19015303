"""Spectrogram-correlation detection over a device mesh (the port of
``das4whales_tpu.parallel.spectro``).

Every stage of the spectro family (per-channel normalisation, the sliced
STFT, the 2-D hat-kernel correlation, the absolute-threshold picks,
reference ``detect.py:650-708``) is channel-local and its threshold is
absolute (14 on normalised correlograms), so the channel-sharded step
needs no collective at all: each rank detects on its own ``[B/Pf, C/Pc,
T]`` slice of a ``(file, channel)`` mesh.

Within a rank, channels go through ``channel_tile`` rows at a time, so
the spectrogram of the whole slice never lives at once. Each tile's one
STFT is sliced into both kernels' bands: on a card it is the fused
``|STFT|²`` kernel (``ops.fused_stft``, engine ``"fused"``, the
counterpart of the JAX package's Pallas kernel), on the CPU its plain
version, as ``models.spectro.SpectroCorrDetector`` runs it. The picks are
the plain sparse picker's (``ops.peaks.find_peaks_sparse_batched``), the
one-device family's.

The time-split step (``make_sharded_spectro_step_time``) serves records
longer than a card: the global per-channel mean and max through ``psum``
/ ``pmax``, a ``halo_exchange`` of ``nperseg // 2`` samples so that every
frame is sample-exact across shard boundaries, uncentred rfft framing
(no kernel, as in JAX), one ``pmax`` for the spectrogram's maximum and
ONE ``all_to_all`` into the channel-split layout, after which the
correlation and the picks are channel-local. Unlike JAX's, the step keeps
and relabels only the frequency rows of the kernels' bands (the maximum
is still taken over every bin): the same correlograms from fewer bytes
on the card and through the collective.

Every rank calls the factories with the same arguments and the step with
its LOCAL slice (``parallel.mesh``). These steps take the UNFILTERED
block and normalise it themselves: they are detectors of their own, not
rungs of the campaign's spectro ladder.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..config import SPECTRO_HF_KERNEL, SPECTRO_LF_KERNEL, as_metadata
from ..models.spectro import _normalise_slice, buildkernel, effective_band, xcorr2d
from ..ops import peaks as peak_ops
from ..ops import spectral
from . import collectives as coll
from .mesh import Mesh
from .timeshard import halo_exchange

#: the STFT engine of the channel-sharded step: the ``fused_stft`` kernel
#: on a card tensor, its plain version on a CPU tensor
STFT_ENGINE = "fused"


def _design_kernels(fs, ns, flims, kernels, nperseg, nhop, nt):
    """Host-side design shared by both factories: each kernel's band rows
    as a slice of the full-band spectrogram grid and the hat kernel on
    those rows, on a time grid of the record's frame spacing that spans
    ``buildkernel``'s ``(7 dur, 8 dur)`` window (so the kernel is the
    record's at any record length). Returns ``([(name, lo, hi, K)],
    names)``, ``K`` float32 numpy."""
    nf = nperseg // 2 + 1
    ff_full = np.linspace(0, fs / 2, num=nf)
    dt = (ns / fs) / max(nt - 1, 1)
    designs = []
    for name, ker in kernels.items():
        fmin, fmax = effective_band(flims, ker)
        sel_rows = np.where((ff_full >= fmin) & (ff_full <= fmax))[0]
        lo, hi = int(sel_rows[0]), int(sel_rows[-1]) + 1
        tt = np.arange(0, 8.2 * ker["dur"] + dt, dt)
        _, _, K = buildkernel(ker["f0"], ker["f1"], ker["bdwidth"], ker["dur"],
                              ff_full[lo:hi], tt, fs, fmin, fmax)
        designs.append((name, lo, hi, np.asarray(K, np.float32)))
    return designs, tuple(d[0] for d in designs)


def _on(designs, dev) -> list:
    return [(name, lo, hi, torch.as_tensor(K, device=dev)) for name, lo, hi, K in designs]


def _hop(win_size: float, overlap_pct: float, fs: float) -> tuple:
    nperseg = int(win_size * fs)
    return nperseg, int(np.floor(nperseg * (1 - overlap_pct)))


def make_sharded_spectro_step(
    metadata,
    mesh: Mesh,
    flims: Tuple[float, float] = (14.0, 30.0),
    kernels: Dict[str, Dict] | None = None,
    win_size: float = 0.8,
    overlap_pct: float = 0.95,
    threshold: float = 14.0,
    max_peaks: int = 256,
    channel_tile: int = 256,
    outputs: str = "full",
    file_axis: str = "file",
    channel_axis: str = "channel",
):
    """The channel- and file-sharded spectro step for ``mesh``: returns
    ``(step, names)``. ``step(local)`` maps this rank's ``[B/Pf, C/Pc,
    T]`` slice (``parallel.pipeline.input_sharding``) to ``(correlograms
    [nT, B/Pf, C/Pc, n_frames], picks)``, the picks an
    ``ops.peaks.SparsePicks`` over ``[nT, B/Pf, C/Pc]``; ``outputs=
    "picks"`` returns the picks alone. No collective. Defaults reproduce
    ``main_spectrodetect.py`` (0.8 s window, 95 % overlap, threshold 14).
    A step makes one STFT call a ``channel_tile`` rows of the slice."""
    if outputs not in ("full", "picks"):
        raise ValueError(f"outputs must be 'full' or 'picks', got {outputs!r}")
    meta = as_metadata(metadata)
    fs, ns = meta.fs, meta.ns
    kernels = kernels or {"HF": SPECTRO_HF_KERNEL, "LF": SPECTRO_LF_KERNEL}
    nperseg, nhop = _hop(win_size, overlap_pct, fs)
    nt = 1 + ns // nhop                          # centred frames of an ns-sample record
    designs, names = _design_kernels(fs, ns, flims, kernels, nperseg, nhop, nt)
    on_dev = _on(designs, mesh.device)

    def step(x):
        x = torch.as_tensor(x).to(mesh.device, torch.float32)
        if x.ndim != 3 or x.shape[-1] != ns:
            raise ValueError(f"local batch {tuple(x.shape)} is not [B, C, {ns}]")
        norm = x - x.mean(dim=-1, keepdim=True)
        norm = norm / x.abs().amax(dim=-1, keepdim=True)
        Cl = norm.shape[1]
        tile = min(channel_tile, Cl)
        per_kernel = [[] for _ in on_dev]
        for lo_c in range(0, Cl, tile):
            mag = spectral.stft_magnitude(norm[:, lo_c:lo_c + tile], nperseg, nhop,
                                          engine=STFT_ENGINE)
            for j, (_, lo, hi, K) in enumerate(on_dev):
                per_kernel[j].append(xcorr2d(_normalise_slice(mag, slice(lo, hi)), K))
            del mag
        del norm
        corr = torch.stack([torch.cat(parts, dim=1) for parts in per_kernel])
        picks = peak_ops.find_peaks_sparse_batched(corr, float(threshold), max_peaks=max_peaks)
        if outputs == "picks":
            return picks
        return corr, picks

    step.mesh = mesh
    return step, names


def make_sharded_spectro_step_time(
    metadata,
    mesh: Mesh,
    flims: Tuple[float, float] = (14.0, 30.0),
    kernels: Dict[str, Dict] | None = None,
    win_size: float = 0.8,
    overlap_pct: float = 0.95,
    threshold: float = 14.0,
    max_peaks: int = 256,
    outputs: str = "full",
    time_axis: str = "time",
    channel_tile: int = 256,
):
    """The spectro step for a ``[channel x time]`` record whose TIME axis
    is split over ``time_axis`` (records longer than one card, the layout
    of ``timeshard.make_sharded_mf_step_time``): returns ``(step,
    names)``; ``step(local)`` takes this rank's ``[C, T/P]`` slice.

    Collectives: one ``psum``/``pmax`` pair for the global per-channel
    statistics, a ``halo_exchange`` of ``nperseg // 2`` samples, one
    ``pmax`` for the spectrogram maximum, ONE ``all_to_all`` into the
    channel-split layout. As in JAX, librosa's last centred frame is
    dropped (``ns // nhop`` frames), so frames within a kernel width of
    the record's end differ from the one-device detector's.

    ``outputs="full"``: ``(correlograms [nT, C/P, n_frames], picks)`` with
    the channels split over ``time_axis`` after the relabel; ``"picks"``:
    the picks alone. ``step.threshold`` is the absolute pick threshold."""
    if outputs not in ("full", "picks"):
        raise ValueError(f"outputs must be 'full' or 'picks', got {outputs!r}")
    meta = as_metadata(metadata)
    fs, ns = meta.fs, meta.ns
    kernels = kernels or {"HF": SPECTRO_HF_KERNEL, "LF": SPECTRO_LF_KERNEL}
    nperseg, nhop = _hop(win_size, overlap_pct, fs)
    p = mesh.axis_size(time_axis)
    if ns % p:
        raise ValueError(f"time length {ns} not divisible by mesh axis {time_axis}={p}")
    local = ns // p
    if local % nhop:
        raise ValueError(
            f"local shard length {local} must be a MULTIPLE of the frame "
            f"hop {nhop} (frame grid must align with shard boundaries)"
        )
    halo = nperseg // 2
    if halo >= local:
        raise ValueError(f"STFT halo {halo} must be < local shard length {local}")
    nt_total = ns // nhop
    designs, names = _design_kernels(fs, ns, flims, kernels, nperseg, nhop, nt_total + 1)
    on_dev = _on(designs, mesh.device)
    b0, b1 = min(d[1] for d in designs), max(d[2] for d in designs)

    def step(x):
        x = torch.as_tensor(x).to(mesh.device, torch.float32)
        if x.ndim != 2 or x.shape[-1] != local:
            raise ValueError(f"local record {tuple(x.shape)} is not [C, {local}] (this "
                             f"rank's time slice of {ns} samples)")
        mean = coll.psum(x.sum(dim=-1, keepdim=True), mesh, time_axis) / ns
        mx = coll.pmax(x.abs().amax(dim=-1, keepdim=True), mesh, time_axis)
        norm = (x - mean) / mx
        ext = halo_exchange(norm, halo, time_axis, mesh=mesh)   # [C, halo + local + halo]
        del norm
        # per channel tile: the frames' maximum over every bin, and the rows
        # of the kernels' bands (nothing past them is read again, so they
        # alone are kept and relabelled: the same values in fewer bytes)
        maxes, bands = [], []
        for i in range(0, ext.shape[0], channel_tile):
            mag = torch.abs(spectral.stft(ext[i:i + channel_tile], nperseg, nhop,
                                          center=False))[..., :local // nhop]
            maxes.append(mag.amax(dim=(-2, -1), keepdim=True))
            bands.append(mag[:, b0:b1])
            del mag
        del ext
        smax = coll.pmax(torch.cat(maxes), mesh, time_axis)
        pnorm = torch.cat(bands) / smax
        del bands
        pr = coll.all_to_all(pnorm, mesh, time_axis, split_axis=0, concat_axis=2)
        del pnorm                                # [C/P, b1 - b0, nt_total]
        corr = torch.stack([xcorr2d(pr[:, lo - b0:hi - b0, :], K)
                            for _, lo, hi, K in on_dev])
        del pr
        picks = peak_ops.find_peaks_sparse_batched(corr, float(threshold), max_peaks=max_peaks)
        if outputs == "picks":
            return picks
        return corr, picks

    step.mesh = mesh
    step.threshold = float(threshold)
    return step, names

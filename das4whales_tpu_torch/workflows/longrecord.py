"""Continuous long-record detection across file boundaries, on one
device (the port of ``das4whales_tpu.workflows.longrecord``).

Processed file by file, a call that straddles two files is split across
two windows and its matched-filter response never fully accumulates.
This workflow joins consecutive files along time into one ``[channel x
time]`` record and detects over the whole of it, so every former file
boundary is an interior sample.

The matched-filter family runs, on the record, what the JAX package's
time-sharded step runs on one device (``parallel/timeshard.py``,
``make_sharded_mf_step_time`` at one shard): on the raw wire the
per-file demean (``ops.conditioning.condition_segmented``), the f-k mask
times the zero-phase Butterworth gain in one 2-D FFT pass, the
true-length-template correlate, the Hilbert envelope, the threshold
``0.5 * max * factor``, the plain tiled picker
(``ops.peaks.find_peaks_sparse_tiled``, ``topk``, 512-row tiles — as in
JAX, the long record does not go through the pick kernel), then one
packed read of the picks (2^20 slots, the full grid on overflow). The
learned family scores the whole record with ``models.learned.
LearnedDetector`` (on the card its features launch the STFT kernel once)
and picks from the scores.

Picks come back with sample indices from the first file's start. Multi-
device meshes, the spectro and Gabor families and the staged (halo)
bandpass raise ``NotImplementedError`` naming the ROADMAP item
'Multi-GPU'. ``mf_engine`` goes through ``ops.mxu.resolve_mf_engine``
on the record's device, as the campaigns' detectors do (None: the FFT
route; ``"matmul-fused"`` has no bandpass FIR here and runs as the
float32 matmul, as in the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Sequence

import numpy as np
import torch

from .. import faults
from ..config import SCRIPT_FK, as_metadata
from ..config import not_in_slice as _not_in_slice
from ..io.stream import stream_strain_blocks
from ..models.matched_filter import design_matched_filter
from ..ops import conditioning, mxu, spectral, xcorr
from ..ops import fk as fk_ops
from ..ops import peaks as peak_ops
from ..ops.filters import butter_zero_phase_gain_full
from ..telemetry import trace as telemetry
from ..utils.device import resolve_device
from ..utils.log import get_logger

log = get_logger("das4whales_tpu_torch.workflows.longrecord")


@dataclass
class LongRecordResult:
    picks: Dict[str, np.ndarray]         # (2, n) [channel_idx, absolute_sample_idx]
    pick_times_s: Dict[str, np.ndarray]  # absolute seconds from the record's start
    thresholds: Dict[str, float]
    t0_utc: object
    n_samples: int
    n_files: int


def _pad_to_multiple(x: np.ndarray, mult: int) -> np.ndarray:
    pad = (-x.shape[-1]) % mult
    if pad:
        x = np.pad(x, ((0, 0), (0, pad)))
    return x


#: record-level pack capacity; counts above it take the exact full-grid
#: route (a module attribute, so a test can force the overflow)
_PICK_PACK_CAP = 1 << 20

#: the row tile of the long record's picker
PICK_TILE = 512


def _mesh_size(mesh) -> int:
    """Devices in ``mesh``: a count, a mesh object with ``devices``, or a
    sequence of devices."""
    if isinstance(mesh, int):
        return mesh
    devices = getattr(mesh, "devices", mesh)
    return int(np.size(np.asarray(devices, dtype=object)))


def _host_means(trace: np.ndarray, rows: int = 4096) -> np.ndarray:
    """Per-channel float32 means of a raw block, as the conditioned
    readers take them (the mean of a float32 copy), a row block at a time
    so the copy stays small."""
    return np.concatenate([trace[i:i + rows].astype(np.float32).mean(axis=1)
                           for i in range(0, trace.shape[0], rows)])


def _pack_record_picks(positions: torch.Tensor, selected: torch.Tensor, ns_eff: int,
                       capacity: int):
    """Pack the record's ``[nT, C, K]`` pick grid on the device in
    row-major order, dropping picks at or past ``ns_eff`` (divisibility
    padding)."""
    sel = selected & (positions < ns_eff)
    return peak_ops.compact_picks_rowmajor(positions, sel, capacity)


def _check_settings(family, wire, fam_kw, fused_bandpass, mesh):
    if family not in ("mf", "spectro", "gabor", "learned"):
        raise ValueError(f"unknown family {family!r}")
    if wire not in ("conditioned", "raw"):
        raise ValueError(f"unknown wire {wire!r}; expected 'conditioned' or 'raw'")
    if wire == "raw" and family != "mf":
        raise ValueError(
            "wire='raw' is wired into the flagship family only; the "
            "spectro/gabor/learned front ends consume conditioned strain"
        )
    if family == "mf" and fam_kw:
        raise ValueError(
            "family_kwargs only apply to family='spectro'/'gabor'/"
            f"'learned' — got {sorted(fam_kw)} with family='mf' (did you "
            "forget family=?)"
        )
    if family == "learned" and not ("model" in fam_kw or ("params" in fam_kw and "cfg" in fam_kw)):
        raise ValueError(
            "family='learned' needs family_kwargs={'model': <npz path>} "
            "(models.learned.save_params) or {'params': ..., 'cfg': ...}"
        )
    if family != "mf" and fused_bandpass:
        raise ValueError(
            "fused_bandpass applies to the flagship family only; the "
            "spectro/gabor front end designs its own bandpass"
        )
    if mesh is not None and _mesh_size(mesh) > 1:
        raise _not_in_slice("detect_long_record over a mesh of more than one device",
                            "Multi-GPU")
    if family in ("spectro", "gabor"):
        raise _not_in_slice(f"detect_long_record(family={family!r})", "Multi-GPU")
    if family == "mf" and not fused_bandpass:
        raise _not_in_slice("detect_long_record(fused_bandpass=False) (the halo bandpass)",
                            "Multi-GPU")


def detect_long_record(
    files: Sequence[str],
    selected_channels,
    metadata=None,
    *,
    mesh=None,
    time_axis: str = "time",
    halo: int = 512,
    engine: str = "auto",
    interrogator: str = "optasense",
    relative_threshold: float = 0.5,
    hf_factor: float | None = None,
    templates=None,
    bp_band=(14.0, 30.0),
    fk_config=None,
    max_peaks_per_channel: int = 512,
    family: str = "mf",
    fused_bandpass: bool | None = None,
    family_kwargs: dict | None = None,
    wire: str = "conditioned",
    mf_engine: str | None = None,
    design=None,
    device=None,
    stage_hook: Callable[[str], None] | None = None,
) -> LongRecordResult:
    """Detect calls over a continuous multi-file record on one device.

    ``files`` are consecutive segments of one recording; their join is
    treated as gapless. ``wire="raw"`` (matched filter only) streams the
    stored dtype and conditions on the device, subtracting each file's
    own host mean (the conditioned wire demeans file by file, so a
    whole-record demean would be the wrong map where files carry
    different DC offsets). ``family``: ``"mf"`` or ``"learned"``
    (``family_kwargs``: ``{"model": <npz path>}`` or ``{"params": ...,
    "cfg": ...}``, and ``"threshold"``). ``design`` takes a
    ``MatchedFilterDesign`` for the record's shape instead of designing
    one (the f-k design of a long record takes minutes on the host).
    ``device`` is where the record is detected (``None``: the card).
    ``stage_hook(name)`` is called after each stage (``read``,
    ``design``, ``condition``, ``mask``, ``fk``, ``correlate``, ``pick``,
    ``compact``; ``read``, ``score``, ``finalize`` for the learned
    family). ``mesh`` (one device only), ``time_axis`` and ``halo`` are
    the JAX signature's; ``halo`` has no effect on the fused route."""
    fam_kw = dict(family_kwargs or {})
    if fused_bandpass is None:
        fused_bandpass = family == "mf"
    _check_settings(family, wire, fam_kw, fused_bandpass, mesh)
    files = list(files)
    if not files:
        raise ValueError("need at least one file")
    dev = resolve_device(device)
    hook = stage_hook or (lambda name: None)

    with telemetry.span("longrecord.read", n_files=len(files), family=family):
        blocks = list(stream_strain_blocks(
            files, selected_channels, metadata, interrogator=interrogator, engine=engine,
            as_numpy=True, wire=wire,
        ))
    meta = as_metadata(blocks[0].metadata)
    record = np.concatenate([b.trace for b in blocks], axis=-1)
    n_samples = record.shape[-1]
    # the time shards' divisibility pad (one device: none)
    record = _pad_to_multiple(record, 1 if mesh is None else _mesh_size(mesh))
    nnx, nns = record.shape
    log.info("continuous record: %d files -> [%d x %d] (%.1f s)",
             len(files), nnx, nns, n_samples / meta.fs)
    x = torch.from_numpy(record).to(dev)
    hook("read")

    if family == "learned":
        return _learned_record(x, blocks, fam_kw, meta, n_samples, len(files), dev, hook)

    if design is None:
        design = design_matched_filter(
            (nnx, nns), blocks[0].selection.to_list(), meta,
            fk_config=fk_config or SCRIPT_FK, bp_band=bp_band, templates=templates,
        )
    elif tuple(design.trace_shape) != (nnx, nns) or design.fk_channels != nnx:
        raise ValueError(f"design for {tuple(design.trace_shape)} (f-k rows "
                         f"{design.fk_channels}) does not fit the record [{nnx} x {nns}]")
    hook("design")
    names = design.template_names
    fac, thr_scope = design.resolve_threshold_policy(hf_factor)
    engine, _why = mxu.resolve_mf_engine(mf_engine, design.trace_shape,
                                         *xcorr.padded_template_stats(design.templates),
                                         device=dev)
    picks_sp, thres = _mf_record_picks(x, blocks, design, meta, wire, fac, thr_scope,
                                       relative_threshold, max_peaks_per_channel, hook, engine)
    del x

    ns_eff = n_samples
    cap = min(int(np.prod(tuple(picks_sp.positions.shape[-2:]))), _PICK_PACK_CAP)
    with telemetry.span("longrecord.resolve", family=family, n_samples=n_samples):
        rows_d, times_d, cnt_d = _pack_record_picks(picks_sp.positions, picks_sp.selected,
                                                    ns_eff, cap)
        faults.count("syncs")
        packed = peak_ops.compacted_to_host(rows_d, times_d, cnt_d, cap)
        saturated = picks_sp.saturated.cpu().numpy()
        base = np.broadcast_to(thres.cpu().numpy().astype(np.float32), fac.shape)
    hook("compact")
    if packed is not None:
        rows_np, times_np, cnt = packed
        positions = selected = None
    else:  # pack overflow: the exact full-grid route
        positions = picks_sp.positions.cpu().numpy()
        selected = picks_sp.selected.cpu().numpy()
    picks, times_s, thr_out = {}, {}, {}
    for i, name in enumerate(names):
        if saturated[i].any():
            log.warning(
                "%s: peak capacity saturated on %d/%d channels; picks beyond "
                "the %d tallest per channel were dropped — raise "
                "max_peaks_per_channel to keep them",
                name, int(saturated[i].sum()), nnx, max_peaks_per_channel,
            )
        if positions is None:
            k = int(cnt[i])
            pk = np.asarray([rows_np[i, :k], times_np[i, :k]])
        else:
            pk = peak_ops.sparse_to_pick_times(positions[i],
                                               selected[i] & (positions[i] < ns_eff))
        picks[name] = pk
        times_s[name] = pk[1] / meta.fs
        thr_out[name] = float(base[i]) * float(fac[i])
    return LongRecordResult(picks=picks, pick_times_s=times_s, thresholds=thr_out,
                            t0_utc=blocks[0].t0_utc, n_samples=n_samples, n_files=len(files))


def _mf_record_correlograms(x, blocks, design, meta, wire, hook, engine="fft") -> torch.Tensor:
    """Conditioning (raw wire), the fused bandpass/f-k pass and the
    correlate on ``engine`` over the whole record: ``[nT, C, T]``
    correlograms."""
    dev = x.device
    nnx, nns = x.shape
    if wire == "raw":
        scales = {as_metadata(b.metadata).scale_factor for b in blocks}
        if len(scales) > 1:
            raise ValueError(
                f"wire='raw' conditions the record with one scale but the files "
                f"probed {sorted(scales)}; use wire='conditioned' for heterogeneous "
                "file sets"
            )
        seg_lens = [b.trace.shape[-1] for b in blocks]
        means = np.stack([_host_means(b.trace) for b in blocks], axis=1)
        seg_ids = np.full(nns, len(seg_lens), np.int64)
        seg_ids[: sum(seg_lens)] = np.repeat(np.arange(len(seg_lens)), seg_lens)
        means = np.concatenate([means, np.zeros((nnx, 1), np.float32)], axis=1)
        x = conditioning.condition_segmented(x, meta.scale_factor, seg_ids, means,
                                             dtype=torch.float32)
    hook("condition")

    # the f-k mask times |H(f)|^2 on the full grid, Hermitian-symmetrised
    # in fft order on both axes: float32 throughout, the JAX step's host
    # arithmetic (ops.fk.symmetrize_mask_fftorder) done on the device
    gain = butter_zero_phase_gain_full(nns, design.fs, design.bp_band, design.bp_order)
    mu = torch.fft.ifftshift(torch.as_tensor(design.fk_mask, device=dev)
                             * torch.as_tensor(gain, device=dev)[None, :], dim=(0, 1))
    mask_rows = 0.5 * (mu + fk_ops._point_reflect(mu))
    del mu
    hook("mask")
    s = torch.fft.fft(x, dim=0)
    del x
    s = torch.fft.fft(s, dim=1)
    s = s * mask_rows.to(s.real.dtype)
    del mask_rows
    s = torch.fft.ifft(s, dim=1)
    trf = torch.fft.ifft(s, dim=0).real.to(torch.float32)
    del s
    hook("fk")

    t_true, t_mu, t_scale = xcorr.padded_template_stats(design.templates)
    return mxu.correlograms_body(
        trf, torch.as_tensor(t_true, device=dev), torch.as_tensor(t_mu, device=dev),
        torch.as_tensor(t_scale, device=dev), engine)


def _mf_record_picks(x, blocks, design, meta, wire, fac, thr_scope, relative_threshold,
                     max_peaks, hook, engine="fft"):
    """The matched-filter step over the whole record: ``(SparsePicks
    [nT, C, K], threshold base)`` (a scalar under the global scope, one a
    template under ``per_template``)."""
    corr = _mf_record_correlograms(x, blocks, design, meta, wire, hook, engine)
    factors = torch.as_tensor(fac, device=corr.device)
    if thr_scope == "per_template":
        thres = relative_threshold * corr.amax(dim=(1, 2))
        thr = (thres * factors)[:, None, None]
    else:
        thres = relative_threshold * corr.amax()
        thr = thres * factors[:, None, None]
    hook("correlate")
    env = spectral.envelope_sqrt(corr, dim=-1)
    del corr
    picks = peak_ops.find_peaks_sparse_tiled(env, thr[..., 0], max_peaks=max_peaks,
                                             tile=PICK_TILE, method="topk")
    hook("pick")
    return picks, thres


def _learned_record(x, blocks, fam_kw, meta, n_samples, n_files, dev, hook):
    """The learned family over the whole record: the detector's scores
    (one STFT of every channel), then its threshold and per-channel NMS;
    picks past the real record are dropped."""
    from ..models import learned as _learned

    if "model" in fam_kw:
        params_l, cfg_l = _learned.load_params(fam_kw["model"])
    else:
        params_l, cfg_l = fam_kw["params"], fam_kw["cfg"]
    thr_l = float(fam_kw.get("threshold", 0.5))
    det = _learned.LearnedDetector(params_l, cfg_l, threshold=thr_l, device=dev)
    scores = det.scores(x).cpu().numpy()
    faults.count("syncs")
    hook("score")
    res = det.picks_from_scores(scores)
    pk = res.picks[det.name]
    pk = pk[:, pk[1] < n_samples]
    hook("finalize")
    return LongRecordResult(picks={det.name: pk}, pick_times_s={det.name: pk[1] / meta.fs},
                            thresholds={det.name: thr_l}, t0_utc=blocks[0].t0_utc,
                            n_samples=n_samples, n_files=n_files)

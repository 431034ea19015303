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

Picks come back with sample indices from the first file's start.

Over a device mesh (``mesh=``, a ``parallel.mesh.Mesh`` with a ``time``
axis; every rank calls this with the same arguments) the matched filter
runs ``parallel.timeshard.make_sharded_mf_step_time``: each rank reads
only the files that overlap its time slice of the record, conditions
(raw wire: the per-file host means of its own files), filters and
relabels, and picks its channel rows through the pick kernel (its
long-row form where a row of the record does not fit one CTA's shared
memory, ``timeshard.pick_route``); the packed picks are gathered, so every rank
returns the same result. The staged bandpass (``fused_bandpass=False``,
the halo exchange) runs there too, on one device as a mesh of one.

The spectro and Gabor families take the time-split front end (the halo
bandpass ``timeshard.sharded_bp_filt_time``, then the pencil f-k
``sharded_fk_apply_time`` on the ``hybrid_ninf`` mask) and then their own
time-split steps (``parallel.spectro.make_sharded_spectro_step_time``,
``parallel.gabor.make_sharded_gabor_step_time``) with ``outputs=
"picks"``, on the mesh or, without one, on a mesh of one (JAX's default
mesh of every device). The spectro record is padded to a multiple of
``P · nhop`` and its frame positions scaled by ``nhop``; both need the
channel count divisible by ``P``. Over a mesh the learned family
channel-shards the record (each rank reads its channel slice of every
file) and scores it through ``models.learned.make_sharded_inference`` on
a ``channel`` mesh of the same ranks; without a mesh it keeps its
one-device route.
``mf_engine`` goes through ``ops.mxu.resolve_mf_engine``
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
    #: ``keep_envelopes=True`` (spectro and Gabor): what the family picks on,
    #: this rank's channel rows ``[nT, C/P, n]`` as host numpy (the spectro
    #: correlograms, the Gabor correlograms' Hilbert envelopes), and the
    #: factor from its positions to samples (a pick's ``t // pos_scale``
    #: indexes ``envelopes``): the knife-edge margin of ``utils.parity``
    envelopes: np.ndarray | None = None
    pos_scale: int = 1


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


def _as_mesh(mesh, time_axis: str, device):
    """``mesh`` as a ``parallel.mesh.Mesh`` over ``time_axis``, or None
    for the one-device route: None (in a world of one) and 1 mean one
    device; None in a world of several ranks is every rank on one
    ``time`` axis, as JAX's default mesh spans every device."""
    from ..parallel.mesh import Mesh, make_mesh
    from ..parallel.timeshard import _world_size

    if isinstance(mesh, Mesh):
        if time_axis not in mesh.shape:
            raise ValueError(f"mesh {mesh.shape} has no axis {time_axis!r}")
        return mesh
    if mesh is None or (isinstance(mesh, int) and mesh == 1):
        n = _world_size()
        if n == 1:
            return None
        return make_mesh(shape=(n,), axis_names=(time_axis,),
                         devices=None if device is None else [str(device)] * n)
    raise ValueError(
        f"mesh={mesh!r}: pass a parallel.mesh.Mesh built by every rank "
        "(make_mesh(shape=(P,), axis_names=('time',)), one rank a device), "
        "or None / 1 for one device"
    )


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
    keep_envelopes: bool = False,
) -> LongRecordResult:
    """Detect calls over a continuous multi-file record on one device.

    ``files`` are consecutive segments of one recording; their join is
    treated as gapless. ``wire="raw"`` (matched filter only) streams the
    stored dtype and conditions on the device, subtracting each file's
    own host mean (the conditioned wire demeans file by file, so a
    whole-record demean would be the wrong map where files carry
    different DC offsets). ``family``: ``"mf"``, ``"spectro"`` (picks at
    frame resolution, converted to samples by the hop), ``"gabor"`` or
    ``"learned"`` (``family_kwargs``: ``{"model": <npz path>}`` or
    ``{"params": ..., "cfg": ...}``, and ``"threshold"``); the spectro and
    Gabor ``family_kwargs`` go to their step factories. ``design`` takes a
    ``MatchedFilterDesign`` for the record's (padded) shape instead of
    designing one (the f-k design of a long record takes minutes on the
    host); the spectro and Gabor families use its f-k mask.
    ``device`` is where the record is detected (``None``: the card).
    ``stage_hook(name)`` is called after each stage (``read``,
    ``design``, ``condition``, ``mask``, ``fk``, ``correlate``, ``pick``,
    ``compact``; ``read``, ``score``, ``finalize`` for the learned
    family; ``read``, ``design``, ``step``, ``compact`` over a mesh and
    for the spectro and Gabor families, with ``front`` (bandpass and f-k)
    before ``step``; ``read``, ``score``, ``compact`` for the learned
    family over a mesh).
    ``mesh`` is a ``parallel.mesh.Mesh`` with a ``time_axis`` (module
    docstring; its device is the record's); ``halo`` is the staged
    bandpass's exchange width and has no effect on the fused route.
    ``keep_envelopes`` (spectro and Gabor) runs the family's step with
    ``outputs="full"`` and returns what it picks on in ``envelopes``."""
    fam_kw = dict(family_kwargs or {})
    if fused_bandpass is None:
        fused_bandpass = family == "mf"
    files = list(files)
    if not files:
        raise ValueError("need at least one file")
    mesh = _as_mesh(mesh, time_axis, device)
    _check_settings(family, wire, fam_kw, fused_bandpass, mesh)
    if keep_envelopes and family not in ("spectro", "gabor"):
        raise ValueError(f"keep_envelopes applies to family='spectro'/'gabor', not {family!r}")
    hook = stage_hook or (lambda name: None)
    if family == "learned" and mesh is not None:
        return _learned_mesh_record(files, selected_channels, metadata, mesh, fam_kw,
                                    time_axis=time_axis, engine=engine,
                                    interrogator=interrogator, hook=hook)
    if family in ("spectro", "gabor") or (family == "mf" and (mesh is not None
                                                              or not fused_bandpass)):
        if mesh is None:
            from ..parallel.mesh import make_mesh

            mesh = make_mesh(shape=(1,), axis_names=(time_axis,),
                             devices=[str(resolve_device(device))])
    if family in ("spectro", "gabor"):
        return _family_record(files, selected_channels, metadata, mesh, family, fam_kw,
                              time_axis=time_axis, halo=halo, engine=engine,
                              interrogator=interrogator, relative_threshold=relative_threshold,
                              hf_factor=hf_factor, bp_band=bp_band, fk_config=fk_config,
                              max_peaks=max_peaks_per_channel, design=design, hook=hook,
                              keep_envelopes=keep_envelopes)
    if family == "mf" and mesh is not None:
        return _mesh_record(files, selected_channels, metadata, mesh, time_axis=time_axis,
                            halo=halo, engine=engine, interrogator=interrogator,
                            relative_threshold=relative_threshold, hf_factor=hf_factor,
                            templates=templates, bp_band=bp_band, fk_config=fk_config,
                            max_peaks=max_peaks_per_channel, fused_bandpass=fused_bandpass,
                            wire=wire, mf_engine=mf_engine, design=design, hook=hook)
    dev = resolve_device(device)

    with telemetry.span("longrecord.read", n_files=len(files), family=family):
        blocks = list(stream_strain_blocks(
            files, selected_channels, metadata, interrogator=interrogator, engine=engine,
            as_numpy=True, wire=wire,
        ))
    meta = as_metadata(blocks[0].metadata)
    record = np.concatenate([b.trace for b in blocks], axis=-1)
    n_samples = record.shape[-1]
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


def _read_time_slice(files, selected_channels, metadata, mesh, time_axis, *, engine,
                     interrogator, wire, pad_mult, family):
    """This rank's time slice ``[C, L]`` of the record (host numpy) over
    ``mesh``'s ``time_axis``: each rank reads only the files that overlap
    its slice; the record is zero-padded to a multiple of ``pad_mult``.
    Returns ``(local, specs, lens, n_samples, nns, blocks, t0)`` with
    ``blocks`` this rank's ``{file index: StrainBlock}`` and ``t0`` the
    first file's start where this rank read it (else None)."""
    from ..config import ChannelSelection
    from ..io.stream import _probe

    p = mesh.axis_size(time_axis)
    i = mesh.axis_index(time_axis)
    metas = (list(metadata) if isinstance(metadata, (list, tuple))
             else [metadata] * len(files))
    specs = [_probe(f, interrogator, m) for f, m in zip(files, metas)]
    meta = specs[0].meta
    lens = [int(sp_.meta.ns) for sp_ in specs]
    starts = np.concatenate([[0], np.cumsum(lens)])
    n_samples = int(starts[-1])
    nns = n_samples + (-n_samples) % pad_mult
    L = nns // p
    lo, hi = i * L, (i + 1) * L
    mine = [k for k in range(len(files)) if starts[k] < hi and starts[k + 1] > lo]
    with telemetry.span("longrecord.read", n_files=len(mine), family=family):
        blocks = dict(zip(mine, stream_strain_blocks(
            [files[k] for k in mine], selected_channels, [metas[k] for k in mine],
            interrogator=interrogator, engine=engine, as_numpy=True, wire=wire))) \
            if mine else {}
    nnx = ChannelSelection.from_list(selected_channels).n_channels(meta.nx)
    like = next(iter(blocks.values())).trace if blocks else np.zeros((nnx, 1), np.float32)
    local = np.zeros((nnx, L), like.dtype)
    for k, b in blocks.items():
        a, z = max(lo, starts[k]), min(hi, starts[k + 1])
        local[:, a - lo:z - lo] = b.trace[:, a - starts[k]:z - starts[k]]
    log.info("continuous record over %d ranks: %d files -> [%d x %d] (%.1f s), rank %d "
             "reads %d", p, len(files), nnx, nns, n_samples / meta.fs, i, len(mine))
    t0 = blocks[0].t0_utc if 0 in blocks else None
    return local, specs, lens, n_samples, nns, blocks, t0


def _gather_record_picks(sp_picks, names, mesh, time_axis, *, n_samples, pos_scale, rows,
                         max_peaks, t0):
    """This rank's ``[nT, C/P, K]`` picks of its channel rows packed on
    the device (positions at or past the record's end dropped, then
    scaled by ``pos_scale``), gathered from every rank in channel order.
    Returns ``({name: (2, n)}, t0 of the rank that read the first file)``."""
    from ..parallel import collectives as coll

    i = mesh.axis_index(time_axis)
    ns_eff = (n_samples - 1) // pos_scale + 1
    cap = min(int(np.prod(tuple(sp_picks.positions.shape[-2:]))), _PICK_PACK_CAP)
    with telemetry.span("longrecord.resolve", n_samples=n_samples):
        rows_d, times_d, cnt_d = _pack_record_picks(sp_picks.positions, sp_picks.selected,
                                                    ns_eff, cap)
        faults.count("syncs")
        packed = peak_ops.compacted_to_host(rows_d, times_d, cnt_d, cap)
        saturated = sp_picks.saturated.cpu().numpy()
    local_picks = {}
    for t, name in enumerate(names):
        if saturated[t].any():
            log.warning("%s: peak capacity saturated on %d/%d channels of rank %d; picks "
                        "beyond the %d tallest per channel were dropped — raise "
                        "max_peaks_per_channel to keep them", name, int(saturated[t].sum()),
                        rows, i, max_peaks)
        if packed is not None:
            rows_np, times_np, cnt = packed
            k = int(cnt[t])
            pk = np.asarray([rows_np[t, :k], times_np[t, :k]])
        else:   # pack overflow: the exact full-grid route
            pos = sp_picks.positions[t].cpu().numpy()
            sel = sp_picks.selected[t].cpu().numpy()
            pk = peak_ops.sparse_to_pick_times(pos, sel & (pos < ns_eff))
        local_picks[name] = np.asarray([pk[0] + i * rows, pk[1] * pos_scale])
    parts = sorted(coll.all_gather_object((i, local_picks, t0), mesh), key=lambda pt: pt[0])
    picks = {name: np.concatenate([pt[1][name] for pt in parts], axis=1).astype(np.int64)
             for name in names}
    return picks, next((pt[2] for pt in parts if pt[2] is not None), None)


def _check_design(design, nnx, nns):
    if tuple(design.trace_shape) != (nnx, nns) or design.fk_channels != nnx:
        raise ValueError(f"design for {tuple(design.trace_shape)} (f-k rows "
                         f"{design.fk_channels}) does not fit the record [{nnx} x {nns}]")


def _mesh_record(files, selected_channels, metadata, mesh, *, time_axis, halo, engine,
                 interrogator, relative_threshold, hf_factor, templates, bp_band, fk_config,
                 max_peaks, fused_bandpass, wire, mf_engine, design, hook):
    """The matched-filter record over a ``time`` mesh (module docstring):
    this rank's time slice of the record, the time-split step, the
    gathered picks."""
    from ..config import ChannelSelection
    from ..parallel.timeshard import make_sharded_mf_step_time

    p = mesh.axis_size(time_axis)
    local, specs, lens, n_samples, nns, blocks, blocks_t0 = _read_time_slice(
        files, selected_channels, metadata, mesh, time_axis, engine=engine,
        interrogator=interrogator, wire=wire, pad_mult=p, family="mf")
    meta = specs[0].meta
    nnx = local.shape[0]
    x = torch.from_numpy(local).to(mesh.device)
    del local
    hook("read")
    sel_list = ChannelSelection.from_list(selected_channels).to_list()
    if design is None:
        design = design_matched_filter((nnx, nns), sel_list, meta,
                                       fk_config=fk_config or SCRIPT_FK, bp_band=bp_band,
                                       templates=templates)
    else:
        _check_design(design, nnx, nns)
    hook("design")
    cond_kw = {}
    if wire == "raw":
        scales = {sp_.meta.scale_factor for sp_ in specs}
        if len(scales) > 1:
            raise ValueError(
                f"wire='raw' conditions the record with one scale but the files "
                f"probed {sorted(scales)}; use wire='conditioned' for heterogeneous "
                "file sets"
            )
        # per-file host means of this rank's own files (the columns of the
        # others are never indexed by its time slice)
        means = np.zeros((nnx, len(files)), np.float32)
        for k, b in blocks.items():
            means[:, k] = _host_means(b.trace)
        cond_kw = dict(scale_factor=meta.scale_factor, cond_segments=lens, cond_means=means)
    blocks.clear()
    fac, _scope = design.resolve_threshold_policy(hf_factor)
    resolved, _why = mxu.resolve_mf_engine(mf_engine, design.trace_shape,
                                           *xcorr.padded_template_stats(design.templates),
                                           device=mesh.device)
    step = make_sharded_mf_step_time(
        design, mesh, time_axis=time_axis, halo=halo, relative_threshold=relative_threshold,
        hf_factor=hf_factor, pick_mode="sparse", max_peaks=max_peaks,
        fused_bandpass=fused_bandpass, outputs="picks", pick_tile=PICK_TILE,
        wire=wire, mf_engine=resolved, **cond_kw)
    sp_picks, thres = step(x)
    del x
    hook("step")
    names = design.template_names
    base = np.broadcast_to(thres.detach().cpu().numpy().astype(np.float32), fac.shape)
    picks, t0 = _gather_record_picks(sp_picks, names, mesh, time_axis, n_samples=n_samples,
                                     pos_scale=1, rows=nnx // p, max_peaks=max_peaks,
                                     t0=blocks_t0)
    hook("compact")
    return LongRecordResult(
        picks=picks, pick_times_s={name: pk[1] / meta.fs for name, pk in picks.items()},
        thresholds={name: float(base[t]) * float(fac[t]) for t, name in enumerate(names)},
        t0_utc=t0, n_samples=n_samples, n_files=len(files))


def _family_record(files, selected_channels, metadata, mesh, family, fam_kw, *, time_axis,
                   halo, engine, interrogator, relative_threshold, hf_factor, bp_band,
                   fk_config, max_peaks, design, hook, keep_envelopes=False):
    """The spectro or Gabor record over a ``time`` mesh (module docstring):
    this rank's time slice, the halo bandpass and the pencil f-k, the
    family's time-split step, the gathered picks (and, ``keep_envelopes``,
    what the step picks on)."""
    from dataclasses import replace as _dc_replace

    from ..config import ChannelSelection
    from ..io.stream import _probe
    from ..parallel.timeshard import sharded_bp_filt_time, sharded_fk_apply_time

    p = mesh.axis_size(time_axis)
    pad_mult, nhop = p, None
    if family == "spectro":
        # each local shard a whole number of hops, from the knobs the step
        # factory will take (family_kwargs may set win_size/overlap_pct)
        meta0 = metadata[0] if isinstance(metadata, (list, tuple)) else metadata
        fs = _probe(files[0], interrogator, meta0).meta.fs
        nperseg = int(float(fam_kw.get("win_size", 0.8)) * fs)
        nhop = int(np.floor(nperseg * (1 - float(fam_kw.get("overlap_pct", 0.95)))))
        pad_mult = p * nhop
    local, specs, _lens, n_samples, nns, blocks, blocks_t0 = _read_time_slice(
        files, selected_channels, metadata, mesh, time_axis, engine=engine,
        interrogator=interrogator, wire="conditioned", pad_mult=pad_mult, family=family)
    blocks.clear()
    meta = specs[0].meta
    nnx = local.shape[0]
    if nnx % p:
        raise ValueError(
            f"family={family!r} relabels channels across the mesh: "
            f"channel count {nnx} must be divisible by {p}"
        )
    x = torch.from_numpy(local).to(mesh.device)
    del local
    hook("read")
    sel_list = ChannelSelection.from_list(selected_channels).to_list()
    if design is None:
        fk_cfg = fk_config or SCRIPT_FK
        fk_mask = fk_ops.hybrid_ninf_filter_design(
            (nnx, nns), sel_list, meta.dx, meta.fs, cs_min=fk_cfg.cs_min,
            cp_min=fk_cfg.cp_min, cp_max=fk_cfg.cp_max, cs_max=fk_cfg.cs_max,
            fmin=fk_cfg.fmin, fmax=fk_cfg.fmax).astype(np.float32)
    else:
        _check_design(design, nnx, nns)
        fk_mask = np.asarray(design.fk_mask, np.float32)
    hook("design")
    trf = sharded_fk_apply_time(
        sharded_bp_filt_time(x, mesh, meta.fs, bp_band[0], bp_band[1], halo=halo,
                             time_axis=time_axis),
        fk_mask, mesh, time_axis=time_axis)
    del x, fk_mask
    hook("front")
    meta_rec = _dc_replace(meta, nx=nnx, ns=nns)
    outputs = "full" if keep_envelopes else "picks"
    env = None
    if family == "spectro":
        from ..parallel.spectro import make_sharded_spectro_step_time

        step, names = make_sharded_spectro_step_time(
            meta_rec, mesh, outputs=outputs, max_peaks=max_peaks, time_axis=time_axis,
            **fam_kw)
        sp_picks = step(trf)
        if keep_envelopes:
            corr, sp_picks = sp_picks
            env = corr.cpu().numpy()
            del corr
        thresholds = {name: step.threshold for name in names}
        pos_scale = nhop
    else:
        from ..parallel.gabor import make_sharded_gabor_step_time

        # the original selection sets the Gabor angle only; the record's row
        # count drives the validation; the family keeps its HF/LF factor pair
        hf_leg = 0.9 if hf_factor is None else float(hf_factor)
        step, names = make_sharded_gabor_step_time(
            meta_rec, sel_list, mesh, relative_threshold=relative_threshold,
            hf_factor=hf_leg, max_peaks=max_peaks, time_axis=time_axis, n_channels=nnx,
            outputs=outputs, **fam_kw)
        if keep_envelopes:
            from ..ops import spectral

            corr, sp_picks, thres = step(trf)
            env = torch.stack([spectral.envelope_sqrt(c) for c in corr]).cpu().numpy()
            del corr
        else:
            sp_picks, thres = step(trf)
        base = float(thres)
        thresholds = {name: base * (hf_leg if name == "HF" else 1.0) for name in names}
        pos_scale = 1
    del trf
    hook("step")
    picks, t0 = _gather_record_picks(sp_picks, names, mesh, time_axis, n_samples=n_samples,
                                     pos_scale=pos_scale, rows=nnx // p, max_peaks=max_peaks,
                                     t0=blocks_t0)
    hook("compact")
    return LongRecordResult(
        picks=picks, pick_times_s={name: pk[1] / meta.fs for name, pk in picks.items()},
        thresholds=thresholds, t0_utc=t0, n_samples=n_samples, n_files=len(files),
        envelopes=env, pos_scale=pos_scale)


def _learned_mesh_record(files, selected_channels, metadata, mesh, fam_kw, *, time_axis,
                         engine, interrogator, hook):
    """The learned record over a mesh (module docstring): the record
    channel-sharded over a ``channel`` mesh of the same ranks, each rank
    reading its channel slice of every file (the record zero-padded to a
    multiple of ``P`` samples, as in JAX), scored through
    ``make_sharded_inference``; each rank's threshold and NMS on the host,
    padding picks dropped, the picks gathered in channel order."""
    from ..config import ChannelSelection
    from ..io.stream import _local_selection, _probe
    from ..models import learned as _learned
    from ..parallel import collectives as coll
    from ..parallel.mesh import channel_sharding, flat_mesh

    if "model" in fam_kw:
        params_l, cfg_l = _learned.load_params(fam_kw["model"])
    else:
        params_l, cfg_l = fam_kw["params"], fam_kw["cfg"]
    thr_l = float(fam_kw.get("threshold", 0.5))
    cmesh = flat_mesh(mesh, "channel")
    p = cmesh.size
    meta0 = metadata[0] if isinstance(metadata, (list, tuple)) else metadata
    first = _probe(files[0], interrogator, meta0)
    sel = ChannelSelection.from_list(selected_channels)
    nnx = sel.n_channels(first.meta.nx)
    if nnx % p:
        raise ValueError(f"family='learned' channel-shards the record: channel count {nnx} "
                         f"must be divisible by {p}")
    local_sel = _local_selection(sel, first.meta.nx, channel_sharding(cmesh), 0)
    with telemetry.span("longrecord.read", n_files=len(files), family="learned"):
        blocks = list(stream_strain_blocks(files, local_sel.to_list(), metadata,
                                           interrogator=interrogator, engine=engine,
                                           as_numpy=True))
    meta = as_metadata(blocks[0].metadata)
    record = np.concatenate([b.trace for b in blocks], axis=-1)
    t0 = blocks[0].t0_utc
    del blocks
    n_samples = record.shape[-1]
    record = _pad_to_multiple(record, p)
    score_fn, _put = _learned.make_sharded_inference(params_l, cfg_l, cmesh)
    x = torch.from_numpy(record).to(cmesh.device)
    del record
    hook("read")
    scores = score_fn(x).cpu().numpy()
    del x
    faults.count("syncs")
    hook("score")
    det = _learned.LearnedDetector(params_l, cfg_l, threshold=thr_l, device="cpu")
    pk = det.picks_from_scores(scores).picks[det.name]
    pk = pk[:, pk[1] < n_samples]
    i = cmesh.axis_index("channel")
    parts = sorted(coll.all_gather_object((i, pk + np.array([[i * (nnx // p)], [0]])), cmesh),
                   key=lambda pt: pt[0])
    picks = np.concatenate([pt[1] for pt in parts], axis=1).astype(np.int64)
    hook("compact")
    return LongRecordResult(picks={det.name: picks}, pick_times_s={det.name: picks[1] / meta.fs},
                            thresholds={det.name: thr_l}, t0_utc=t0, n_samples=n_samples,
                            n_files=len(files))


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

"""Sharded matched-filter detection steps over a ``(file, channel)`` mesh
(the port of ``das4whales_tpu.parallel.pipeline``).

Every rank runs the whole detection pipeline on its LOCAL slice ``[B/Pf,
C/Pc, T]`` of a ``[file x channel x time]`` batch: data parallelism over
files, channel parallelism within a file, with the two ``all_to_all``
transposes of the distributed f-k transform (``parallel.fft``) and one
``pmax`` for the per-file threshold as the only communication.

The sparse picks go through the pick kernel, as on one card: per
``pick_tile`` channel rows the Hilbert analytic signal and
``ops.fused_picks.analytic_envelope_peaks`` (the hand-written
counterpart of the JAX package's Pallas ``_picks_kernel``; JAX's body
computes the same function with ``ops.peaks.find_peaks_sparse_tiled`` on
the envelope), one launch a tile for every template and file of the
shard. The plain version runs only on the CPU.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models.matched_filter import mf_correlate_tiled, mf_envelope_tiled, mf_pick_tiled
from ..ops import conditioning as cond_ops
from ..ops import peaks as peak_ops
from ..ops import xcorr
from ..ops.filters import butter_zero_phase_gain_full, fft_zero_phase_apply
from . import collectives as coll
from .fft import fk_apply_local_banded, prepare_mask_band
from .mesh import Mesh, Sharding


def _bp_local(trace: torch.Tensor, gain: torch.Tensor, padlen: int) -> torch.Tensor:
    """Zero-phase bandpass along time (local to every shard)."""
    return fft_zero_phase_apply(trace, gain, padlen)


def _mf_body(trace, mask_band, bp_gain, templates_true, template_mu, template_scale,
             cond_scale, *, mesh: Mesh, band_lo: int, band_hi: int, bp_padlen: int,
             channel_axis: str, relative_threshold: float, threshold_factors,
             pick_mode: str, max_peaks: int, outputs: str = "full", fused: bool = False,
             pick_tile: int = 512, pick_method: str = "topk", condition: bool = False,
             threshold_scope: str = "global"):
    """The step on one rank. Local shapes: trace ``[B/Pf, C/Pc, T]``,
    mask_band ``[K, Bpad/Pc]`` (this rank's in-band columns), bp_gain
    ``[Fext]``, templates_true ``[nT, m]``. Returns ``(picks, thres)``
    or ``(trf_fk, corr, env, picks, thres)``, all local."""
    if condition:
        # the raw wire: time is whole on every rank, so the per-channel
        # demean is local (ops.conditioning)
        trace = cond_ops.condition(trace, cond_scale, dtype=templates_true.dtype)
    tr_bp = trace if fused else _bp_local(trace, bp_gain, bp_padlen)
    del trace
    trf_fk = fk_apply_local_banded(tr_bp, mask_band, band_lo, band_hi, channel_axis,
                                   mesh=mesh)
    del tr_bp
    tiles, gmax = mf_correlate_tiled(trf_fk, templates_true, template_mu, template_scale,
                                     pick_tile)                    # gmax [nT, B/Pf]
    factors = torch.as_tensor(threshold_factors, dtype=torch.float32, device=gmax.device)
    if threshold_scope == "per_template":
        # each template's base from its own per-file max over the shards
        thres = relative_threshold * coll.pmax(gmax, mesh, channel_axis)    # [nT, B/Pf]
        thr = thres * factors[:, None]
    else:
        # one max over templates, channels and time couples the templates
        file_max = coll.pmax(gmax.amax(dim=0), mesh, channel_axis)           # [B/Pf]
        thres = relative_threshold * file_max
        thr = thres[None, :] * factors[:, None]
    if outputs == "full":
        corr = torch.cat(tiles, dim=-2)
        env = mf_envelope_tiled(tiles)
    if pick_mode == "sparse":
        # time is whole here, so positions are global sample indices
        picks = mf_pick_tiled(tiles, thr, max_peaks, pick_method, release=True)
    else:
        # the dense debug route: exact per-sample prominences
        env_d = env if outputs == "full" else mf_envelope_tiled(tiles)
        picks = peak_ops.local_maxima(env_d) & (
            peak_ops.peak_prominences_dense(env_d) >= thr[..., None, None])
        del env_d
    del tiles
    if outputs == "picks":
        return picks, thres
    return trf_fk, corr, env, picks, thres


def make_sharded_mf_step(
    design,
    mesh: Mesh,
    file_axis: str = "file",
    channel_axis: str = "channel",
    relative_threshold: float = 0.5,
    hf_factor: float | None = None,
    threshold_factors=None,
    threshold_scope: str | None = None,
    pick_mode: str = "sparse",
    max_peaks: int = 256,
    outputs: str = "full",
    fused_bandpass: bool = True,
    pick_tile: int = 512,
    pick_method: str = "topk",
    wire: str = "conditioned",
    scale_factor: float | None = None,
) -> Callable:
    """Build the multi-device detection step for a ``[file x channel x
    time]`` batch. Every rank calls the returned ``step(local_batch)``
    with its slice ``[B/Pf, C/Pc, T]`` (:func:`input_sharding`), on its
    device, and gets its local outputs.

    ``outputs="full"``: ``(trf_fk [B/Pf, C/Pc, T], corr, env [nT, B/Pf,
    C/Pc, T], picks, thresholds)``; ``outputs="picks"``: ``(picks,
    thresholds)`` (the campaigns' mode: no correlogram outlives its tile).
    ``pick_mode="sparse"`` gives an ``ops.peaks.SparsePicks`` of ``[nT,
    B/Pf, C/Pc, K]`` slots and a ``[nT, B/Pf, C/Pc]`` ``saturated`` flag,
    through the pick kernel in ``pick_tile``-row tiles (``pick_method``
    ``"pack"``/``"topk"``); ``"dense"`` the boolean peak mask.
    The thresholds are the pre-factor base: ``[B/Pf]`` under the
    reference's global scope, ``[nT, B/Pf]`` under a bank's
    ``per_template`` scope, each a ``pmax`` over the channel shards.

    ``fused_bandpass=True`` folds ``|H(f)|²`` into the f-k mask before the
    band crop (the multi-device analog of ``MatchedFilterDetector(
    fused_bandpass=True)``); ``False`` runs the staged bandpass first.
    ``wire="raw"`` takes the stored-dtype counts and conditions them on
    each rank with ``scale_factor`` (required then). The campaigns run
    the adaptive pair of this step (``workflows.campaign.
    _adaptive_sharded_steps``): ``pack`` at K0 = 64, then ``topk`` at
    ``max_peaks`` when any row of any rank saturated. The step carries
    this rank's banded mask (``step.mask_band``) and its rFFT band
    (``step.band``): the bandpass gain is folded in before the band crop,
    as in the JAX package's step."""
    if pick_mode not in ("sparse", "dense"):
        raise ValueError(f"pick_mode must be 'sparse' or 'dense', got {pick_mode!r}")
    if outputs not in ("full", "picks"):
        raise ValueError(f"outputs must be 'full' or 'picks', got {outputs!r}")
    if wire not in ("conditioned", "raw"):
        raise ValueError(f"unknown wire {wire!r}; expected 'conditioned' or 'raw'")
    if wire == "raw" and scale_factor is None:
        raise ValueError("wire='raw' needs scale_factor (metadata.scale_factor)")
    nnx, nns = design.trace_shape
    if design.fk_channels != nnx:
        raise ValueError(
            "channel-padded designs (design_matched_filter(channel_pad=...)) "
            "are single-device only; design without padding for the sharded step"
        )
    pc = mesh.axis_size(channel_axis)
    if nnx % pc:
        raise ValueError(f"channels {nnx} not divisible by {channel_axis}={pc}")
    fk_mask = design.fk_mask
    if fused_bandpass:
        gain_full = butter_zero_phase_gain_full(nns, design.fs, design.bp_band,
                                                design.bp_order)
        fk_mask = fk_mask * gain_full[None, :].astype(fk_mask.dtype)
    mask_band_np, band_lo, band_hi = prepare_mask_band(fk_mask, pc)
    dev = mesh.device
    mask_band = Sharding(mesh, (None, channel_axis)).place(mask_band_np).to(torch.float32)
    bp_gain = torch.as_tensor(design.bp_gain, device=dev)
    templates_true, template_mu, template_scale = xcorr.padded_template_stats_device(
        design.templates, dev)
    factors_np, thr_scope = design.resolve_threshold_policy(
        hf_factor, threshold_factors, threshold_scope)
    cond_scale = 0.0 if scale_factor is None else scale_factor
    kw = dict(mesh=mesh, band_lo=band_lo, band_hi=band_hi, bp_padlen=design.bp_padlen,
              fused=fused_bandpass, channel_axis=channel_axis,
              relative_threshold=relative_threshold, threshold_factors=factors_np,
              threshold_scope=thr_scope, pick_mode=pick_mode, max_peaks=max_peaks,
              outputs=outputs, pick_tile=pick_tile, pick_method=pick_method,
              condition=wire == "raw")
    c_local = nnx // pc

    def step(trace_batch):
        x = torch.as_tensor(trace_batch).to(dev)
        if x.ndim != 3 or tuple(x.shape[1:]) != (c_local, nns):
            raise ValueError(f"local batch {tuple(x.shape)} is not [B/Pf, {c_local}, {nns}] "
                             f"(this rank's slice of the {nnx}-channel design)")
        return _mf_body(x, mask_band, bp_gain, templates_true, template_mu, template_scale,
                        cond_scale, **kw)

    step.mesh = mesh
    step.mask_band = mask_band
    step.band = (band_lo, band_hi)
    step.threshold_scope = thr_scope
    step.pick_method = pick_method
    step.max_peaks = max_peaks
    return step


def input_sharding(mesh: Mesh, file_axis: str = "file",
                   channel_axis: str = "channel") -> Sharding:
    """The step's input layout: a ``[file x channel x time]`` batch split
    over both axes (each rank's slice, ``parallel.mesh.Sharding``)."""
    return Sharding(mesh, (file_axis, channel_axis, None))


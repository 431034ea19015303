"""Matched-filter whale-call detector: the one-program path in PyTorch.

The port of ``das4whales_tpu.models.matched_filter``'s main path:
``MatchedFilterDetector.detect_picks`` -> ``dispatch_picks`` ->
``mf_detect_picks_program``, which runs

1. raw-wire conditioning (``ops.conditioning``);
2. the bandpass folded into the banded f-k mask, one rfft-in-time /
   FFT-in-channel pass (``mf_filter_fused`` -> ``ops.fk``), or with
   ``fused_bandpass=False`` the staged bandpass — odd extension, its own
   rfft round trip — ahead of the f-k pass (``mf_filter_only``);
3. the channel-tiled corrected correlograms (``mf_correlate_tiled`` ->
   ``ops.xcorr``);
4. the in-graph threshold ``0.5 * max * factor``;
5. the Hilbert analytic signal (``ops.spectral``);
6. the fused pick kernel (``ops.fused_picks``), at K0 = 64 with
   ``"pack"`` and again at K = 256 with ``"topk"`` when a row saturates;
7. row-major compaction (``ops.peaks.compact_picks_rowmajor``),

with ``with_health=True`` preceded by the data-health stats of the input
block (``ops.health``), eagerly on torch tensors: JAX's ``jit`` becomes
an eager call and its ``lax.map`` over channel tiles a Python loop. On a
``[B, C, T]`` stack the program runs every stage over the file axis at
once (the batched route, ``parallel.batch``). Each attempt ends in ONE
device->host copy of the packed ``(chan, times, count, sat_count, thr)``
and, with ``with_health=True``, the health rows (counted in
``MatchedFilterDetector.syncs``); nothing before it reads a device value
on the host. On the card that copy is queued right behind the program,
into pinned memory with an event after it (:class:`PackedFetch`), so a
later resolve waits on that event alone while the programs dispatched
after it keep the card busy (the campaign's pipelined dispatch).

``MatchedFilterDetector.__call__`` is the full-artifact route of the
reference's ``main_mfdetect.py``: it keeps the filtered block
(``trf_fk``), the correlograms and, with ``with_snr=True``, the envelope
SNR matrices, and picks in one of three modes (``pick_mode``): ``sparse``
(the pick kernel through ``fused_picks.analytic_envelope_peaks``, the
default on the card), ``scipy`` (per-channel scipy on the host, the
default on the CPU) or ``dense`` (every sample's exact prominence,
``ops.peaks.find_peaks_prominence_blocked``). Untiled it correlates at
the trace length (``_call_full``); past the memory budget it walks
channel tiles (``_call_tiled``) with the threshold computed on the host
from the tiles' maxima. In the campaign configuration (``sparse``,
``keep_correlograms=False``, no SNR) it is ``detect_picks``.

``design_matched_filter(channel_pad=...)`` designs the f-k mask on a
channel axis padded to a 5-smooth length (``"auto"``) or a given one;
every filter variant pads the block with silent channels before the
channel FFT and crops after (``_fk_apply_padded``).

The resource ladder's rung views share the design: ``tiled_view`` is a
shallow copy with channel-tiled correlation, ``host_view`` the same
detector built with ``device="cpu"``, and ``bank_view(lo, hi)`` a shallow
copy on the sub-bank ``[lo:hi)`` that slices the parent's template
tensors (``split_views`` halves a bank with decoupled thresholds, the
ladder's bank-split rung).

The correlate and f-k stages run on the engines of ``ops.mxu``:
``mf_engine`` ``"fft"`` (the default), ``"matmul"`` (the correlate as a
``F.conv1d`` contraction), ``"matmul-bf16"`` and ``"matmul-fused"``
(gated: an ineligible shape falls back to ``"matmul"``), and
``fk_engine`` ``"fft"`` or ``"matmul"`` (the channel transforms as
``[C, C]`` DFT products); ``"auto"`` runs the calibrated router. The
tap-folded engine carries the bandpass in its taps, so its program
applies the GAINLESS f-k mask and skips the staged bandpass; the staged
routes (``__call__``'s tiled correlate) correlate an already bandpassed
block and run it as ``"matmul"``. ``condition_input`` and
``filter_block`` are the prefilter the other detector families share
(``workflows.common``).
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, NamedTuple

import numpy as np
import scipy.signal as sp
import torch

from ..config import (  # noqa: F401 — FIN_LF_NOTE, CallTemplateConfig: the JAX module's names
    FIN_HF_NOTE,
    FIN_LF_NOTE,
    SCRIPT_FK,
    CallTemplateConfig,
    ChannelSelection,
    FkFilterConfig,
    as_metadata,
)
from ..config import hbm_budget_bytes as _default_hbm_budget_bytes
from ..ops import conditioning, fused_picks, mxu, spectral, xcorr
from ..ops import health as health_ops
from ..ops import fk as fk_ops
from ..ops import peaks as peak_ops
from ..ops.filters import butter_zero_phase_fir, butter_zero_phase_gain, fft_zero_phase_apply
from ..ops.filters import zero_phase_gain  # noqa: F401 — the JAX module's name
from ..utils.checkpoint import register_design
from ..utils import oprecord
from ..utils.device import resolve_device
from ..utils.views import _VIEW_CACHE_ATTRS, cached_shallow_view
from .templates import TemplateBank, gen_template_fincall, resolve_bank  # noqa: F401

#: The reference threshold policy: ``thres = REL_THRESHOLD * max``, scaled
#: per template by its factor; HF_FACTOR is the HF fin note's factor.
REL_THRESHOLD = 0.5
HF_FACTOR = FIN_HF_NOTE.threshold_factor


def reference_threshold_factors(n_templates: int) -> np.ndarray:
    """The pre-bank factor vector: first template at ``HF_FACTOR``, the
    rest at 1.0 (float32)."""
    fac = np.ones((n_templates,), np.float32)
    fac[0] = HF_FACTOR
    return fac


@register_design
@dataclass
class MatchedFilterDesign:
    """Precomputed, shape-specific design artifacts (host numpy)."""

    fk_mask: np.ndarray          # [channel x time] fftshifted mask
    bp_gain: np.ndarray          # rFFT |H(f)|^2 zero-phase bandpass gain
    bp_padlen: int
    templates: np.ndarray        # [n_templates x time]
    template_names: tuple
    trace_shape: tuple
    fs: float = 200.0
    bp_band: tuple = (14.0, 30.0)
    bp_order: int = 8
    fk_channels: int = 0
    threshold_factors: np.ndarray | None = None
    threshold_scope: str = "global"

    def __post_init__(self):
        if not self.fk_channels:
            self.fk_channels = self.fk_mask.shape[0]
        if self.threshold_factors is None:
            self.threshold_factors = reference_threshold_factors(self.templates.shape[0])

    def resolve_threshold_policy(self, hf_factor=None, threshold_factors=None,
                                 threshold_scope=None):
        """The one resolution of the bank threshold policy: ``(factors [nT]
        float32, scope)``. An explicit legacy ``hf_factor`` rebuilds the
        index-0-is-HF vector and pins the global scope (unless
        ``threshold_scope`` overrides); an explicit ``threshold_factors``
        vector comes next; else the design's own vector and scope."""
        n = self.templates.shape[0]
        if hf_factor is not None:
            fac = np.ones(n, np.float32)
            fac[0] = float(hf_factor)
            scope = threshold_scope or "global"
        elif threshold_factors is not None:
            fac = np.asarray(threshold_factors, np.float32)
            scope = threshold_scope or self.threshold_scope
        else:
            fac = np.asarray(self.threshold_factors, np.float32)
            scope = threshold_scope or self.threshold_scope
        if fac.shape != (n,):
            raise ValueError(f"threshold factors shape {fac.shape} != ({n},)")
        if scope not in ("global", "per_template"):
            raise ValueError(
                f"unknown threshold_scope {scope!r}; expected 'global' or 'per_template'"
            )
        return fac, scope

    def sparsity_report(self, verbose: bool = False) -> dict:
        """Dense against sparse storage of the f-k mask (host numpy)."""
        return fk_ops.compression_report(self.fk_mask, verbose=verbose)


def design_matched_filter(trace_shape, selected_channels, metadata,
                          fk_config: FkFilterConfig = SCRIPT_FK,
                          bp_band=(14.0, 30.0), templates=None,
                          channel_pad=None) -> MatchedFilterDesign:
    """Design the pipeline for one block shape: the hybrid_ninf f-k mask
    with the script fan, the 14-30 Hz Butterworth-8 zero-phase gain and
    the template bank's ``[T, time]`` stack with its threshold policy.

    ``channel_pad`` pads the f-k transform's CHANNEL axis: ``"auto"`` to
    the next 5-smooth length (22050 = 2·3²·5²·7² becomes 22500 =
    2²·3²·5⁴), an int to that length, ``None`` keeps the count. The mask
    is designed on the padded wavenumber grid (``fk_channels`` rows); the
    filter pads the block with silent channels and crops after, which
    changes only the circular wrap at the array's ends."""
    meta = as_metadata(metadata)
    sel = ChannelSelection.from_list(selected_channels)
    bank = resolve_bank(templates)
    if channel_pad == "auto":
        fk_channels = xcorr.next_fast_len(trace_shape[0])
    elif channel_pad:
        if int(channel_pad) < trace_shape[0]:
            raise ValueError(f"channel_pad={channel_pad} < channel count {trace_shape[0]}")
        fk_channels = int(channel_pad)
    else:
        fk_channels = trace_shape[0]
    mask = fk_ops.hybrid_ninf_filter_design(
        (fk_channels, trace_shape[1]), sel.to_list(), meta.dx, meta.fs,
        cs_min=fk_config.cs_min, cp_min=fk_config.cp_min,
        cp_max=fk_config.cp_max, cs_max=fk_config.cs_max,
        fmin=fk_config.fmin, fmax=fk_config.fmax,
    )
    sos = sp.butter(8, [bp_band[0] / (meta.fs / 2), bp_band[1] / (meta.fs / 2)], "bp", output="sos")
    padlen = 3 * (2 * len(sos) + 1)
    bp_gain = butter_zero_phase_gain(trace_shape[1] + 2 * padlen, meta.fs, bp_band)
    return MatchedFilterDesign(
        fk_mask=mask.astype(np.float32),
        bp_gain=bp_gain.astype(np.float32),
        bp_padlen=padlen,
        templates=bank.compile(trace_shape[1], meta.fs),
        template_names=bank.names,
        trace_shape=tuple(trace_shape),
        fs=float(meta.fs),
        bp_band=(float(bp_band[0]), float(bp_band[1])),
        fk_channels=fk_channels,
        threshold_factors=bank.threshold_factors(),
        threshold_scope=bank.threshold_scope,
    )


def _fk_apply_padded(x: torch.Tensor, mask_band: torch.Tensor, band_lo: int,
                     band_hi: int, pad_rows: int, fk_engine: str = "fft",
                     fk_dft=None) -> torch.Tensor:
    """The banded f-k apply of every filter variant on ``fk_engine``
    (``ops.mxu.fk_apply_body``; ``fk_dft`` the matmul engine's ``(wr,
    wi)`` pair): ``pad_rows`` silent channels appended on ``dim=-2`` (the
    mask's ``fk_channels`` rows), the banded apply, and the crop back to
    the real channels."""
    if not pad_rows:
        return mxu.fk_apply_body(x, mask_band, band_lo, band_hi, fk_engine, fk_dft)
    C = x.shape[-2]
    x = torch.nn.functional.pad(x, (0, 0, 0, pad_rows))
    return mxu.fk_apply_body(x, mask_band, band_lo, band_hi, fk_engine, fk_dft)[..., :C, :]


def mf_filter_fused(trace: torch.Tensor, fused_mask_band: torch.Tensor,
                    band_lo: int, band_hi: int, pad_rows: int = 0, fk_engine: str = "fft",
                    fk_dft=None) -> torch.Tensor:
    """Bandpass ∘ f-k filter as ONE banded spectral multiply: the mask
    carries ``|H(f)|^2`` folded in (circular edges, as in the JAX
    package's fused route). ``pad_rows``: the padded design's silent
    channels (:func:`_fk_apply_padded`)."""
    return _fk_apply_padded(trace, fused_mask_band, band_lo, band_hi, pad_rows, fk_engine,
                            fk_dft)


def mf_filter_only(trace: torch.Tensor, fk_mask_band: torch.Tensor, bp_gain: torch.Tensor,
                   band_lo: int, band_hi: int, bp_padlen: int,
                   pad_rows: int = 0, fk_engine: str = "fft", fk_dft=None) -> torch.Tensor:
    """The staged bandpass, then the banded f-k filter: odd extension by
    ``bp_padlen``, one rfft round trip times ``bp_gain`` (the rFFT bins of
    the extended length), crop, then the f-k pass on the gainless mask
    (padded by ``pad_rows`` channels, :func:`_fk_apply_padded`)."""
    tr_bp = fft_zero_phase_apply(trace, bp_gain, bp_padlen)
    return _fk_apply_padded(tr_bp, fk_mask_band, band_lo, band_hi, pad_rows, fk_engine,
                            fk_dft)


def mf_filter_and_correlate(trace: torch.Tensor, fk_mask, bp_gain: torch.Tensor,
                            templates: torch.Tensor, bp_padlen: int):
    """The untiled bandpass -> f-k -> correlograms core of the reference's
    ``main_mfdetect.py:53-80``: the staged bandpass (odd extension by
    ``bp_padlen``, one rfft round trip times ``bp_gain``), the f-k filter
    on the whole fftshifted ``fk_mask`` (``ops.fk.fk_filter_apply_rfft``)
    and the correlograms against ``templates``
    (``ops.xcorr.compute_cross_correlograms_multi``). Returns ``(trf_fk,
    correlograms [n_templates, channel, time])``. A channel-padded
    design is refused, as in the JAX package."""
    if fk_mask.shape[0] != trace.shape[0]:
        raise ValueError(
            f"fk_mask has {fk_mask.shape[0]} channel rows but trace has "
            f"{trace.shape[0]}; channel-padded designs "
            f"(design_matched_filter(channel_pad=...)) are not supported by "
            f"this legacy entry point — use MatchedFilterDetector"
        )
    trf_fk = fk_ops.fk_filter_apply_rfft(fft_zero_phase_apply(trace, bp_gain, bp_padlen),
                                         fk_mask)
    return trf_fk, xcorr.compute_cross_correlograms_multi(trf_fk, templates)


def mf_correlate_tiled(trf_fk: torch.Tensor, templates_true: torch.Tensor,
                       mu: torch.Tensor, scale: torch.Tensor, tile: int,
                       mf_engine: str = "fft", fused=None, fir_half: int = 0):
    """Correlograms of ``trf_fk [..., C, n]`` over channel tiles, one tile
    at a time (the JAX package's ``lax.map``, here a Python loop; a
    leading axis stacks files), on ``mf_engine`` (``ops.mxu.
    correlograms_body``; ``fused``/``fir_half`` the tap-folded engine's
    pair and FIR half-length). Returns ``(corr_tiles, gmax)``: a list of
    ``[nT, ..., rows, n]`` tiles (the last one ragged — no padding rows)
    and each template's max over all channels ``[nT, ...]``."""
    C = trf_fk.shape[-2]
    tiles, maxes = [], []
    for lo in range(0, C, tile):
        corr = mxu.correlograms_body(
            trf_fk[..., lo : lo + tile, :], templates_true, mu, scale, mf_engine,
            fused=fused, fir_half=fir_half,
        )
        tiles.append(corr)
        maxes.append(corr.amax(dim=(-2, -1)))
    return tiles, torch.stack(maxes).amax(dim=0)


def mf_pick_tiled(corr_tiles: list, thresholds: torch.Tensor, max_peaks: int,
                  pick_method: str = "topk", release: bool = False) -> peak_ops.SparsePicks:
    """The pick stage over channel tiles: per tile the Hilbert analytic
    signal and the fused pick kernel (``fused_picks.analytic_envelope_peaks``,
    its plain version on the CPU), with ``thresholds [nT, ...]`` one per
    template (and file). The tiles' slots concatenate back to ``[nT, ...,
    C, K]`` (``saturated [nT, ..., C]``). ``release`` drops each tile from
    ``corr_tiles`` once picked (the picks-only program keeps no
    correlograms)."""
    picks = []
    for i in range(len(corr_tiles)):
        picks.append(fused_picks.analytic_envelope_peaks(
            corr_tiles[i], thresholds[..., None], max_peaks=max_peaks, method=pick_method
        ))
        if release:
            corr_tiles[i] = None
    return peak_ops.SparsePicks(
        *(torch.cat([getattr(p, f) for p in picks], dim=-2)
          for f in ("positions", "heights", "prominences", "selected")),
        torch.cat([p.saturated for p in picks], dim=-1))


def mf_envelope_tiled(corr_tiles: list) -> torch.Tensor:
    """The Hilbert envelopes ``sqrt(re² + im²)`` of the tiles' correlograms,
    untiled: ``[nT, ..., C, n]`` (what the scipy and dense pickers read)."""
    return torch.cat([spectral.envelope_sqrt(ct) for ct in corr_tiles], dim=-2)


def _relative_thresholds(gmax: torch.Tensor, thr_factors: torch.Tensor,
                         thr_scope: str) -> torch.Tensor:
    """The bank threshold policy from each template's correlogram maximum
    ``gmax [nT, ...]`` (a trailing axis per file on a stack): ``0.5 * max``
    of all templates' (``"global"``) or of each template's own
    (``"per_template"``), times each template's factor."""
    fac = thr_factors.to(gmax.dtype).reshape((-1,) + (1,) * (gmax.ndim - 1))
    if thr_scope == "per_template":
        return (REL_THRESHOLD * gmax) * fac
    return (REL_THRESHOLD * gmax.amax(dim=0, keepdim=True)) * fac


def mf_envelope_and_threshold(corr: torch.Tensor, thr_factors: torch.Tensor,
                              thr_scope: str = "global"):
    """The envelopes ``sqrt(re² + im²)`` of untiled correlograms
    ``[nT, C, n]`` and their thresholds (:func:`_relative_thresholds`).
    The envelopes are taken a template at a time, the transform shape of
    the sparse route's (``fused_picks.analytic_envelope_peaks`` on
    ``corr[i]``), so every pick mode reads the same rounding."""
    env = torch.stack([spectral.envelope_sqrt(c) for c in corr])
    return env, _relative_thresholds(corr.amax(dim=(1, 2)), thr_factors, thr_scope)


def mf_compact_tiled_picks(positions: torch.Tensor, selected: torch.Tensor,
                           n_channels: int, capacity: int):
    """``[nT, ..., R, K]`` picks -> per-template compacted (channel, time)
    buffers ``[..., nT, capacity]`` and counts ``[..., nT]`` on the
    device, in the row-major order of :func:`merge_tiled_picks`; rows
    ``>= n_channels`` are dropped."""
    R, K = positions.shape[-2:]
    lead = tuple(positions.shape[1:-2])
    valid = (torch.arange(R, device=positions.device) < n_channels)[:, None]
    rows, times, count = peak_ops.compact_picks_rowmajor(
        positions.movedim(0, -3).reshape(-1, R, K),
        (selected & valid).movedim(0, -3).reshape(-1, R, K), capacity)
    nT = positions.shape[0]
    return (rows.reshape(lead + (nT, capacity)), times.reshape(lead + (nT, capacity)),
            count.reshape(lead + (nT,)))


def merge_tiled_picks(positions: np.ndarray, selected: np.ndarray,
                      template_idx: int, n_channels: int) -> np.ndarray:
    """Host ``[nT, R, K]`` picks -> the reference's stacked ``(2, n)``
    [channel_idx, time_idx] array of one template (row-major order),
    dropping rows ``>= n_channels``."""
    return peak_ops.sparse_to_pick_times(
        positions[template_idx, :n_channels], selected[template_idx, :n_channels]
    )


class ProgramOutputs(NamedTuple):
    """One attempt's device results: the packed compaction the caller
    fetches, and the slot grid it keeps for the exact overflow route.
    Over a ``[B, C, T]`` stack every field gains a leading file axis
    ``[B, ...]``, except ``positions``/``selected`` (``[nT, B, C, K]``)."""

    chan: torch.Tensor        # [nT, capacity] int32
    times: torch.Tensor       # [nT, capacity] int32
    count: torch.Tensor       # [nT] int32 (> capacity: overflow)
    sat_count: torch.Tensor   # [nT] int32 rows saturated at this K
    thr: torch.Tensor         # [nT] float32 thresholds
    positions: torch.Tensor   # [nT, C, K] int32
    selected: torch.Tensor    # [nT, C, K] bool
    health: tuple | None = None   # with_health: (counts, rms, bin_counts, bin_rms)


def mf_detect_picks_program(
    trace: torch.Tensor,
    mask_band: torch.Tensor,
    bp_gain: torch.Tensor,
    templates_true: torch.Tensor,
    mu: torch.Tensor,
    scale: torch.Tensor,
    thr_in: torch.Tensor,
    thr_factors: torch.Tensor,
    *,
    band_lo: int,
    band_hi: int,
    bp_padlen: int,
    staged_bp: bool,
    tile: int | None,
    pad_rows: int = 0,
    max_peaks: int,
    capacity: int,
    use_threshold: bool,
    pick_method: str = "topk",
    condition: bool = False,
    cond_scale: float = 1.0,
    cond_n_real: int | None = None,
    thr_scope: str = "global",
    with_health: bool = False,
    health_clip: float | None = None,
    stage_hook: Callable[[str], None] | None = None,
    mf_engine: str = "fft",
    fk_engine: str = "fft",
    fk_dft=None,
    mf_fused=None,
    fir_half: int = 0,
) -> ProgramOutputs:
    """The whole detection step: [raw-wire conditioning ->] fused
    bandpass/f-k filter (``staged_bp``: the staged bandpass, then the
    f-k filter on the gainless ``mask_band``) -> correlate -> threshold
    -> analytic signal -> fused pick kernel -> row-major compaction. ``tile=None`` correlates
    the block at once; an int walks channel tiles (one correlate sweep,
    the threshold off the tiles' maxima, then one pick sweep).
    ``thr_scope="global"`` bases every template's threshold on one max
    over all correlograms, ``"per_template"`` on each template's own.
    ``stage_hook(name)``, when given, is called after each stage
    (``health`` with ``with_health``, ``condition``, ``fk``,
    ``correlate``, ``pick``, ``compact``) — a timer's hook; it must not
    synchronize. ``thr_factors [nT]`` are the per-template threshold
    factors; ``use_threshold`` takes ``thr_in`` instead of the relative
    policy. ``pad_rows`` is a channel-padded design's silent channels.

    ``with_health=True`` adds the data-health stats
    (``ops.health.health_stats_profiled``) of the INPUT block as it
    enters — raw counts on the raw wire, strain on the conditioned wire —
    over its real samples ``[:, :cond_n_real]`` when that is given, to
    the outputs (``health``); ``health_clip`` is the clipped-sample
    magnitude (None: clip accounting off).

    ``mf_engine``/``fk_engine`` are the correlate and f-k engines
    (``ops.mxu``): ``fk_dft`` the matmul f-k's ``(wr, wi)`` pair,
    ``mf_fused``/``fir_half`` the tap-folded engine's ``(folded_taps,
    tcum)`` pair and FIR half-length (its caller hands the program the
    GAINLESS mask and ``staged_bp=False``:
    ``MatchedFilterDetector._program_inputs``).

    ``trace [B, C, T]`` runs every stage over the leading file axis at
    once (JAX's ``vmap`` of the program; ``parallel.batch``'s batched
    mode): the FFTs over ``[B, tile, ...]``, the pick kernel once a tile
    on ``nT * B * tile`` rows with per-file thresholds; ``cond_n_real`` is
    then None or one real length per file. Each file's outputs are those
    of its own run up to the batched FFTs' rounding."""
    if thr_scope not in ("global", "per_template"):
        raise ValueError(f"unknown thr_scope {thr_scope!r}")
    hook = stage_hook or (lambda name: None)
    C = trace.shape[-2]
    nT = templates_true.shape[0]
    lead = tuple(trace.shape[:-2])          # () for one file, (B,) for a stack
    health = None
    if with_health:
        health = health_ops.health_stats_profiled(
            trace, float("inf") if health_clip is None else health_clip, n_real=cond_n_real)
        hook("health")
    if condition:
        if cond_n_real is None:
            trace = conditioning.condition(trace, cond_scale, dtype=templates_true.dtype)
        else:
            trace = conditioning.condition_padded(trace, cond_scale, cond_n_real,
                                                  dtype=templates_true.dtype)
    hook("condition")
    if staged_bp:
        trf = mf_filter_only(trace, mask_band, bp_gain, band_lo, band_hi, bp_padlen, pad_rows,
                             fk_engine, fk_dft)
    else:
        trf = mf_filter_fused(trace, mask_band, band_lo, band_hi, pad_rows, fk_engine, fk_dft)
    del trace   # the conditioned block is dead once filtered
    hook("fk")

    def resolve_thr(gmax):
        # gmax [nT, ...]: each file's threshold from its own maxima
        if use_threshold:
            per = (nT,) + (1,) * len(lead)
            return thr_in.to(torch.float32).reshape(per).expand((nT,) + lead)
        return _relative_thresholds(gmax, thr_factors, thr_scope)

    if tile is None:
        corr_tiles = [mxu.correlograms_body(trf, templates_true, mu, scale, mf_engine,
                                            fused=mf_fused, fir_half=fir_half)]
        thr = resolve_thr(corr_tiles[0].amax(dim=(-2, -1)))
    else:
        corr_tiles, gmax = mf_correlate_tiled(trf, templates_true, mu, scale, tile, mf_engine,
                                              fused=mf_fused, fir_half=fir_half)
        thr = resolve_thr(gmax)
    del trf
    hook("correlate")

    sp = mf_pick_tiled(corr_tiles, thr, max_peaks, pick_method, release=True)
    hook("pick")

    chan, times, count = mf_compact_tiled_picks(sp.positions, sp.selected, C, capacity)
    sat_count = sp.saturated.sum(dim=-1).to(torch.int32).movedim(0, -1)
    hook("compact")
    return ProgramOutputs(chan, times, count, sat_count,
                          thr.to(torch.float32).movedim(0, -1), sp.positions, sp.selected,
                          health)


def mf_detect_picks_tiled_program(trace, mask_band, bp_gain, templates_true, mu, scale,
                                  thr_in, thr_factors, *, tile: int, **kw) -> ProgramOutputs:
    """The one-program TILED slab by name: :func:`mf_detect_picks_program`
    with ``tile`` required (a positive int — the channel-tile walk whose
    per-tile correlate -> envelope -> pick chain never holds the whole
    correlogram grid). The same function under a second name, as in the
    JAX package."""
    if not isinstance(tile, int) or tile <= 0:
        raise ValueError(
            f"mf_detect_picks_tiled_program needs a positive int tile, "
            f"got {tile!r}; use mf_detect_picks_program for the "
            "monolithic (tile=None) route"
        )
    return mf_detect_picks_program(trace, mask_band, bp_gain, templates_true, mu, scale,
                                   thr_in, thr_factors, tile=tile, **kw)


@dataclass
class MatchedFilterResult:
    picks: Dict[str, np.ndarray]          # (2, n_picks) [channel_idx, time_idx]
    thresholds: Dict[str, float]
    #: the data-health stats (``ops.health.stats_to_dict``) with
    #: ``with_health=True``; empty otherwise
    health: Dict[str, float] = field(default_factory=dict)
    #: the full-artifact route's (``__call__``): the filtered block
    #: ``[C, n]`` on the detector's device (None from ``detect_picks``),
    #: the ``[C, n]`` correlograms by template (with
    #: ``keep_correlograms``), the dense route's ``[C, n]`` boolean peak
    #: masks (host numpy) and, with ``with_snr``, the ``[C, n]`` envelope
    #: SNR in dB by template
    trf_fk: torch.Tensor | None = None
    correlograms: Dict[str, torch.Tensor] = field(default_factory=dict)
    peak_masks: Dict[str, np.ndarray] = field(default_factory=dict)
    snr: Dict[str, torch.Tensor] = field(default_factory=dict)


class PackedFetch:
    """An attempt's one device->host copy, started where it is made.

    ``parts`` (int32 tensors) are concatenated and, on the card, copied
    asynchronously into a pinned host buffer on the current stream with
    an event recorded after the copy; :meth:`wait` blocks on that event
    only, then splits the buffer back into numpy arrays of the parts'
    shapes. On the CPU the copy is the concatenation itself."""

    def __init__(self, parts: list):
        self._shapes = [tuple(p.shape) for p in parts]
        flat = torch.cat([p.reshape(-1) for p in parts])
        self._event = None
        with oprecord.counted_read():
            if flat.is_cuda:
                self._host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
                self._host.copy_(flat, non_blocking=True)
                self._event = torch.cuda.Event()
                self._event.record()
            else:
                self._host = flat

    def wait(self) -> list:
        if self._event is not None:
            self._event.synchronize()
        out, at, flat = [], 0, self._host.numpy()
        for shape in self._shapes:
            n = int(np.prod(shape, dtype=np.int64))
            out.append(flat[at : at + n].reshape(shape))
            at += n
        return out


class InFlightResult:
    """Handle for a dispatched detection: :meth:`resolve` performs the
    packed fetch (the attempt's one device->host copy) and the host-side
    assembly; the first successful resolve caches its result."""

    def __init__(self, resolve_fn):
        self._resolve_fn = resolve_fn
        self._result = None

    def resolve(self):
        if self._resolve_fn is not None:
            self._result = self._resolve_fn()
            self._resolve_fn = None
        return self._result


class MatchedFilterDetector:
    """Design-once / detect-many façade over the detection program.

    Plain counters on the instance: ``dispatches`` (program runs),
    ``syncs`` (device->host copies) and ``escalations`` (K0 -> K reruns).
    The engine labels ``mf_engine``, ``fk_engine`` (resolved by
    ``ops.mxu``'s routers, each with its ``*_engine_reason``) and
    ``pick_engine`` (the fused pick kernel on the card, its plain version
    on the CPU) go into the campaign's downshift events. ``mf_engine`` /
    ``fk_engine`` None take ``DAS_MF_ENGINE`` / ``DAS_FK_ENGINE``, else
    ``"fft"``; ``"auto"`` runs the calibrated router (the FFT route off a
    CUDA device).

    ``pick_mode`` (``"auto"``: ``"sparse"`` on the card, ``"scipy"`` on
    the CPU, as the JAX package resolves it per backend), ``peak_block``
    and ``keep_correlograms`` shape :meth:`__call__`'s full-artifact
    route; :meth:`detect_picks` is the one-program sparse route whatever
    the pick mode.
    """

    def __init__(
        self,
        metadata,
        selected_channels,
        trace_shape,
        fk_config: FkFilterConfig = SCRIPT_FK,
        bp_band=(14.0, 30.0),
        templates=None,
        peak_block: int = 1024,
        pick_mode: str = "auto",
        max_peaks: int = 256,
        channel_tile: int | str | None = "auto",
        hbm_budget_bytes: int | None = None,
        keep_correlograms: bool = True,
        channel_pad=None,
        fused_bandpass: bool = True,
        pick_pack_cap: int = 1 << 18,
        wire: str = "conditioned",
        mf_engine: str | None = None,
        fk_engine: str | None = None,
        device=None,
    ):
        meta = as_metadata(metadata)
        bank = resolve_bank(templates)
        design = design_matched_filter(trace_shape, selected_channels, meta,
                                       fk_config, bp_band, bank,
                                       channel_pad=channel_pad)
        self._setup(design, meta, bank=bank, peak_block=peak_block, pick_mode=pick_mode,
                    max_peaks=max_peaks, channel_tile=channel_tile,
                    hbm_budget_bytes=hbm_budget_bytes, keep_correlograms=keep_correlograms,
                    fused_bandpass=fused_bandpass, pick_pack_cap=pick_pack_cap, wire=wire,
                    mf_engine=mf_engine, fk_engine=fk_engine, device=device)

    @classmethod
    def from_design(cls, design: MatchedFilterDesign, metadata, *, templates=None,
                    peak_block: int = 1024, pick_mode: str = "auto",
                    max_peaks: int = 256, channel_tile: int | str | None = "auto",
                    hbm_budget_bytes: int | None = None, keep_correlograms: bool = True,
                    fused_bandpass: bool = True,
                    pick_pack_cap: int = 1 << 18, wire: str = "conditioned",
                    mf_engine: str | None = None, fk_engine: str | None = None,
                    device=None) -> "MatchedFilterDetector":
        """A detector on an existing design (e.g. one carried over from the
        JAX package by ``convert.design_from_arrays``, padded or not).
        ``templates`` names the bank the design was compiled from (its
        entry names must be the design's); without it the detector has no
        ``bank`` and takes the bank's split policy from the design's
        threshold scope."""
        bank = None
        if templates is not None:
            bank = resolve_bank(templates)
            if bank.names != tuple(design.template_names):
                raise ValueError(f"bank {bank.name!r} entries {bank.names} are not the "
                                 f"design's templates {tuple(design.template_names)}")
        det = cls.__new__(cls)
        det._setup(design, as_metadata(metadata), bank=bank, peak_block=peak_block,
                   pick_mode=pick_mode, max_peaks=max_peaks, channel_tile=channel_tile,
                   hbm_budget_bytes=hbm_budget_bytes, keep_correlograms=keep_correlograms,
                   fused_bandpass=fused_bandpass, pick_pack_cap=pick_pack_cap,
                   wire=wire, mf_engine=mf_engine, fk_engine=fk_engine, device=device)
        return det

    def _setup(self, design, meta, *, bank, peak_block, pick_mode, max_peaks, channel_tile,
               hbm_budget_bytes, keep_correlograms, fused_bandpass, pick_pack_cap, wire,
               mf_engine, fk_engine, device):
        if wire not in ("conditioned", "raw"):
            raise ValueError(f"unknown wire {wire!r}; expected 'conditioned' or 'raw'")
        self.device = resolve_device(device)
        if pick_mode == "auto":
            pick_mode = "sparse" if self.device.type == "cuda" else "scipy"
        if pick_mode not in ("sparse", "scipy", "dense"):
            raise ValueError(f"unknown pick_mode {pick_mode!r}")
        self.pick_mode = pick_mode
        self.peak_block = peak_block
        self.keep_correlograms = keep_correlograms
        self.metadata = meta
        self.design = design
        # the template bank (None for a design given without one); name ->
        # config mapping of its entries
        self.bank = bank
        self.template_configs = None if bank is None else bank.configs
        self.wire = wire
        self.fused_bandpass = fused_bandpass
        self.threshold_scope = design.threshold_scope
        self.max_peaks = max_peaks
        # adaptive K: run at K0 first, rerun at max_peaks only if a row
        # saturated (exact: a row that does not saturate is exact at any K)
        self.pick_k0 = min(64, max_peaks)
        self.channel_tile = channel_tile
        self.pick_pack_cap = pick_pack_cap
        self.hbm_budget_bytes = (_default_hbm_budget_bytes() if hbm_budget_bytes is None
                                 else hbm_budget_bytes)
        self.dispatches = self.syncs = self.escalations = 0

        mask_band, self._band_lo, self._band_hi = fk_ops.banded_mask_half(design.fk_mask)
        gainless = mask_band
        gain_n = butter_zero_phase_gain(design.trace_shape[1], design.fs, design.bp_band,
                                        order=design.bp_order)
        if fused_bandpass:
            # fold |H(f)|^2 into the mask; staged, the mask stays gainless
            mask_band = mask_band * gain_n[self._band_lo : self._band_hi][None, :]
        dev = self.device
        self._mask_band = torch.as_tensor(mask_band, device=dev)
        self._bp_gain = torch.as_tensor(design.bp_gain, device=dev)
        self._templates_dev = torch.as_tensor(design.templates, device=dev)
        t_true, t_mu, t_scale = xcorr.padded_template_stats(design.templates)
        self._templates_true = torch.as_tensor(t_true, device=dev)
        self._template_mu = torch.as_tensor(t_mu, device=dev)
        self._template_scale = torch.as_tensor(t_scale, device=dev)
        self._thr_factors = torch.as_tensor(
            np.asarray(design.threshold_factors, np.float32), device=dev)
        self._cond_scale = float(np.float32(meta.scale_factor))
        # the tap-fold pair (ops.mxu.resolve_mf_engine's fused_design): the
        # truncated zero-phase FIR and the record-length circular gain its
        # gate holds the fold against
        self._bp_fir, _ = butter_zero_phase_fir(design.fs, design.bp_band, order=design.bp_order)
        self._fused_design = (self._bp_fir, gain_n.astype(np.float32))
        self._mf_engine_requested = mf_engine
        self._fk_engine_requested = fk_engine
        self._resolve_engines(t_true, t_mu, t_scale, gainless)

    def _resolve_engines(self, t_true, t_mu, t_scale, gainless) -> None:
        """Resolve the correlate and f-k engines for this device (``ops.mxu``)
        and place what they run on: the DFT pair of the matmul f-k, and the
        tap-folded engine's gainless mask and folded taps."""
        dev = self.device
        design = self.design
        self.mf_engine, self.mf_engine_reason = mxu.resolve_mf_engine(
            self._mf_engine_requested, design.trace_shape, t_true, t_mu, t_scale,
            device=dev, fused_design=self._fused_design)
        self.fk_engine, self.fk_engine_reason = mxu.resolve_fk_engine(
            self._fk_engine_requested, design.fk_channels, design.trace_shape[1],
            self._band_hi - self._band_lo, device=dev)
        self._fk_dft = None
        if self.fk_engine == "matmul":
            self._fk_dft = tuple(torch.as_tensor(a, device=dev)
                                 for a in mxu.dft_matrices(design.fk_channels))
        self._mask_band_fused = self._mf_fused = None
        self._mf_fir_half = 0
        if self.mf_engine == "matmul-fused":
            self._mask_band_fused = (self._mask_band if not self.fused_bandpass
                                     else torch.as_tensor(gainless, device=dev))
            self._mf_fused, self._mf_fir_half = self._fused_tap_arrays(t_true)

    def _fused_tap_arrays(self, templates_true) -> tuple:
        """The ``matmul-fused`` engine's ``((folded, tcum) device pair, FIR
        half-length)`` for a template stack (``ops.mxu.fused_template_taps``);
        a sub-bank view builds its own (the fold has an extra row)."""
        t = templates_true.cpu().numpy() if isinstance(templates_true, torch.Tensor) \
            else np.asarray(templates_true)
        folded, tcum, L = mxu.fused_template_taps(t, self._bp_fir)
        return (torch.as_tensor(folded, device=self.device),
                torch.as_tensor(tcum, device=self.device)), L

    def _program_inputs(self) -> tuple:
        """``(mask, staged_bp, engine keyword arguments)`` of the
        one-program routes: on the tap-folded engine the GAINLESS mask and
        no staged bandpass (the bandpass rides the taps), else the
        constructor's mask and bandpass mode."""
        fused = self.mf_engine == "matmul-fused"
        kw = dict(mf_engine=self.mf_engine, fk_engine=self.fk_engine, fk_dft=self._fk_dft,
                  mf_fused=self._mf_fused, fir_half=self._mf_fir_half)
        if fused:
            return self._mask_band_fused, False, kw
        return self._mask_band, not self.fused_bandpass, kw

    @property
    def _staged_mf_engine(self) -> str:
        """The correlate engine of the STAGED routes, which correlate an
        already bandpassed block: the tap-folded engine would apply the
        bandpass twice there, so it runs as the float32 matmul."""
        return "matmul" if self.mf_engine == "matmul-fused" else self.mf_engine

    def monolithic_temp_estimate(self) -> int:
        """Rough byte estimate of the untiled correlate+envelope temps at
        the design shape (routing only; conservative)."""
        C, n = self.design.trace_shape
        nT = self.design.templates.shape[0]
        nfft = xcorr._xcorr_full_len(n, n)
        return 4 * C * (nfft * (1 + 2 * nT) + 6 * n * nT)

    def _route(self) -> str:
        if self.channel_tile is None:
            return "mono"
        if isinstance(self.channel_tile, int):
            return "tiled"
        return "tiled" if self.monolithic_temp_estimate() > self.hbm_budget_bytes else "mono"

    @property
    def effective_channel_tile(self) -> int:
        return self.channel_tile if isinstance(self.channel_tile, int) else 512

    @property
    def pick_engine(self) -> str:
        return "cuda" if self.device.type == "cuda" else "plain"

    @property
    def fk_pad_rows(self) -> int:
        """The silent channels a channel-padded design appends."""
        return self.design.fk_channels - self.design.trace_shape[0]

    def tiled_view(self) -> "MatchedFilterDetector":
        """A shallow view with the channel-TILED correlate route forced —
        the resource ladder's memory-lean per-file rung
        (``workflows.planner``). Shares the design and device tensors.
        Cached: repeated calls return the same view."""

        def mutate(det):
            det.channel_tile = self.effective_channel_tile

        return cached_shallow_view(self, "_tiled_view_cache", mutate)

    def host_view(self) -> "MatchedFilterDetector":
        """This detector on the CPU — the resource ladder's LAST rung:
        where no card rung fits, detection still completes (slowly) in
        host memory. The same design and settings with ``device="cpu"``,
        where every stage runs its plain PyTorch version (the pick
        kernel's included); channel-tiled, lean on the host too. The
        requested engines are resolved again for the CPU (an ``"auto"``
        verdict of the card does not route the host; a gated engine earns
        its verdict there). Cached: repeated calls return the same view."""
        view = getattr(self, "_host_view_cache", None)
        if view is None:
            view = self._host_view_cache = type(self).from_design(
                self.design, self.metadata, templates=self.bank, peak_block=self.peak_block,
                pick_mode=self.pick_mode, max_peaks=self.max_peaks,
                channel_tile=self.effective_channel_tile,
                hbm_budget_bytes=self.hbm_budget_bytes,
                keep_correlograms=self.keep_correlograms, fused_bandpass=self.fused_bandpass,
                pick_pack_cap=self.pick_pack_cap, wire=self.wire,
                mf_engine=self._mf_engine_requested, fk_engine=self._fk_engine_requested,
                device="cpu")
        return view

    @property
    def supports_bank_split(self) -> bool:
        """True when the ladder's bank-split rung may run this detector as
        two sub-banks with the full bank's picks bit for bit: decoupled
        per-template thresholds (``threshold_scope="per_template"``) and
        T >= 2 (``TemplateBank.splittable``)."""
        return self.threshold_scope == "per_template" and self.design.templates.shape[0] >= 2

    @property
    def _bank_name(self) -> str:
        return "custom" if self.bank is None else self.bank.name

    def bank_view(self, lo: int, hi: int) -> "MatchedFilterDetector":
        """A shallow view on the contiguous sub-bank ``[lo:hi)`` of the
        template stack: the unit of the bank-split rung.

        It SLICES the parent's device tensors (true-length templates,
        their means and scales, the factor vector) rather than deriving
        them again: every template keeps the bank-wide true length ``m``
        (a row's zero tail is exact), so the correlate runs at the bank's
        FFT length and, under the ``per_template`` scope, a sub-bank's
        picks equal the full bank's rows bit for bit wherever the
        transforms are row-independent. A detector designed on the
        sub-bank alone would take its own ``m`` and FFT length. Shares the
        f-k design, mask, DFT pair and resolved engines, except that a
        ``"matmul-bf16"`` or ``"matmul-fused"`` parent's sub-bank is gated
        again: the gates' verdicts are keyed on the template CONTENT, and a
        sub-bank is another template set (it earns or loses the engine on
        its own record, and a tap-folded sub-bank folds its own slice).
        Cached per ``(lo, hi)``."""
        key = (int(lo), int(hi))
        cache = self.__dict__.setdefault("_bank_view_cache", {})
        view = cache.get(key)
        if view is not None:
            return view
        nT = self.design.templates.shape[0]
        if not 0 <= key[0] < key[1] <= nT:
            raise ValueError(f"sub-bank [{key[0]}:{key[1]}] out of range for T={nT}")
        view = copy.copy(self)
        for attr in _VIEW_CACHE_ATTRS:
            view.__dict__.pop(attr, None)
        if self.bank is not None:
            view.bank = self.bank.subset(*key)
            view.template_configs = view.bank.configs
        view.design = dataclasses.replace(
            self.design, templates=self.design.templates[lo:hi],
            template_names=tuple(self.design.template_names[lo:hi]),
            threshold_factors=np.asarray(self.design.threshold_factors[lo:hi]),
        )
        for attr in ("_templates_dev", "_templates_true", "_template_mu", "_template_scale",
                     "_thr_factors"):
            setattr(view, attr, getattr(self, attr)[lo:hi])
        if self.mf_engine in ("matmul-bf16", "matmul-fused"):
            view.mf_engine, view.mf_engine_reason = mxu.resolve_mf_engine(
                self._mf_engine_requested, self.design.trace_shape,
                view._templates_true.cpu().numpy(), view._template_mu.cpu().numpy(),
                view._template_scale.cpu().numpy(), device=self.device,
                fused_design=self._fused_design)
            view._mf_fused, view._mf_fir_half = None, 0
            if view.mf_engine == "matmul-fused":
                view._mf_fused, view._mf_fir_half = self._fused_tap_arrays(
                    view._templates_true)
                if view._mask_band_fused is None:
                    view._mask_band_fused = (
                        self._mask_band if not self.fused_bandpass else torch.as_tensor(
                            fk_ops.banded_mask_half(self.design.fk_mask)[0],
                            device=self.device))
        cache[key] = view
        return view

    def split_views(self) -> tuple:
        """The bank-split rung's ``(first half, second half)`` views
        (T -> ceil(T/2) + floor(T/2)); needs :attr:`supports_bank_split`."""
        nT = self.design.templates.shape[0]
        if not self.supports_bank_split:
            raise ValueError(
                f"bank {self._bank_name!r} is not splittable "
                f"(threshold_scope={self.threshold_scope!r}, T={nT}): sub-bank picks "
                "would not be bit-identical to the one-dispatch bank"
            )
        mid = (nT + 1) // 2
        return self.bank_view(0, mid), self.bank_view(mid, nT)

    def _warn_saturated(self, name: str, n_saturated: int) -> None:
        # name the bank entry, bank-qualified for a named bank other than fin
        label = name if self._bank_name in ("fin", "custom") else f"{self._bank_name}/{name}"
        peak_ops.warn_saturated(n_saturated, f"template {label}", self.max_peaks)

    def _as_input(self, trace) -> torch.Tensor:
        """Raw wire keeps the stored dtype across the transfer; the
        conditioned wire casts to float32."""
        t = torch.as_tensor(trace)
        if self.wire == "raw":
            return t.to(self.device)
        return t.to(self.device, torch.float32)

    def condition_input(self, trace) -> torch.Tensor:
        """The block as float32 strain on the device: raw counts are
        conditioned there (``ops.conditioning``), a conditioned block is
        cast."""
        x = self._as_input(trace)
        if self.wire != "raw":
            return x
        return conditioning.condition(x, self._cond_scale, dtype=self._templates_true.dtype)

    def filter_block(self, trace) -> torch.Tensor:
        """The detector's filter alone, in its bandpass mode: the
        prefilter of the other detector families and what
        ``utils.parity.envelopes`` correlates."""
        x = self.condition_input(trace)
        if self.fused_bandpass:
            return mf_filter_fused(x, self._mask_band, self._band_lo, self._band_hi,
                                   self.fk_pad_rows, self.fk_engine, self._fk_dft)
        return mf_filter_only(x, self._mask_band, self._bp_gain, self._band_lo,
                              self._band_hi, self.design.bp_padlen, self.fk_pad_rows,
                              self.fk_engine, self._fk_dft)

    def __call__(self, trace, threshold: float | None = None, with_snr: bool = False,
                 stage_hook: Callable[[str], None] | None = None) -> MatchedFilterResult:
        """Detect calls in one ``[channel x time]`` block, the reference's
        full artifact set: ``trf_fk``, the correlograms (with
        ``keep_correlograms``), the picks and thresholds, the dense
        route's peak masks and, with ``with_snr``, the envelope SNR. In the
        campaign configuration — ``pick_mode="sparse"``,
        ``keep_correlograms=False``, no SNR — this is :meth:`detect_picks`
        (no ``trf_fk``, no correlograms). ``stage_hook(name)`` is called
        after each stage (``fk``, ``correlate``, ``threshold``, ``pick``,
        ``correlograms`` on the tiled route, ``snr``), as
        ``mf_detect_picks_program`` calls it."""
        trace = self._as_input(trace)
        if self.pick_mode == "sparse" and not self.keep_correlograms and not with_snr:
            return self.detect_picks(trace, threshold=threshold, stage_hook=stage_hook)
        return self._call_full(trace, threshold=threshold, with_snr=with_snr,
                               stage_hook=stage_hook)

    def _call_full(self, trace, threshold: float | None = None, with_snr: bool = False,
                   stage_hook: Callable[[str], None] | None = None) -> MatchedFilterResult:
        """The full-artifact route, untiled: the filter, correlograms at
        the trace length (``compute_cross_correlograms_multi``), the
        threshold on the device, then each template's picks in the pick
        mode; :meth:`_call_tiled` where the route is tiled."""
        if self._route() == "tiled":
            return self._call_tiled(trace, threshold=threshold, with_snr=with_snr,
                                    stage_hook=stage_hook)
        hook = stage_hook or (lambda name: None)
        trf_fk = self.filter_block(trace)
        hook("fk")
        corr = xcorr.compute_cross_correlograms_multi(trf_fk, self._templates_dev)
        hook("correlate")
        env = None
        if self.pick_mode == "sparse":
            thresholds = _relative_thresholds(corr.amax(dim=(1, 2)), self._thr_factors,
                                              self.threshold_scope)
        else:
            env, thresholds = mf_envelope_and_threshold(corr, self._thr_factors,
                                                        self.threshold_scope)
        if threshold is not None:
            thresholds = torch.full_like(thresholds, threshold)
        thr_host = thresholds.cpu().numpy()
        syncs = peak_ops.SyncCounter()
        syncs.add()
        hook("threshold")

        names = self.design.template_names
        correlograms, peak_masks, picks, thr_out, snr = {}, {}, {}, {}, {}
        for i, name in enumerate(names):
            if self.keep_correlograms:
                correlograms[name] = corr[i]
            thr_out[name] = float(thr_host[i])
            if self.pick_mode == "sparse":
                # the pick kernel on the card, its plain version on the CPU;
                # adaptive K with the exact escalation on saturation
                def run(k, i=i):
                    return fused_picks.analytic_envelope_peaks(
                        corr[i], thresholds[i], max_peaks=k,
                        method=peak_ops.escalation_method(k, self.max_peaks))

                sp = peak_ops.picks_with_escalation(run, self.pick_k0, self.max_peaks, syncs)
                picks[name] = peak_ops.pick_times_compacted(sp.positions, sp.selected,
                                                            syncs=syncs)
                self._warn_saturated(name, int(sp.saturated.sum()))
            elif self.pick_mode == "scipy":
                picks[name] = peak_ops.find_peaks_scipy_host(env[i], thr_host[i])
            else:
                mask = peak_ops.find_peaks_prominence_blocked(env[i], thresholds[i],
                                                              self.peak_block)
                peak_masks[name] = mask.cpu().numpy()
                picks[name] = peak_ops.convert_pick_times(peak_masks[name])
        self.syncs += syncs.count
        del env
        hook("pick")
        if with_snr:
            for i, name in enumerate(names):
                snr[name] = spectral.snr_tr_array(corr[i], env=True)
            hook("snr")
        return MatchedFilterResult(picks=picks, thresholds=thr_out, trf_fk=trf_fk,
                                   correlograms=correlograms, peak_masks=peak_masks, snr=snr)

    def _call_tiled(self, trace, threshold: float | None = None, with_snr: bool = False,
                    stage_hook: Callable[[str], None] | None = None) -> MatchedFilterResult:
        """The memory-lean full-artifact route: the filter over the whole
        block, then the correlate over channel tiles
        (:func:`mf_correlate_tiled`, as the program's), the thresholds on
        the host from the tiles' maxima (``0.5 * max * factor`` in numpy
        float32, as the JAX package computes them), the picks over the
        tiles in the pick mode; sparse picks are compacted on the device
        (capacity ``min(C * max_peaks, 2^20)``, the exact slot-grid merge
        on overflow)."""
        hook = stage_hook or (lambda name: None)
        tile = self.effective_channel_tile
        C, n = trace.shape
        nT = self.design.templates.shape[0]
        names = self.design.template_names

        trf_fk = self.filter_block(trace)
        hook("fk")
        corr_tiles, gmax = mf_correlate_tiled(trf_fk, self._templates_true,
                                              self._template_mu, self._template_scale, tile,
                                              self._staged_mf_engine)
        hook("correlate")
        if threshold is None:
            fac = np.asarray(self.design.threshold_factors, np.float32)
            g = gmax.cpu().numpy()
            self.syncs += 1
            if self.threshold_scope == "per_template":
                thr_np = (REL_THRESHOLD * g) * fac
            else:
                thr_np = (REL_THRESHOLD * float(g.max())) * fac
        else:
            thr_np = np.full((nT,), float(threshold), dtype=np.float32)
        thr_dev = torch.as_tensor(thr_np, dtype=torch.float32).to(self.device)
        hook("threshold")

        correlograms, peak_masks, picks, thr_out, snr = {}, {}, {}, {}, {}
        if self.pick_mode == "sparse":
            def attempt(k):
                sp = mf_pick_tiled(corr_tiles, thr_dev, k,
                                   peak_ops.escalation_method(k, self.max_peaks))
                satc = sp.saturated.sum(dim=-1).cpu().numpy()
                self.syncs += 1
                return sp, satc

            sp, satc = attempt(self.pick_k0)
            if self.pick_k0 < self.max_peaks and int(satc.sum()):
                self.escalations += 1
                sp, satc = attempt(self.max_peaks)
            cap = min(C * self.max_peaks, 1 << 20)
            chan_d, times_d, cnt_d = mf_compact_tiled_picks(sp.positions, sp.selected, C, cap)
            syncs = peak_ops.SyncCounter()
            packed = peak_ops.compacted_to_host(chan_d, times_d, cnt_d, cap, syncs)
            if packed is None:
                pos, sel = sp.positions.cpu().numpy(), sp.selected.cpu().numpy()
                syncs.add()
            self.syncs += syncs.count
            for i, name in enumerate(names):
                if packed is not None:
                    chan_np, times_np, cnt = packed
                    k = int(cnt[i])
                    picks[name] = np.asarray([chan_np[i, :k], times_np[i, :k]])
                else:
                    picks[name] = merge_tiled_picks(pos, sel, i, C)
                self._warn_saturated(name, int(satc[i]))
        else:
            env_full = mf_envelope_tiled(corr_tiles)
            for i, name in enumerate(names):
                if self.pick_mode == "scipy":
                    picks[name] = peak_ops.find_peaks_scipy_host(env_full[i], thr_np[i])
                else:
                    mask = peak_ops.find_peaks_prominence_blocked(
                        env_full[i], torch.as_tensor(thr_np[i]).to(self.device),
                        self.peak_block)
                    peak_masks[name] = mask.cpu().numpy()
                    picks[name] = peak_ops.convert_pick_times(peak_masks[name])
            del env_full
        hook("pick")

        # the user-facing [C, n] correlograms, untiled once (the reference
        # keeps them for its plots); skipped without keep_correlograms
        # unless the SNR needs them
        corr_full = (torch.cat(corr_tiles, dim=-2)
                     if self.keep_correlograms or with_snr else None)
        del corr_tiles
        hook("correlograms")
        for i, name in enumerate(names):
            thr_out[name] = float(thr_np[i])
            if self.keep_correlograms:
                correlograms[name] = corr_full[i]
            if with_snr:
                snr[name] = spectral.snr_tr_array(corr_full[i], env=True)
        if with_snr:
            hook("snr")
        return MatchedFilterResult(picks=picks, thresholds=thr_out, trf_fk=trf_fk,
                                   correlograms=correlograms, peak_masks=peak_masks, snr=snr)

    @property
    def supports_fused_health(self) -> bool:
        """True: :meth:`detect_picks` fuses the data-health stats
        (``ops.health``) into its one program, and the campaign takes
        them from there rather than from the host block. Here that holds
        on every ``pick_mode``, since :meth:`detect_picks` is always the
        sparse route (the JAX package's: on ``pick_mode="sparse"``)."""
        return True

    def detect_picks(self, trace, threshold: float | None = None,
                     n_real: int | None = None, with_health: bool = False,
                     health_clip: float | None = None,
                     stage_hook: Callable[[str], None] | None = None) -> MatchedFilterResult:
        """Picks-only detection: one program run and one packed fetch per
        attempt (``dispatch_picks(...).resolve()``), the sparse route
        whatever ``pick_mode`` says."""
        return self.dispatch_picks(trace, threshold=threshold, n_real=n_real,
                                   with_health=with_health, health_clip=health_clip,
                                   stage_hook=stage_hook).resolve()

    def dispatch_picks(self, trace, threshold: float | None = None,
                       n_real: int | None = None, with_health: bool = False,
                       health_clip: float | None = None,
                       stage_hook: Callable[[str], None] | None = None) -> InFlightResult:
        """Run the K0 attempt (queued on the card, nothing fetched) and
        return an :class:`InFlightResult`. ``resolve()`` fetches the K0
        payload, reruns at ``max_peaks`` if a row saturated (decided from
        that payload), and on capacity overflow returns the exact full pick
        set from the same attempt's slot grid — never a truncated one.

        ``n_real`` marks a time-padded block whose real samples are
        ``[:, :n_real]``; on the raw wire the demean spans them alone.

        ``with_health=True`` computes the data-health stats of the input
        block in the same program (over its real samples on either wire);
        they ride the attempt's packed fetch and land in
        ``result.health``. ``health_clip`` is the clipped-sample
        magnitude, in the wire's units."""
        trace = self._as_input(trace)
        C = trace.shape[0]
        nT = self.design.templates.shape[0]
        names = self.design.template_names
        cap = int(min(C * self.max_peaks, self.pick_pack_cap))
        use_thr = threshold is not None
        thr_in = torch.full((nT,), 0.0 if threshold is None else float(threshold),
                            dtype=torch.float32, device=self.device)
        tile = self.effective_channel_tile if self._route() == "tiled" else None
        pad_real = n_real is not None and int(n_real) != trace.shape[1]
        # the health stats mask the pad on either wire (the conditioned
        # wire's pad is zeros, but it would dilute the rms)
        cond_nr = int(n_real) if ((self.wire == "raw" or with_health) and pad_real) else None

        mask, staged_bp, engine_kw = self._program_inputs()

        def run(k):
            self.dispatches += 1
            return mf_detect_picks_program(
                trace, mask, self._bp_gain, self._templates_true,
                self._template_mu, self._template_scale, thr_in, self._thr_factors,
                band_lo=self._band_lo, band_hi=self._band_hi,
                bp_padlen=self.design.bp_padlen, staged_bp=staged_bp, tile=tile,
                pad_rows=self.fk_pad_rows, max_peaks=k, capacity=cap, use_threshold=use_thr,
                pick_method=peak_ops.escalation_method(k, self.max_peaks),
                condition=self.wire == "raw", cond_scale=self._cond_scale,
                cond_n_real=cond_nr, thr_scope=self.threshold_scope,
                with_health=with_health, health_clip=health_clip, stage_hook=stage_hook,
                **engine_kw,
            )

        health = {}
        n_samples = C * (int(n_real) if pad_real else trace.shape[1])

        def start_fetch(outs: ProgramOutputs) -> PackedFetch:
            # THE one device->host copy of an attempt, queued behind it
            parts = [outs.chan, outs.times, outs.count, outs.sat_count,
                     outs.thr.view(torch.int32)]
            if with_health:
                parts += health_parts(outs.health)
            return PackedFetch(parts)

        def fetch(pending: PackedFetch):
            chan, times, count, satc, thr, *h = pending.wait()
            self.syncs += 1
            if with_health:
                health.update(health_from_parts(h, n_samples, C))
            return chan, times, count, satc, thr.view(np.float32)

        outs = run(self.pick_k0)
        pending = start_fetch(outs)

        def resolve():
            nonlocal outs
            chan, times, count, satc, thr = fetch(pending)
            if self.pick_k0 < self.max_peaks and int(satc.sum()):
                self.escalations += 1
                outs = run(self.max_peaks)
                chan, times, count, satc, thr = fetch(start_fetch(outs))
            picks, thr_out = {}, {}
            if int(count.max(initial=0)) > cap:
                # capacity overflow: the exact full pick set from this
                # attempt's slot grid (the row-major np.nonzero order)
                pos = outs.positions.cpu().numpy()
                sel = outs.selected.cpu().numpy()
                self.syncs += 1
                for i, name in enumerate(names):
                    picks[name] = merge_tiled_picks(pos, sel, i, C)
            else:
                for i, name in enumerate(names):
                    k = int(count[i])
                    picks[name] = np.asarray([chan[i, :k], times[i, :k]], dtype=np.int64)
            for i, name in enumerate(names):
                thr_out[name] = float(thr[i])
                self._warn_saturated(name, int(satc[i]))
            return MatchedFilterResult(picks=picks, thresholds=thr_out, health=health)

        return InFlightResult(resolve)


def health_parts(health: tuple) -> list:
    """The health rows of a program's outputs as int32 tensors for the
    packed fetch (the float rows viewed bit for bit)."""
    counts, rms, bin_counts, bin_rms = health
    return [counts, rms.view(torch.int32), bin_counts, bin_rms.view(torch.int32)]


def health_from_parts(h: list, n_samples: int, n_channels: int) -> dict:
    """One record's fetched health rows -> its ``ops.health`` stats dict."""
    counts, rms, bin_counts, bin_rms = h
    return health_ops.stats_to_dict(counts, rms.view(np.float32), n_samples,
                                    bin_counts=bin_counts, bin_rms=bin_rms.view(np.float32),
                                    n_channels=n_channels)

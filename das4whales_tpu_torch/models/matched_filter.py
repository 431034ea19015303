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
on the host.

This slice carries ``mf_engine="fft"`` and ``fk_engine="fft"`` only;
every other value raises ``NotImplementedError`` naming the ROADMAP item
that brings it. ``condition_input`` and ``filter_block`` are the
prefilter the other detector families share (``workflows.common``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, NamedTuple

import numpy as np
import scipy.signal as sp
import torch

from ..config import (
    FIN_HF_NOTE,
    SCRIPT_FK,
    ChannelSelection,
    FkFilterConfig,
    as_metadata,
)
from ..config import not_in_slice as _not_in_slice
from ..config import hbm_budget_bytes as _default_hbm_budget_bytes
from ..ops import conditioning, fused_picks, xcorr
from ..ops import health as health_ops
from ..ops import fk as fk_ops
from ..ops import peaks as peak_ops
from ..ops.filters import butter_zero_phase_gain, fft_zero_phase_apply
from ..utils.device import resolve_device
from .templates import resolve_bank

#: The reference threshold policy: ``thres = REL_THRESHOLD * max``, scaled
#: per template by its factor; HF_FACTOR is the HF fin note's factor.
REL_THRESHOLD = 0.5
HF_FACTOR = FIN_HF_NOTE.threshold_factor


def check_engines(mf_engine: str, fk_engine: str) -> None:
    """Raise for every engine setting this slice does not carry."""
    if mf_engine != "fft":
        raise _not_in_slice(f"mf_engine={mf_engine!r}", "Matmul engines")
    if fk_engine != "fft":
        raise _not_in_slice(f"fk_engine={fk_engine!r}", "Matmul engines")


def reference_threshold_factors(n_templates: int) -> np.ndarray:
    """The pre-bank factor vector: first template at ``HF_FACTOR``, the
    rest at 1.0 (float32)."""
    fac = np.ones((n_templates,), np.float32)
    fac[0] = HF_FACTOR
    return fac


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


def design_matched_filter(trace_shape, selected_channels, metadata,
                          fk_config: FkFilterConfig = SCRIPT_FK,
                          bp_band=(14.0, 30.0), templates=None,
                          channel_pad=None) -> MatchedFilterDesign:
    """Design the pipeline for one block shape: the hybrid_ninf f-k mask
    with the script fan, the 14-30 Hz Butterworth-8 zero-phase gain and
    the template bank's ``[T, time]`` stack with its threshold policy."""
    if channel_pad is not None:
        raise _not_in_slice("channel_pad", "channel_pad")
    meta = as_metadata(metadata)
    sel = ChannelSelection.from_list(selected_channels)
    bank = resolve_bank(templates)
    mask = fk_ops.hybrid_ninf_filter_design(
        tuple(trace_shape), sel.to_list(), meta.dx, meta.fs,
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
        fk_channels=int(trace_shape[0]),
        threshold_factors=bank.threshold_factors(),
        threshold_scope=bank.threshold_scope,
    )


def mf_filter_fused(trace: torch.Tensor, fused_mask_band: torch.Tensor,
                    band_lo: int, band_hi: int) -> torch.Tensor:
    """Bandpass ∘ f-k filter as ONE banded spectral multiply: the mask
    carries ``|H(f)|^2`` folded in (circular edges, as in the JAX
    package's fused route)."""
    return fk_ops.fk_filter_apply_rfft_banded(trace, fused_mask_band, band_lo, band_hi)


def mf_filter_only(trace: torch.Tensor, fk_mask_band: torch.Tensor, bp_gain: torch.Tensor,
                   band_lo: int, band_hi: int, bp_padlen: int) -> torch.Tensor:
    """The staged bandpass, then the banded f-k filter: odd extension by
    ``bp_padlen``, one rfft round trip times ``bp_gain`` (the rFFT bins of
    the extended length), crop, then the f-k pass on the gainless mask."""
    tr_bp = fft_zero_phase_apply(trace, bp_gain, bp_padlen)
    return fk_ops.fk_filter_apply_rfft_banded(tr_bp, fk_mask_band, band_lo, band_hi)


def mf_correlate_tiled(trf_fk: torch.Tensor, templates_true: torch.Tensor,
                       mu: torch.Tensor, scale: torch.Tensor, tile: int):
    """Correlograms of ``trf_fk [..., C, n]`` over channel tiles, one tile
    at a time (the JAX package's ``lax.map``, here a Python loop; a
    leading axis stacks files). Returns ``(corr_tiles, gmax)``: a list of
    ``[nT, ..., rows, n]`` tiles (the last one ragged — no padding rows)
    and each template's max over all channels ``[nT, ...]``."""
    C = trf_fk.shape[-2]
    tiles, maxes = [], []
    for lo in range(0, C, tile):
        corr = xcorr.compute_cross_correlograms_corrected(
            trf_fk[..., lo : lo + tile, :], templates_true, mu, scale
        )
        tiles.append(corr)
        maxes.append(corr.amax(dim=(-2, -1)))
    return tiles, torch.stack(maxes).amax(dim=0)


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
    policy.

    ``with_health=True`` adds the data-health stats
    (``ops.health.health_stats_profiled``) of the INPUT block as it
    enters — raw counts on the raw wire, strain on the conditioned wire —
    over its real samples ``[:, :cond_n_real]`` when that is given, to
    the outputs (``health``); ``health_clip`` is the clipped-sample
    magnitude (None: clip accounting off).

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
        trf = mf_filter_only(trace, mask_band, bp_gain, band_lo, band_hi, bp_padlen)
    else:
        trf = mf_filter_fused(trace, mask_band, band_lo, band_hi)
    del trace   # the conditioned block is dead once filtered
    hook("fk")

    def resolve_thr(gmax):
        # gmax [nT, ...]: each file's threshold from its own maxima
        per = (nT,) + (1,) * len(lead)
        if use_threshold:
            return thr_in.to(torch.float32).reshape(per).expand((nT,) + lead)
        fac = thr_factors.to(torch.float32).reshape(per)
        if thr_scope == "per_template":
            return (REL_THRESHOLD * gmax) * fac
        return (REL_THRESHOLD * gmax.amax(dim=0))[None] * fac

    if tile is None:
        corr_tiles = [xcorr.compute_cross_correlograms_corrected(trf, templates_true, mu, scale)]
        thr = resolve_thr(corr_tiles[0].amax(dim=(-2, -1)))
    else:
        corr_tiles, gmax = mf_correlate_tiled(trf, templates_true, mu, scale, tile)
        thr = resolve_thr(gmax)
    del trf
    hook("correlate")

    picks = []
    for i in range(len(corr_tiles)):
        picks.append(fused_picks.analytic_envelope_peaks(
            corr_tiles[i], thr[..., None], max_peaks=max_peaks, method=pick_method
        ))
        corr_tiles[i] = None   # free each tile's correlograms once picked
    positions = torch.cat([p.positions for p in picks], dim=-2)
    selected = torch.cat([p.selected for p in picks], dim=-2)
    saturated = torch.cat([p.saturated for p in picks], dim=-1)
    hook("pick")

    chan, times, count = mf_compact_tiled_picks(positions, selected, C, capacity)
    sat_count = saturated.sum(dim=-1).to(torch.int32).movedim(0, -1)
    hook("compact")
    return ProgramOutputs(chan, times, count, sat_count,
                          thr.to(torch.float32).movedim(0, -1), positions, selected, health)


@dataclass
class MatchedFilterResult:
    picks: Dict[str, np.ndarray]          # (2, n_picks) [channel_idx, time_idx]
    thresholds: Dict[str, float]
    #: the data-health stats (``ops.health.stats_to_dict``) with
    #: ``with_health=True``; empty otherwise
    health: Dict[str, float] = field(default_factory=dict)


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
    """

    def __init__(
        self,
        metadata,
        selected_channels,
        trace_shape,
        fk_config: FkFilterConfig = SCRIPT_FK,
        bp_band=(14.0, 30.0),
        templates=None,
        max_peaks: int = 256,
        channel_tile: int | str | None = "auto",
        hbm_budget_bytes: int | None = None,
        channel_pad=None,
        fused_bandpass: bool = True,
        pick_pack_cap: int = 1 << 18,
        wire: str = "conditioned",
        mf_engine: str = "fft",
        fk_engine: str = "fft",
        device=None,
    ):
        check_engines(mf_engine, fk_engine)
        meta = as_metadata(metadata)
        design = design_matched_filter(trace_shape, selected_channels, meta,
                                       fk_config, bp_band, templates,
                                       channel_pad=channel_pad)
        self._setup(design, meta, max_peaks=max_peaks, channel_tile=channel_tile,
                    hbm_budget_bytes=hbm_budget_bytes, fused_bandpass=fused_bandpass,
                    pick_pack_cap=pick_pack_cap, wire=wire, device=device)

    @classmethod
    def from_design(cls, design: MatchedFilterDesign, metadata, *,
                    max_peaks: int = 256, channel_tile: int | str | None = "auto",
                    hbm_budget_bytes: int | None = None, fused_bandpass: bool = True,
                    pick_pack_cap: int = 1 << 18, wire: str = "conditioned",
                    mf_engine: str = "fft", fk_engine: str = "fft",
                    device=None) -> "MatchedFilterDetector":
        """A detector on an existing design (e.g. one carried over from the
        JAX package by ``convert.design_from_arrays``)."""
        check_engines(mf_engine, fk_engine)
        if design.fk_channels != design.trace_shape[0]:
            raise _not_in_slice("a channel-padded design", "channel_pad")
        det = cls.__new__(cls)
        det._setup(design, as_metadata(metadata), max_peaks=max_peaks,
                   channel_tile=channel_tile, hbm_budget_bytes=hbm_budget_bytes,
                   fused_bandpass=fused_bandpass, pick_pack_cap=pick_pack_cap,
                   wire=wire, device=device)
        return det

    def _setup(self, design, meta, *, max_peaks, channel_tile, hbm_budget_bytes,
               fused_bandpass, pick_pack_cap, wire, device):
        if wire not in ("conditioned", "raw"):
            raise ValueError(f"unknown wire {wire!r}; expected 'conditioned' or 'raw'")
        self.device = resolve_device(device)
        self.metadata = meta
        self.design = design
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
        if fused_bandpass:
            # fold |H(f)|^2 into the mask; staged, the mask stays gainless
            gain_n = butter_zero_phase_gain(design.trace_shape[1], design.fs, design.bp_band,
                                            order=design.bp_order)
            mask_band = mask_band * gain_n[self._band_lo : self._band_hi][None, :]
        dev = self.device
        self._mask_band = torch.as_tensor(mask_band, device=dev)
        self._bp_gain = torch.as_tensor(design.bp_gain, device=dev)
        t_true, t_mu, t_scale = xcorr.padded_template_stats(design.templates)
        self._templates_true = torch.as_tensor(t_true, device=dev)
        self._template_mu = torch.as_tensor(t_mu, device=dev)
        self._template_scale = torch.as_tensor(t_scale, device=dev)
        self._thr_factors = torch.as_tensor(
            np.asarray(design.threshold_factors, np.float32), device=dev)
        self._cond_scale = float(np.float32(meta.scale_factor))

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
            return mf_filter_fused(x, self._mask_band, self._band_lo, self._band_hi)
        return mf_filter_only(x, self._mask_band, self._bp_gain, self._band_lo,
                              self._band_hi, self.design.bp_padlen)

    def detect_picks(self, trace, threshold: float | None = None,
                     n_real: int | None = None, with_health: bool = False,
                     health_clip: float | None = None,
                     stage_hook: Callable[[str], None] | None = None) -> MatchedFilterResult:
        """Picks-only detection: one program run and one packed fetch per
        attempt (``dispatch_picks(...).resolve()``)."""
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

        def run(k):
            self.dispatches += 1
            return mf_detect_picks_program(
                trace, self._mask_band, self._bp_gain, self._templates_true,
                self._template_mu, self._template_scale, thr_in, self._thr_factors,
                band_lo=self._band_lo, band_hi=self._band_hi,
                bp_padlen=self.design.bp_padlen, staged_bp=not self.fused_bandpass, tile=tile,
                max_peaks=k, capacity=cap, use_threshold=use_thr,
                pick_method=peak_ops.escalation_method(k, self.max_peaks),
                condition=self.wire == "raw", cond_scale=self._cond_scale,
                cond_n_real=cond_nr, thr_scope=self.threshold_scope,
                with_health=with_health, health_clip=health_clip, stage_hook=stage_hook,
            )

        health = {}
        n_samples = C * (int(n_real) if pad_real else trace.shape[1])

        def fetch(outs: ProgramOutputs):
            # THE one device->host copy of an attempt
            parts = [outs.chan, outs.times, outs.count, outs.sat_count,
                     outs.thr.view(torch.int32)]
            if with_health:
                parts += health_parts(outs.health)
            chan, times, count, satc, thr, *h = unpack(
                torch.cat([p.reshape(-1) for p in parts]).cpu().numpy(), parts)
            self.syncs += 1
            if with_health:
                health.update(health_from_parts(h, n_samples, C))
            return chan, times, count, satc, thr.view(np.float32)

        outs = run(self.pick_k0)

        def resolve():
            nonlocal outs
            chan, times, count, satc, thr = fetch(outs)
            if self.pick_k0 < self.max_peaks and int(satc.sum()):
                self.escalations += 1
                outs = run(self.max_peaks)
                chan, times, count, satc, thr = fetch(outs)
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
                peak_ops.warn_saturated(int(satc[i]), f"template {name}", self.max_peaks)
            return MatchedFilterResult(picks=picks, thresholds=thr_out, health=health)

        return InFlightResult(resolve)


def health_parts(health: tuple) -> list:
    """The health rows of a program's outputs as int32 tensors for the
    packed fetch (the float rows viewed bit for bit)."""
    counts, rms, bin_counts, bin_rms = health
    return [counts, rms.view(torch.int32), bin_counts, bin_rms.view(torch.int32)]


def unpack(packed: np.ndarray, parts: list) -> list:
    """Split the fetched int32 vector back into the shapes of ``parts``."""
    out, at = [], 0
    for p in parts:
        n = p.numel()
        out.append(packed[at : at + n].reshape(tuple(p.shape)))
        at += n
    return out


def health_from_parts(h: list, n_samples: int, n_channels: int) -> dict:
    """One record's fetched health rows -> its ``ops.health`` stats dict."""
    counts, rms, bin_counts, bin_rms = h
    return health_ops.stats_to_dict(counts, rms.view(np.float32), n_samples,
                                    bin_counts=bin_counts, bin_rms=bin_rms.view(np.float32),
                                    n_channels=n_channels)

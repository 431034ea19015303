"""Batched detection: B files a step on one card (the port's copy of
``das4whales_tpu.parallel.batch``).

A ``[B, channel, time]`` slab of same-bucket files (``io.stream.
stream_batched_slabs``) goes through the matched-filter detection
program once per attempt, with ONE packed device->host read per attempt
carrying every file's picks, thresholds and health rows. The per-file
math is the one detection program (``models.matched_filter.
mf_detect_picks_program``) over a leading file axis, in one of two modes
(``serial``):

* ``True`` — the program runs file by file (JAX's ``lax.map``): each
  file's outputs are bitwise those of ``detect_picks`` on that file.
  The default on the CPU.
* ``False`` — the program runs on the stack, every stage over the file
  axis at once (JAX's ``vmap``): the FFTs over ``[B, tile, ...]``, the
  pick kernel once a channel tile on ``nT * B * tile`` rows with per-row
  thresholds. Each
  file keeps its own threshold, health and picks; the thresholds may
  differ from the serial mode's in the last ulp where the batched FFTs
  round differently. The default on the card.

Eager PyTorch has no compiled shape to keep, so both modes compute only
the slab's ``n_valid`` real files; the empty slots past them are never
run. Heterogeneous record lengths ride shape buckets: on the raw wire
the program demeans each file over its own real samples (``n_real``),
and the health stats exclude the pad on either wire.

An attempt's packed read is queued on the card right behind its program
(``models.matched_filter.PackedFetch``): ``dispatch_batch`` returns with
the program and the copy in flight, and ``resolve()`` waits on the
copy's event alone — the campaign's pipelined dispatch enqueues the next
slab's program before it.

Not in this slice: ``split_views`` (it raises) waits for the banks with
decoupled thresholds (ROADMAP item 'Template banks beyond fin'),
``program_spec`` (absent) for the memory preflight ('Campaign
preflight'); the gabor and learned facades come with 'Gabor and
learned'.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from ..config import not_in_slice as _not_in_slice
from ..eval import SpectroEvalAdapter
from ..models.matched_filter import (
    InFlightResult,
    MatchedFilterDetector,
    PackedFetch,
    ProgramOutputs,
    health_from_parts,
    health_parts,
    mf_detect_picks_program,
)
from ..ops import health as health_ops
from ..ops import peaks as peak_ops


def _batched_body(stack: torch.Tensor, arrays: tuple, n_real, *, serial: bool,
                  **kw) -> ProgramOutputs:
    """The detection program over a ``[n, C, T]`` stack: at once over the
    file axis, or (``serial``) file by file with the outputs stacked.
    ``arrays`` are the program's positional device arrays, ``n_real``
    None or one real length per file, ``kw`` its keyword arguments."""
    if not serial:
        return mf_detect_picks_program(stack, *arrays, cond_n_real=n_real, **kw)
    outs = [mf_detect_picks_program(stack[b], *arrays,
                                    cond_n_real=None if n_real is None else n_real[b], **kw)
            for b in range(stack.shape[0])]
    health = (tuple(torch.stack(h) for h in zip(*(o.health for o in outs)))
              if outs[0].health is not None else None)
    return ProgramOutputs(*(torch.stack([getattr(o, f) for o in outs])
                            for f in ("chan", "times", "count", "sat_count", "thr")),
                          None, None, health)


def trim_picks(picks: Dict[str, np.ndarray], n_real: int) -> Dict[str, np.ndarray]:
    """Drop picks in a bucket-padded record's pad region (``time >=
    n_real``): the pad holds no signal, so anything picked there is
    filter ring-down past the record end. Exact-fit records pass through
    unchanged."""
    return {
        name: pk[:, pk[1] < n_real] if pk.shape[1] else pk
        for name, pk in picks.items()
    }


class BatchedMatchedFilterDetector:
    """Batched facade over one :class:`MatchedFilterDetector` built at the
    BUCKET shape: a ``[B, channel, time]`` slab in, per-file picks out,
    one packed read per attempt.

    The adaptive-K policy of ``detect_picks`` holds across the slab: a
    K0 = ``pick_k0`` ``pack`` attempt first, then one ``topk`` rerun at
    ``max_peaks`` only when any file's row saturated, decided from the
    packed K0 payload. ``serial=None`` resolves by the detector's device
    (serial on the CPU, batched on the card; module docstring). The
    wrapped detector's ``dispatches``/``syncs``/``escalations`` count
    the slab's attempts, reads and reruns. ``donate`` is accepted for
    the JAX signature and inert (eager PyTorch donates nothing).
    """

    family = "mf"

    def __init__(self, detector: MatchedFilterDetector, donate: bool = True,
                 serial: bool | None = None):
        self.det = detector
        self.donate = bool(donate)
        if serial is None:
            serial = detector.device.type == "cpu"
        self.serial = bool(serial)

    def split_views(self) -> tuple:
        raise _not_in_slice("split_views (the bank-split rung of the resource ladder)",
                            "Template banks beyond fin")

    def detect_batch(self, stack, n_real=None, n_valid: int | None = None,
                     with_health: bool = False, health_clip: float | None = None,
                     stage_hook: Callable[[str], None] | None = None) -> List[tuple | None]:
        """Detect over a ``[B, C, T]`` slab: ``dispatch_batch(...).resolve()``."""
        return self.dispatch_batch(stack, n_real=n_real, n_valid=n_valid,
                                   with_health=with_health, health_clip=health_clip,
                                   stage_hook=stage_hook).resolve()

    def dispatch_batch(self, stack, n_real=None, n_valid: int | None = None,
                       with_health: bool = False, health_clip: float | None = None,
                       stage_hook: Callable[[str], None] | None = None) -> InFlightResult:
        """Queue the K0 attempt on the card and return an
        :class:`InFlightResult`. ``resolve()`` makes the packed read,
        reruns at ``max_peaks`` when a row saturated, and returns one
        entry per real file: ``(picks {name: (2, n) int64}, thresholds
        {name: float})``, with a third element, the file's ``ops.health``
        stats dict, when ``with_health=True`` — or ``None`` where that
        file's packed capacity overflowed (the caller takes its exact
        per-file route, ``detect_picks`` on the block).

        ``n_real`` (one real time length per file) marks bucket-padded
        files; ``n_valid`` the slab's real files (the slots past it are
        not computed). ``stage_hook`` is the program's stage timer hook
        (serial mode: called for each file's stages)."""
        det = self.det
        C, T = det.design.trace_shape
        if tuple(stack.shape[1:]) != (C, T):
            raise ValueError(
                f"slab shape {tuple(stack.shape[1:])} != detector design shape "
                f"{(C, T)}; one batched detector serves one bucket"
            )
        B = int(stack.shape[0])
        nv = B if n_valid is None else int(n_valid)
        if not 1 <= nv <= B:
            raise ValueError(f"n_valid={n_valid} for a slab of {B} files")
        stack = det._as_input(stack)[:nv]
        names = det.design.template_names
        nT = len(names)
        cap = int(min(C * det.max_peaks, det.pick_pack_cap))
        thr_in = torch.zeros((nT,), dtype=torch.float32, device=det.device)
        tile = det.effective_channel_tile if det._route() == "tiled" else None
        n_reals = None if n_real is None else [int(v) for v in np.asarray(n_real).tolist()]
        if n_reals is not None and not 1 <= len(n_reals) <= B:
            raise ValueError(f"n_real must be a <= {B}-vector, got {len(n_reals)} entries")
        nr = None
        if (det.wire == "raw" or with_health) and n_reals is not None:
            # file slots without an entry are whole-length
            full = (n_reals + [T] * nv)[:nv]
            if min(full) < T:
                nr = full
        kw = dict(
            band_lo=det._band_lo, band_hi=det._band_hi, bp_padlen=det.design.bp_padlen,
            staged_bp=not det.fused_bandpass, tile=tile, capacity=cap, use_threshold=False,
            condition=det.wire == "raw", cond_scale=det._cond_scale,
            thr_scope=det.threshold_scope, with_health=with_health, health_clip=health_clip,
            stage_hook=stage_hook,
        )
        arrays = (det._mask_band, det._bp_gain, det._templates_true, det._template_mu,
                  det._template_scale, thr_in, det._thr_factors)

        def run(k) -> ProgramOutputs:
            det.dispatches += 1
            return _batched_body(stack, arrays, nr, serial=self.serial, max_peaks=k,
                                 pick_method=peak_ops.escalation_method(k, det.max_peaks), **kw)

        def start_fetch(outs: ProgramOutputs) -> PackedFetch:
            # THE one device->host read of an attempt, every file's rows
            # in it, queued right behind the program
            parts = [outs.chan, outs.times, outs.count, outs.sat_count,
                     outs.thr.view(torch.int32)]
            if with_health:
                parts += health_parts(outs.health)
            return PackedFetch(parts)

        def fetch(pending: PackedFetch):
            vals = pending.wait()
            det.syncs += 1
            return vals

        state = {"k0": start_fetch(run(det.pick_k0))}

        def resolve() -> List[tuple | None]:
            chan, times, cnt, satc, thr, *h = fetch(state.pop("k0"))
            if det.pick_k0 < det.max_peaks and int(satc.sum()):
                # a row saturated at K0: the full-capacity rerun, decided
                # from the packed K0 payload already read
                det.escalations += 1
                chan, times, cnt, satc, thr, *h = fetch(start_fetch(run(det.max_peaks)))
            thr = thr.view(np.float32)
            out: List[tuple | None] = []
            for b in range(nv):
                if int(cnt[b].max(initial=0)) > cap:
                    out.append(None)   # packed overflow: the exact per-file route
                    continue
                picks, thr_out = {}, {}
                for i, name in enumerate(names):
                    k = int(cnt[b, i])
                    picks[name] = np.asarray([chan[b, i, :k], times[b, i, :k]], dtype=np.int64)
                    thr_out[name] = float(thr[b, i])
                    peak_ops.warn_saturated(int(satc[b, i]), f"template {name}", det.max_peaks)
                if with_health:
                    ns_b = n_reals[b] if n_reals is not None and b < len(n_reals) else T
                    out.append((picks, thr_out, health_from_parts(
                        [v[b] for v in h], C * ns_b, C)))
                else:
                    out.append((picks, thr_out))
            return out

        return InFlightResult(resolve)


class _BatchedFamilyDetector:
    """Batched-facade machinery for the detector families without a fused
    program (spectro here): a ``[B, C, T]`` slab in, per-file ``(picks,
    thresholds[, stats])`` entries out. The heavy stage (prefilter +
    correlograms) runs file by file (``serial``) or over the file axis
    at once; the finalize stage is the family's own per-file picking.
    Health stats are the host-side ``ops.health.host_health_stats`` of
    each file's block, read back from the slab."""

    family = "generic"

    def __init__(self, detector, donate: bool = True, serial: bool | None = None,
                 trace_shape=None):
        self.det = detector
        self.donate = bool(donate)
        if serial is None:
            serial = self._device().type == "cpu"
        self.serial = bool(serial)
        if trace_shape is None:
            trace_shape = self._design_shape()
        self._trace_shape = None if trace_shape is None else tuple(int(s) for s in trace_shape)

    def _device(self) -> torch.device:
        raise NotImplementedError

    def _design_shape(self):
        return None

    def _heavy(self, stack: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The heavy stage over ``stack [n, C, T]``: ``{name: [n, ...]}``."""
        raise NotImplementedError

    def _finalize_one(self, heavy, b: int):
        raise NotImplementedError

    def detect_batch(self, stack, n_real=None, n_valid: int | None = None,
                     with_health: bool = False, health_clip: float | None = None
                     ) -> List[tuple]:
        """Detect over a ``[B, C, T]`` slab: one entry per real file, never
        None (these families have no packed capacity)."""
        return self.dispatch_batch(stack, n_real=n_real, n_valid=n_valid,
                                   with_health=with_health, health_clip=health_clip).resolve()

    def dispatch_batch(self, stack, n_real=None, n_valid: int | None = None,
                       with_health: bool = False, health_clip: float | None = None
                       ) -> InFlightResult:
        B = int(stack.shape[0])
        got = tuple(int(s) for s in stack.shape[1:])
        if self._trace_shape is not None and got != self._trace_shape:
            raise ValueError(
                f"slab shape {got} != detector design shape {self._trace_shape}; "
                "one batched detector serves one bucket"
            )
        nv = B if n_valid is None else int(n_valid)
        stack = stack[:nv]
        host_rows = None
        if with_health:
            host_rows = (stack.cpu().numpy() if isinstance(stack, torch.Tensor)
                         else np.asarray(stack))
        state = {"heavy": self._heavy(stack)}

        def resolve() -> List[tuple]:
            heavy = state.pop("heavy")
            out = []
            for b in range(nv):
                picks, thresholds = self._finalize_one(heavy, b)
                if with_health:
                    out.append((picks, thresholds,
                                health_ops.host_health_stats(host_rows[b], clip_abs=health_clip)))
                else:
                    out.append((picks, thresholds))
            return out

        return InFlightResult(resolve)


class BatchedSpectroDetector(_BatchedFamilyDetector):
    """Batched facade over one ``eval.SpectroEvalAdapter``: the heavy
    stage is the shared bandpass + f-k prefilter and the per-kernel
    spectro correlograms (batched: the prefilter over ``[n, C, T]`` and
    the correlograms over the ``n * C`` channels, which the family treats
    one by one); finalize is the adapter's own pick + hop->sample
    conversion per file."""

    family = "spectro"

    def _device(self) -> torch.device:
        return self.det.det.device

    def _design_shape(self):
        design = getattr(self.det.prefilter, "design", None)
        return getattr(design, "trace_shape", None)

    def _heavy(self, stack):
        adapter = self.det
        filt = getattr(adapter.prefilter, "filter_block", adapter.prefilter)
        if self.serial:
            per = [adapter.det.correlograms(filt(stack[b])) for b in range(stack.shape[0])]
            return {name: torch.stack([p[name] for p in per]) for name in per[0]}
        n, C, T = stack.shape
        trf = filt(stack)
        corr = adapter.det.correlograms(trf.reshape(n * C, T))
        return {name: v.reshape(n, C, v.shape[-1]) for name, v in corr.items()}

    def _finalize_one(self, heavy, b: int):
        sdet = self.det.det
        picks, spectro_fs = sdet.picks_from_correlograms({name: v[b] for name, v in heavy.items()})
        fs = sdet.metadata.fs
        out = {}
        for name, pk in picks.items():
            pk = np.asarray(pk)
            t_samples = np.round(pk[1] * (fs / spectro_fs)).astype(int)
            out[name] = np.asarray([pk[0], t_samples])
        thr = float(sdet.threshold)
        return out, {name: thr for name in out}


def batched_detector_for(detector, *, donate: bool = True, serial: bool | None = None,
                         trace_shape=None):
    """Any campaign detector -> its batched facade: the matched filter and
    the spectro family. Gabor and learned come with their ROADMAP item."""
    if isinstance(detector, MatchedFilterDetector):
        return BatchedMatchedFilterDetector(detector, donate=donate, serial=serial)
    if isinstance(detector, SpectroEvalAdapter):
        return BatchedSpectroDetector(detector, donate=donate, serial=serial,
                                      trace_shape=trace_shape)
    if type(detector).__name__ in ("GaborEvalAdapter", "LearnedDetector"):
        raise _not_in_slice(f"the batched facade of {type(detector).__name__}",
                            "Gabor and learned")
    raise TypeError(
        f"no batched facade for detector type {type(detector).__name__}; "
        "families with one: matched filter, spectro"
    )

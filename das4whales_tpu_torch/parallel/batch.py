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

``split_views`` gives the ladder's bank-split rung: two facades over the
halves of a bank with decoupled thresholds, each on the parent's sliced
template tensors (``MatchedFilterDetector.split_views``).

The learned family's facade (:class:`BatchedLearnedDetector`) scores a
slab's windows in chunks of at most :data:`LEARNED_BATCH_ROWS` rows, so
its activations stay bounded at any batch size.

Every facade carries ``program_spec(batch, stack_dtype, ...)``: the
program the memory preflight, the cost cards and the service's
admission price (``utils.memory.ProgramSpec``) — a callable that runs
the facade's batched program once on a ``[B, C, T]`` stack (the matched
filter's full-capacity escalation attempt), its probe key, and its
operations and bytes counted stage by stage.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from ..eval import GaborEvalAdapter, SpectroEvalAdapter
from ..models.learned import FEATURE_STFT_ENGINE, LearnedDetector
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
from ..ops.xcorr import next_fast_len
from ..telemetry import costs
from ..utils import oprecord
from ..utils.memory import ProgramSpec


_rfft_ops = costs.rfft_ops


def _counted(stages: list) -> dict:
    """Sum ``(name, ops, bytes, transcendentals)`` stage rows into the
    ``ProgramSpec`` count fields."""
    return dict(flops=float(sum(r[1] for r in stages)),
                bytes_accessed=float(sum(r[2] for r in stages)),
                transcendentals=float(sum(r[3] for r in stages)),
                stages=tuple(r[0] for r in stages))


def _fk_stage(mf: MatchedFilterDetector, B: int) -> tuple:
    """The f-k filter's counted row for ``B`` files on ``mf``'s design and
    f-k engine (``telemetry.costs.fk_stage``)."""
    C, T = mf.design.trace_shape
    return costs.fk_stage(mf.fk_engine, B, C, T, int(mf.design.fk_channels),
                          int(mf._band_hi - mf._band_lo))


def _fk_sizing(mf: MatchedFilterDetector) -> tuple:
    """What sizes the buffers of ``mf``'s bandpass and f-k stages (a
    probe key's part, ``utils.memory``): the band, the f-k channel
    count, the bandpass padding and form, the route."""
    return (int(mf._band_lo), int(mf._band_hi), int(mf.design.fk_channels),
            int(mf.design.bp_padlen), bool(mf.fused_bandpass), mf._route())


def _stft_stage(name: str, rows: int, T: int, nfft: int, hop: int) -> tuple:
    """The STFT-power kernel's counted row (``chip_smoke.py``'s bound:
    per frame the window, a real FFT and the power; the input read once,
    the power written once)."""
    F = nfft // 2 + 1
    nf = 1 + T // hop
    return (name, rows * nf * (nfft + _rfft_ops(nfft) + 3 * F),
            4 * rows * T + 4 * nfft * 2 * F + 4 * rows * F * nf, 0.0)


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
        """The bank-split rung's pair of sub-bank facades (T ->
        ceil(T/2) + floor(T/2) over the same bucket shape and mode,
        ``MatchedFilterDetector.split_views``): two dispatches, each with
        about half the correlate and pick working set, before the ladder
        gives up batch size. Neither donates. Cached: one pair a facade."""
        cached = self.__dict__.get("_split_cache")
        if cached is None:
            a, b = self.det.split_views()
            cached = self.__dict__["_split_cache"] = (
                BatchedMatchedFilterDetector(a, donate=False, serial=self.serial),
                BatchedMatchedFilterDetector(b, donate=False, serial=self.serial),
            )
        return cached

    def _program_args(self, with_health: bool, health_clip, stage_hook=None) -> tuple:
        """The detection program's positional device arrays, keyword
        arguments (less ``max_peaks``/``pick_method``) and packed
        capacity: one definition for ``dispatch_batch`` and
        ``program_spec``."""
        det = self.det
        C, _T = det.design.trace_shape
        nT = len(det.design.template_names)
        cap = int(min(C * det.max_peaks, det.pick_pack_cap))
        thr_in = torch.zeros((nT,), dtype=torch.float32, device=det.device)
        tile = det.effective_channel_tile if det._route() == "tiled" else None
        # the detector's engines: the matmul f-k's DFT pair and the tap-fold
        # pair serve every file of the slab
        mask, staged_bp, engine_kw = det._program_inputs()
        kw = dict(
            band_lo=det._band_lo, band_hi=det._band_hi, bp_padlen=det.design.bp_padlen,
            staged_bp=staged_bp, tile=tile, pad_rows=det.fk_pad_rows,
            capacity=cap, use_threshold=False,
            condition=det.wire == "raw", cond_scale=det._cond_scale,
            thr_scope=det.threshold_scope, with_health=with_health, health_clip=health_clip,
            stage_hook=stage_hook, **engine_kw,
        )
        arrays = (mask, det._bp_gain, det._templates_true, det._template_mu,
                  det._template_scale, thr_in, det._thr_factors)
        return arrays, kw, cap

    def program_spec(self, batch: int, stack_dtype, *, with_health: bool = False,
                     health_clip: float | None = None) -> ProgramSpec:
        """The priced program (``utils.memory``): one full-capacity
        attempt (K = ``max_peaks``, ``topk`` — the escalation the K0
        attempt may take; a zero slab saturates no row, so it is run
        explicitly) over a ``[batch, C, T]`` stack, with its packed read
        (the attempt's device-side concatenation) and health rows."""
        det = self.det
        C, T = det.design.trace_shape
        nT = int(det.design.templates.shape[0])
        arrays, kw, cap = self._program_args(with_health, health_clip)
        K = int(det.max_peaks)

        def run(stack):
            outs = _batched_body(det._as_input(stack), arrays, None, serial=self.serial,
                                 max_peaks=K, pick_method=peak_ops.escalation_method(K, K),
                                 **kw)
            parts = [outs.chan, outs.times, outs.count, outs.sat_count,
                     outs.thr.view(torch.int32)]
            if with_health:
                parts += health_parts(outs.health)
            return PackedFetch(parts).wait()

        B = int(batch)
        itemsize = np.dtype(stack_dtype).itemsize
        rows_in, rows_c = B * C, nT * B * C
        n_corr = next_fast_len(T + int(det.design.templates.shape[-1]) - 1)
        stages = [
            # the raw wire's demean and scale, or the conditioned wire's cast
            ("condition", 3.0 * rows_in * T, rows_in * T * (itemsize + 4), 0.0),
            _fk_stage(det, B),
            costs.correlate_stage(det.mf_engine, rows_in, nT, T,
                                  int(det._templates_true.shape[-1]), n_corr, det._mf_fir_half),
            # the threshold's max over each file's correlograms
            ("threshold", 1.0 * rows_c * T, rows_c * T * 4, 0.0),
            # the analytic signal: rfft, the one-sided mask, complex ifft
            ("hilbert", rows_c * (_rfft_ops(T) + 2 * _rfft_ops(T) + 2.0 * T),
             rows_c * T * (4 + 8), 0.0),
            # the pick kernel: re and im read once, slots written once
            ("picks", 4.0 * rows_c * T, rows_c * (8 * T + 16 * K + 4), 1.0 * rows_c * T),
            ("compact", 2.0 * rows_c * K, rows_c * K * 8 + nT * B * cap * 8, 0.0),
        ]
        if with_health:
            stages.append(("health", 4.0 * rows_in * T, rows_in * T * itemsize, 0.0))
        key = ("mf", C, T, B, np.dtype(stack_dtype).name, bool(with_health), nT,
               int(det.design.templates.shape[-1]), K, cap, kw["tile"], kw["pad_rows"],
               _fk_sizing(det), det.threshold_scope, bool(self.serial), det.wire,
               str(det.device), det.mf_engine, det.fk_engine)
        return ProgramSpec(family="mf", run=run, shape=(B, C, T), dtype=np.dtype(stack_dtype),
                           device=det.device, key=key, **_counted(stages))

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
        n_reals = None if n_real is None else [int(v) for v in np.asarray(n_real).tolist()]
        if n_reals is not None and not 1 <= len(n_reals) <= B:
            raise ValueError(f"n_real must be a <= {B}-vector, got {len(n_reals)} entries")
        nr = None
        if (det.wire == "raw" or with_health) and n_reals is not None:
            # file slots without an entry are whole-length
            full = (n_reals + [T] * nv)[:nv]
            if min(full) < T:
                nr = full
        arrays, kw, cap = self._program_args(with_health, health_clip, stage_hook)

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
                    det._warn_saturated(name, int(satc[b, i]))
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
    program (spectro, Gabor and learned): a ``[B, C, T]`` slab in,
    per-file ``(picks, thresholds[, stats])`` entries out. The heavy
    stage (the family's device work) runs file by file (``serial``) or
    over the file axis at once; the finalize stage is the family's own
    per-file picking.
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

    def _fetch(self, heavy):
        """The heavy output as :meth:`_finalize_one` reads it: as it is,
        on the device, unless the family reads it to the host once."""
        return heavy

    def _finalize_one(self, heavy, b: int):
        raise NotImplementedError

    def _stages(self, B: int, C: int, T: int) -> list:
        """The heavy stage's counted rows (``_counted``) for ``B`` files."""
        raise NotImplementedError

    def _n_templates(self) -> int:
        cfgs = getattr(self.det, "template_configs", None)
        return int(len(cfgs)) if cfgs else 1

    def _sizing(self) -> tuple:
        """What sizes the heavy stage's buffers besides the slab's shape
        (the family's part of the probe key, ``utils.memory``)."""
        raise NotImplementedError

    def program_spec(self, batch: int, stack_dtype, *, with_health: bool = False,
                     health_clip: float | None = None) -> ProgramSpec:
        """The priced program (``utils.memory``): the heavy stage over a
        ``[batch, C, T]`` stack and its read. Health stats are host-side
        for these families, so the priced program is the same with or
        without them."""
        if self._trace_shape is None:
            raise ValueError(
                f"cannot price a {self.family} batched program without a bucket shape; "
                "construct the facade with trace_shape=(C, T)"
            )
        C, T = self._trace_shape
        B = int(batch)

        def run(stack):
            return self._fetch(self._heavy(stack))

        key = (self.family, C, T, B, np.dtype(stack_dtype).name, bool(with_health),
               self._n_templates(), self._sizing(), bool(self.serial), str(self._device()))
        return ProgramSpec(family=self.family, run=run, shape=(B, C, T),
                           dtype=np.dtype(stack_dtype), device=self._device(), key=key,
                           **_counted(self._stages(B, C, T)))

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
            heavy = self._fetch(state.pop("heavy"))
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

    def _sizing(self):
        sdet = self.det.det
        return (_fk_sizing(self.det.prefilter), float(sdet.win_size), float(sdet.overlap_pct),
                float(sdet.metadata.fs), repr(sorted(sdet.kernels.items())),
                repr(sdet.flims), sdet.batch_channels, sdet.stft_engine)

    def _stages(self, B, C, T):
        sdet = self.det.det
        nperseg = int(sdet.win_size * sdet.metadata.fs)
        nhop = max(1, int(np.floor(nperseg * (1 - sdet.overlap_pct))))
        # the prefilter and one STFT-power launch a hat kernel; the
        # correlation over the band is not counted
        return [_fk_stage(self.det.prefilter, B)] + [
            _stft_stage(f"{name}.stft", B * C, T, nperseg, nhop) for name in sdet.kernels]

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


class BatchedGaborDetector(_BatchedFamilyDetector):
    """Batched facade over one ``eval.GaborEvalAdapter``: the heavy stage
    is the shared bandpass + f-k prefilter, the oriented Gabor pair and
    the per-note masked matched filter, and it keeps the correlograms
    only (batched: every stage over ``[n, C, T]`` at once, each file with
    its own image scale and mask renormalisation); finalize is the
    detector's relative-threshold policy and per-note picks per file.
    Gabor batches over FILES, so the channel seams that forbid the
    family's tiled rung (``workflows.planner.GaborProgram``) never
    arise."""

    family = "gabor"

    def _device(self) -> torch.device:
        return self.det.det.device

    def _design_shape(self):
        design = getattr(self.det.prefilter, "design", None)
        return getattr(design, "trace_shape", None)

    def _heavy(self, stack):
        adapter = self.det
        filt = getattr(adapter.prefilter, "filter_block", adapter.prefilter)
        if self.serial:
            per = [adapter.det.correlograms(filt(stack[b]))[3] for b in range(stack.shape[0])]
            return {name: torch.stack([p[name] for p in per]) for name in per[0]}
        return adapter.det.correlograms(filt(stack))[3]

    def _sizing(self):
        gdet = self.det.det
        return (_fk_sizing(self.det.prefilter), tuple(tuple(k.shape) for k in gdet._kernels),
                tuple(sorted((n, tuple(a.shape)) for n, a in gdet._note_arrays.items())),
                gdet.max_peaks, gdet.gabor_engine)

    def _stages(self, B, C, T):
        # the prefilter; the image stages are not counted
        return [_fk_stage(self.det.prefilter, B)]

    def _finalize_one(self, heavy, b: int):
        picks, _, thresholds = self.det.det.picks_from_correlograms(
            {name: v[b] for name, v in heavy.items()})
        return {k: np.asarray(v) for k, v in picks.items()}, dict(thresholds)


#: Window rows a CNN pass of the batched learned facade takes at most:
#: 2^20 rows of [32, 8] windows give conv0 an output of 2^30 float32
#: elements (4.3 GB) and conv1 a padded input of 1.43e9 (5.7 GB), about
#: 10 GB live at a time, so a [4, 22050, 12000] slab (8.2M windows) scores
#: in 8 passes where one pass would hold about 78 GB (PERF.md §5).
LEARNED_BATCH_ROWS = 1 << 20


class BatchedLearnedDetector(_BatchedFamilyDetector):
    """Batched facade over one ``models.learned.LearnedDetector``: the
    heavy stage is the windowed features and the CNN's sigmoid scores,
    ``[n, C, n_win]`` on the device (serial: file by file, each file the
    per-file call's one-program sweep; batched: the STFT kernel once over
    the slab's ``n * C`` rows, the CNN in passes of at most
    :data:`LEARNED_BATCH_ROWS` window rows); finalize is the detector's
    threshold and per-channel NMS on the host. The bucket shape is not
    derivable from the detector: pass ``trace_shape``."""

    family = "learned"

    def _device(self) -> torch.device:
        return self.det.device

    @property
    def engine(self) -> str:
        """The STFT engine the features ride."""
        return FEATURE_STFT_ENGINE

    def _heavy(self, stack):
        det = self.det
        if self.serial:
            return torch.stack([det.scores(stack[b]) for b in range(stack.shape[0])])
        n, C, T = stack.shape
        scores = det.scores(torch.as_tensor(stack).reshape(n * C, T),
                            row_chunk=LEARNED_BATCH_ROWS)
        return scores.reshape(n, C, scores.shape[-1])

    def _sizing(self):
        return (repr(self.det.cfg), self.det.row_chunk, self.engine, LEARNED_BATCH_ROWS)

    def _stages(self, B, C, T):
        cfg = self.det.cfg
        nf = 1 + T // cfg.hop
        n_win = max(0, (nf - cfg.win_frames) // cfg.win_stride + 1)
        win = cfg.fmax_bin * cfg.win_frames
        conv_ops = 2 * (cfg.features[0] * (cfg.fmax_bin // 2) * (cfg.win_frames // 2) * 9
                        + cfg.features[1] * (cfg.fmax_bin // 4) * (cfg.win_frames // 4) * 9
                        * cfg.features[0])
        rows = B * C
        return [_stft_stage("stft", rows, T, cfg.nfft, cfg.hop),
                # the sqrt and log of the kept bins, each window standardised
                ("features", rows * (3.0 * cfg.fmax_bin * nf + 4.0 * n_win * win),
                 rows * 4 * (cfg.fmax_bin * nf + n_win * win), 2.0 * rows * cfg.fmax_bin * nf),
                # the CNN's convolutions (multiply-adds as 2) and its sigmoid
                ("cnn", rows * n_win * conv_ops, rows * n_win * (win + 1) * 4,
                 1.0 * rows * n_win)]

    def _fetch(self, heavy):
        # the slab's one device->host read: every file's scores
        self.det.syncs += 1
        with oprecord.counted_read():
            return heavy.cpu().numpy()

    def _finalize_one(self, heavy, b: int):
        res = self.det.picks_from_scores(heavy[b])
        return dict(res.picks), dict(res.thresholds)


def batched_detector_for(detector, *, donate: bool = True, serial: bool | None = None,
                         trace_shape=None):
    """Any campaign detector -> its batched facade: the matched filter, the
    spectro, the Gabor and the learned family (``trace_shape`` pins the
    bucket ``(C, T)`` where the family cannot derive it)."""
    if isinstance(detector, MatchedFilterDetector):
        return BatchedMatchedFilterDetector(detector, donate=donate, serial=serial)
    if isinstance(detector, SpectroEvalAdapter):
        return BatchedSpectroDetector(detector, donate=donate, serial=serial,
                                      trace_shape=trace_shape)
    if isinstance(detector, GaborEvalAdapter):
        return BatchedGaborDetector(detector, donate=donate, serial=serial,
                                    trace_shape=trace_shape)
    if isinstance(detector, LearnedDetector):
        return BatchedLearnedDetector(detector, donate=donate, serial=serial,
                                      trace_shape=trace_shape)
    raise TypeError(
        f"no batched facade for detector type {type(detector).__name__}; "
        "families with one: matched filter, spectro, gabor, learned"
    )

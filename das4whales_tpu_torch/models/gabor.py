"""Gabor/image-based whale-call detector in PyTorch (the third detector
family; the port's copy of ``das4whales_tpu.models.gabor``, the
reference's ``main_gabordetect.py``).

The f-k-filtered t-x envelope is treated as an image: a Gabor pair
oriented along the sound-speed moveout scores the binned image, two
threshold stages build a binary mask, the mask is upsampled and smoothed
onto the strain block, and a masked matched filter per call note gives
correlograms. Their picks run through the fused pick kernel
(``ops.fused_picks.analytic_envelope_peaks``: the Hilbert envelope and
the sparse prominence picker, the kernel on a CUDA tensor, its plain
version on the CPU), with the adaptive-K escalation of the other
families.

Differences of procedure from the JAX package, none of result:

* the Gabor pair and the notes are kept on the device, made once per
  detector (a host-to-device copy would wait for the stream at every
  call);
* the notes are synthesized in float64 and rounded to float32 once; with
  x64 off the JAX package synthesizes the chirp in float32, about 1e-6
  of their peak apart (``convert.gabor_detector_from_jax`` carries JAX's
  own notes across);
* the masked matched filter gathers the scipy ``same`` window of the
  circular correlation directly instead of rolling the whole FFT length
  first — the same samples.

``gabor_engine``: ``"fft"`` or ``"conv"`` forced; None takes
``DAS_GABOR_ENGINE``, else ``"fft"``; ``"auto"`` runs the per-shape A/B
of ``ops.mxu.resolve_gabor_engine`` at the first block's binned shape
(``"fft"`` off a CUDA device, where it resolves at construction).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..config import C0_WATER, as_metadata
from ..ops import fused_picks
from ..ops import image as img_ops
from ..ops import mxu
from ..ops import peaks as peak_ops
from ..utils.device import resolve_device
from ..utils.views import cached_shallow_view
from .templates import gen_hyperbolic_chirp

#: The reference's two fin-call notes: ``(fmin, fmax, duration)``.
DEFAULT_NOTES = {"HF": (17.8, 28.8, 0.68), "LF": (14.7, 21.8, 0.78)}


@dataclass
class GaborDesign:
    gabor_up: np.ndarray
    gabor_down: np.ndarray
    theta_c0: float
    bin_factor: float
    threshold1: float
    threshold2: float


def design_gabor(
    metadata,
    selected_channels,
    c0: float = C0_WATER,
    bin_factor: float = 0.1,
    threshold1: float = 9100.0,
    threshold2: float = 150.0,
    ksize: int = 100,
) -> GaborDesign:
    """Gabor pair oriented along the c0 moveout in the binned image, with
    the script's two detection thresholds (main_gabordetect.py:87-137)."""
    meta = as_metadata(metadata)
    theta = img_ops.angle_fromspeed(c0, meta.fs, meta.dx, list(selected_channels))
    up, down = img_ops.gabor_filt_design(theta, ksize=ksize)
    return GaborDesign(up, down, theta, bin_factor, threshold1, threshold2)


def _gabor_score(image: torch.Tensor, up: torch.Tensor, down: torch.Tensor,
                 engine: str = "fft") -> torch.Tensor:
    """Sum of both-orientation Gabor responses (``cv2.filter2D``
    correlation, main_gabordetect.py:109)."""
    return (img_ops.filter2d_same(image, up, engine=engine)
            + img_ops.filter2d_same(image, down, engine=engine))


def gabor_mask(trf_fk: torch.Tensor, design: GaborDesign, engine: str = "fft",
               kernels: Tuple[torch.Tensor, torch.Tensor] | None = None,
               stage_hook: Callable[[str], None] | None = None):
    """The binned Gabor score, the binary mask and the full-resolution
    smooth-masked trace (main_gabordetect.py:78-169), batched over leading
    axes (each image its own scale). ``kernels`` are the design's pair as
    tensors on ``trf_fk``'s device (made here when None). ``stage_hook``
    is called after ``trace2image``, ``binning``, ``score``, ``mask`` and
    ``smooth``.

    Returns ``(score, mask_binned, masked_trace)``."""
    hook = stage_hook or (lambda name: None)
    if kernels is None:
        kernels = tuple(torch.as_tensor(np.ascontiguousarray(k), dtype=trf_fk.dtype,
                                        device=trf_fk.device)
                        for k in (design.gabor_up, design.gabor_down))
    up, down = kernels
    image = img_ops.trace2image(trf_fk)
    hook("trace2image")
    imagebin = img_ops.binning(image, design.bin_factor, design.bin_factor)
    del image
    hook("binning")
    score = _gabor_score(imagebin, up, down, engine=engine)
    hook("score")
    binary = (score > design.threshold1).to(trf_fk.dtype)
    mask_binned = _gabor_score(binary, up, down, engine=engine) > design.threshold2
    hook("mask")
    # upsample the mask back to the exact trace shape in one resize
    mask_full = img_ops.resize_linear(mask_binned.to(trf_fk.dtype), tuple(trf_fk.shape[-2:]),
                                      antialias=False)
    masked_tr = img_ops.apply_smooth_mask(trf_fk, mask_full)
    hook("smooth")
    return score, mask_binned, masked_tr


def masked_matched_filter(masked_tr: torch.Tensor, note: torch.Tensor) -> torch.Tensor:
    """Same-mode correlation of the per-channel max-normalized masked trace
    with a call note; channels masked out entirely stay zero
    (main_gabordetect.py:243-246), at the JAX package's pow2 FFT length."""
    mx = masked_tr.amax(dim=-1, keepdim=True)
    norm = torch.where(mx > 0, masked_tr / torch.where(mx > 0, mx, 1.0), 0.0)
    n, m = masked_tr.shape[-1], note.shape[-1]
    nfft = int(2 ** np.ceil(np.log2(n + m - 1)))
    X = torch.fft.rfft(norm, nfft, dim=-1)
    del norm
    X *= torch.conj(torch.fft.rfft(note, nfft))
    full = torch.fft.irfft(X, nfft, dim=-1)
    del X
    # scipy.correlate 'same': lags -(m-1-start) .. n-1-(m-1-start) of the
    # circular correlation, start = (m-1)//2
    s = m - 1 - (m - 1) // 2
    return torch.cat([full[..., nfft - s :], full[..., : n - s]], dim=-1)


def synthesize_notes(note_params: Dict[str, Tuple[float, float, float]], fs: float
                     ) -> Dict[str, np.ndarray]:
    """Hann-windowed hyperbolic chirp per ``(fmin, fmax, duration)`` note,
    float32 host arrays (main_gabordetect.py:186-200)."""
    out = {}
    for name, (fmin, fmax, dur) in note_params.items():
        chirp = gen_hyperbolic_chirp(fmin, fmax, dur, fs)
        out[name] = (chirp * np.hanning(len(chirp))).astype(np.float32)
    return out


class GaborDetector:
    """Design-once / detect-many façade for the image-based detector.

    Defaults reproduce ``main_gabordetect.py``: c0 = 1500 m/s, bin factor
    0.1, ``ksize=100`` (a 101 x 101 pair), thresholds 9100 / 150, the HF
    and LF fin notes, picks at 0.5 · the correlograms' max (HF at 0.9 ×).
    Plain counters on the instance: ``syncs`` (device->host reads) and
    ``escalations`` (K0 -> K reruns, one per note that saturated).
    """

    def __init__(
        self,
        metadata,
        selected_channels,
        c0: float = C0_WATER,
        bin_factor: float = 0.1,
        threshold1: float = 9100.0,
        threshold2: float = 150.0,
        notes: Dict[str, Tuple[float, float, float]] | None = None,
        max_peaks: int = 256,
        ksize: int = 100,
        gabor_engine: str | None = None,
        device=None,
        *,
        design: GaborDesign | None = None,
        note_arrays: Dict[str, np.ndarray] | None = None,
    ):
        self.device = resolve_device(device)
        self.metadata = as_metadata(metadata)
        if design is None:
            design = design_gabor(self.metadata, selected_channels, c0, bin_factor,
                                  threshold1, threshold2, ksize=ksize)
        self.design = design
        # (fmin, fmax, duration) per note, kept for the eval adapter's
        # call-to-template association
        self.note_params = dict(DEFAULT_NOTES if notes is None else notes)
        if note_arrays is None:
            note_arrays = synthesize_notes(self.note_params, self.metadata.fs)
        if set(note_arrays) != set(self.note_params):
            raise ValueError(f"note arrays {sorted(note_arrays)} != notes "
                             f"{sorted(self.note_params)}")
        self._note_arrays = {name: np.asarray(note_arrays[name], np.float32)
                             for name in self.note_params}
        self.max_peaks = max_peaks
        # the resolved engine and its reason (gabor_engine /
        # gabor_engine_reason): a forced engine resolves now, "auto" on the
        # card at the first block's binned shape
        self._gabor_engine_req = gabor_engine
        self.gabor_engine: str | None = None
        self.gabor_engine_reason: str | None = None
        self.resolve_engine()
        self.syncs = self.escalations = 0
        self._to_device()

    def _to_device(self) -> None:
        dev = self.device
        self._kernels = tuple(
            torch.as_tensor(np.ascontiguousarray(k), dtype=torch.float32, device=dev)
            for k in (self.design.gabor_up, self.design.gabor_down))
        self.notes = {name: torch.as_tensor(a, device=dev)
                      for name, a in self._note_arrays.items()}

    def host_view(self) -> "GaborDetector":
        """This detector on the CPU (the ladder's host rung): every stage
        runs its plain PyTorch version there, the pick kernel's included.
        Cached: repeated calls return the same view."""

        def mutate(det):
            det.device = torch.device("cpu")
            det._to_device()

        return cached_shallow_view(self, "_host_view_cache", mutate)

    def resolve_engine(self, trace_shape=None) -> str | None:
        """The oriented pair's correlation engine, resolved once and cached
        on self (``ops.mxu.resolve_gabor_engine``): a forced engine, or
        ``"auto"`` off a CUDA device, at construction; ``"auto"`` on the
        card at the BINNED image shape of ``trace_shape``, the first
        block's."""
        if self.gabor_engine is None:
            req = mxu.requested_gabor_engine(self._gabor_engine_req)
            if req == "auto" and self.device.type == "cuda" and trace_shape is None:
                return None
            binned = (0, 0) if trace_shape is None else (
                max(1, int(trace_shape[-2] * self.design.bin_factor)),
                max(1, int(trace_shape[-1] * self.design.bin_factor)))
            self.gabor_engine, self.gabor_engine_reason = mxu.resolve_gabor_engine(
                req, binned, self.design.gabor_up.shape, device=self.device)
        return self.gabor_engine

    def correlograms(self, trf_fk, stage_hook: Callable[[str], None] | None = None):
        """Heavy stage: mask + per-note masked matched filter over
        ``trf_fk [..., C, T]`` on the device. Returns ``(score,
        mask_binned, masked_trace, correlograms)``; ``stage_hook`` gets
        :func:`gabor_mask`'s stages and then ``masked_mf``."""
        x = torch.as_tensor(trf_fk).to(self.device, torch.float32)
        self.resolve_engine(x.shape)
        score, mask_binned, masked_tr = gabor_mask(x, self.design, engine=self.gabor_engine,
                                                   kernels=self._kernels,
                                                   stage_hook=stage_hook)
        correlograms = {name: masked_matched_filter(masked_tr, note)
                        for name, note in self.notes.items()}
        if stage_hook is not None:
            stage_hook("masked_mf")
        return score, mask_binned, masked_tr, correlograms

    def picks_from_correlograms(self, correlograms: Dict[str, torch.Tensor],
                                threshold: float | None = None,
                                stage_hook: Callable[[str], None] | None = None):
        """Finalize: the relative-threshold policy (0.5 · the max over
        every note's correlogram, one read; HF at 0.9 ×) or the absolute
        ``threshold``, then per note the envelope picks through the fused
        pick kernel with the adaptive-K escalation, compacted on the
        device. Returns ``(picks, thres, thresholds)``. Device->host reads:
        the max (relative policy), then per note one saturation check and
        one packed fetch; one more for the saturated-row count after an
        escalation, and one on a capacity overflow."""
        syncs = peak_ops.SyncCounter()
        if threshold is None:
            maxv = float(torch.stack([c.amax() for c in correlograms.values()]).amax())
            syncs.add()
            thres = 0.5 * maxv
        else:
            thres = float(threshold)
        k0 = min(64, self.max_peaks)
        picks, thresholds = {}, {}
        for name, corr in correlograms.items():
            hf_discount = 0.9 if (name == "HF" and threshold is None) else 1.0
            thr = thres * hf_discount
            thresholds[name] = float(thr)
            attempts = []

            def run(k, corr=corr, thr=thr, attempts=attempts):
                attempts.append(k)
                return fused_picks.analytic_envelope_peaks(
                    corr, thr, max_peaks=k,
                    method=peak_ops.escalation_method(k, self.max_peaks))

            res = peak_ops.picks_with_escalation(run, k0, self.max_peaks, syncs)
            if len(attempts) > 1:
                self.escalations += 1
            if k0 < self.max_peaks and len(attempts) == 1:
                n_sat = 0      # the K0 check read no saturated row
            else:
                n_sat = int(res.saturated.sum())
                syncs.add()
            peak_ops.warn_saturated(n_sat, f"note {name}", self.max_peaks)
            picks[name] = peak_ops.pick_times_compacted(res.positions, res.selected,
                                                        syncs=syncs)
        self.syncs += syncs.count
        if stage_hook is not None:
            stage_hook("picks")
        return picks, thres, thresholds

    def __call__(self, trf_fk, threshold: float | None = None,
                 stage_hook: Callable[[str], None] | None = None):
        """Detect on a filtered block. ``threshold`` overrides the
        reference's relative 0.5 · max policy with an absolute value (the
        threshold-sweep knob)."""
        score, mask_binned, masked_tr, correlograms = self.correlograms(
            trf_fk, stage_hook=stage_hook)
        picks, thres, thresholds = self.picks_from_correlograms(
            correlograms, threshold, stage_hook=stage_hook)
        return {
            "score": score,
            "mask": mask_binned,
            "masked_trace": masked_tr,
            "correlograms": correlograms,
            "picks": picks,
            "threshold": thres,
            # per-note effective thresholds (the HF 0.9 x discount applied),
            # as the campaign's picks artifact records them
            "thresholds": thresholds,
        }

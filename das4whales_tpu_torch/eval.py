"""Detection-quality evaluation on synthetic ground truth (the port of
``das4whales_tpu.eval``).

* ``io.synth.SyntheticScene`` renders propagating calls with known
  (channel, arrival time) footprints (:func:`arrival_times`);
* :func:`match_picks` scores a detector's (channel, time) picks against
  them — per (call, channel) hits, misses and unmatched picks;
* :func:`evaluate_detector`, :func:`amplitude_sweep` and
  :func:`threshold_sweep` turn that into recall, precision and false
  alarms a channel-minute per template;
* :func:`localize_scene_call` closes the loop: picks -> per-channel TDOA
  -> the Gauss-Newton position (``loc``).

The scoring is host numpy around the detector; the rendered block goes
to the detector as a float32 tensor on the detector's own device, so on
the card a sweep runs the production detection path (the matched
filter's ``__call__`` launches the pick kernel). The spectro and Gabor
families join through their adapters (:class:`SpectroEvalAdapter`,
:class:`GaborEvalAdapter`).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict, Sequence

import numpy as np
import torch

from .config import as_metadata  # noqa: F401 — the JAX module's name
from .io.synth import SyntheticCall, SyntheticScene, synthesize_scene
from .utils.device import resolve_device
from .utils.views import cached_shallow_view


def arrival_times(call, scene) -> np.ndarray:
    """Per-channel arrival time [s] of ``call`` (an ``io.synth.SyntheticCall``)
    in ``scene``'s geometry: the straight cable along x, the 3-D slant
    range at the call's speed (``io.synth.synthesize_scene``'s injection
    delays)."""
    x = np.arange(scene.nx) * scene.dx
    slant = np.sqrt((x - call.x0_m) ** 2 + call.y0_m ** 2 + call.z0_m ** 2)
    return call.t0 + slant / call.speed


def scene_cable_positions(scene) -> np.ndarray:
    """``[nx, 3]`` coordinates of the scene's straight cable (along x at
    y = z = 0), the geometry the localizer takes."""
    pos = np.zeros((scene.nx, 3))
    pos[:, 0] = np.arange(scene.nx) * scene.dx
    return pos


def localize_scene_call(picks: np.ndarray, scene, call_index: int = 0, gate_s: float = 1.0,
                        n_iter: int = 30, fix_z: bool = True, *, device=None):
    """Detector picks -> per-channel TDOA -> the source of one scene call.

    Picks within ``gate_s`` of the call's true moveout are kept, the
    earliest a channel, and handed to ``loc.localize`` (float64) with the
    scene's straight-cable geometry, from a neutral start: mid-cable,
    slightly off the axis, at the earliest kept arrival. Returns the
    ``loc.LocalizationResult`` on ``device`` (``None``: the card); the
    truth is ``(call.x0_m, call.y0_m, call.z0_m, call.t0)``."""
    from . import loc

    call = scene.calls[call_index]
    expected = arrival_times(call, scene)
    ch = np.asarray(picks[0], dtype=int)
    t = np.asarray(picks[1], dtype=float) / scene.fs
    keep = np.abs(t - expected[ch]) <= gate_s
    ti = np.full(scene.nx, np.nan)
    for c, tt in zip(ch[keep], t[keep]):
        if not np.isfinite(ti[c]) or tt < ti[c]:
            ti[c] = tt
    cable = scene_cable_positions(scene)
    # the exact on-axis start is a stationary point of the y derivative
    guess = [
        float(np.mean(cable[:, 0])),
        max(50.0, 2 * scene.dx),
        call.z0_m if fix_z else -10.0,
        float(np.nanmin(ti)) - 0.05,
    ]
    return loc.localize(ti, cable, call.speed, n_iter=n_iter, fix_z=fix_z,
                        initial_guess=guess, device=device)


@dataclass
class PickMatch:
    """One template's picks scored against the scene's ground truth."""

    hits: np.ndarray          # [n_calls, n_channels] bool: footprint picked
    covered: np.ndarray       # [n_calls, n_channels] bool: footprint inside the record
    n_false: int              # picks matching no call footprint
    n_picks: int

    @property
    def recall(self) -> float:
        n_cov = int(self.covered.sum())
        return float(self.hits.sum() / n_cov) if n_cov else float("nan")

    @property
    def precision(self) -> float:
        return float((self.n_picks - self.n_false) / self.n_picks) if self.n_picks else float("nan")


def match_picks(picks: np.ndarray, scene, time_tol_s: float = 0.3,
                call_indices: Sequence[int] | None = None) -> PickMatch:
    """Score ``picks`` (``(2, n)`` [channel_idx, time_idx]) against the
    scene's call footprints. A (call, channel) cell is hit when a pick on
    that channel lies within ``time_tol_s`` of the call's onset there;
    ``call_indices`` restricts recall to those calls, while false picks
    are counted against every call (a pick on another template's call is
    a cross-template response, not a false alarm)."""
    picks = np.asarray(picks)
    n_calls = len(scene.calls)
    sel = set(range(n_calls)) if call_indices is None else set(call_indices)
    hits = np.zeros((len(sel), scene.nx), dtype=bool)
    covered = np.zeros((len(sel), scene.nx), dtype=bool)
    tol = time_tol_s * scene.fs

    pick_t = [picks[1][picks[0] == ch] for ch in range(scene.nx)]
    matched_any = [np.zeros(t.shape, dtype=bool) for t in pick_t]
    row = 0
    for ci, call in enumerate(scene.calls):
        onsets = arrival_times(call, scene) * scene.fs
        L = call.duration * scene.fs
        cov = (onsets >= 0) & (onsets + L <= scene.ns)
        scored = ci in sel
        if scored:
            covered[row] = cov
        for ch in range(scene.nx):
            if not cov[ch] or pick_t[ch].size == 0:
                continue
            near = np.abs(pick_t[ch] - onsets[ch]) <= tol
            if near.any():
                matched_any[ch] |= near
                if scored:
                    hits[row, ch] = True
        if scored:
            row += 1
    n_picks = int(picks.shape[1])
    n_false = int(n_picks - sum(int(m.sum()) for m in matched_any))
    return PickMatch(hits=hits, covered=covered, n_false=n_false, n_picks=n_picks)


def _call_groups(scene) -> Dict[tuple, list]:
    """Scene calls grouped by ``(fmin, fmax, duration)``: one group a
    note type."""
    groups: Dict[tuple, list] = {}
    for ci, call in enumerate(scene.calls):
        groups.setdefault((call.fmin, call.fmax, call.duration), []).append(ci)
    return groups


def _calls_for_template(cfg, scene) -> list:
    """The scene call group nearest a template's chirp: ``cfg`` is a
    template configuration (``fmin``/``fmax``/``duration``) or a spectro
    kernel dict (``f0``/``f1``/``dur``). Empty only when the scene has no
    calls."""
    if isinstance(cfg, dict):
        fmin = min(cfg["f0"], cfg["f1"])
        fmax = max(cfg["f0"], cfg["f1"])
        dur = cfg["dur"]
    else:
        fmin, fmax, dur = cfg.fmin, cfg.fmax, cfg.duration
    groups = _call_groups(scene)
    if not groups:
        return []
    key = min(groups, key=lambda g: abs(g[0] - fmin) + abs(g[1] - fmax) + 10.0 * abs(g[2] - dur))
    return groups[key]


def _detector_device(detector) -> torch.device:
    """Where ``detector`` runs: its own ``device``, an adapter's
    detector's or prefilter's; else the card."""
    for obj in (detector, getattr(detector, "det", None), getattr(detector, "prefilter", None)):
        dev = getattr(obj, "device", None)
        if dev is not None:
            return torch.device(dev)
    return resolve_device(None)


def _scene_block(detector, scene) -> torch.Tensor:
    """The rendered scene as a float32 tensor on the detector's device."""
    return torch.as_tensor(synthesize_scene(scene), dtype=torch.float32).to(
        _detector_device(detector))


def _template_metrics(name, picks, cfgs, scene, time_tol_s, minutes) -> dict:
    indices = _calls_for_template(cfgs[name], scene) if name in cfgs else []
    m = match_picks(picks, scene, time_tol_s, call_indices=indices or None)
    return {"recall": m.recall, "precision": m.precision, "n_picks": m.n_picks,
            "n_false": m.n_false,
            "false_per_channel_minute": m.n_false / (scene.nx * minutes)}


def evaluate_detector(detector, scene, time_tol_s: float = 0.3) -> Dict[str, dict]:
    """Run ``detector`` (a ``MatchedFilterDetector`` or any callable whose
    result has ``.picks``) on the rendered scene and score every
    template's picks: ``{template: {recall, precision, n_picks, n_false,
    false_per_channel_minute}}``."""
    result = detector(_scene_block(detector, scene))
    minutes = scene.ns / scene.fs / 60.0
    cfgs = getattr(detector, "template_configs", None) or {}
    return {name: _template_metrics(name, picks, cfgs, scene, time_tol_s, minutes)
            for name, picks in result.picks.items()}


def amplitude_sweep(detector, base_scene, amplitudes: Sequence[float],
                    seeds: Sequence[int] = (0,), time_tol_s: float = 0.3) -> list:
    """The detection-performance curve: ``base_scene`` re-rendered at each
    call amplitude (the noise fixed, so amplitude is the SNR knob) and
    seed, scored by :func:`evaluate_detector` with one detector, averaged
    an amplitude: rows ``{"amplitude", "snr_db", <template>: {recall,
    precision, false_per_channel_minute}}``."""
    rows = []
    for amp in amplitudes:
        per_template: Dict[str, list] = {}
        for seed in seeds:
            scene = replace(base_scene, seed=seed,
                            calls=[replace(c, amplitude=amp) for c in base_scene.calls])
            for name, metrics in evaluate_detector(detector, scene, time_tol_s).items():
                per_template.setdefault(name, []).append(metrics)
        row = {"amplitude": float(amp),
               "snr_db": float(20 * np.log10(amp / base_scene.noise_rms))}
        for name, ms in per_template.items():
            row[name] = {k: float(np.nanmean([m[k] for m in ms]))
                         for k in ("recall", "precision", "false_per_channel_minute")}
        rows.append(row)
    return rows


def sharded_picks_to_dict(sp_picks, template_names, file_index: int = 0,
                          n_samples: int | None = None) -> Dict[str, np.ndarray]:
    """One file's picks from a ``SparsePicks`` of ``[n_templates, file,
    channel, K]`` arrays (tensors or numpy) -> ``{name: (2, n)}``;
    ``n_samples`` drops picks in divisibility padding."""
    from .ops import peaks as peak_ops

    pos = peak_ops._host(sp_picks.positions)
    sel = peak_ops._host(sp_picks.selected)
    out = {}
    for i, name in enumerate(template_names):
        s = sel[i, file_index]
        if n_samples is not None:
            s = s & (pos[i, file_index] < n_samples)
        out[name] = peak_ops.sparse_to_pick_times(pos[i, file_index], s)
    return out


def threshold_sweep(detector, scene, thresholds: Sequence[float],
                    time_tol_s: float = 0.3) -> list:
    """The operating curve over the pick threshold: one rendered scene,
    one detector, ``detector(block, threshold=thr)`` at each absolute
    threshold, rows ``{"threshold", <template>: {recall, precision,
    false_per_channel_minute}}``."""
    block = _scene_block(detector, scene)
    cfgs = getattr(detector, "template_configs", None) or {}
    minutes = scene.ns / scene.fs / 60.0
    rows = []
    for thr in thresholds:
        result = detector(block, threshold=float(thr))
        row = {"threshold": float(thr)}
        for name, picks in result.picks.items():
            m = _template_metrics(name, picks, cfgs, scene, time_tol_s, minutes)
            row[name] = {k: m[k] for k in ("recall", "precision", "false_per_channel_minute")}
        rows.append(row)
    return rows


def default_eval_scene(nx: int = 256, ns: int = 6000) -> SyntheticScene:
    """The standard evaluation scene: three fin-call pairs (HF then LF
    note 2 s later) at staggered times and positions along the cable."""
    calls = []
    dx = 2.042
    for k, t0 in enumerate((4.0, 12.0, 21.0)):
        x0 = (0.25 + 0.25 * k) * nx * dx
        calls.append(SyntheticCall(t0=t0, x0_m=x0, fmin=17.8, fmax=28.8,
                                   duration=0.68, amplitude=1.0))
        calls.append(SyntheticCall(t0=t0 + 2.0, x0_m=x0, fmin=14.7, fmax=21.8,
                                   duration=0.78, amplitude=1.0))
    return SyntheticScene(nx=nx, ns=ns, dx=dx, noise_rms=0.05, calls=calls)


@dataclass
class _EvalResult:
    picks: Dict[str, np.ndarray]
    #: per-template effective thresholds when the family exposes them;
    #: None means absent
    thresholds: Dict[str, float] | None = None


class SpectroEvalAdapter:
    """Adapts the spectrogram-correlation family to the detector protocol
    ``adapter(block, threshold=None) -> result.picks``.

    ``prefilter`` supplies the bandpass + f-k front end: a
    ``MatchedFilterDetector`` (its ``filter_block``) or any callable
    mapping a block to ``trf_fk``. Pick times are converted from
    spectrogram-hop units back to sample units (the inverse of the
    workflow's ``spectro_fs`` rescale)."""

    def __init__(self, prefilter, spectro_detector):
        self.prefilter = prefilter
        self.det = spectro_detector
        self.template_configs = dict(spectro_detector.kernels)

    def __call__(self, block, threshold: float | None = None,
                 stage_hook: Callable[[str], None] | None = None) -> _EvalResult:
        """Picks in sample units of one block. ``threshold`` overrides the
        detector's absolute threshold for this call (the threshold-sweep
        knob). ``stage_hook(name)`` is called after ``prefilter`` and
        passed on to the detector."""
        filt = getattr(self.prefilter, "filter_block", self.prefilter)
        trf_fk = filt(block)
        if stage_hook is not None:
            stage_hook("prefilter")
        if threshold is None:
            _, picks, spectro_fs = self.det(trf_fk, stage_hook=stage_hook)
        else:
            saved = self.det.threshold
            try:
                self.det.threshold = float(threshold)
                _, picks, spectro_fs = self.det(trf_fk, stage_hook=stage_hook)
            finally:
                self.det.threshold = saved
        fs = self.det.metadata.fs
        out = {}
        for name, pk in picks.items():
            pk = np.asarray(pk)
            t_samples = np.round(pk[1] * (fs / spectro_fs)).astype(int)
            out[name] = np.asarray([pk[0], t_samples])
        # one absolute correlogram threshold serves every kernel
        thr = float(self.det.threshold if threshold is None else threshold)
        return _EvalResult(picks=out, thresholds={name: thr for name in out})


class GaborEvalAdapter:
    """Adapts the Gabor/image family to the detector protocol
    ``adapter(block, threshold=None) -> result.picks``.

    ``prefilter`` is the shared bandpass + f-k front end
    (main_gabordetect.py:10-74): a ``MatchedFilterDetector`` (its
    ``filter_block``) or any callable mapping a block to ``trf_fk``. The
    Gabor picks are in sample units already; the notes' ``(fmin, fmax,
    duration)`` become the template configurations."""

    def __init__(self, prefilter, gabor_detector):
        self.prefilter = prefilter
        self.det = gabor_detector
        self.template_configs = {
            name: {"f0": fmax, "f1": fmin, "dur": dur}
            for name, (fmin, fmax, dur) in gabor_detector.note_params.items()
        }

    def host_view(self) -> "GaborEvalAdapter":
        """This adapter on the CPU (the ladder's host rung): the prefilter's
        and the detector's host views. Cached: repeated calls return the
        same view."""

        def mutate(adapter):
            adapter.prefilter = self.prefilter.host_view()
            adapter.det = self.det.host_view()

        return cached_shallow_view(self, "_host_view_cache", mutate)

    def __call__(self, block, threshold: float | None = None,
                 stage_hook: Callable[[str], None] | None = None) -> _EvalResult:
        """Picks of one block and the per-note thresholds. ``threshold``
        overrides the relative policy with an absolute value;
        ``stage_hook(name)`` is called after ``prefilter`` and passed on to
        the detector."""
        filt = getattr(self.prefilter, "filter_block", self.prefilter)
        trf_fk = filt(block)
        if stage_hook is not None:
            stage_hook("prefilter")
        out = self.det(trf_fk, threshold=threshold, stage_hook=stage_hook)
        return _EvalResult(picks={k: np.asarray(v) for k, v in out["picks"].items()},
                           thresholds=out.get("thresholds"))

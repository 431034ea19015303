"""Pick-set comparison under a rounding margin.

Two correct runs of the detector can differ where the arithmetic rounds
differently: cuFFT, pocketfft and XLA's FFT disagree in the last bits,
and so do reductions taken in another order. A pick then flips only
where a decision sits on a knife edge. :func:`unexplained_differences`
lists the picks in the symmetric difference of two pick sets that no
such knife edge explains; :func:`unexplained_learned_differences` does
the same for the learned family's window picks against its scores. The
tests and ``chip_smoke.py`` require those lists to be empty.
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.signal as sp


def envelopes(det, trace) -> np.ndarray:
    """The Hilbert envelopes ``[nT, C, n]`` (host numpy) that ``det``'s
    detection program picks on, for the margin check. Runs the
    detector's own filter (``det.filter_block``, so its bandpass mode,
    fused or staged) and the later stages on ``det.device`` at once,
    untiled (correlograms are per row, so tiling moves a value by
    rounding at most)."""
    from ..ops import spectral, xcorr

    trf = det.filter_block(trace)
    corr = xcorr.compute_cross_correlograms_corrected(
        trf, det._templates_true, det._template_mu, det._template_scale)
    return spectral.envelope_sqrt(corr).cpu().numpy()


def unexplained_differences(picks_a: np.ndarray, picks_b: np.ndarray,
                            env: np.ndarray, thr: float, rel: float = 1e-5):
    """Picks (``(2, n)`` [channel, time] arrays) in exactly one of the two
    sets that no rounding knife edge explains. A pick at ``(c, t)`` is
    explained when, in ``env [C, n]``, its height or its prominence lies
    within ``rel`` (relative) of the threshold ``thr`` — the height
    prefilter or the prominence test could round either way — or a
    neighbouring sample ties it within ``rel`` (the local-maximum and
    plateau decisions could round either way). Returns the list of
    unexplained ``(channel, time)`` pairs."""
    a = {tuple(p) for p in np.asarray(picks_a).T.tolist()}
    b = {tuple(p) for p in np.asarray(picks_b).T.tolist()}
    tol = rel * abs(thr)
    bad = []
    for c, t in sorted(a ^ b):
        row = env[c]
        h = float(row[t])
        if abs(h - thr) <= tol:
            continue
        near = [row[j] for j in (t - 1, t + 1) if 0 <= j < row.shape[0]]
        if any(abs(float(v) - h) <= rel * abs(h) for v in near):
            continue
        with warnings.catch_warnings():
            # a sample that is no peak in env has prominence 0 (warned)
            warnings.simplefilter("ignore")
            prom = float(sp.peak_prominences(row.astype(np.float64), [t])[0][0])
        if abs(prom - thr) <= tol:
            continue
        bad.append((int(c), int(t)))
    return bad


def unexplained_learned_differences(picks_a: np.ndarray, picks_b: np.ndarray,
                                    scores: np.ndarray, centers: np.ndarray, thr: float,
                                    tol: float = 1e-5):
    """The learned family's counterpart of :func:`unexplained_differences`:
    picks ``(2, n)`` [channel, window-center sample] in exactly one of the
    two sets that no knife edge of ``scores [C, n_win]`` explains. A pick
    at window ``w`` is explained when its score lies within ``tol``
    (absolute) of the threshold ``thr`` or of a neighbouring window's
    score (the NMS comparison could round either way). Returns the
    unexplained ``(channel, sample)`` pairs."""
    a = {tuple(p) for p in np.asarray(picks_a).T.tolist()}
    b = {tuple(p) for p in np.asarray(picks_b).T.tolist()}
    centers = np.asarray(centers)
    bad = []
    for c, t in sorted(a ^ b):
        w = int(np.searchsorted(centers, t))
        row = scores[c]
        s = float(row[w])
        near = [float(row[j]) for j in (w - 1, w + 1) if 0 <= j < row.shape[0]]
        if abs(s - thr) <= tol or any(abs(v - s) <= tol for v in near):
            continue
        bad.append((int(c), int(t)))
    return bad

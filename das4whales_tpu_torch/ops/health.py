"""Data-health statistics: the quarantine gate and its triage profile.

The port's copy of ``das4whales_tpu.ops.health``. A file can read cleanly
and still be garbage: a NaN-poisoned record, an ADC-saturated one, a dead
span of fiber. With ``with_health=True`` the detection program
(``models.matched_filter.mf_detect_picks_program`` and the batched route
of ``parallel.batch``) computes these stats over its input block, on the
block's device, and they ride the attempt's one packed device->host read.
The caller compares them against :class:`config.DataHealthConfig`.

Counts, not fractions, cross the wire: at the canonical block size
(2.6e8 samples) one NaN gives a finite fraction of ``1 - 4e-9``, which
float32 rounds to exactly 1.0. int32 counts are exact up to 2**31
samples; the host forms the fractions in float64 (:func:`stats_to_dict`).

Besides the whole-block scalars, :func:`health_profile` reduces over
~:data:`N_BINS` channel bins (RMS, non-finite, clipped and dead-channel
counts), so a fault can be located on the fiber while the transfer stays
O(bins).

The element-level definition exists once (:func:`_element_stats`,
written over an array namespace): torch on the device path
(:func:`health_stats`, :func:`health_profile` on tensors) and numpy on
the host path (:func:`host_health_stats`, for detector families without
a fused program), so the two cannot drift apart. These are plain torch
ops; the JAX package leaves them to XLA too.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import to_device_async

#: Number of scalar slots in the packed health-count vector.
N_COUNTS = 2

#: Per-bin slots in the packed profile count matrix: non-finite, clipped
#: and dead-channel counts (int32, exact).
N_BIN_COUNTS = 3

#: Default channel-bin budget for :func:`health_profile`: ~87 channels a
#: bin at the canonical 22050-channel shape.
N_BINS = 256


class _TorchNamespace:
    """The array functions the health definition uses, as numpy spells
    them, on torch tensors of one device (numpy is the other namespace)."""

    float32 = torch.float32
    int32 = torch.int32
    isfinite = staticmethod(torch.isfinite)
    abs = staticmethod(torch.abs)
    sqrt = staticmethod(torch.sqrt)
    where = staticmethod(torch.where)

    def __init__(self, device: torch.device):
        self.device = device

    def arange(self, n):
        return torch.arange(n, device=self.device)

    def zeros(self, shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def asarray(self, v, dtype):
        return to_device_async(v, dtype, self.device)

    def sum(self, a, axis, dtype=None):
        # keep the input's dtype unless told: int32 counts stay int32
        return torch.sum(a, dim=axis, dtype=a.dtype if dtype is None else dtype)

    def stack(self, arrays, axis):
        return torch.stack(arrays, dim=axis)

    def clip(self, a, lo, hi):
        return torch.clamp(a, lo, hi)

    def pad(self, a, widths):
        # numpy's [(before, after)] per axis; only the last axis is padded here
        return torch.nn.functional.pad(a, (widths[-1][0], widths[-1][1]))


def _namespace(x):
    return _TorchNamespace(x.device) if isinstance(x, torch.Tensor) else np


def channel_bins(n_channels: int, n_bins: int | None = None) -> tuple[int, int]:
    """Resolve the per-bin layout for ``n_channels``: ``(bins, per)``
    with ``per = ceil(C / min(n_bins, C))`` channels per bin and
    ``bins = ceil(C / per)`` bins actually needed (the last bin may be
    partial — its real channel count is ``C - (bins - 1) * per``)."""
    c = int(n_channels)
    nb = N_BINS if n_bins is None else int(n_bins)
    nb = max(1, min(nb, max(c, 1)))
    # per >= 1 even for an empty selection: (0 bins, 1 channel a bin)
    per = max(1, -(-c // nb))
    return -(-c // per), per


def _element_stats(xp, xf, clip_abs, n_real):
    """THE per-element health definition, shared by the device (torch)
    and host (numpy) paths: ``(finite, clipped, sq)`` masks/values over
    ``xf`` (already float). ``clipped`` is FINITE saturation only —
    non-finite samples are counted by the first slot and must not
    double-report. ``n_real`` (None, a scalar, or an array broadcasting
    against ``xf``'s time axis) restricts the stats to the real time
    samples of a bucket-padded record: pad samples read finite,
    unclipped, and contribute 0 to the sum of squares. ``clip_abs=None``
    (no clip level: nothing can clip) skips the clip pass and returns
    ``clipped=None``."""
    finite = xp.isfinite(xf)
    clipped = None if clip_abs is None else (xp.abs(xf) >= clip_abs) & finite
    if n_real is not None:
        valid = xp.arange(xf.shape[-1]) < n_real
        finite = finite | ~valid
        clipped = None if clipped is None else clipped & valid
        sq = xp.where(valid, xf * xf, xp.zeros((), xf.dtype))
    else:
        sq = xf * xf
    return finite, clipped, sq


def _n_real_arrays(xp, n_real, lead: tuple):
    """``n_real`` (None, an int, or a per-record vector over the leading
    axes ``lead``) as the element mask's operand (broadcasting over
    ``[..., C, T]``) and as a float32 count over ``lead``."""
    if n_real is None:
        return None, None
    nr = xp.asarray(n_real, xp.int32)
    if nr.ndim == 0:
        return nr, xp.asarray(n_real, xp.float32)
    if tuple(nr.shape) != lead:
        raise ValueError(f"n_real of shape {tuple(nr.shape)} for records {lead}")
    return nr.reshape(lead + (1, 1)), xp.asarray(n_real, xp.float32)


def _as_int32(xp, a):
    return a.astype(np.int32) if xp is np else a.to(torch.int32)


def _as_float32(xp, a):
    return a.astype(np.float32) if xp is np else a.to(torch.float32)


def health_stats(x, clip_abs, n_real=None):
    """Per-block health statistics of ``x [..., C, T]``: the detection
    program's input block — raw stored-dtype counts on the narrow wire,
    float strain on the conditioned wire. ``clip_abs`` is the saturation
    magnitude (``inf`` disables it). ``n_real`` (None, an int, or one
    length per leading record) restricts the stats to the real samples of
    a bucket-padded record, so padding can never dilute a breach.

    Returns ``(counts int32 [..., 2], rms float32 [...])``: non-finite
    and clipped sample counts, and the root-mean-square over the real
    samples (NaN when the block holds a NaN)."""
    xp = _namespace(x)
    xf = _as_float32(xp, x)
    nr_elem, nr_f = _n_real_arrays(xp, n_real, tuple(x.shape[:-2]))
    finite, clipped, sq = _element_stats(xp, xf, _clip(xp, clip_abs), nr_elem)
    nonfinite = xp.sum(~finite, axis=(-2, -1), dtype=xp.int32)
    counts = xp.stack([nonfinite, _count(xp, clipped, (-2, -1), nonfinite)], axis=-1)
    rms = xp.sqrt(xp.sum(sq, axis=(-2, -1)) / _n_samples(xp, x, nr_f))
    return counts, rms


def _clip(xp, clip_abs):
    """The clip level as the namespace's float32 scalar, or None when it
    is infinite (nothing can clip)."""
    return None if float(clip_abs) == float("inf") else xp.asarray(clip_abs, xp.float32)


def _count(xp, mask, axis, like):
    """int32 count of ``mask`` over ``axis``; zeros like ``like`` when the
    mask was skipped (None)."""
    if mask is None:
        return like * 0
    return xp.sum(mask, axis=axis, dtype=xp.int32)


def _n_samples(xp, x, nr_f):
    """The real sample count of each record as float32."""
    if nr_f is not None:
        return nr_f * xp.asarray(x.shape[-2], xp.float32)
    return xp.asarray(x.shape[-1] * x.shape[-2], xp.float32)


def _channel_stats(xp, x, clip_abs, n_real):
    """One element pass over ``x [..., C, T]`` reduced per channel:
    ``(nonfinite [..., C] int32, clipped [..., C] int32, sumsq [..., C]
    float32, n_real as float32 or None)``."""
    xf = _as_float32(xp, x)
    nr_elem, nr_f = _n_real_arrays(xp, n_real, tuple(x.shape[:-2]))
    finite, clipped, sq = _element_stats(xp, xf, _clip(xp, clip_abs), nr_elem)
    del xf
    nonfinite_ch = xp.sum(~finite, axis=-1, dtype=xp.int32)
    clipped_ch = _count(xp, clipped, -1, nonfinite_ch)
    return nonfinite_ch, clipped_ch, xp.sum(sq, axis=-1), nr_f


def health_profile(x, clip_abs, n_real=None, n_bins: int | None = None, xp=None):
    """Per-channel-bin health profile of ``x [..., C, T]`` (same inputs as
    :func:`health_stats`; ``xp`` defaults to ``x``'s own namespace, and
    the host path passes numpy). Channels are grouped into
    :func:`channel_bins` bins of ``per`` consecutive channels. Returns
    ``(bin_counts int32 [..., bins, 3], bin_rms float32 [..., bins])``
    with slots non-finite / clipped / dead per bin — a channel is DEAD
    when its real samples are all exactly zero. Pad channels of the last
    partial bin contribute nothing; ``bin_rms`` divides by each bin's
    real channel count."""
    if xp is None:
        xp = _namespace(x)
    return _binned_profile(xp, x, *_channel_stats(xp, x, clip_abs, n_real), n_bins)


def _binned_profile(xp, x, nonfinite_ch, clipped_ch, sumsq_ch, nr_f, n_bins):
    """:func:`health_profile` from the per-channel reductions."""
    c = x.shape[-2]
    nb, per = channel_bins(c, n_bins)
    dead_ch = _as_int32(xp, sumsq_ch == 0)

    def binned(a):
        pad = nb * per - c
        if pad:
            a = xp.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, pad)])
        return xp.sum(a.reshape(tuple(a.shape[:-1]) + (nb, per)), axis=-1)

    bin_counts = xp.stack(
        [binned(nonfinite_ch), binned(clipped_ch), binned(dead_ch)], axis=-1
    )
    if nr_f is None:
        nt = xp.asarray(x.shape[-1], xp.float32)
    else:
        nt = nr_f if nr_f.ndim == 0 else nr_f.reshape(tuple(nr_f.shape) + (1,))
    # real channels per bin (only the last bin may be partial)
    ch_in_bin = xp.asarray(np.clip(c - per * np.arange(nb), 0, per), xp.float32)
    bin_rms = xp.sqrt(binned(sumsq_ch) / (ch_in_bin * nt))
    return bin_counts, bin_rms


def health_stats_profiled(x, clip_abs, n_real=None, n_bins: int | None = None):
    """Scalars + per-bin profile for the fused ``with_health`` programs:
    ``(counts, rms, bin_counts, bin_rms)``, from ONE element pass reduced
    per channel (the JAX package leaves the sharing to XLA's CSE). The
    scalar counts equal :func:`health_stats`'; the rms sums the channels'
    sums of squares, so it may differ from it in the last bits."""
    xp = _namespace(x)
    nonfinite_ch, clipped_ch, sumsq_ch, nr_f = _channel_stats(xp, x, clip_abs, n_real)
    counts = xp.stack([xp.sum(nonfinite_ch, axis=-1), xp.sum(clipped_ch, axis=-1)], axis=-1)
    rms = xp.sqrt(xp.sum(sumsq_ch, axis=-1) / _n_samples(xp, x, nr_f))
    bin_counts, bin_rms = _binned_profile(xp, x, nonfinite_ch, clipped_ch, sumsq_ch, nr_f,
                                          n_bins)
    return counts, rms, bin_counts, bin_rms


def stats_to_dict(counts, rms, n_samples: int, bin_counts=None, bin_rms=None,
                  n_channels: int | None = None) -> dict:
    """One file's fetched health outputs -> the host-side stats dict the
    quarantine gate (:meth:`DataHealthConfig.breach`) consumes. Fractions
    are derived in float64 from the exact counts. ``bin_counts`` /
    ``bin_rms`` (the :func:`health_profile` outputs, with ``n_channels``
    naming the real channel count) add the per-bin fields ``bin_nonfinite``
    / ``bin_clipped`` / ``bin_dead`` / ``bin_rms`` and ``n_bins`` /
    ``bin_channels`` / ``dead_channels`` / ``dead_frac``."""
    counts = np.asarray(counts)
    n = max(int(n_samples), 1)
    out = {
        "nonfinite": int(counts[0]),
        "clipped": int(counts[1]),
        "nonfinite_frac": float(counts[0]) / n,
        "clip_frac": float(counts[1]) / n,
        "rms": float(rms),
        "n_samples": int(n_samples),
    }
    if bin_counts is not None and bin_rms is not None and n_channels:
        bc = np.asarray(bin_counts)
        nb = int(bc.shape[0])
        _, per = channel_bins(int(n_channels), n_bins=nb if nb else None)
        dead = int(bc[:, 2].sum())
        out.update({
            "n_channels": int(n_channels),
            "n_bins": nb,
            "bin_channels": per,
            "bin_nonfinite": [int(v) for v in bc[:, 0]],
            "bin_clipped": [int(v) for v in bc[:, 1]],
            "bin_dead": [int(v) for v in bc[:, 2]],
            "bin_rms": [float(v) for v in np.asarray(bin_rms)],
            "dead_channels": dead,
            "dead_frac": dead / max(int(n_channels), 1),
        })
    return out


def host_health_stats(arr: np.ndarray, clip_abs: float | None = None) -> dict:
    """Host-side stats for detector families without the fused program:
    the same element definition (:func:`_element_stats`, numpy, float64
    for the scalars) in one pass over a host block, with the per-bin
    profile when ``arr`` is a ``[C, T]`` block."""
    x = np.asarray(arr)
    xf = x.astype(np.float64, copy=False)
    clip = float("inf") if clip_abs is None else float(clip_abs)
    finite, clipped, sq = _element_stats(np, xf, clip, None)
    counts = (int(x.size - np.count_nonzero(finite)),
              int(np.count_nonzero(clipped)))
    # an empty block keeps a NaN rms: NaN reads unhealthy against any rms bound
    rms = float(np.sqrt(sq.sum() / x.size)) if x.size else float("nan")
    bin_counts = bin_rms = n_channels = None
    if x.ndim == 2 and x.size:
        bin_counts, bin_rms = health_profile(x, clip, xp=np)
        n_channels = x.shape[0]
    return stats_to_dict(np.asarray(counts), rms, x.size,
                         bin_counts=bin_counts, bin_rms=bin_rms,
                         n_channels=n_channels)

"""Peak picking with exact scipy prominence semantics (plain PyTorch).

The port's copy of ``das4whales_tpu.ops.peaks``. The dense exact picker
(:func:`find_peaks_prominence`, channel-blocked in
:func:`find_peaks_prominence_blocked`) takes every sample's prominence
by binary lifting over sliding-window max/min tables, O(N log N); the
host route (:func:`find_peaks_scipy_host`) runs scipy per channel; the
reference-shaped converters (:func:`convert_pick_times` and friends)
are host numpy. The sparse candidate route: plateau-exact local maxima, the height
prefilter (exact for nonnegative envelopes, whose prominence never
exceeds their height), fixed-capacity candidate slots — ``"pack"``, the
first K in time order, or ``"topk"``, the K tallest — and exact scipy
prominences from per-block max/min tables in both directions. This is
the plain version of the CUDA pick kernel (``ops.fused_picks``): the
CPU route, and the reference ``chip_smoke.py`` holds the kernel against
on the card. The spectrogram-correlation family picks on its
correlograms with this plain route on every device, as the JAX package
does, through the adaptive-K escalation and the on-device compaction
below, whose device->host reads a :class:`SyncCounter` counts.

Three JAX idioms have no direct torch twin and are spelled out here:
``jnp.argsort`` is stable (``torch.argsort(..., stable=True)``);
``lax.top_k`` breaks ties toward the lower index while ``torch.topk``
promises no order (a stable descending sort, first K); and
``.at[].set(mode="drop")`` drops out-of-range writes (scatter into one
extra slot, then slice it off).
"""

from __future__ import annotations

import logging
import warnings
from typing import List, NamedTuple

import numpy as np
import torch


class SparsePicks(NamedTuple):
    """Fixed-capacity peak-pick result (one row per channel/correlogram).

    ``positions [..., K]`` sample indices, ascending among selected slots
    (every unselected slot holds N), ``heights``/``prominences`` float32,
    ``selected`` the validity mask, ``saturated [...]`` set when more than
    K candidates passed the height prefilter (only then can picks be
    missed)."""

    positions: torch.Tensor
    heights: torch.Tensor
    prominences: torch.Tensor
    selected: torch.Tensor
    saturated: torch.Tensor


def _run_info(x: torch.Tensor):
    """(run_start, rising) per sample: the start index of the sample's
    equal-value run and whether the run was entered by a strict rise
    (False for the run touching the left edge) — one cummax over the
    packed key ``2*start + rising``."""
    n = x.shape[-1]
    chg = x[..., 1:] != x[..., :-1]
    rising = x[..., 1:] > x[..., :-1]
    idx1 = torch.arange(1, n, dtype=torch.int32, device=x.device)
    key_tail = torch.where(chg, 2 * idx1 + rising.to(torch.int32),
                           torch.full_like(idx1, -1))
    zeros = torch.zeros(x.shape[:-1] + (1,), dtype=torch.int32, device=x.device)
    carried = torch.cummax(torch.cat([zeros, key_tail], dim=-1), dim=-1).values
    return carried >> 1, (carried & 1).to(torch.bool)


def local_maxima(x: torch.Tensor) -> torch.Tensor:
    """Boolean mask of local maxima with scipy plateau semantics: a run of
    equal samples strictly greater than both neighbours, reported at its
    floor-midpoint; runs touching either edge are not maxima."""
    n = x.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=x.device)
    run_start, rising = _run_info(x)
    run_start_r, falling_r = _run_info(torch.flip(x, (-1,)))
    run_end = (n - 1) - torch.flip(run_start_r, (-1,))
    falling = torch.flip(falling_r, (-1,))
    mid = torch.div(run_start + run_end, 2, rounding_mode="floor")
    return rising & falling & (idx == mid)


def _window_tables(x: torch.Tensor, levels: int):
    """Sparse tables of sliding-window max and min: level k holds the
    max/min over the window of length 2^k ending at each index."""
    n = x.shape[-1]
    tmax, tmin = [x], [x]
    for k in range(1, levels + 1):
        half = 1 << (k - 1)
        prev_max, prev_min = tmax[-1], tmin[-1]
        pad_max = torch.nn.functional.pad(prev_max, (half, 0), value=-float("inf"))[..., :n]
        pad_min = torch.nn.functional.pad(prev_min, (half, 0), value=float("inf"))[..., :n]
        tmax.append(torch.maximum(prev_max, pad_max))
        tmin.append(torch.minimum(prev_min, pad_min))
    return tmax, tmin


def _one_sided_base_min(x: torch.Tensor, levels: int) -> torch.Tensor:
    """For each index i: ``min(x[j+1..i])`` where j is the nearest index
    < i with ``x[j] > x[i]`` (or the signal start) — scipy's left-base
    minimum — by a greedy high-to-low descent over the window tables."""
    n = x.shape[-1]
    tmax, tmin = _window_tables(x, levels)
    pos = torch.arange(n, device=x.device).expand(x.shape)
    base_min = torch.full_like(x, float("inf"))
    for k in range(levels, -1, -1):
        width = 1 << k
        can = pos >= (width - 1)               # the window lies inside the signal
        gpos = pos.clamp(0, n - 1)
        blk_max = tmax[k].gather(-1, gpos)
        blk_min = tmin[k].gather(-1, gpos)
        skip = can & (blk_max <= x)
        base_min = torch.where(skip, torch.minimum(base_min, blk_min), base_min)
        pos = torch.where(skip, pos - width, pos)
    return base_min


def peak_prominences_dense(x: torch.Tensor) -> torch.Tensor:
    """The prominence of every sample taken as a peak: at local maxima
    ``scipy.signal.peak_prominences`` exactly (``wlen=None``)."""
    n = x.shape[-1]
    levels = max(1, int(np.ceil(np.log2(n))))
    left_min = _one_sided_base_min(x, levels)
    right_min = torch.flip(_one_sided_base_min(torch.flip(x, (-1,)), levels), (-1,))
    return x - torch.maximum(left_min, right_min)


def find_peaks_prominence(x: torch.Tensor, threshold) -> torch.Tensor:
    """Boolean mask of the peaks with prominence >= ``threshold`` along the
    last axis: ``scipy.signal.find_peaks(x, prominence=threshold)``,
    batched. ``threshold`` compares in ``x``'s dtype."""
    thr = torch.as_tensor(threshold, dtype=x.dtype, device=x.device)
    return local_maxima(x) & (peak_prominences_dense(x) >= thr)


def find_peaks_prominence_blocked(x: torch.Tensor, threshold,
                                  block_size: int = 1024) -> torch.Tensor:
    """:func:`find_peaks_prominence` over ``[channel x time]`` in blocks of
    ``block_size`` channels, one after the other: the window tables of a
    whole 22k-channel block would not fit the card."""
    return torch.cat([find_peaks_prominence(x[lo : lo + block_size], threshold)
                      for lo in range(0, x.shape[0], block_size)])


def find_peaks_scipy_host(env, threshold) -> np.ndarray:
    """Per-channel ``scipy.signal.find_peaks(prominence=threshold)`` on the
    host: the stacked ``(2, n)`` [channel_idx, time_idx] int64 picks. The
    route for envelopes that live on the CPU anyway."""
    import scipy.signal as sp

    env = env.cpu().numpy() if isinstance(env, torch.Tensor) else np.asarray(env)
    thr = np.broadcast_to(np.asarray(threshold), (env.shape[0],))
    chan: list = []
    time: list = []
    for i in range(env.shape[0]):
        pk = sp.find_peaks(env[i], prominence=thr[i])[0]
        chan.extend([i] * len(pk))
        time.extend(pk.tolist())
    return np.asarray([chan, time], dtype=np.int64).reshape(2, -1)


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def mask_to_pick_lists(mask) -> List[np.ndarray]:
    """Dense peak mask -> the reference's ragged list of per-channel index
    arrays, in channel order."""
    return [np.nonzero(row)[0] for row in np.atleast_2d(_host(mask))]


def convert_pick_times(peaks_indexes_m) -> np.ndarray:
    """Ragged pick lists, or a dense boolean mask, -> the stacked
    ``(channel_idx[], time_idx[])`` array (reference
    ``detect.convert_pick_times``)."""
    if isinstance(peaks_indexes_m, (np.ndarray, torch.Tensor)) and _host(peaks_indexes_m).dtype == bool:
        chan, time = np.nonzero(_host(peaks_indexes_m))
        return np.asarray([chan, time])
    chan: list = []
    time: list = []
    for i, picks in enumerate(peaks_indexes_m):
        chan.extend([i] * len(picks))
        time.extend(list(picks))
    return np.asarray([chan, time])


def select_picked_times(idx_tp, tstart: float, tend: float, fs: float):
    """Restrict picks to the window ``[tstart, tend]`` seconds (reference
    ``detect.select_picked_times``)."""
    sel = (idx_tp[1] >= tstart * fs) & (idx_tp[1] <= tend * fs)
    return idx_tp[0][sel], idx_tp[1][sel]


def _block_stats(x: torch.Tensor, nb: int):
    """``[..., N] -> [..., B, nb]`` with per-block max/min (the pad is
    -inf, excluded from the min)."""
    n = x.shape[-1]
    b = -(-n // nb)
    pad = b * nb - n
    xpad = torch.nn.functional.pad(x, (0, pad), value=-float("inf")) if pad else x
    xb = xpad.reshape(x.shape[:-1] + (b, nb))
    inf = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
    return xb, xb.amax(dim=-1), torch.where(torch.isneginf(xb), inf, xb).amin(dim=-1)


def _one_sided_base_min_sparse(xb, block_max, block_min, pos, h, nb: int):
    """Exact scipy left-base minimum for candidate positions: for
    ``pos [C, K]`` with heights ``h``, the min of x over ``(j, pos]`` where
    j is the last index < pos with ``x[j] > h`` (or -1)."""
    C, B, _ = xb.shape
    K = pos.shape[1]
    dev = xb.device
    bp = torch.div(pos, nb, rounding_mode="floor")
    tp = pos % nb
    offs = torch.arange(nb, dtype=torch.int32, device=dev)
    blocks = torch.arange(B, dtype=torch.int32, device=dev)
    inf = torch.tensor(float("inf"), dtype=xb.dtype, device=dev)
    big = torch.tensor(torch.finfo(xb.dtype).max, dtype=xb.dtype, device=dev)
    neg1 = torch.tensor(-1, dtype=torch.int32, device=dev)

    def block_gather(idx):
        # [C, K, nb]: the row of block idx[c, k]
        return xb.gather(1, idx.long()[..., None].expand(C, K, nb))

    hk = h[..., None]
    ob = block_gather(bp)

    # 1) previous-greater inside the candidate's own block
    m_own = (offs < tp[..., None]) & (ob > hk)
    has_own = m_own.any(dim=-1)
    j_own = torch.where(m_own, offs, neg1).amax(dim=-1)
    seg_own = (offs > j_own[..., None]) & (offs <= tp[..., None])
    min_own = torch.where(seg_own, ob, inf).amin(dim=-1)

    # 2) previous-greater in an earlier block
    bmask = (blocks < bp[..., None]) & (block_max[:, None, :] > hk)
    has_blk = bmask.any(dim=-1)
    bprev = torch.where(bmask, blocks, torch.zeros_like(blocks)).amax(dim=-1)
    pb = block_gather(bprev)
    j_pb = torch.where(pb > hk, offs, neg1).amax(dim=-1)
    min_pb_suffix = torch.where(offs > j_pb[..., None], pb, inf).amin(dim=-1)

    # full blocks strictly between bprev and bp (all blocks < bp if none)
    lo = torch.where(has_blk, bprev, neg1)
    mid_mask = (blocks > lo[..., None]) & (blocks < bp[..., None])
    min_mid = torch.where(mid_mask, block_min[:, None, :], inf).amin(dim=-1)

    min_own_prefix = torch.where(offs <= tp[..., None], ob, inf).amin(dim=-1)
    other = torch.minimum(torch.where(has_blk, min_pb_suffix, big),
                          torch.minimum(min_mid, min_own_prefix))
    return torch.where(has_own, min_own, other)


def _find_peaks_rows(x: torch.Tensor, thr_bc: torch.Tensor, max_peaks: int,
                     nb: int, method: str) -> SparsePicks:
    """The per-row core of :func:`find_peaks_sparse`: ``x [C, N]``,
    ``thr_bc [C]``."""
    C, N = x.shape
    dev = x.device
    K = max_peaks
    neg_inf = torch.tensor(-float("inf"), dtype=x.dtype, device=dev)

    mask = local_maxima(x) & (x >= thr_bc[:, None])
    n_cand = mask.sum(dim=-1)
    saturated = n_cand > K

    if method == "pack":
        cnt = torch.cumsum(mask.to(torch.int32), dim=-1)
        # candidates past the K-th go to the extra slot K, sliced off below
        dest = torch.where(mask & (cnt <= K), cnt - 1, K).long()
        src = torch.arange(N, dtype=torch.int32, device=dev).expand(C, N)
        pos = torch.full((C, K + 1), N, dtype=torch.int32, device=dev)
        pos = pos.scatter(1, dest, src)[:, :K]
        slot_valid = (torch.arange(K, device=dev)[None, :]
                      < torch.clamp_max(n_cand, K)[:, None])
        gpos = torch.where(slot_valid, pos, torch.zeros_like(pos))
        heights = torch.where(slot_valid, x.gather(1, gpos.long()), neg_inf)
        valid = slot_valid
    elif method == "topk":
        cand_scores = torch.where(mask, x, neg_inf)
        # lax.top_k: K largest, ties toward the lower index
        heights, order = torch.sort(cand_scores, dim=-1, descending=True, stable=True)
        heights = heights[:, :K]
        pos = order[:, :K].to(torch.int32)
        valid = torch.isfinite(heights)
        gpos = pos
    else:
        raise ValueError(f"unknown method {method!r}")

    xb, bmax, bmin = _block_stats(x, nb)
    left_min = _one_sided_base_min_sparse(xb, bmax, bmin, gpos, heights, nb)
    xbf, bmaxf, bminf = _block_stats(torch.flip(x, (-1,)), nb)
    right_min = _one_sided_base_min_sparse(xbf, bmaxf, bminf, (N - 1) - gpos,
                                           heights, nb)
    prom = heights - torch.maximum(left_min, right_min)
    selected = valid & (prom >= thr_bc[:, None])

    n_fill = torch.full_like(pos, N)
    if method == "pack":
        # slots are position-ascending by construction; an unselected
        # slot never reports its position
        return SparsePicks(torch.where(selected, pos, n_fill), heights, prom,
                           selected, saturated)
    key = torch.where(selected, pos, n_fill)
    order = torch.argsort(key, dim=-1, stable=True)

    def take(a):
        return a.gather(1, order)

    return SparsePicks(take(key), take(heights), take(prom), take(selected),
                       saturated)


def find_peaks_sparse(x: torch.Tensor, threshold, max_peaks: int = 256,
                      nb: int = 128, method: str = "topk") -> SparsePicks:
    """Threshold-prominence peak picking over the rows of ``x [C, N]``;
    equals ``scipy.signal.find_peaks(x, prominence=threshold)`` for
    nonnegative rows whenever ``saturated`` is False. ``method``:
    ``"topk"`` keeps the K tallest candidates, ``"pack"`` the first K in
    time order (identical results on rows that do not saturate)."""
    C, N = x.shape
    max_peaks = min(max_peaks, N)
    thr = torch.as_tensor(threshold, dtype=x.dtype, device=x.device)
    thr_bc = thr.expand(C) if thr.ndim <= 1 else thr
    return _find_peaks_rows(x, thr_bc, max_peaks, nb, method)


def find_peaks_sparse_batched(x: torch.Tensor, threshold, max_peaks: int = 256,
                              nb: int = 128, method: str = "topk") -> SparsePicks:
    """:func:`find_peaks_sparse` over arbitrary leading axes: ``x [..., T]``,
    ``threshold`` broadcast to ``x.shape[:-1]``."""
    lead = tuple(x.shape[:-1])
    rows = int(np.prod(lead)) if lead else 1
    thr = torch.as_tensor(threshold, dtype=x.dtype, device=x.device)
    thr = thr.expand(lead).reshape(rows)
    res = find_peaks_sparse(x.reshape(rows, x.shape[-1]), thr,
                            max_peaks=max_peaks, nb=nb, method=method)
    return SparsePicks(*(a.reshape(lead + tuple(a.shape[1:])) for a in res))


def find_peaks_sparse_tiled(x: torch.Tensor, threshold, max_peaks: int = 256,
                            tile: int = 512, nb: int = 128,
                            method: str = "topk") -> SparsePicks:
    """:func:`find_peaks_sparse_batched` with the row (second-to-last)
    axis walked in ``tile``-row chunks (JAX's ``lax.map``, here a Python
    loop): the candidates' block tables stay at tile size. Rows are
    zero-padded to a tile multiple with a ``+inf`` threshold (no
    candidates) and cropped on output; results equal the untiled call's.
    ``x [..., C, T]``; ``threshold`` broadcasts to ``x.shape[:-1]``."""
    lead = tuple(x.shape[:-2])
    C = x.shape[-2]
    thr_rows = torch.as_tensor(threshold, dtype=x.dtype, device=x.device).expand(
        tuple(x.shape[:-1]))
    tile = min(tile, C)
    n_t = -(-C // tile)
    pad = n_t * tile - C
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        thr_rows = torch.nn.functional.pad(thr_rows, (0, pad), value=float("inf"))
    parts = [find_peaks_sparse_batched(x[..., i * tile:(i + 1) * tile, :],
                                       thr_rows[..., i * tile:(i + 1) * tile],
                                       max_peaks=max_peaks, nb=nb, method=method)
             for i in range(n_t)]
    nl = len(lead)

    def untile(field: str) -> torch.Tensor:
        return torch.cat([getattr(p, field) for p in parts], dim=nl).narrow(nl, 0, C)

    return SparsePicks(*(untile(f) for f in SparsePicks._fields))


def compact_picks_rowmajor(positions: torch.Tensor, selected: torch.Tensor,
                           capacity: int):
    """Stable on-device compaction of ``[B, R, K]`` picks into
    ``capacity``-length buffers, in the row-major (row, slot) order
    ``np.nonzero`` walks. Returns ``(rows [B, capacity] int32, times
    [B, capacity] int32, count [B] int32)``; entries past ``count`` are
    zero; ``count > capacity`` means overflow (nothing is truncated
    silently: the caller must take its full-transfer route)."""
    B, R, K = positions.shape
    dev = positions.device
    sel = selected.reshape(B, R * K)
    pos = positions.reshape(B, R * K).to(torch.int32)
    row_of = torch.div(torch.arange(R * K, dtype=torch.int32, device=dev), K,
                       rounding_mode="floor").expand(B, R * K)
    idx = torch.cumsum(sel.to(torch.int32), dim=-1) - 1
    dest = torch.where(sel & (idx < capacity), idx, capacity).long()
    rows_out = torch.zeros((B, capacity + 1), dtype=torch.int32, device=dev)
    times_out = torch.zeros((B, capacity + 1), dtype=torch.int32, device=dev)
    rows_out = rows_out.scatter(1, dest, row_of)[:, :capacity]
    times_out = times_out.scatter(1, dest, pos)[:, :capacity]
    count = sel.sum(dim=-1).to(torch.int32)
    return rows_out, times_out, count


def sparse_to_pick_times(positions, selected) -> np.ndarray:
    """``[C, K]`` sparse picks -> stacked ``(2, n)`` [channel_idx, time_idx]
    array in the reference's row-major order."""
    positions = np.asarray(positions)
    selected = np.asarray(selected)
    chan, slot = np.nonzero(selected)
    return np.asarray([chan, positions[chan, slot]], dtype=np.int64).reshape(2, -1)


class SyncCounter:
    """A count of device->host reads. The functions below that read a
    device value on the host take one as ``syncs`` and add one per read."""

    __slots__ = ("count",)

    def __init__(self):
        self.count = 0

    def add(self, n: int = 1) -> None:
        self.count += n


def _count(syncs: SyncCounter | None) -> None:
    if syncs is not None:
        syncs.add()


def picks_with_escalation(run, k0: int, k_full: int, syncs: SyncCounter | None = None):
    """Adaptive-K sparse picking: ``run(k)`` returns a result with a
    ``.saturated`` row mask. Runs at ``k0`` and reruns at ``k_full`` only
    when a row saturated — identical to running at ``k_full`` directly,
    since a row that does not saturate is exact at any K. The saturation
    read is one device->host read (counted)."""
    res = run(k0)
    if k0 < k_full:
        saturated = bool(res.saturated.any())
        _count(syncs)
        if saturated:
            res = run(k_full)
    return res


def compacted_to_host(rows_d: torch.Tensor, times_d: torch.Tensor, cnt_d: torch.Tensor,
                      capacity: int, syncs: SyncCounter | None = None):
    """Bring :func:`compact_picks_rowmajor` outputs to the host in ONE
    packed device->host read (counted), or report overflow. Returns
    ``(rows int64 [..., kpad], times int64 [..., kpad], count [...])``
    with the slot axis cut to the pow2-rounded max count, as the JAX
    package returns it, or ``None`` when a count exceeds ``capacity``
    (the caller takes its exact full-grid route)."""
    lead = tuple(cnt_d.shape)
    packed = torch.cat([rows_d.reshape(-1).to(torch.int32), times_d.reshape(-1).to(torch.int32),
                        cnt_d.reshape(-1).to(torch.int32)]).cpu().numpy()
    _count(syncs)
    n = rows_d.numel()
    cnt = packed[2 * n :].reshape(lead)
    kmax = int(cnt.max(initial=0))
    if kmax > capacity:
        return None
    kpad = min(capacity, 1 << max(kmax - 1, 0).bit_length())
    rows = packed[:n].reshape(tuple(rows_d.shape))[..., :kpad].astype(np.int64)
    times = packed[n : 2 * n].reshape(tuple(times_d.shape))[..., :kpad].astype(np.int64)
    return rows, times, cnt


def pick_times_compacted(positions: torch.Tensor, selected: torch.Tensor,
                         capacity: int = 1 << 18,
                         syncs: SyncCounter | None = None) -> np.ndarray:
    """``[C, K]`` sparse picks -> the reference's ``(2, n)``
    [channel_idx, time_idx] int64 array, compacted on the device so that
    only O(capacity) ints cross to the host in one read; on capacity
    overflow the exact full transfer (one more read) and
    :func:`sparse_to_pick_times`. Order and dtype equal
    :func:`sparse_to_pick_times`'s."""
    C, K = positions.shape
    cap = int(min(C * K, capacity))
    rows_d, times_d, cnt_d = compact_picks_rowmajor(positions[None], selected[None], cap)
    packed = compacted_to_host(rows_d, times_d, cnt_d, cap, syncs)
    if packed is None:
        pos, sel = positions.cpu().numpy(), selected.cpu().numpy()
        _count(syncs)
        return sparse_to_pick_times(pos, sel)
    rows, times, cnt = packed
    k = int(cnt[0])
    return np.asarray([rows[0, :k], times[0, :k]])


def escalation_method(k: int, k_full: int) -> str:
    """The adaptive-K method policy: an attempt a larger-capacity rerun can
    correct packs; the full-capacity run keeps the K tallest."""
    return "pack" if k < k_full else "topk"


def warn_saturated(saturated, label: str, max_peaks: int) -> bool:
    """Surface pick-capacity saturation, as a log warning and a
    ``warnings.warn``; returns True iff any row saturated."""
    n = int(np.asarray(saturated).sum())
    if not n:
        return False
    msg = (f"peak capacity saturated for {label} on {n} channel slots; "
           f"picks beyond the {max_peaks} tallest were dropped — raise "
           f"max_peaks to keep them")
    logging.getLogger("das4whales_tpu_torch.ops.peaks").warning(msg)
    warnings.warn(msg)
    return True

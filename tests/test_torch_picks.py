"""Port parity, pick stage: das4whales_tpu_torch.ops.peaks /
ops.fused_picks (plain PyTorch, on the CPU) against das4whales_tpu.ops.peaks
and the Pallas pick kernel (interpret mode), float32.

Contract: positions, selected and saturated bitwise equal; heights to
rtol 1e-6 (the JAX routes may fuse the envelope's multiply-adds into an
FMA; the port rounds each operation), and prominences — a difference of
two such heights — to 1e-6 of the heights they are taken from. The cases cover both slot
methods, the shapes of tests/test_pallas_picks.py, plateaus, tied
heights, saturated rows and +inf-threshold rows — and the three JAX
idioms the port spells out (stable argsort, ``lax.top_k`` ties toward the
lower index, ``.at[].set(mode="drop")``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

from das4whales_tpu.ops import pallas_picks as jpallas
from das4whales_tpu.ops import peaks as jpeaks
from das4whales_tpu.ops import spectral as jspec
from das4whales_tpu_torch.ops import fused_picks as tfused
from das4whales_tpu_torch.ops import peaks as tpeaks
from das4whales_tpu_torch.ops import spectral as tspec
from tests.torch_threads import one_torch_thread  # noqa: F401

SHAPES = [(3, 10, 777), (2, 8, 512), (1, 3, 1000)]


def _j32(fn, *args, **kw):
    with jax.enable_x64(False):
        out = fn(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args], **kw)
        return jax.tree_util.tree_map(np.array, out)  # copies: never alias a JAX buffer


def _assert_same_picks(t, j):
    """positions/selected/saturated bitwise; heights/prominences rtol 1e-6."""
    for f in ("positions", "selected", "saturated"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), err_msg=f)
    h = t.heights.numpy()
    np.testing.assert_allclose(h, np.asarray(j.heights), rtol=1e-6, err_msg="heights")
    h_scale = float(np.abs(h[np.isfinite(h)]).max(initial=0.0))
    np.testing.assert_allclose(t.prominences.numpy(), np.asarray(j.prominences),
                               rtol=1e-6, atol=1e-6 * h_scale, err_msg="prominences")
    assert t.positions.dtype == torch.int32 and t.selected.dtype == torch.bool


def _envelope(shape, seed):
    rng = np.random.default_rng(seed)
    corr = (2.0 * rng.normal(size=shape)).astype(np.float32)
    return _j32(jspec.envelope_sqrt, corr)


def _special_rows(T=1000, seed=5):
    """(env [6, T], thr [6]): plateaus, ties, saturation, +inf threshold."""
    rng = np.random.default_rng(seed)
    smooth = np.convolve(rng.normal(size=T + 8), np.ones(8) / 8, "same")[:T]
    quant = np.abs(np.round(smooth * 3) / 3)                 # plateaus + ties
    tri = np.tile(np.r_[np.arange(10), np.arange(10, 0, -1)] / 10.0, T // 20 + 1)[:T]
    edge = 0.1 * np.abs(rng.normal(size=T))
    edge[:30] = edge[-30:] = 5.0                             # edge plateaus
    edge[T // 3 : T // 3 + 200] = 4.0                        # long plateau
    noise = np.abs(rng.normal(size=T))
    env = np.stack([quant, tri, edge, noise, noise, np.zeros(T)]).astype(np.float32)
    thr = np.asarray([0.2, 0.5, 1.0, 0.05, np.inf, np.inf], np.float32)
    return env, thr


@pytest.mark.parametrize("method", ["pack", "topk"])
@pytest.mark.parametrize("shape", SHAPES)
def test_find_peaks_sparse_batched_matches(method, shape):
    env = _envelope(shape, seed=shape[-1])
    thr = np.linspace(0.8, 1.2, shape[0]).astype(np.float32)[:, None]
    j = _j32(jpeaks.find_peaks_sparse_batched, env, thr, max_peaks=32, method=method)
    t = tpeaks.find_peaks_sparse_batched(torch.from_numpy(env), torch.from_numpy(thr),
                                         max_peaks=32, method=method)
    _assert_same_picks(t, j)
    assert int(t.selected.sum()) > 0


@pytest.mark.parametrize("K", [4, 64])
@pytest.mark.parametrize("method", ["pack", "topk"])
def test_special_rows_match(method, K):
    env, thr = _special_rows()
    j = _j32(jpeaks.find_peaks_sparse, env, thr, max_peaks=K, method=method)
    t = tpeaks.find_peaks_sparse(torch.from_numpy(env), torch.from_numpy(thr),
                                 max_peaks=K, method=method)
    _assert_same_picks(t, j)
    sat = t.saturated.numpy()
    assert sat[3] and (sat[1] or K > 50)          # low threshold; 50 tied peaks
    assert not t.selected.numpy()[4:].any()       # +inf thresholds select nothing
    assert int(t.selected.sum()) > 0


def test_topk_ties_break_toward_lower_index():
    # 50 identical peaks, K = 8: top_k keeps the 8 lowest-index ones
    env = np.tile(np.r_[0.0, 1.0], 50).astype(np.float32)[None, :]
    env = np.concatenate([env, [[0.0]]], axis=1)
    t = tpeaks.find_peaks_sparse(torch.from_numpy(env), 0.5, max_peaks=8, method="topk")
    j = _j32(jpeaks.find_peaks_sparse, env, 0.5, max_peaks=8, method="topk")
    _assert_same_picks(t, j)
    np.testing.assert_array_equal(t.positions.numpy()[0], np.arange(1, 17, 2))


@pytest.mark.parametrize("method", ["pack", "topk"])
@pytest.mark.parametrize("shape", SHAPES)
def test_envelope_peaks_matches_pallas_kernel(method, shape):
    rng = np.random.default_rng(shape[-1])
    re = (2.0 * rng.normal(size=shape)).astype(np.float32)
    im = (2.0 * rng.normal(size=shape)).astype(np.float32)
    thr = np.linspace(2.0, 3.0, shape[0]).astype(np.float32)[:, None]
    j = _j32(jpallas.envelope_peaks_sparse, re, im, thr, max_peaks=32, method=method,
             interpret=True)
    launches = tfused.launches
    t = tfused.envelope_peaks_sparse(torch.from_numpy(re), torch.from_numpy(im),
                                     torch.from_numpy(thr), max_peaks=32, method=method)
    assert tfused.launches == launches            # the CPU runs the plain version
    _assert_same_picks(t, j)
    assert int(t.selected.sum()) > 0


@pytest.mark.parametrize("method", ["pack", "topk"])
def test_envelope_peaks_special_rows_match_pallas_kernel(method):
    env, thr = _special_rows(T=600)
    im = np.zeros_like(env)
    j = _j32(jpallas.envelope_peaks_sparse, env, im, thr, max_peaks=16, method=method,
             interpret=True)
    t = tfused.envelope_peaks_sparse(torch.from_numpy(env), torch.from_numpy(im),
                                     torch.from_numpy(thr), max_peaks=16, method=method)
    _assert_same_picks(t, j)


def test_analytic_envelope_peaks_matches_jnp_route():
    rng = np.random.default_rng(11)
    corr = (2.0 * rng.normal(size=(2, 6, 800))).astype(np.float32)
    thr = np.asarray([[2.2], [2.6]], np.float32)
    env = _j32(jspec.envelope_sqrt, corr)
    j = _j32(jpeaks.find_peaks_sparse_batched, env, thr, max_peaks=16, method="pack")
    t = tfused.analytic_envelope_peaks(torch.from_numpy(corr), torch.from_numpy(thr),
                                       max_peaks=16, method="pack")
    for f in ("positions", "selected", "saturated"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), getattr(j, f))


@pytest.mark.parametrize("capacity", [500, 7])
def test_compact_picks_rowmajor_matches(capacity):
    rng = np.random.default_rng(capacity)
    pos = rng.integers(0, 1000, size=(2, 30, 8)).astype(np.int32)
    sel = rng.random((2, 30, 8)) < 0.2
    j = _j32(jpeaks.compact_picks_rowmajor, pos, sel, capacity=capacity)
    t = tpeaks.compact_picks_rowmajor(torch.from_numpy(pos), torch.from_numpy(sel), capacity)
    for a, b in zip(t, j):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), b)
    if capacity == 7:
        assert int(t[2].max()) > capacity         # overflow reported, not hidden


def test_local_maxima_matches():
    env, _ = _special_rows()
    np.testing.assert_array_equal(tpeaks.local_maxima(torch.from_numpy(env)).numpy(),
                                  _j32(jpeaks.local_maxima, env))


def test_sparse_picks_equal_scipy_find_peaks():
    env = _envelope((6, 900), seed=3)
    thr = 2.5
    t = tpeaks.find_peaks_sparse(torch.from_numpy(env), thr, max_peaks=256, method="topk")
    assert not t.saturated.any()
    got = tpeaks.sparse_to_pick_times(t.positions.numpy(), t.selected.numpy())
    chan, time = [], []
    for i, row in enumerate(env):
        pk = sps.find_peaks(row, prominence=thr)[0]
        chan += [i] * len(pk)
        time += pk.tolist()
    assert len(time) > 0
    np.testing.assert_array_equal(got, np.asarray([chan, time]))


def test_escalation_policy_and_kernel_needs_cuda():
    assert tpeaks.escalation_method(64, 256) == "pack"
    assert tpeaks.escalation_method(256, 256) == "topk"
    X = torch.zeros((2, 100), dtype=torch.complex64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfused.picks_cuda(X, torch.zeros(2), 8, "pack")
    with pytest.warns(UserWarning, match="saturated"):
        assert tpeaks.warn_saturated(np.asarray([1, 0]), "template HF", 8)
    assert not tpeaks.warn_saturated(np.asarray([0, 0]), "template HF", 8)


def test_magnitude_is_the_kernel_envelope():
    # three roundings, never a hypot: bitwise torch's sqrt of the sum of
    # squares, which numpy forms bit for bit; torch's vectorised float32
    # sqrt is not correctly rounded on every CPU, so against numpy's
    # correctly rounded sqrt it is held within one float32 ulp
    rng = np.random.default_rng(4)
    z = torch.complex(torch.from_numpy(rng.normal(size=50).astype(np.float32)),
                      torch.from_numpy(rng.normal(size=50).astype(np.float32)))
    re, im = z.real.numpy(), z.imag.numpy()
    sq = re * re + im * im
    got = tspec.magnitude_sqrt(z).numpy()
    np.testing.assert_array_equal(got, torch.sqrt(torch.from_numpy(sq)).numpy())
    ulps = np.abs(got.view(np.int32).astype(np.int64) - np.sqrt(sq).view(np.int32))
    assert ulps.max() <= 1, ulps.max()


# --- a numpy model of the CUDA kernel's candidate logic -----------------------
# csrc/fused_picks.cu as its threads split the work: the load's index map (a
# head sample where a row starts 8 bytes past a 16-byte boundary, two samples
# a float4, an odd tail), the sweep that sets one candidate bit a sample (a
# full 128-sample block at four samples a lane, the lanes' nibbles OR-ed into
# words; any other block 32 samples a step, its ballot shifted into one word
# or two), the ranks from a scan of the popcounts of each thread's run of
# words, pack's slot = rank and topk's 8-bit radix select with its tie scan.
# Check a change of the kernel's candidate logic here first, against JAX's
# Pallas kernel and the port's plain version.

KERNEL_THREADS = 256


def _load_map(row, T):
    """The sample each of row ``row``'s loads writes, in the kernel's
    order (rows of complex64 from a 16-byte aligned base)."""
    head = min((row * T) & 1, T)
    n4 = (T - head) >> 1
    idx = [0] * head + (head + np.arange(2 * n4)).tolist()
    return idx + [T - 1] * (head + 2 * n4 < T)


def _order_key(v):
    """float32 -> uint32 with the same order, as the kernel's order_key."""
    u = np.asarray(v, np.float32).view(np.uint32)
    return np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))


def _sweep_words(x, thr, nb):
    """The candidate words as the kernel's sweep sets them: the thread at a
    strict rise above thr marks a peak, or walks its plateau and marks the
    floor-midpoint when the run falls again; samples 0 and T-1 never."""
    T = len(x)
    words = [0] * -(-T // 32)

    def plateau(i):
        j = i + 2
        while j < T and x[j] == x[i]:
            j += 1
        if j < T and x[j] < x[i]:
            mid = (i + j - 1) >> 1
            words[mid >> 5] |= 1 << (mid & 31)

    for b in range(-(-T // nb)):
        i0 = b * nb
        if nb == 128 and i0 + 128 <= T:          # a float4 a lane, neighbours by shuffles
            v = x[i0 : i0 + 128].reshape(32, 4)
            l = np.r_[x[i0 - 1] if i0 > 0 else np.inf, v[:-1, 3]]
            r = np.r_[v[1:, 0], x[i0 + 128] if i0 + 128 < T else np.inf]
            s = np.concatenate([l[:, None], v, r[:, None]], axis=1)
            rise = (s[:, :4] < s[:, 1:5]) & (s[:, 1:5] >= thr)
            nib = ((rise & (s[:, 2:] < s[:, 1:5])) << np.arange(4)).sum(axis=1)
            for w in range(4):                   # lanes 8w..8w+7 make word w of the block
                words[(i0 >> 5) + w] |= sum(int(nib[8 * w + k]) << 4 * k for k in range(8))
            for lane, k in zip(*np.nonzero(rise & (s[:, 2:] == s[:, 1:5]))):
                plateau(i0 + 4 * int(lane) + int(k))
            continue
        end = min(i0 + nb, T)
        for j0 in range(i0, end, 32):            # 32 samples a step, one ballot
            i = np.arange(j0, min(j0 + 32, end))
            v, l, r = x[i], x[np.maximum(i - 1, 0)], x[np.minimum(i + 1, T - 1)]
            rise = (i > 0) & (i < T - 1) & (l < v) & (v >= thr)
            m = sum(1 << int(k) for k in np.nonzero(rise & (r < v))[0])
            for k in np.nonzero(rise & (r == v))[0]:
                plateau(j0 + int(k))
            w0, off = j0 >> 5, j0 & 31
            words[w0] |= (m << off) & 0xFFFFFFFF
            if off and m >> (32 - off):
                words[w0 + 1] |= m >> (32 - off)
    return words


def _thread_runs(words):
    """Each thread's candidates, from its contiguous run of words, and the
    exclusive scan of their counts: its first candidate's rank."""
    chunk = -(-len(words) // KERNEL_THREADS)
    runs = [[32 * w + b for w in range(t * chunk, min(t * chunk + chunk, len(words)))
             for b in range(32) if words[w] >> b & 1] for t in range(KERNEL_THREADS)]
    counts = np.asarray([len(run) for run in runs])
    return runs, np.cumsum(counts) - counts, int(counts.sum())


def _radix_select(keys, K):
    """The K-th largest of ``keys``, 8 bits at a time: (its key, how many of
    the keys equal to it go in)."""
    prefix, mask, k_rem = 0, 0, K
    for shift in (24, 16, 8, 0):
        live = keys[(keys & np.uint32(mask)) == np.uint32(prefix)]
        hist = np.bincount((live >> np.uint32(shift)) & np.uint32(255), minlength=256)
        above, b = 0, 255
        while b > 0 and above + hist[b] < k_rem:
            above += hist[b]
            b -= 1
        k_rem -= above
        prefix |= b << shift
        mask |= 255 << shift
    return np.uint32(prefix), k_rem


def _slots(runs, rank0, n_cand, x, K, method):
    """pack: each thread whose first rank is under K writes its candidates
    to slots rank0, rank0 + 1, ... below K. topk: all candidates, or those
    above the K-th key and, of the keys equal to it, the first k_rem by an
    exclusive scan of each thread's count; then height desc, index asc."""
    nS = min(n_cand, K)
    if method == "pack":
        slots = np.zeros(nS, np.int64)
        for run, r in zip(runs, rank0):
            for p in run[: max(0, K - r)]:
                slots[r] = p
                r += 1
        return slots
    kept = [p for run in runs for p in run]
    if n_cand > K:
        prefix, k_rem = _radix_select(_order_key(x[kept]), K)
        eq = np.asarray([int((_order_key(x[run]) == prefix).sum()) for run in runs])
        kept = []
        for run, t in zip(runs, np.cumsum(eq) - eq):
            for p, u in zip(run, _order_key(x[run])):
                if u > prefix or (u == prefix and t < k_rem):
                    kept.append(p)
                t += u == prefix
    kept = np.asarray(kept, np.int64)
    return kept[np.lexsort((kept, ~_order_key(x[kept])))]


def _base_min(x, p, h, step):
    """scipy's base: the min of x from p to the first sample past it (in
    direction ``step``) that is above h, or to the edge."""
    side = x[p::step] if step > 0 else x[p::-1]
    above = np.nonzero(side[1:] > h)[0]
    return side[: above[0] + 1 if len(above) else len(side)].min()


def _bitmask_model(env, thr, K, method, nb=128):
    """The five outputs of the kernel as its candidate bitmask computes them
    from the envelope ``env [rows, T]`` float32."""
    rows, T = env.shape
    K = min(K, T)
    out = dict(positions=np.zeros((rows, K), np.int32),
               heights=np.zeros((rows, K), np.float32),
               prominences=np.zeros((rows, K), np.float32),
               selected=np.zeros((rows, K), bool), saturated=np.zeros(rows, bool))
    for r in range(rows):
        idx = _load_map(r, T)
        np.testing.assert_array_equal(np.sort(idx), np.arange(T))   # each sample once
        x = env[r, idx][np.argsort(idx)]
        runs, rank0, n_cand = _thread_runs(_sweep_words(x, thr[r], nb))
        slots = _slots(runs, rank0, n_cand, x, K, method)
        nS = len(slots)
        slot_pos = np.zeros(K, np.int64)
        slot_pos[:nS] = slots
        h = np.full(K, -np.inf, np.float32)
        h[:nS] = x[slots]
        prom = np.full(K, np.float32(-np.inf) - x[0], np.float32)
        for s in range(nS):
            p = int(slot_pos[s])
            prom[s] = h[s] - max(_base_min(x, p, h[s], -1), _base_min(x, p, h[s], 1))
        sel = (np.arange(K) < nS) & (prom >= thr[r])
        key = np.where(sel, slot_pos, T)
        order = np.arange(K) if method == "pack" else np.argsort(key, kind="stable")
        out["positions"][r] = key[order]
        out["heights"][r] = h[order]
        out["prominences"][r] = prom[order]
        out["selected"][r] = sel[order]
        out["saturated"][r] = n_cand > K
    return tfused.peak_ops.SparsePicks(*(torch.from_numpy(out[f]) for f in (
        "positions", "heights", "prominences", "selected", "saturated")))


def _spike_row(T, n, rng):
    """Zeros with n isolated spikes in [1, 2): exactly n candidates above 0.5."""
    row = np.zeros(T, np.float32)
    row[np.linspace(1, T - 2, n).round().astype(int)] = 1.0 + rng.random(n)
    return row


def _model_rows(T, K, seed):
    """(re, im, thr): random analytic rows over a spread of thresholds, rows
    with exactly K and K + 1 candidates, and at T = 1000 the special rows."""
    rng = np.random.default_rng(seed)
    re = [(2.0 * rng.normal(size=T)) for _ in range(4)]
    im = [(2.0 * rng.normal(size=T)) for _ in range(4)]
    thr = [0.05, 1.0, 2.5, 4.0]
    for n in (K, K + 1):
        re.append(_spike_row(T, n, rng))
        im.append(np.zeros(T))
        thr.append(0.5)
    if T == 1000:
        env, sthr = _special_rows(T)
        re += list(env)
        im += [np.zeros(T)] * len(env)
        thr += list(sthr)
    return (np.stack(re).astype(np.float32), np.stack(im).astype(np.float32),
            np.asarray(thr, np.float32))


_PALLAS_CASES = {(1, 1000), (8, 963), (64, 1000), (256, 963)}


@pytest.mark.parametrize("T", [1000, 963])
@pytest.mark.parametrize("K", [1, 8, 64, 256])
@pytest.mark.parametrize("method", ["pack", "topk"])
def test_bitmask_model_matches_pallas_kernel_and_plain(method, K, T):
    """The kernel's candidate bitmask, modelled in numpy, gives the plain
    version's five outputs bit for bit, and JAX's Pallas kernel's picks
    (for each K at one of the two lengths)."""
    re, im, thr = _model_rows(T, K, seed=T + K)
    X = torch.complex(torch.from_numpy(re), torch.from_numpy(im))
    # the port's envelope: torch's CPU sqrt is not correctly rounded
    # everywhere (an ulp low on about 1 sample in 140 here), where numpy's
    # and the card's __fsqrt_rn are; the model is about candidates, not that
    model = _bitmask_model(tspec.magnitude_sqrt(X).numpy(), thr, K, method)
    plain = tfused.picks_plain(X, torch.from_numpy(thr), K, method)
    for f in ("positions", "heights", "prominences", "selected", "saturated"):
        np.testing.assert_array_equal(getattr(model, f).numpy(), getattr(plain, f).numpy(),
                                      err_msg=f)
    if (K, T) in _PALLAS_CASES:                  # each K once: interpret mode is slow
        j = _j32(jpallas.envelope_peaks_sparse, re, im, thr, max_peaks=K, method=method,
                 interpret=True)
        _assert_same_picks(model, j)
    sat = model.saturated.numpy()
    assert not sat[4] and sat[5]                  # exactly K, then K + 1 candidates
    assert int(model.selected.sum()) > 0


@pytest.mark.parametrize("T", [1000, 963])
@pytest.mark.parametrize("method", ["pack", "topk"])
def test_bitmask_model_blocks_off_the_word_grid(method, T):
    """At nb = 100 every block takes the sweep's 32-sample path, most of
    its ballots straddle two words, and the outputs stay the plain
    version's (which do not depend on nb)."""
    re, im, thr = _model_rows(T, 64, seed=2 * T)
    X = torch.complex(torch.from_numpy(re), torch.from_numpy(im))
    model = _bitmask_model(tspec.magnitude_sqrt(X).numpy(), thr, 64, method, nb=100)
    plain = tfused.picks_plain(X, torch.from_numpy(thr), 64, method, nb=100)
    for f in ("positions", "heights", "prominences", "selected", "saturated"):
        np.testing.assert_array_equal(getattr(model, f).numpy(), getattr(plain, f).numpy(),
                                      err_msg=f)
    assert int(model.selected.sum()) > 0


def test_timed_kernel_needs_cuda_and_names_its_phases():
    """The phase-timed entry routes like the kernel's: a CPU tensor raises
    (it never falls back to the plain version); its stamps carry one
    column per phase boundary."""
    X = torch.zeros((2, 100), dtype=torch.complex64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfused.picks_cuda_timed(X, torch.zeros(2), 8, "pack")
    assert tfused.PHASES == ("load", "tables+maxima", "candidates", "slots",
                             "prominences", "outputs")


def test_chip_smoke_reads_the_phase_stamps():
    """chip_smoke.py's split of the timed launch: per phase the mean and max
    of the %globaltimer differences and the mean clock64 cycles, the CTA
    time, the launch's span and the CTAs resident an SM."""
    import chip_smoke

    P = len(tfused.PHASES)
    ns = np.zeros((2, P + 1), np.int64)
    ns[0] = 1000 + np.arange(P + 1) * 100             # CTA 0: 100 ns a phase
    ns[1] = 1300 + np.arange(P + 1) * 300             # CTA 1: 300 ns a phase
    stamps = torch.from_numpy(np.stack([ns, 2 * ns], axis=1))   # 2 cycles a ns
    sp = chip_smoke._phase_split(stamps, 0.005)
    assert sp["phases"]["load"] == (200.0, 300.0, 400.0)
    assert sp["cta_mean_ns"] == 200.0 * P and sp["cta_max_ns"] == 300.0 * P
    assert sp["span_ns"] == 1300 + 300 * P - 1000 and sp["ghz"] == 2.0
    assert sp["resident"] == pytest.approx(400 * P / sp["span_ns"] / chip_smoke.SMS)


def test_chip_smoke_captures_the_inputs_a_main_path_gives_a_kernel():
    """chip_smoke.py's spy forwards every call of the routed function and
    keeps clones of the first and the latest call's arguments, then puts
    the function back."""
    import chip_smoke

    rng = np.random.default_rng(5)
    corr = torch.from_numpy(rng.standard_normal((2, 3, 4, 200)).astype(np.float32))
    thr = torch.tensor([[1.0], [2.0]])
    orig = tfused.picks_plain
    with chip_smoke._capture(tfused, "picks_plain") as calls:
        want = [tfused.analytic_envelope_peaks(corr[:, :, k], thr, max_peaks=8, method="pack")
                for k in range(4)]
    assert tfused.picks_plain is orig and calls["n"] == 4
    for which, k in (("first", 0), ("last", 3)):
        (X, t, K, method, nb), kw = calls[which]
        assert (K, method, nb, kw) == (8, "pack", 128, {})
        assert torch.equal(X, tspec.analytic_signal(corr[:, :, k]).reshape(6, 200))
        assert torch.equal(t, torch.tensor([1.0, 1.0, 1.0, 2.0, 2.0, 2.0]))
        got = tfused.picks_plain(X, t, K, method)
        assert torch.equal(got.positions, want[k].positions.reshape(6, 8))
    with chip_smoke._capture(tfused, "picks_plain") as calls:
        tfused.analytic_envelope_peaks(corr[0, 0, 0], 1.0, max_peaks=8)
    assert calls["n"] == 1 and calls["last"] is calls["first"]


@pytest.mark.parametrize("T,pack_bytes,topk_bytes,want", [
    (12000, 51344, 56144, {"pack": 4, "topk": 3}),
    (16384, 69696, 74816, {"pack": 3, "topk": 3}),
    (60000, 241000, 246000, {"pack": 0, "topk": 0})])
def test_chip_smoke_holds_the_ctas_an_sm_to_the_shared_memory(monkeypatch, T, pack_bytes,
                                                              topk_bytes, want):
    """Past the row length where the design's CTAs fit an SM's 228 KiB of
    shared memory (each CTA reserving 1 KiB more), chip_smoke.py expects
    as many as fit."""
    import chip_smoke

    monkeypatch.setattr(tfused, "smem_bytes", lambda T_, K, method: {
        "pack": pack_bytes, "topk": topk_bytes}[method])
    assert {m: chip_smoke._picks_ctas_want(T, 64, m) for m in want} == want


def test_chip_smoke_reads_the_pick_kernels_ptxas():
    """chip_smoke.py reads registers and spills of each
    ``fused_picks_kernel<method, timed, long_row>``, to show that the main
    launch's ``pack`` instantiation (the shared-memory form) does not
    spill."""
    import chip_smoke

    fn = "_ZN46_GLOBAL__N__0e7b6d0a_14_fused_picks_cu_b1f9c1a118fused_picks_kernelILi{}ELb{}ELb{}EEEvPK6float2PKfPiPfS7_PhS8_iiiS8_Px"
    report = "\n".join(
        line for m, t, lr, regs, spill in ((0, 0, 0, 56, 0), (1, 1, 1, 72, 8)) for line in (
            f"ptxas info    : Compiling entry function '{fn.format(m, t, lr)}' for 'sm_90a'",
            f"ptxas info    : Function properties for {fn.format(m, t, lr)}",
            f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads",
            f"ptxas info    : Used {regs} registers, used 1 barriers"))
    got = chip_smoke.ptxas_instances(report, "fused_picks_kernel")
    assert got == {(0, False, False): (56, 0, 0), (1, True, True): (72, 8, 8)}
    assert chip_smoke.PICKS_MAIN_INSTANCE == (0, False, False)

"""Port parity, the STFT: ``ops.fused_stft`` and the STFT routes of
``ops.spectral`` of das4whales_tpu_torch (on the CPU, so the kernel's
plain version) against das4whales_tpu (float32, x64 off): the Pallas
kernel in interpret mode and the rFFT route.

Tolerance: ``atol = 5e-6 * max|ref|`` for the power, the contract
``tests/test_pallas_stft.py`` holds the JAX kernel to against the rFFT
route (the DFT as a product and as an FFT round differently).
"""

from __future__ import annotations

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from das4whales_tpu.ops import pallas_stft as jps
from das4whales_tpu.ops import spectral as jspec
from das4whales_tpu_torch.ops import fused_stft, spectral
from das4whales_tpu_torch.utils import build

POWER_REL = 5e-6

#: the five shapes of tests/test_pallas_stft.py, then center=False and
#: window="ones"
CASES = [
    (8, 512, 128, 32, True, "hann"),
    (5, 300, 64, 16, True, "hann"),
    (3, 1000, 256, 60, True, "hann"),
    (8, 256, 128, 128, True, "hann"),
    (2, 150, 128, 25, True, "hann"),
    (4, 400, 128, 32, False, "hann"),
    (6, 700, 160, 8, True, "ones"),
]

#: spans past the kernel's 48 KB of shared memory (its per-chunk gather)
LARGE_SPANS = [
    (2, 4000, 1024, 384, True, "hann"),
    (2, 4000, 2048, 2048, True, "hann"),
]


def _x(c, n, seed=0):
    return np.random.default_rng(seed).standard_normal((c, n)).astype(np.float32)


def _assert_rel(ref, got, rel):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    scale = float(np.abs(ref).max())
    assert scale > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * scale)


@pytest.mark.parametrize("c,n,nfft,hop,center,window", CASES)
def test_stft_power_matches_pallas_kernel(c, n, nfft, hop, center, window):
    x = _x(c, n)
    with jax.enable_x64(False):
        ref = np.array(jps.stft_power(x, nfft, hop, window=window, center=center,
                                      interpret=True))
    got = fused_stft.stft_power(torch.from_numpy(x), nfft, hop, window=window, center=center)
    assert got.dtype == torch.float32
    _assert_rel(ref, got.numpy(), POWER_REL)


@pytest.mark.parametrize("c,n,nfft,hop,center,window", CASES + LARGE_SPANS)
def test_stft_power_matches_rfft_power(c, n, nfft, hop, center, window):
    x = _x(c, n, seed=1)
    with jax.enable_x64(False):
        ref = np.abs(np.array(jspec.stft(jnp.asarray(x), nfft, hop, window=window,
                                         center=center))) ** 2
    got = fused_stft.stft_power(torch.from_numpy(x), nfft, hop, window=window, center=center)
    _assert_rel(ref, got.numpy(), POWER_REL)


@pytest.mark.parametrize("nfft", [64, 128, 160, 256])
@pytest.mark.parametrize("window", ["hann", "ones"])
def test_dft_matrix_is_bitwise_the_jax_kernels(nfft, window):
    win = (0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(nfft) / nfft)) if window == "hann"
           else np.ones(nfft))
    ref = jps._dft_matrix(nfft, win)
    got = fused_stft._dft_matrix(nfft, fused_stft._window(nfft, window))
    assert got.dtype == np.float32 and got.shape == (nfft, 2 * (nfft // 2 + 1))
    np.testing.assert_array_equal(got, ref)


def test_stft_power_validates_args_like_jax():
    x = torch.from_numpy(_x(2, 64))
    bad = [
        (x[0], 32, 8, {}),                       # not 2-D
        (x, 32, 0, {}),                          # hop < 1
        (x, 32, 33, {}),                         # hop > nfft
        (x, 32, 8, {"window": "nuttall"}),
        (x, 128, 8, {"center": False}),          # n < nfft: no full frame
    ]
    for arr, nfft, hop, kw in bad:
        with pytest.raises(ValueError):
            jps.stft_power(arr.numpy(), nfft, hop, **kw)
        with pytest.raises(ValueError):
            fused_stft.stft_power(arr, nfft, hop, **kw)
    with pytest.raises(ValueError, match="center=False"):
        spectral.stft(x, 128, 8, center=False)


def test_cuda_route_refuses_a_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_stft.stft_power_cuda(torch.zeros(2, 64), 32, 8)
    assert fused_stft.launches == 0


@pytest.mark.parametrize("c,n,nfft,hop,center", [
    (3, 701, 160, 8, True), (2, 500, 64, 16, False), (2, 303, 65, 13, True),
])
def test_stft_matches_jax(c, n, nfft, hop, center):
    x = _x(c, n, seed=2)
    with jax.enable_x64(False):
        ref = np.array(jspec.stft(jnp.asarray(x), nfft, hop, center=center))
    got = spectral.stft(torch.from_numpy(x), nfft, hop, center=center).numpy()
    assert got.dtype == np.complex64
    _assert_rel(ref.real, got.real, 1e-5)
    _assert_rel(ref.imag, got.imag, 1e-5)


@pytest.mark.parametrize("engine,jax_engine", [("rfft", "rfft"), ("fused", "pallas")])
def test_stft_magnitude_engines_match_jax(engine, jax_engine):
    x = _x(6, 700, seed=3)[None]                  # a leading axis flattens and comes back
    with jax.enable_x64(False):
        ref = np.array(jspec.stft_magnitude(jnp.asarray(x), 160, 8, engine=jax_engine))
    got = spectral.stft_magnitude(torch.from_numpy(x), 160, 8, engine=engine).numpy()
    assert got.shape == (1, 6, 81, 88)
    _assert_rel(ref, got, POWER_REL)


def test_stft_engine_vocabulary(monkeypatch):
    from das4whales_tpu_torch.ops import mxu

    assert spectral.STFT_ENGINES == ("rfft", "matmul", "fused")
    for eng in spectral.STFT_ENGINES:
        assert spectral.check_stft_engine(eng) == eng
    # the default, the environment and "auto" resolve in one place
    # (ops.mxu.resolve_stft_engine_ab); the functions here take a concrete
    # engine only, so no word means two routes
    monkeypatch.delenv("DAS4WHALES_STFT_ENGINE", raising=False)
    assert mxu.resolve_stft_engine_ab(None, 8, 900, 160, 8, device="cpu") == ("fused", "forced")
    monkeypatch.setenv("DAS4WHALES_STFT_ENGINE", "auto")
    assert mxu.resolve_stft_engine_ab(None, 8, 900, 160, 8, device="cpu")[0] == "rfft"
    x = torch.zeros((2, 400))
    for bad in ("auto", None, "pallas"):
        with pytest.raises(ValueError, match="unknown stft engine"):
            spectral.stft_magnitude(x, 160, 8, engine=bad)


def test_each_kernel_builds_with_its_own_flags():
    # the pick kernel keeps -fmad=false (bitwise with its plain version)
    # and its library name; the STFT kernel keeps FMA contraction on
    assert build.nvcc_flags("fused_picks") == build.NVCC_FLAGS
    assert "-fmad=false" in build.nvcc_flags("fused_picks")
    assert "-fmad=false" not in build.nvcc_flags("fused_stft")
    assert set(build.nvcc_flags("fused_stft")) == set(build.NVCC_FLAGS) - {"-fmad=false"}
    src = (build.CSRC_DIR / "fused_picks.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(build.NVCC_FLAGS).encode()).hexdigest()[:12]
    assert build.library_path("fused_picks").name == f"fused_picks-{digest}.so"
    assert build.library_path("fused_stft").name.startswith("fused_stft-")


def test_each_engine_keeps_its_own_magnitude_form():
    # "rfft" is abs of the complex STFT, "fused" the sqrt of the power, as
    # in the JAX package
    x = torch.from_numpy(_x(3, 500, seed=4))
    assert torch.equal(spectral.stft_magnitude(x, 160, 8, engine="rfft"),
                       torch.abs(spectral.stft(x, 160, 8)))
    assert torch.equal(spectral.stft_magnitude(x, 160, 8, engine="fused"),
                       torch.sqrt(fused_stft.stft_power(x, 160, 8)))


@pytest.mark.parametrize("center,window", [(True, "hann"), (False, "hann"), (True, "ones")])
def test_the_library_yardstick_pads_with_zeros(center, window):
    """chip_smoke.py's ``torch.stft`` yardstick centres with zeros, as the
    port does; ``torch.stft``'s default reflect padding would part at the
    record's edges."""
    import chip_smoke

    x = torch.from_numpy(_x(4, 1000, seed=5))
    lib = chip_smoke._torch_stft_power(x, 160, 8, window, center)
    _assert_rel(fused_stft.stft_power(x, 160, 8, window=window, center=center).numpy(),
                lib.numpy(), POWER_REL)
    if center:
        win = torch.hann_window(160, periodic=True) if window == "hann" else torch.ones(160)
        s = torch.stft(x, 160, 8, window=win, center=True, return_complex=True)
        reflect = (s.real * s.real + s.imag * s.imag).numpy()
        assert np.abs(reflect - lib.numpy()).max() > 1e-3 * np.abs(lib.numpy()).max()


@pytest.mark.parametrize("nfft", [6, 64, 65, 128, 160, 256, 1024, 2048])
@pytest.mark.parametrize("window", ["hann", "ones"])
def test_dft_matrix_has_the_symmetries_the_kernel_folds(nfft, window):
    """The CUDA kernel reads only rows n <= N/2 of the float32 matrix, and
    for even N only columns k <= N/4: it relies on C[N-n] = C[n],
    S[N-n] = -S[n] (a symmetric window) and, for even N,
    C[n, N/2-k] = (-1)^n C[n, k], S[n, N/2-k] = -(-1)^n S[n, k]. The
    float64 angles are cast once, so these hold to rounding, not bit for
    bit; the peeled tap 0 relies on S[0] = sin 0 = 0 exactly."""
    M = fused_stft._dft_matrix(nfft, fused_stft._window(nfft, window))
    F_ = nfft // 2 + 1
    C, S = M[:, :F_].astype(np.float64), M[:, F_:].astype(np.float64)
    tol = np.finfo(np.float32).eps * float(np.abs(M).max())
    n = np.arange(1, nfft)
    np.testing.assert_allclose(C[nfft - n], C[n], rtol=0, atol=tol)
    np.testing.assert_allclose(S[nfft - n], -S[n], rtol=0, atol=tol)
    assert not S[0].any()
    if nfft % 2 == 0:
        k = np.arange(nfft // 4 + 1)
        sign = ((-1.0) ** np.arange(nfft))[:, None]
        np.testing.assert_allclose(C[:, nfft // 2 - k], sign * C[:, k], rtol=0, atol=tol)
        np.testing.assert_allclose(S[:, nfft // 2 - k], -sign * S[:, k], rtol=0, atol=tol)


def _frames(x: np.ndarray, nfft: int, hop: int, center: bool) -> np.ndarray:
    """The frames ``[C, n_frames, nfft]`` of ``x``, zero outside it."""
    nf = fused_stft.n_frames(x.shape[1], nfft, hop, center)
    idx = (np.arange(nf)[:, None] * hop + np.arange(nfft)[None, :]
           - (nfft // 2 if center else 0))
    return np.where((idx >= 0) & (idx < x.shape[1]),
                    x[:, np.clip(idx, 0, x.shape[1] - 1)], np.float32(0))


def _folded_power(x: np.ndarray, nfft: int, hop: int, window: str, center: bool) -> np.ndarray:
    """A float32 numpy model of the CUDA kernel's folded sums: tap 0 on
    its own, u and v over taps 1 .. N/2 (the middle tap of even N read
    twice against half its row), sums split by the parity of the tap, the
    bin k and its pair N/2 - k written from one set of sums (the middle
    bin k = N/4 once), odd N folded once over every k < F."""
    M = fused_stft._dft_matrix(nfft, fused_stft._window(nfft, window))
    F_, H = nfft // 2 + 1, nfft // 2
    even = nfft % 2 == 0
    K2 = nfft // 4 + 1 if even else F_
    s = _frames(x, nfft, hop, center)
    n = np.arange(1, H + 1)
    u, v = s[..., n] + s[..., nfft - n], s[..., n] - s[..., nfft - n]
    Cf, Sf = M[1:H + 1, :K2].copy(), M[1:H + 1, F_:F_ + K2]
    if even:
        Cf[H - 1] *= np.float32(0.5)
    odd_tap = n % 2 == 1
    er = s[..., :1] * M[0, :K2] + u[..., ~odd_tap] @ Cf[~odd_tap]
    eo = u[..., odd_tap] @ Cf[odd_tap]
    ie, io = v[..., ~odd_tap] @ Sf[~odd_tap], v[..., odd_tap] @ Sf[odd_tap]
    assert er.dtype == np.float32
    P = np.zeros(s.shape[:2] + (F_,), np.float32)
    written = np.zeros(F_, int)
    P[..., :K2] = (er + eo) ** 2 + (ie + io) ** 2
    written[:K2] += 1
    if even:
        k = np.arange(K2)
        k = k[H - k != k]
        P[..., H - k] = (er - eo)[..., k] ** 2 + (ie - io)[..., k] ** 2
        written[H - k] += 1
    assert (written == 1).all(), written                 # every bin exactly once
    return P.transpose(0, 2, 1)


@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("nfft,hop,window", [
    (6, 2, "hann"), (64, 16, "ones"), (65, 8, "hann"), (160, 8, "hann"), (1024, 256, "hann"),
])
def test_folded_sums_match_plain_and_pallas(nfft, hop, window, center):
    """The folded sums against float64 sums over the same float32 matrix
    and against the Pallas kernel, to 1e-6 * max; against the plain
    version to 2e-6 * max."""
    x = _x(3, 2500, seed=6)
    got = _folded_power(x, nfft, hop, window, center)
    plain = fused_stft.stft_power_plain(torch.from_numpy(x), nfft, hop, window=window,
                                        center=center).numpy()
    with jax.enable_x64(False):
        ref = np.array(jps.stft_power(x, nfft, hop, window=window, center=center,
                                      interpret=True))
    M = fused_stft._dft_matrix(nfft, fused_stft._window(nfft, window)).astype(np.float64)
    prod = _frames(x, nfft, hop, center).astype(np.float64) @ M
    exact = (prod[..., :nfft // 2 + 1] ** 2 + prod[..., nfft // 2 + 1:] ** 2).transpose(0, 2, 1)
    _assert_rel(exact, got, 1e-6)
    _assert_rel(ref, got, 1e-6)
    # the plain version's own float32 sums part from `exact` by up to
    # 1.0e-6 * max at nfft 160 (the folded model by 2.2e-7), so against it
    # the two float32 roundings add
    _assert_rel(plain, got, 2e-6)


def test_the_kernel_bound_counts_the_fft_form():
    """The kernel line's bound is the function's, not the design's: at
    the main launch the FFT form's operations (2.0e10) take less time than
    the bytes, so bytes bound it; the DFT-form contraction (3.19e11) is a
    side figure."""
    import chip_smoke

    b = chip_smoke._stft_bounds(4096, 12000, 160, 8)
    assert b["bound_by"] == "bytes" and b["bound_ms"] == b["bytes_ms"]
    assert b["bytes"] == 4 * 4096 * 12000 + 4 * 160 * 162 + 4 * 4096 * 81 * 1501
    assert 1.9e10 < b["ops"] < 2.2e10 and b["ops_ms"] < b["bytes_ms"]
    assert b["dft_ops"] == 2 * 4096 * 1501 * 160 * 162 and b["dft_ops_ms"] > b["bound_ms"]


def test_ptxas_report_is_read_per_instantiation():
    """chip_smoke.py reads registers and spills of each
    ``fused_stft_kernel<R, kSpan>`` from the ``-Xptxas -v`` report, to
    show that the main launch's instantiation does not spill."""
    import chip_smoke

    fn = "_ZN46_GLOBAL__N__192a1c5e_13_fused_stft_cu_7dcb5ad817fused_stft_kernelILi{}ELb{}EEEvPKfS2_Pfiiiiiiiiiii"
    report = "\n".join([
        "ptxas info    : 0 bytes gmem",
        f"ptxas info    : Compiling entry function '{fn.format(1, 1)}' for 'sm_90a'",
        f"ptxas info    : Function properties for {fn.format(1, 1)}",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 48 registers, used 1 barriers, 8 bytes cumulative stack size",
        f"ptxas info    : Compiling entry function '{fn.format(4, 1)}' for 'sm_90a'",
        f"ptxas info    : Function properties for {fn.format(4, 1)}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 127 registers, used 1 barriers",
    ])
    got = chip_smoke.ptxas_instances(report, "fused_stft_kernel")
    assert got == {(1, True): (48, 4, 4), (4, True): (127, 0, 0)}
    assert chip_smoke.STFT_MAIN_INSTANCE == (4, True)


def test_the_folded_form_counts_its_own_operations():
    """The kernel's folded DFT, a side figure beside the dense form: per
    frame 81 taps x 41 k x (re, im) multiply-adds, the 80 folds of u and
    v, the 4 sums of the pairing per k and the power of 81 bins — 8.5e10
    operations at the main launch, 1.27 ms at 67 TFLOP/s, within 2x of
    the byte bound; odd N folds once, over every k."""
    import chip_smoke

    b = chip_smoke._stft_bounds(4096, 12000, 160, 8)
    frames = 4096 * 1501
    assert b["fold_ops"] == frames * (4 * 81 * 41 + 2 * 80 + 4 * 41 + 3 * 81)
    assert 8.4e10 < b["fold_ops"] < 8.6e10 and 1.26 < b["fold_ops_ms"] < 1.28
    assert b["bound_ms"] < b["fold_ops_ms"] < 2 * b["bound_ms"] < b["dft_ops_ms"]
    odd = chip_smoke._stft_bounds(2, 1000, 65, 8)
    assert odd["fold_ops"] == 2 * 126 * (4 * 33 * 33 + 2 * 32 + 2 * 33 + 3 * 33)

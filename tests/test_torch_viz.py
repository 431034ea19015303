"""Port parity, the figures: ``viz`` (``cmaps``, ``plot``, ``map``) and
``workflows.campaign.plot_campaign_density`` of das4whales_tpu_torch
(device work on the CPU) against das4whales_tpu's (float32, x64 off),
artist by artist, on the same seeded numpy inputs.

Contract: the colormaps' tables bitwise JAX's; per figure the same axes,
and on each the same images (extent, colormap, limits), lines, scatter
offsets, mesh arrays, titles (all three), axis labels, limits and legend
texts. Data that numpy makes equal bitwise; data an FFT op makes (the
envelope images, the f-x panels) within ``FFT_REL * max|ref|``; the
instantaneous frequencies within ``IF_ULPS`` float32 ulps of the largest
unwrapped phase, in Hz (the ``dsp`` phase's bound: a difference of two
unwrapped phases keeps their absolute rounding), where the analytic
signal's amplitude exceeds ``PHASE_FLOOR`` of its max (below it the
phase is rounding noise in either package). ``import
das4whales_tpu_torch.viz`` works without matplotlib
(``tests/test_torch_imports.py``)."""

from __future__ import annotations

from datetime import datetime

import matplotlib
from tests.torch_threads import one_torch_thread  # noqa: F401

matplotlib.use("Agg")

import jax  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from das4whales_tpu import viz as jviz  # noqa: E402
from das4whales_tpu.workflows import campaign as jcampaign  # noqa: E402
from das4whales_tpu_torch import viz as tviz  # noqa: E402
from das4whales_tpu_torch.workflows import campaign as tcampaign  # noqa: E402

FFT_REL = 1e-5
PHASE_FLOOR = 1e-3
IF_ULPS = 8

NX, NS, FS, DX = 16, 400, 200.0, 8.0


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


def _block(seed=0):
    rng = np.random.default_rng(seed)
    trace = (rng.standard_normal((NX, NS)) * 1e-9).astype(np.float32)
    return trace, np.arange(NS) / FS, np.arange(NX) * DX


def _near(ref, got, rel, mask=None, atol=None):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    if mask is not None:
        ref, got = ref[mask], got[mask]
    scale = float(np.nanmax(np.abs(ref))) if ref.size else 0.0
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * scale if atol is None else atol)


def _texts(ax):
    legend = ax.get_legend()
    return {
        "titles": [ax.get_title(loc) for loc in ("left", "center", "right")],
        "labels": (ax.get_xlabel(), ax.get_ylabel()),
        "legend": [t.get_text() for t in legend.get_texts()] if legend else None,
    }


def _same_figure(jfig, tfig, fft_images=False, fft_lines=None):
    """The artists of two figures agree. ``fft_images``: image data within
    ``FFT_REL``; ``fft_lines(ax, k)`` -> None (bitwise) or ``(mask, atol)``:
    the samples held within ``atol``."""
    jaxes, taxes = jfig.axes, tfig.axes
    assert len(jaxes) == len(taxes)
    for ja, ta in zip(jaxes, taxes):
        assert _texts(ja) == _texts(ta)
        assert ja.get_xlim() == pytest.approx(ta.get_xlim(), rel=1e-6)
        assert ja.get_ylim() == pytest.approx(ta.get_ylim(), rel=1e-6)
        assert len(ja.images) == len(ta.images)
        for ji, ti in zip(ja.images, ta.images):
            assert ji.get_extent() == pytest.approx(ti.get_extent(), rel=0, abs=0)
            assert ji.get_cmap().name == ti.get_cmap().name
            assert ji.get_clim() == ti.get_clim() or fft_images
            if fft_images:
                _near(ji.get_array(), ti.get_array(), FFT_REL)
            else:
                np.testing.assert_array_equal(ti.get_array(), ji.get_array())
        assert len(ja.lines) == len(ta.lines)
        for k, (jl, tl) in enumerate(zip(ja.lines, ta.lines)):
            np.testing.assert_array_equal(tl.get_xdata(), jl.get_xdata())
            held = fft_lines(ja, k) if fft_lines is not None else None
            if held is None:
                np.testing.assert_array_equal(tl.get_ydata(), jl.get_ydata())
            else:
                _near(jl.get_ydata(), tl.get_ydata(), None, *held)
            assert tl.get_label() == jl.get_label()
        assert len(ja.collections) == len(ta.collections)
        for jc, tc in zip(ja.collections, ta.collections):
            np.testing.assert_array_equal(tc.get_offsets(), jc.get_offsets())
            if jc.get_array() is not None:
                np.testing.assert_array_equal(tc.get_array(), jc.get_array())


def _j(fn, *args, **kw):
    with jax.enable_x64(False):
        return fn(*args, **kw)


def test_colormaps_are_bitwise_jax():
    for name in ("import_roseus", "import_parula"):
        j, t = getattr(jviz, name)(), getattr(tviz, name)()
        assert t.name == j.name and t.N == j.N
        np.testing.assert_array_equal(np.asarray(t.colors), np.asarray(j.colors))


@pytest.mark.parametrize("name, extra", [
    ("plot_rawdata", {}),
    ("plot_tx", {"file_begin_time_utc": datetime(2021, 11, 4, 2, 0, 2)}),
    ("plot_tx", {"v_min": 0.0, "v_max": 1.0}),
])
def test_host_waterfalls_match_jax(name, extra):
    trace, time, dist = _block(1)
    jf = _j(getattr(jviz, name), trace, time, dist, show=False, **extra)
    tf = getattr(tviz, name)(torch.from_numpy(trace), time, dist, show=False, **extra)
    _same_figure(jf, tf)


def test_snr_matrix_and_spectrogram_match_jax():
    trace, time, dist = _block(2)
    snr = np.abs(trace) * 1e9
    jf = _j(jviz.snr_matrix, snr, time, dist, vmax=30, title="HF",
            file_begin_time_utc=datetime(2021, 1, 1), show=False)
    tf = tviz.snr_matrix(torch.from_numpy(snr), time, dist, vmax=30, title="HF",
                         file_begin_time_utc=datetime(2021, 1, 1), show=False)
    _same_figure(jf, tf)
    p = np.random.default_rng(0).standard_normal((64, 40))
    jf = _j(jviz.plot_spectrogram, p, np.arange(40), np.arange(64), f_min=10, f_max=35,
            show=False)
    tf = tviz.plot_spectrogram(torch.from_numpy(p), np.arange(40), np.arange(64), f_min=10,
                               f_max=35, show=False)
    _same_figure(jf, tf)


def test_plot_3calls_and_eval_curves_match_jax():
    trace, time, _ = _block(3)
    _same_figure(_j(jviz.plot.plot_3calls, trace[0], time, 0.1, 0.5, 1.0, show=False),
                 tviz.plot_3calls(trace[0], time, 0.1, 0.5, 1.0, show=False))
    rows = [{"amplitude": a, "snr_db": 10 * a, "HF": {"recall": a / 2, "precision": 1 - a / 4},
             "LF": {"recall": a / 3, "precision": float("nan")}} for a in (0.1, 0.5, 1.0)]
    _same_figure(_j(jviz.plot.plot_eval_curves, rows, show=False),
                 tviz.plot.plot_eval_curves(rows, show=False))


@pytest.mark.parametrize("nfft, win_s", [(256, 2), (128, 0.75)])
def test_plot_fx_matches_jax(nfft, win_s):
    trace, _, dist = _block(4)
    jf = _j(jviz.plot_fx, trace, dist, FS, nfft=nfft, win_s=win_s, show=False)
    tf = tviz.plot_fx(trace, dist, FS, nfft=nfft, win_s=win_s, show=False, device="cpu")
    _same_figure(jf, tf, fft_images=True)


def test_detection_panels_match_jax():
    trace, time, dist = _block(5)
    picks = (np.array([1, 5, 9]), np.array([40, 120, 300]))
    picks2 = (np.array([2, 3]), np.array([10, 390]))
    sel = [4, 4 + 2 * NX, 2]
    cases = [
        ("detection_mf", (trace, picks, picks2, time, dist, FS, DX, sel)),
        ("detection_spectcorr", (trace, picks, picks2, time, dist, 50.0, DX, sel)),
        ("detection_grad", (trace, picks, time, dist, FS, DX, sel)),
    ]
    for name, args in cases:
        jf = _j(getattr(jviz, name), *args, file_begin_time_utc=datetime(2021, 1, 1),
                show=False)
        targs = (torch.from_numpy(trace),) + args[1:]
        tf = getattr(tviz, name)(*targs, file_begin_time_utc=datetime(2021, 1, 1), show=False,
                                 device="cpu")
        _same_figure(jf, tf, fft_images=True)


def test_correlogram_panels_match_jax():
    trace, time, dist = _block(6)
    other = _block(7)[0]
    _same_figure(_j(jviz.plot_cross_correlogram, trace, time, dist, maxv=1e-9, show=False),
                 tviz.plot_cross_correlogram(trace, time, dist, maxv=1e-9, show=False,
                                             device="cpu"), fft_images=True)
    _same_figure(_j(jviz.plot_cross_correlogramHL, trace, other, time, dist, maxv=1e-9,
                    show=False),
                 tviz.plot_cross_correlogramHL(trace, other, time, dist, maxv=1e-9,
                                               show=False, device="cpu"), fft_images=True)


def test_design_mf_matches_jax():
    from das4whales_tpu_torch.models.templates import gen_template_fincall

    time = np.arange(NS) / FS
    rng = np.random.default_rng(8)
    hf = np.asarray(gen_template_fincall(time, FS, 17.8, 28.8, 0.68))
    lf = np.asarray(gen_template_fincall(time, FS, 14.7, 21.8, 0.78))
    trace = (np.cos(2 * np.pi * 22.0 * time) + np.roll(hf, 60) * 3
             + 0.01 * rng.standard_normal(NS)).astype(np.float32)
    jf = _j(jviz.design_mf, trace, hf, lf, 0.3, 0.9, time, FS, show=False)
    tf = tviz.design_mf(torch.from_numpy(trace), hf, lf, 0.3, 0.9, time, FS, show=False,
                        device="cpu")
    # the dummy channel the panels build (numpy), for the phase floor and
    # the largest unwrapped phase
    dummy = np.zeros_like(hf)
    dummy[60:] = hf[: hf.size - 60]
    dummy[180:] = lf[: lf.size - 180]
    analytic = {k: np.fft.ifft(np.fft.fft(x) * np.where(np.arange(NS) < NS // 2, 2.0, 0.0))
                for k, x in ((0, trace.astype(np.float64)), (1, dummy))}

    def fft_lines(ax, k):
        if ax.get_ylabel() != "Instantaneous frequency [Hz]":
            return None
        a = np.abs(analytic[k])
        phase = np.max(np.abs(np.unwrap(np.angle(analytic[k]))))
        atol = IF_ULPS * float(np.spacing(np.float32(phase))) * FS / (2 * np.pi)
        return np.minimum(a[1:], a[:-1]) > PHASE_FLOOR * a.max(), atol

    _same_figure(jf, tf, fft_lines=fft_lines)


def test_detection_learned_matches_jax():
    rng = np.random.default_rng(9)
    scores = rng.uniform(size=(NX, 30)).astype(np.float32)
    centers = np.arange(30) * 32 + 64
    picks = np.asarray([[1, 4, 9], [64, 320, 960]])
    dist = np.arange(NX) * DX
    _same_figure(_j(jviz.plot.detection_learned, scores, centers, picks, FS, dist,
                    threshold=0.5, show=False),
                 tviz.plot.detection_learned(torch.from_numpy(scores), centers,
                                             torch.from_numpy(picks), FS, dist,
                                             threshold=0.5, show=False))


def test_campaign_density_matches_jax():
    rng = np.random.default_rng(10)
    summary = {"density": {"HF": rng.integers(0, 5, (3, 40)), "LF": rng.integers(0, 3, (3, 40))},
               "total_picks": {"HF": 17, "LF": 9}}
    _same_figure(jcampaign.plot_campaign_density(summary),
                 tcampaign.plot_campaign_density(summary))


def _grd(path, ny=12, nx=20, nan_border=False):
    from scipy.io import netcdf_file

    z = np.linspace(-2800, 150, ny * nx).astype(np.float64)
    if nan_border:
        z = z.reshape(ny, nx)
        z[0, :] = np.nan
        z[:, -1] = np.nan
        z = z.ravel()
    with netcdf_file(str(path), "w") as ds:
        ds.createDimension("side", 2)
        ds.createDimension("xysize", ny * nx)
        xr = ds.createVariable("x_range", "d", ("side",))
        xr[:] = [-126.0, -124.0]
        yr = ds.createVariable("y_range", "d", ("side",))
        yr[:] = [44.0, 45.0]
        dim = ds.createVariable("dimension", "i", ("side",))
        dim[:] = [nx, ny]
        zv = ds.createVariable("z", "d", ("xysize",))
        zv[:] = z
    return str(path)


@pytest.mark.parametrize("nan_border", [False, True])
def test_bathymetry_matches_jax(tmp_path, nan_border):
    path = _grd(tmp_path / "b.grd", nan_border=nan_border)
    for a, b in zip(jviz.load_bathymetry(path), tviz.load_bathymetry(path)):
        np.testing.assert_array_equal(b, a)
    bathy = tviz.load_bathymetry(path)[0]
    np.testing.assert_array_equal(tviz.map.flatten_bathy(bathy, 0.0),
                                  jviz.map.flatten_bathy(bathy, 0.0))
    assert tviz.latlon_to_utm is tviz.map.latlon_to_utm
    e, n = tviz.latlon_to_utm(np.array([-125.3, -124.8]), np.array([44.3, 44.6]))
    je, jn = jviz.latlon_to_utm(np.array([-125.3, -124.8]), np.array([44.3, 44.6]))
    np.testing.assert_array_equal(e, je)
    np.testing.assert_array_equal(n, jn)


def _cables(tmp_path):
    rows = []
    for name, lat0 in (("north", 44.2), ("south", 44.6)):
        path = tmp_path / f"{name}.csv"
        np.savetxt(path, np.column_stack([np.arange(6), np.linspace(lat0, lat0 + 0.3, 6),
                                          np.linspace(-125.8, -124.4, 6),
                                          -np.linspace(100, 600, 6)]), delimiter=",")
        rows.append(str(path))
    return rows


def test_cable_maps_match_jax(tmp_path):
    grd = _grd(tmp_path / "b.grd")
    bathy, xlon, ylat = tviz.load_bathymetry(grd)
    north, south = _cables(tmp_path)
    tn, ts = (tviz.load_cable_coordinates(p, 2.0) for p in (north, south))
    jn, js = (jviz.load_cable_coordinates(p, 2.0) for p in (north, south))
    for t, j in ((tn, jn), (ts, js)):
        for col in ("chan_idx", "lat", "lon", "depth", "chan_m"):
            # pandas' default float parser is not correctly rounded: 1 ulp
            # (tests/test_torch_annotations_coords.py holds the exact parse)
            np.testing.assert_array_max_ulp(t[col].astype(np.float64),
                                            j[col].to_numpy().astype(np.float64), maxulp=1)
    # the figures on the same columns: the port's mapping, JAX's DataFrame
    jn, js = (pd.DataFrame(dict(t)) for t in (tn, ts))
    _same_figure(_j(jviz.map.plot_cables2D, jn, js, bathy, xlon, ylat, show=False),
                 tviz.map.plot_cables2D(tn, ts, bathy, xlon, ylat, show=False))
    xy = (np.linspace(0, 1e5, 6), np.linspace(0, 5e4, 6))
    _same_figure(_j(jviz.map.plot_cables2D, xy, xy, bathy, xlon, ylat, show=False),
                 tviz.map.plot_cables2D(xy, xy, bathy, xlon, ylat, show=False))
    for name in ("plot_cables3D", "plot_cables3D_m"):
        if name == "plot_cables3D_m":
            for t, j in ((tn, jn), (ts, js)):
                x, y = tviz.latlon_to_utm(t["lon"], t["lat"])
                t["x"], t["y"] = x, y
                j["x"], j["y"] = x, y
        jf = _j(getattr(jviz.map, name), jn, js, bathy, xlon, ylat, show=False)
        tf = getattr(tviz.map, name)(tn, ts, bathy, xlon, ylat, show=False)
        assert len(jf.axes) == len(tf.axes)
        for ja, ta in zip(jf.axes, tf.axes):
            assert _texts(ja) == _texts(ta)
            assert ja.get_zlabel() == ta.get_zlabel()
            for jl, tl in zip(ja.lines, ta.lines):
                for a, b in zip(jl.get_data_3d(), tl.get_data_3d()):
                    np.testing.assert_array_equal(b, a)

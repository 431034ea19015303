"""Port parity, host design half: das4whales_tpu_torch against das4whales_tpu.

The matched-filter design is host numpy on both sides (f-k mask, bandpass
gain, banded mask crop, template stack and statistics, threshold policy,
synthetic scenes), so the port must reproduce it to float rounding. The
JAX side runs under the suite's x64 mode here, where its chirps are
synthesized in float64 like the port's; in float32 mode JAX synthesizes
them in float32 (about 1e-5 off), which is why the detector tests carry
the JAX design across with ``convert.design_from_arrays``.
"""

from __future__ import annotations

import numpy as np
import pytest

from das4whales_tpu import config as jcfg
from das4whales_tpu.io import synth as jsynth
from das4whales_tpu.models import matched_filter as jmf
from das4whales_tpu.models import templates as jtpl
from das4whales_tpu.ops import filters as jfilters
from das4whales_tpu.ops import fk as jfk
from das4whales_tpu.ops import xcorr as jxcorr
from das4whales_tpu_torch import config as tcfg
from das4whales_tpu_torch import convert
from das4whales_tpu_torch.io import synth as tsynth
from das4whales_tpu_torch.models import matched_filter as tmf
from das4whales_tpu_torch.models import templates as ttpl
from das4whales_tpu_torch.ops import filters as tfilters
from das4whales_tpu_torch.ops import fk as tfk
from das4whales_tpu_torch.ops import xcorr as txcorr
from tests.torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-6
SHAPES = [(24, 900), (64, 3000), (33, 1001)]


def _meta(nx, ns):
    return jsynth.SyntheticScene(nx=nx, ns=ns).metadata


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, a.dtype, b.shape, b.dtype)
    np.testing.assert_allclose(b, a, rtol=rtol, atol=rtol * float(np.abs(a).max() or 1.0))


@pytest.mark.parametrize("shape", SHAPES)
def test_fk_mask_matches(shape):
    fk = jcfg.SCRIPT_FK
    args = (shape, [0, shape[0], 1], 2.042, 200.0)
    kw = dict(cs_min=fk.cs_min, cp_min=fk.cp_min, cp_max=fk.cp_max,
              cs_max=fk.cs_max, fmin=fk.fmin, fmax=fk.fmax)
    mj = jfk.hybrid_ninf_filter_design(*args, **kw)
    mt = tfk.hybrid_ninf_filter_design(*args, **kw)
    _close(mj, mt)
    assert np.abs(mt).max() > 0
    bj, loj, hij = jfk.banded_mask_half(mj.astype(np.float32))
    bt, lot, hit = tfk.banded_mask_half(mt.astype(np.float32))
    assert (loj, hij) == (lot, hit)
    _close(bj, bt)


@pytest.mark.parametrize("nfft", [900, 1001, 12000])
def test_bandpass_gain_matches(nfft):
    _close(jfilters.butter_zero_phase_gain(nfft, 200.0, (14.0, 30.0)),
           tfilters.butter_zero_phase_gain(nfft, 200.0, (14.0, 30.0)))


@pytest.mark.parametrize("n_time", [900, 3000, 100])
def test_templates_and_stats_match(n_time):
    bank_j = jtpl.TemplateBank(
        name="pair", entries=(("HF", jcfg.FIN_HF_NOTE),
                              ("lin", jcfg.CallTemplateConfig(14.0, 22.0, 0.9, method="linear"))),
    )
    bank_t = ttpl.TemplateBank(
        name="pair", entries=(("HF", tcfg.FIN_HF_NOTE),
                              ("lin", tcfg.CallTemplateConfig(14.0, 22.0, 0.9, method="linear"))),
    )
    tj = bank_j.compile(n_time, 200.0)
    tt = bank_t.compile(n_time, 200.0)
    _close(tj, tt)
    for a, b in zip(jxcorr.padded_template_stats(tj), txcorr.padded_template_stats(tt)):
        _close(a, b)
    np.testing.assert_array_equal(bank_j.threshold_factors(), bank_t.threshold_factors())
    assert bank_j.names == bank_t.names


def test_threshold_factors_and_banks():
    np.testing.assert_array_equal(
        np.asarray(jmf.reference_threshold_factors(3)), tmf.reference_threshold_factors(3))
    fin = ttpl.resolve_bank(None)
    assert ttpl.resolve_bank("fin") is fin
    assert fin.names == jtpl.FIN_BANK.names
    assert fin.threshold_scope == jtpl.FIN_BANK.threshold_scope == "global"
    np.testing.assert_array_equal(fin.threshold_factors(), jtpl.FIN_BANK.threshold_factors())
    custom = ttpl.resolve_bank({"a": tcfg.FIN_LF_NOTE})
    assert custom.threshold_scope == "global" and custom.names == ("a",)
    blue = ttpl.resolve_bank("blue")
    assert blue.names == jtpl.BLUE_BANK.names and blue.threshold_scope == "per_template"


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_design_matched_filter_matches(shape):
    meta = _meta(*shape)
    sel = [0, shape[0], 1]
    dj = jmf.design_matched_filter(shape, sel, meta)
    dt = tmf.design_matched_filter(shape, sel, tsynth.SyntheticScene(nx=shape[0], ns=shape[1]).metadata)
    for f in convert.DESIGN_FIELDS:
        a, b = getattr(dj, f), getattr(dt, f)
        if isinstance(a, np.ndarray):
            _close(a, b)
        else:
            assert tuple(np.atleast_1d(a)) == tuple(np.atleast_1d(b)), f


def test_design_from_arrays_round_trips_exactly():
    shape = (24, 900)
    dj = jmf.design_matched_filter(shape, [0, 24, 1], _meta(*shape),
                                   templates=jtpl.FIN_VARIANTS_BANK)
    dt = convert.design_from_arrays({f: getattr(dj, f) for f in convert.DESIGN_FIELDS})
    for f in convert.DESIGN_FIELDS:
        a, b = getattr(dj, f), getattr(dt, f)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, f
    assert dt.threshold_scope == "per_template"
    with pytest.raises(KeyError):
        convert.design_from_arrays({"fk_mask": dj.fk_mask})


def test_synthetic_scene_matches():
    calls_j = [jsynth.SyntheticCall(t0=1.2, x0_m=20.0, amplitude=2.0),
               jsynth.SyntheticCall(t0=2.0, x0_m=60.0, y0_m=30.0, fmin=14.7, fmax=21.8)]
    calls_t = [tsynth.SyntheticCall(t0=1.2, x0_m=20.0, amplitude=2.0),
               tsynth.SyntheticCall(t0=2.0, x0_m=60.0, y0_m=30.0, fmin=14.7, fmax=21.8)]
    sj = jsynth.SyntheticScene(nx=40, ns=900, seed=3, calls=calls_j)
    st = tsynth.SyntheticScene(nx=40, ns=900, seed=3, calls=calls_t)
    bj, bt = jsynth.synthesize_scene(sj), tsynth.synthesize_scene(st)
    np.testing.assert_array_equal(bj, bt)
    np.testing.assert_array_equal(jsynth.to_raw_counts(bj, sj.metadata),
                                  tsynth.to_raw_counts(bt, st.metadata))
    assert sj.metadata.scale_factor == st.metadata.scale_factor
    assert tcfg.as_metadata(sj.metadata) == st.metadata


def test_next_fast_len_matches():
    for n in list(range(1, 300)) + [12000, 12155, 23999, 22050]:
        assert jxcorr.next_fast_len(n) == txcorr.next_fast_len(n)


def test_channel_pad_is_not_in_the_slice():
    """channel_pad is in the port now: it designs as the JAX package
    does (the mask on the padded grid, ``fk_channels`` riding along)."""
    tmeta = tsynth.SyntheticScene(nx=24, ns=900).metadata
    for pad, want in (("auto", 24), (25, 25)):   # 24 is already 5-smooth
        dj = jmf.design_matched_filter((24, 900), [0, 24, 1], _meta(24, 900), channel_pad=pad)
        dt = tmf.design_matched_filter((24, 900), [0, 24, 1], tmeta, channel_pad=pad)
        assert dt.fk_channels == dj.fk_channels == want
        np.testing.assert_array_equal(dt.fk_mask, dj.fk_mask)

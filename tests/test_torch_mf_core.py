"""Port parity, the matched filter's reference entry points outside the
one-program detector: ``models.matched_filter.mf_filter_and_correlate``
(the untiled bandpass -> f-k -> correlograms core of
``main_mfdetect.py:53-80``), the ``mf_detect_picks_tiled_program`` name
and ``io.hello_world_das_package`` — das4whales_tpu_torch on the CPU
against das4whales_tpu (float32, x64 off) on JAX's own design.

Tolerances: ``trf_fk`` and the correlograms within 1e-5 of their max, the
untiled route's bound in ``tests/test_torch_full.py`` (pocketfft and
XLA's FFT round differently); thresholds rtol 1e-5 and picks equal up to
rounding knife edges (``utils.parity``), as ``tests/test_torch_detector.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from das4whales_tpu import io as jio
from das4whales_tpu.io.synth import SyntheticCall, SyntheticScene, synthesize_scene
from das4whales_tpu.models import matched_filter as jmf
from das4whales_tpu.ops import peaks as jpeaks
from das4whales_tpu_torch import convert
from das4whales_tpu_torch import io as tio
from das4whales_tpu_torch.models import matched_filter as tmf
from das4whales_tpu_torch.ops import peaks as tpeaks
from das4whales_tpu_torch.utils.parity import envelopes, unexplained_differences
from tests.torch_threads import one_torch_thread  # noqa: F401

REL = 1e-5
TILE = 8


def _block(nx, ns, seed):
    scene = SyntheticScene(nx=nx, ns=ns, noise_rms=0.05, seed=seed,
                           calls=[SyntheticCall(t0=1.2, x0_m=nx / 2 * 2.042, amplitude=2.0)])
    return scene, synthesize_scene(scene).astype(np.float32)


def _jax_det(scene, **kw):
    return jmf.MatchedFilterDetector(scene.metadata, [0, scene.nx, 1], (scene.nx, scene.ns),
                                     pick_mode="sparse", keep_correlograms=False,
                                     mf_engine="fft", fk_engine="fft", **kw)


def _close(a, b, what):
    scale = float(np.abs(b).max())
    err = float(np.abs(a - b).max())
    assert err <= REL * scale, f"{what}: max error {err:.3e} > {REL} * {scale:.3e}"


def test_mf_filter_and_correlate_matches_jax():
    """The same design arrays through both packages' untiled core:
    ``trf_fk`` and every template's correlogram within 1e-5 of its max;
    a channel-padded design is refused by both."""
    scene, x = _block(48, 3000, 4)
    with jax.enable_x64(False):
        jd = _jax_det(scene)
        d = jd.design
        jt, jc = jmf.mf_filter_and_correlate(jnp.asarray(x), jnp.asarray(d.fk_mask),
                                             jnp.asarray(d.bp_gain), jnp.asarray(d.templates),
                                             d.bp_padlen)
        jt, jc = np.array(jt), np.array(jc)
    tt, tc = tmf.mf_filter_and_correlate(torch.from_numpy(x), d.fk_mask,
                                         torch.from_numpy(np.array(d.bp_gain)),
                                         torch.from_numpy(np.array(d.templates)), d.bp_padlen)
    assert tt.dtype == torch.float32 and tuple(tc.shape) == jc.shape == (2, 48, 3000)
    _close(tt.numpy(), jt, "trf_fk")
    for i in range(jc.shape[0]):
        _close(tc[i].numpy(), jc[i], f"correlograms {d.template_names[i]}")
    with jax.enable_x64(False):
        padded = _jax_det(scene, channel_pad=60).design
        with pytest.raises(ValueError, match="channel-padded"):
            jmf.mf_filter_and_correlate(jnp.asarray(x), jnp.asarray(padded.fk_mask),
                                        jnp.asarray(padded.bp_gain),
                                        jnp.asarray(padded.templates), padded.bp_padlen)
    with pytest.raises(ValueError, match="channel-padded"):
        tmf.mf_filter_and_correlate(torch.from_numpy(x), padded.fk_mask,
                                    torch.from_numpy(np.array(padded.bp_gain)),
                                    torch.from_numpy(np.array(padded.templates)),
                                    padded.bp_padlen)


def _picks(chan, times, count):
    chan, times, count = (np.asarray(v) for v in (chan, times, count))
    return [np.stack([chan[t, :count[t]], times[t, :count[t]]]).astype(np.int64)
            for t in range(count.shape[0])]


def test_tiled_program_alias_matches_jax():
    """``mf_detect_picks_tiled_program`` is ``mf_detect_picks_program`` with
    ``tile`` required: bitwise the program at the same tile in the port,
    thresholds and picks as JAX's alias on the same design and block, and
    a non-positive or non-int tile refused by both before any work."""
    scene, x = _block(40, 900, 7)
    with jax.enable_x64(False):
        jd = _jax_det(scene, channel_tile=TILE)
        jd.detect_picks(x)
        nT = jd.design.templates.shape[0]
        cap = int(min(scene.nx * jd.max_peaks, jd.pick_pack_cap))
        jkw = dict(
            band_lo=jd._band_lo, band_hi=jd._band_hi, bp_padlen=jd.design.bp_padlen,
            pad_rows=jd.fk_pad_rows, staged_bp=jd._program_staged_bp, max_peaks=jd.pick_k0,
            capacity=cap, use_threshold=False,
            pick_method=jpeaks.escalation_method(jd.pick_k0, jd.max_peaks),
            condition=False, cond_scale=jd._cond_scale, cond_n_real=None,
            with_health=False, health_clip=None, pick_engine=jd.pick_engine,
            mf_engine=jd.mf_engine, fk_engine=jd.fk_engine, fk_dft=jd._fk_dft_dev,
            thr_factors=jd._thr_factors_dev, thr_scope=jd.threshold_scope,
            mf_fused=jd._mf_fused_dev, fir_half=jd._mf_fir_half)
        jargs = (jnp.asarray(x), jd._program_mask_dev, jd._gain_dev, jd._templates_true,
                 jd._template_mu, jd._template_scale, jnp.zeros((nT,), jnp.float32))
        jchan, jtimes, jcnt, _jsat, jthr = (np.array(v) for v in jmf.mf_detect_picks_tiled_program(
            *jargs, tile=TILE, **jkw))
        for bad in (0, -4, None, 8.0):
            with pytest.raises(ValueError, match="positive int tile"):
                jmf.mf_detect_picks_tiled_program(*jargs, tile=bad, **jkw)
    td = tmf.MatchedFilterDetector.from_design(
        convert.design_from_arrays({f: getattr(jd.design, f) for f in convert.DESIGN_FIELDS}),
        scene.metadata, channel_tile=TILE, device="cpu")
    mask, staged_bp, engine_kw = td._program_inputs()
    targs = (torch.from_numpy(x), mask, td._bp_gain, td._templates_true, td._template_mu,
             td._template_scale, torch.zeros((nT,), dtype=torch.float32), td._thr_factors)
    tkw = dict(band_lo=td._band_lo, band_hi=td._band_hi, bp_padlen=td.design.bp_padlen,
               staged_bp=staged_bp, pad_rows=td.fk_pad_rows, max_peaks=td.pick_k0,
               capacity=cap, use_threshold=False,
               pick_method=tpeaks.escalation_method(td.pick_k0, td.max_peaks),
               thr_scope=td.threshold_scope, **engine_kw)
    alias = tmf.mf_detect_picks_tiled_program(*targs, tile=TILE, **tkw)
    prog = tmf.mf_detect_picks_program(*targs, tile=TILE, **tkw)
    for a, b in zip(alias[:5], prog[:5]):
        assert torch.equal(a, b)
    for bad in (0, -4, None, 8.0):
        with pytest.raises(ValueError, match="positive int tile"):
            tmf.mf_detect_picks_tiled_program(*targs, tile=bad, **tkw)
    thr = alias.thr.numpy()
    np.testing.assert_allclose(thr, jthr, rtol=1e-5)
    env = envelopes(td, x)
    n = 0
    for i, (a, b) in enumerate(zip(_picks(jchan, jtimes, jcnt),
                                   _picks(alias.chan, alias.times, alias.count))):
        bad = unexplained_differences(a, b, env[i], float(thr[i]))
        assert not bad, f"template {i}: picks differ beyond rounding at {bad[:10]}"
        n += b.shape[1]
    assert n > 0


def test_hello_world_matches_jax(capsys):
    jio.hello_world_das_package()
    want = capsys.readouterr().out
    tio.hello_world_das_package()
    assert capsys.readouterr().out == want and "Yepee!" in want

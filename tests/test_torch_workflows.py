"""Port parity, the workflow mains: ``workflows.mfdetect.main`` and
``workflows.spectrodetect.main`` of das4whales_tpu_torch
(``device="cpu"``) against das4whales_tpu's (float32, x64 off) on the
offline synthetic scene both write (``acquire(None)``, 512 x 12000).
On the CPU both packages resolve ``pick_mode="auto"`` to the host scipy
picker. Contract: thresholds to rtol 1e-5; ``trf_fk`` within 1e-5 of its
max; picks equal or differing only on rounding knife edges
(``utils.parity``, on the port's own correlograms' envelopes; the
spectro picks on its correlograms, in frames). The figure branches
(``outdir``/``show``) are held in ``tests/test_torch_mains.py``.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from das4whales_tpu.workflows import mfdetect as jmain_mf
from das4whales_tpu.workflows import spectrodetect as jmain_sp
from das4whales_tpu_torch.ops import spectral
from das4whales_tpu_torch.utils.parity import unexplained_differences
from das4whales_tpu_torch.utils.profiling import StageTimer
from das4whales_tpu_torch.workflows import mfdetect, spectrodetect
from tests.torch_threads import one_torch_thread  # noqa: F401


def _assert_picks(jpicks, tpicks, env_of, thr_of):
    total = 0
    for name, b in tpicks.items():
        a = np.asarray(jpicks[name])
        assert b.shape[0] == 2
        bad = unexplained_differences(a, b, env_of(name), thr_of(name))
        assert not bad, f"{name}: picks differ beyond rounding at {bad[:10]}"
        total += b.shape[1]
    assert total > 0


def test_mfdetect_main_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with jax.enable_x64(False):
        jr = jmain_mf.main(None)
        jtrf = np.array(jr["trf_fk"])
    tr = mfdetect.main(None, device="cpu")
    assert list(tr["picks"]) == list(jr["picks"]) == ["HF", "LF"]
    assert set(tr["snr"]) == {"HF", "LF"} and set(tr["correlograms"]) == {"HF", "LF"}
    assert set(tr["timings"]) == {"acquire", "design", "detect"} and tr["figures"] == {}
    trf = tr["trf_fk"].numpy()
    assert float(np.abs(trf - jtrf).max()) <= 1e-5 * float(np.abs(jtrf).max())
    for name in tr["picks"]:
        np.testing.assert_allclose(tr["thresholds"][name], jr["thresholds"][name], rtol=1e-5)
        assert torch.isfinite(tr["snr"][name]).any()
    _assert_picks(jr["picks"], tr["picks"],
                  lambda n: spectral.envelope_sqrt(tr["correlograms"][n]).numpy(),
                  lambda n: tr["thresholds"][n])


def test_spectrodetect_main_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with jax.enable_x64(False):
        jr = jmain_sp.main(None)
        jtrf = np.array(jr["trf_fk"])
    tr = spectrodetect.main(None, device="cpu")
    assert tr["spectro_fs"] == jr["spectro_fs"] and tr["figures"] == {}
    trf = tr["trf_fk"].numpy()
    assert float(np.abs(trf - jtrf).max()) <= 1e-5 * float(np.abs(jtrf).max())
    for name, c in tr["correlograms"].items():
        jc = np.asarray(jr["correlograms"][name])
        assert float(np.abs(c.numpy() - jc).max()) <= 1e-4 * float(np.abs(jc).max())
    _assert_picks(jr["picks"], tr["picks"], lambda n: tr["correlograms"][n].numpy(),
                  lambda n: 14.0)


def test_mains_take_the_card_by_default(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    monkeypatch.chdir(tmp_path)
    for main in (mfdetect.main, spectrodetect.main):
        with pytest.raises(RuntimeError, match="CUDA device"):
            main(None)


def test_stage_timer_accumulates_and_syncs():
    calls = []
    timer = StageTimer(sync=lambda: calls.append(1))
    for name in ("a", "b", "a"):
        with timer.stage(name):
            pass
    with pytest.raises(ValueError):
        with timer.stage("c"):
            raise ValueError("stage failed")
    assert timer.counts == {"a": 2, "b": 1, "c": 1} and len(calls) == 4
    assert set(timer.totals) == {"a", "b", "c"} and all(v >= 0 for v in timer.totals.values())
    assert len(timer.report().splitlines()) == 3
    assert StageTimer().sync is None

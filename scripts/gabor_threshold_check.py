#!/usr/bin/env python3
"""Do the Gabor detector's thresholds keep the synthetic scene's calls?

    JAX_PLATFORMS=cpu python scripts/gabor_threshold_check.py NX [T1/T2 ...]

Runs the JAX package (float32, on the CPU) on ``chip_smoke.py``'s scene
(``_scene(NX, 12000, n_calls=6, seed=2026)``: the canonical scene with
NX channels), conditioned on the host as the smoke run's ``gabor`` phase
conditions it, through the matched filter's bandpass + f-k prefilter and
``GaborDetector`` at ``main_gabordetect.py``'s settings, once at the
reference's thresholds 9100 / 150 and once at each extra ``T1/T2`` pair.
For each it prints the score's percentiles, the share of the binned mask
that is set, the pick counts and the injected calls that no note picks on
their nearest channel within 1 s (``chip_smoke._check_calls``). The
reference's thresholds were set on OOI data; this says whether they hold
on the synthetic scene, and which ones do where they do not. Keep NX well
below the canonical 22050 on a shared host: the JAX program's host memory
grows with it.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
import jax  # noqa: E402
from das4whales_tpu.io.synth import (SyntheticCall, SyntheticScene,  # noqa: E402
                                     synthesize_scene, to_raw_counts)
from das4whales_tpu.models.gabor import GaborDetector  # noqa: E402
from das4whales_tpu.models.matched_filter import MatchedFilterDetector  # noqa: E402


def main(argv) -> int:
    nx, ns = int(argv[0]), chip_smoke.CANONICAL[1]
    pairs = [chip_smoke.GABOR_THRESHOLDS] + [tuple(float(v) for v in a.split("/"))
                                             for a in argv[1:]]
    scene = chip_smoke._scene(nx, ns, n_calls=6, seed=chip_smoke.SEED)
    jscene = SyntheticScene(nx=nx, ns=ns, noise_rms=scene.noise_rms, seed=scene.seed,
                            calls=[SyntheticCall(**vars(c)) for c in scene.calls])
    meta = jscene.metadata
    cond = chip_smoke._condition_on_host(to_raw_counts(synthesize_scene(jscene), meta),
                                         meta.scale_factor)
    with jax.enable_x64(False):
        trf = MatchedFilterDetector(meta, [0, nx, 1], (nx, ns), mf_engine="fft",
                                    fk_engine="fft").filter_block(cond)
        for thr1, thr2 in pairs:
            res = GaborDetector(meta, [0, nx, 1], threshold1=thr1, threshold2=thr2)(trf)
            score = np.array(res["score"])
            picks = {k: np.array(v) for k, v in res["picks"].items()}
            misses = chip_smoke._check_calls(scene, picks)
            print(f"{nx}x{ns} thresholds {thr1:g} / {thr2:g}: score percentiles 50/90/99 "
                  f"{np.percentile(score, [50, 90, 99]).round(1).tolist()}, max "
                  f"{float(score.max()):.1f}; mask {100 * float(np.mean(res['mask'])):.2f} % "
                  f"set; picks {({k: int(v.shape[1]) for k, v in picks.items()})}; "
                  f"{len(scene.calls) - len(misses)} of {len(scene.calls)} calls picked"
                  + (f", missed {misses}" if misses else ""), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

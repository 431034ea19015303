"""das4whales_tpu_torch — the PyTorch/CUDA port of das4whales_tpu.

Four detector families run eagerly on torch tensors: the matched-filter
one-program path (raw-wire conditioning -> bandpass folded into the
banded f-k mask, or staged -> channel-tiled corrected correlograms ->
in-graph threshold -> Hilbert analytic signal -> fused pick kernel ->
row-major compaction), the spectrogram-correlation family (the same
prefilter -> per-chunk |STFT|^2 -> band slice -> hat-kernel correlation
-> adaptive-K picks), the Gabor/image family (the same prefilter -> the
t-x envelope as an image -> an oriented Gabor pair and two thresholds ->
a smoothed mask -> masked matched filters -> fused pick kernel) and the
learned family (|STFT| -> log-spectrogram windows -> a small CNN on
cuDNN -> threshold and NMS on the host; trainable with ``fit``).
Transforms go to ``torch.fft`` (cuFFT on the card);
the pick stage and the STFT are hand-written CUDA kernels for Hopper
(``csrc/fused_picks.cu``, ``csrc/fused_stft.cu``), built with ``nvcc`` at
first use. The batched ingest path feeds them: ``io.stream`` streams
OptaSense HDF5 or Silixa TDMS files into ``[B, C, T_bucket]`` slabs on
the card through pinned memory (``io.staging``), and
``parallel.batch.BatchedMatchedFilterDetector`` detects a slab with the
data-health stats (``ops.health``) in one packed read per attempt.
Around the detectors: the reference's DSP API (``ops.filters``,
``ops.fk``, ``ops.spectral``, ``ops.chunked``), TDOA localization in
float64 (``loc``), detection-quality evaluation and the detect ->
localize loop (``eval``), Raven tables and cable geometry
(``io.annotations``, ``io.coords``), and detection over a record joined
from consecutive files (``workflows.longrecord``). Module paths and names mirror ``das4whales_tpu`` so each counterpart is
easy to find. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper runs its plain PyTorch
version.

This package imports neither ``jax`` nor anything of ``das4whales_tpu``.
"""

__version__ = "0.1.0"

from . import config  # noqa: F401
from . import faults  # noqa: F401
from . import io  # noqa: F401
from . import loc  # noqa: F401
from . import ops  # noqa: F401
from . import models  # noqa: F401
from . import utils  # noqa: F401
from .config import AcquisitionMetadata, ChannelSelection  # noqa: F401


def __getattr__(name):
    # viz renders with matplotlib (not on every host) and the others pull
    # in the campaign and mesh machinery: each loads on first use, as in
    # the JAX package. No eager import builds a kernel.
    if name in ("viz", "parallel", "workflows", "eval", "service"):
        import importlib

        module = importlib.import_module(f".{name}", __name__)
        globals()[name] = module
        return module
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

"""das4whales_tpu_torch — the PyTorch/CUDA port of das4whales_tpu.

The matched-filter one-program path (raw-wire conditioning -> bandpass
folded into the banded f-k mask -> channel-tiled corrected correlograms
-> in-graph threshold -> Hilbert analytic signal -> fused pick kernel ->
row-major compaction) runs eagerly on torch tensors. Transforms go to
``torch.fft`` (cuFFT on the card); the pick stage is a hand-written CUDA
kernel for Hopper (``csrc/fused_picks.cu``), built with ``nvcc`` at first
use. Module paths and names mirror ``das4whales_tpu`` so each counterpart
is easy to find. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper runs its plain PyTorch
version.

This package imports neither ``jax`` nor anything of ``das4whales_tpu``.
"""

__version__ = "0.1.0"

from . import config  # noqa: F401
from .config import AcquisitionMetadata, ChannelSelection  # noqa: F401

"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device``. ``None`` means the card:
the port is written for an NVIDIA H100, and a run that silently landed
on the CPU would be mistaken for a card run. ``device="cpu"`` is the
explicit opt-in the tests use; there each kernel wrapper runs its plain
PyTorch version.

TF32 is off wherever the port runs. ``torch.backends.cuda.matmul.
allow_tf32`` already defaults to False, but ``torch.backends.cudnn.
allow_tf32`` defaults to True and would round float32 convolutions to
about three decimal digits; the port's parity contract with the JAX
package is float32, so both switches are set to False here, once, by
:func:`resolve_device`. (The STFT kernel's plain version is a float32
``torch.matmul``; on the card it must not round to TF32.)
"""

from __future__ import annotations

import torch


def disable_tf32() -> None:
    """Keep float32 matmuls and cuDNN convolutions in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises ``RuntimeError`` when a CUDA device is
    asked for and none is available. Never falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "das4whales_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run the plain PyTorch "
            "versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    disable_tf32()
    return dev

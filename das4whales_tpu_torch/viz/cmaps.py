"""Colormaps for DAS visualization (the port's copy of
``das4whales_tpu.viz.cmaps``; host numpy and scipy, the tables bitwise
the JAX package's).

The reference package embeds two 256-entry literal RGB tables — the
"roseus" perceptually-uniform colormap used for spectrograms (reference
plot.py:620-890) and MATLAB's "parula" (plot.py:893-1161). Rather than
carry a kilobyte-scale data table, we regenerate both maps from a small
set of RGB anchor points with a monotone cubic (PCHIP) interpolation in
each channel. The result is a smooth 256-entry table that is visually
equivalent to (but numerically distinct from) the embedded originals;
max per-channel deviation is a few percent, irrelevant for display.
``matplotlib`` is imported where a map is made, so the package imports
without it.
"""

from __future__ import annotations

import numpy as np
from scipy.interpolate import PchipInterpolator

# 13 anchor points (position in [0,1], sRGB) characterizing each ramp.
_ROSEUS_ANCHORS = [
    (0.0000, (0.005, 0.004, 0.004)),
    (0.0824, (0.005, 0.083, 0.133)),
    (0.1647, (0.036, 0.141, 0.329)),
    (0.2510, (0.217, 0.145, 0.525)),
    (0.3333, (0.412, 0.107, 0.627)),
    (0.4157, (0.599, 0.088, 0.615)),
    (0.5020, (0.765, 0.156, 0.517)),
    (0.5843, (0.885, 0.270, 0.398)),
    (0.6667, (0.962, 0.411, 0.298)),
    (0.7490, (0.987, 0.571, 0.283)),
    (0.8314, (0.961, 0.736, 0.430)),
    (0.9176, (0.922, 0.887, 0.719)),
    (1.0000, (0.998, 0.983, 0.977)),
]

_PARULA_ANCHORS = [
    (0.0000, (0.242, 0.150, 0.660)),
    (0.0824, (0.276, 0.238, 0.877)),
    (0.1647, (0.278, 0.353, 0.976)),
    (0.2510, (0.201, 0.480, 0.991)),
    (0.3333, (0.154, 0.590, 0.922)),
    (0.4157, (0.091, 0.683, 0.856)),
    (0.5020, (0.077, 0.747, 0.722)),
    (0.5843, (0.240, 0.790, 0.564)),
    (0.6667, (0.504, 0.799, 0.348)),
    (0.7490, (0.783, 0.758, 0.161)),
    (0.8314, (0.984, 0.733, 0.245)),
    (0.9176, (0.969, 0.859, 0.167)),
    (1.0000, (0.977, 0.984, 0.081)),
]


def _from_anchors(anchors, name: str, n: int = 256):
    from matplotlib.colors import ListedColormap

    pos = np.array([p for p, _ in anchors])
    rgb = np.array([c for _, c in anchors])
    x = np.linspace(0.0, 1.0, n)
    table = np.stack([PchipInterpolator(pos, rgb[:, c])(x) for c in range(3)], axis=1)
    return ListedColormap(np.clip(table, 0.0, 1.0), name=name)


def import_roseus():
    """Spectrogram colormap (reference plot.py:620-890), regenerated."""
    return _from_anchors(_ROSEUS_ANCHORS, "Roseus")


def import_parula():
    """MATLAB parula colormap (reference plot.py:893-1161), regenerated."""
    return _from_anchors(_PARULA_ANCHORS, "Parula")

"""Host-side visualization (the port's copy of ``das4whales_tpu.viz``):
t-x/f-x/spectrogram plots, detection overlays, bathymetry maps, and
colormaps (reference plot.py + map.py). The figures' device work runs on
the port's ops; ``matplotlib`` is imported only where a figure is made,
so this package imports without it."""

from . import cmaps, map, plot  # noqa: F401
from .cmaps import import_parula, import_roseus  # noqa: F401
from .plot import (  # noqa: F401
    design_mf,
    detection_grad,
    detection_mf,
    detection_spectcorr,
    plot_3calls,
    plot_cross_correlogram,
    plot_cross_correlogramHL,
    plot_fx,
    plot_rawdata,
    plot_spectrogram,
    plot_tx,
    snr_matrix,
)
from .map import latlon_to_utm, load_bathymetry, load_cable_coordinates  # noqa: F401

"""Shared workflow prologue and prefilter (the port's copy of
``das4whales_tpu.workflows.common``): download -> metadata -> channel
selection in meters -> load, with an offline synthetic scene when no
file is given, the bandpass + f-k prefilter every signal-processing
family shares, and the figure writer of the mains."""

from __future__ import annotations

import logging
import os
from typing import Sequence

from ..config import SELECTED_CHANNELS_M, ChannelSelection, as_metadata
from ..io import synth
from ..io.download import dl_file
from ..io.hdf5 import load_das_data
from ..io.interrogators import get_acquisition_parameters
from ..models.matched_filter import MatchedFilterDetector
from ..utils.log import get_logger, log_metadata  # noqa: F401 — the JAX module's names

log = logging.getLogger("das4whales_tpu_torch.workflows")


def default_scene(nx: int = 512, ns: int = 12000) -> synth.SyntheticScene:
    """A 60 s OOI-like scene with HF+LF fin-call pairs at three sites."""
    calls = []
    for k, x0 in enumerate((800.0, 2000.0, 3400.0)):
        t0 = 8.0 + 14.0 * k
        calls.append(synth.SyntheticCall(t0=t0, x0_m=x0, fmin=17.8, fmax=28.8,
                                         duration=0.68, amplitude=4.0))
        calls.append(synth.SyntheticCall(t0=t0 + 12.0, x0_m=x0, fmin=14.7, fmax=21.8,
                                         duration=0.78, amplitude=4.0))
    return synth.SyntheticScene(nx=nx, ns=ns, calls=calls, seed=42)


def channels_m_to_idx(selected_channels_m: Sequence[float], dx: float) -> list:
    """Meters -> channel indices, the caller-side convention of every
    reference script."""
    return [int(m // dx) for m in selected_channels_m]


def acquire(
    url: str | None = None,
    *,
    datadir: str = "data",
    interrogator: str = "optasense",
    selected_channels_m: Sequence[float] | None = None,
    scene: synth.SyntheticScene | None = None,
    dtype=None,
    device=None,
):
    """Resolve ``url`` (remote URL, local path, or None -> the synthetic
    scene written to ``datadir``), read metadata, and load the strided
    channel selection as strain onto ``device`` (``None``: the card). An
    OptaSense file loads with ``io.hdf5.load_das_data`` (``h5py``), a
    Silixa TDMS file (``interrogator="silixa"`` or a ``.tdms`` name)
    through the streams' TDMS reader, which needs no ``h5py``; the JAX
    package's ``acquire`` reads HDF5 only.

    Returns ``(block, metadata, selected_channels)`` where ``block`` is a
    :class:`~das4whales_tpu_torch.io.hdf5.StrainBlock`.
    """
    if url is None:
        scene = scene or default_scene()
        os.makedirs(datadir, exist_ok=True)
        filepath = os.path.join(datadir, "synthetic_ooi.h5")
        synth.write_synthetic_file(filepath, scene)
        log.info("synthesized offline scene at %s (%d calls)", filepath, len(scene.calls))
    elif url.startswith(("http://", "https://")):
        filepath = dl_file(url, datadir=datadir)
    else:
        filepath = url

    meta = as_metadata(get_acquisition_parameters(filepath, interrogator=interrogator))
    log.info("metadata: %s", meta)
    if selected_channels_m is None:
        # the canonical 20-65 km selection when it fits, else the whole array
        if meta.nx * meta.dx > SELECTED_CHANNELS_M[1]:
            selected_channels_m = SELECTED_CHANNELS_M
        else:
            selected_channels_m = (0.0, meta.nx * meta.dx, meta.dx)
    selected_channels = channels_m_to_idx(selected_channels_m, meta.dx)

    if filepath.lower().endswith(".tdms") or meta.interrogator == "silixa":
        # a Silixa TDMS file reads through the streams' TDMS reader (no h5py)
        from ..io.stream import stream_strain_blocks

        (block,) = list(stream_strain_blocks([filepath], selected_channels, meta,
                                             interrogator=interrogator, prefetch=1,
                                             device=device))
        if dtype is not None:
            block.trace = block.trace.to(dtype)
        return block, meta, selected_channels
    kwargs = {} if dtype is None else {"dtype": dtype}
    block = load_das_data(filepath, selected_channels, meta, device=device, **kwargs)
    return block, meta, selected_channels


def mf_prefilter(metadata, selected_channels, trace_shape=None, *,
                 fused_bandpass: bool = True, device=None) -> MatchedFilterDetector:
    """The bandpass + f-k front end of main_mfdetect / main_spectrodetect:
    a :class:`MatchedFilterDetector` whose ``filter_block`` is the
    prefilter. ``trace_shape=None`` derives the post-selection shape from
    the metadata."""
    meta = as_metadata(metadata)
    if trace_shape is None:
        sel = ChannelSelection.from_list(list(selected_channels))
        trace_shape = (sel.n_channels(meta.nx), meta.ns)
    return MatchedFilterDetector(meta, list(selected_channels), tuple(trace_shape),
                                 fused_bandpass=fused_bandpass, device=device)


def maybe_savefig(fig, outdir: str | None, name: str) -> str | None:
    """Write ``fig`` as ``outdir/name`` (80 dpi) and close it; None where
    there is no figure or no ``outdir``."""
    if fig is None or outdir is None:
        return None
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, name)
    fig.savefig(path, dpi=80)
    import matplotlib.pyplot as plt

    plt.close(fig)
    return path

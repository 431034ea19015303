"""OptaSense HDF5 ingest (the port's copy of ``das4whales_tpu.io.hdf5``).

The reference's ``data_handle.get_metadata_optasense``, ``load_das_data``
and ``raw2strain``, and a schema-faithful writer for offline fixtures.
The raw read stays on the host; a loaded block lands on the caller's
device (the card unless ``device="cpu"``) through pinned memory
(``io.staging``), and the demean + scale-to-strain runs there
(``ops.conditioning``), except on the native engine's conditioned wire,
whose C++ pass conditions while it reads. ``h5py`` is imported where a
file is opened, so the rest of the ingest path (TDMS, the streams)
imports without it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import datetime, timezone

import numpy as np
import torch

from ..config import AcquisitionMetadata, ChannelSelection, as_metadata
from ..ops import conditioning
from ..utils.device import resolve_device
from .staging import to_device
from .synth import optasense_scale_factor

__all__ = [
    "optasense_scale_factor", "get_metadata_optasense", "raw2strain", "StrainBlock",
    "load_das_data", "assemble_block", "write_optasense",
]


def get_metadata_optasense(filepath: str) -> AcquisitionMetadata:
    """Read acquisition parameters from an OptaSense HDF5 file."""
    import h5py

    if not os.path.exists(filepath):
        raise FileNotFoundError(f"File {filepath} not found")
    with h5py.File(filepath, "r") as fp:
        acq = fp["Acquisition"]
        raw = acq["Raw[0]"]
        fs = float(raw.attrs["OutputDataRate"])
        dx = float(acq.attrs["SpatialSamplingInterval"])
        ns = int(raw["RawDataTime"].attrs["Count"])
        n = float(acq["Custom"].attrs["Fibre Refractive Index"])
        gl = float(acq.attrs["GaugeLength"])
        nx = int(raw.attrs["NumberOfLoci"])
    return AcquisitionMetadata(
        fs=fs, dx=dx, nx=nx, ns=ns, n=n, gauge_length=gl,
        scale_factor=optasense_scale_factor(n, gl), interrogator="optasense",
    )


def raw2strain(trace: torch.Tensor, scale_factor: float) -> torch.Tensor:
    """Demean each channel and scale raw counts to strain, on the
    tensor's device, through ``ops.conditioning.condition``. Float inputs
    keep their dtype; integer counts condition to float32."""
    dtype = trace.dtype if trace.dtype.is_floating_point else torch.float32
    return conditioning.condition(trace, scale_factor, dtype=dtype)


@dataclass
class StrainBlock:
    """A loaded ``[channel x time]`` block with its axes.

    Iterable as ``(trace, tx, dist, t0_utc)``, the reference
    ``load_das_data`` return convention. ``trace`` is a tensor on the
    loader's device, or host numpy from the streams' ``as_numpy=True``.
    ``wire`` is ``"conditioned"`` (strain) or ``"raw"`` (stored-dtype
    counts, to be conditioned on the card). ``read_s`` and
    ``condition_s`` are the host seconds this block's read and host
    conditioning took in a stream (0.0 where not measured)."""

    trace: object
    tx: np.ndarray
    dist: np.ndarray
    t0_utc: datetime
    metadata: AcquisitionMetadata | None = None
    selection: ChannelSelection | None = None
    wire: str = "conditioned"
    read_s: float = 0.0
    condition_s: float = 0.0

    def __iter__(self):
        return iter((self.trace, self.tx, self.dist, self.t0_utc))


def load_das_data(
    filename: str,
    selected_channels,
    metadata,
    *,
    dtype=torch.float32,
    device=None,
    engine: str = "auto",
    wire: str = "conditioned",
) -> StrainBlock:
    """Load a strided channel selection as strain, with time/distance axes,
    onto ``device`` (``None``: the card).

    ``engine`` selects the bulk-read path: ``"native"`` the C++ ingest
    engine (threaded pread + fused conditioning, ``io.native``; raises
    where it cannot be built or the dataset is not contiguous),
    ``"h5py"`` the pure-Python path, ``"auto"`` native where available
    and the layout allows it.

    ``wire="raw"`` moves the stored-dtype counts to the device untouched
    and conditions there; the returned block is strain either way.
    """
    if not os.path.exists(filename):
        raise FileNotFoundError(f"File {filename} not found")
    meta = as_metadata(metadata)
    sel = ChannelSelection.from_list(selected_channels)
    if engine not in ("auto", "native", "h5py"):
        raise ValueError(f"unknown engine {engine!r}; expected 'auto', 'native', or 'h5py'")
    if wire not in ("conditioned", "raw"):
        raise ValueError(f"unknown wire {wire!r}; expected 'conditioned' or 'raw'")
    if engine == "native" and wire == "conditioned" and dtype != torch.float32:
        raise ValueError("engine='native' produces float32; pass dtype=torch.float32")
    import h5py

    dev = resolve_device(device)
    native_spec = None
    with h5py.File(filename, "r") as fp:
        raw = fp["Acquisition/Raw[0]/RawData"]
        t_us = int(fp["Acquisition/Raw[0]/RawDataTime"][0])
        if engine in ("auto", "native") and (wire == "raw" or dtype == torch.float32):
            from . import native as native_mod

            layout = native_mod.contiguous_layout(raw) if native_mod.available() else None
            if layout is not None:
                native_spec = (layout[0], layout[1], raw.shape[0], raw.shape[1])
            elif engine == "native":
                raise ValueError(
                    f"engine='native' but {filename} is not natively readable "
                    "(chunked/compressed dataset, unsupported dtype, or build failure)"
                )
        if native_spec is None:
            block = raw[sel.start : sel.stop : sel.step, :]

    if native_spec is not None:
        from . import native as native_mod

        offset, disk_dtype, nx_disk, ns_disk = native_spec
        args = (filename, offset, disk_dtype, nx_disk, ns_disk,
                sel.start, min(sel.stop, nx_disk), sel.step)
        if wire == "conditioned":
            # fused read + demean + scale in C++: the result is strain
            host = native_mod.read_strided(*args, fuse=True, scale=meta.scale_factor)
            return assemble_block(to_device(host, dev), meta, sel, t_us)
        block = native_mod.read_strided_raw(*args)
    if wire == "raw":
        # the stored dtype crosses to the device; conditioning runs there
        trace = conditioning.condition(to_device(block, dev), meta.scale_factor, dtype=dtype)
        return assemble_block(trace, meta, sel, t_us)
    host = np.asarray(block, dtype=str(dtype).replace("torch.", ""))
    return assemble_block(raw2strain(to_device(host, dev), meta.scale_factor), meta, sel, t_us)


def assemble_block(trace, metadata, sel: ChannelSelection, t0_us: int,
                   wire: str = "conditioned") -> StrainBlock:
    """Build a :class:`StrainBlock` (time/distance axes + UTC start) from a
    ``[channel x time]`` array; shared by the single-file loader and the
    streams (``io.stream``). ``wire`` records whether ``trace`` is
    conditioned strain or raw counts."""
    meta = as_metadata(metadata)
    nnx, nns = trace.shape
    tx = np.arange(nns) / meta.fs
    dist = (np.arange(nnx) * sel.step + sel.start) * meta.dx
    t0 = datetime.fromtimestamp(t0_us * 1e-6, tz=timezone.utc).replace(tzinfo=None)
    return StrainBlock(trace=trace, tx=tx, dist=dist, t0_utc=t0, metadata=meta,
                       selection=sel, wire=wire)


def write_optasense(
    filepath: str,
    raw_data: np.ndarray,
    fs: float,
    dx: float,
    gauge_length: float = 51.05,
    n: float = 1.4681,
    t0_us: int = 1_636_000_000_000_000,
    raw_dtype=np.int32,
) -> str:
    """Write a ``[channel x time]`` raw block in the OptaSense HDF5 schema
    the reader (and the reference) expects. ``raw_dtype`` sets the stored
    dtype (int32 by default, as deployments store it; float32 files
    exercise the float narrow-wire path)."""
    import h5py

    raw_data = np.asarray(raw_data)
    nx, ns = raw_data.shape
    with h5py.File(filepath, "w") as fp:
        acq = fp.create_group("Acquisition")
        acq.attrs["SpatialSamplingInterval"] = dx
        acq.attrs["GaugeLength"] = gauge_length
        custom = acq.create_group("Custom")
        custom.attrs["Fibre Refractive Index"] = n
        raw = acq.create_group("Raw[0]")
        raw.attrs["OutputDataRate"] = fs
        raw.attrs["NumberOfLoci"] = nx
        raw.create_dataset("RawData", data=raw_data.astype(raw_dtype, copy=False))
        times = (t0_us + np.arange(ns) * 1e6 / fs).astype(np.int64)
        dt = raw.create_dataset("RawDataTime", data=times)
        dt.attrs["Count"] = ns
    return filepath

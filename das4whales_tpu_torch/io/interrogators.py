"""Interrogator dispatch: acquisition metadata per vendor (the port's copy
of ``das4whales_tpu.io.interrogators``, host side).

Parity target: reference ``data_handle.get_acquisition_parameters``
(data_handle.py:26-68), which dispatches over
``['optasense', 'silixa', 'mars', 'alcatel']`` but only defines the first
two readers — calling the others raises ``NameError`` in the reference
(data_handle.py:59-63, a documented quirk in SURVEY.md §7). Here all four
names resolve: 'mars' and 'alcatel' are explicit informative stubs until a
public schema sample exists, and a generic schema-mapping reader covers
unknown HDF5 layouts.
"""

from __future__ import annotations

import os
import re

import numpy as np

from ..config import AcquisitionMetadata
from .hdf5 import get_metadata_optasense
from .tdms import TdmsFile

INTERROGATORS = ("optasense", "silixa", "mars", "alcatel")


def silixa_scale_factor(fs: float, gauge_length: float) -> float:
    """Raw counts -> strain for Silixa iDAS (data_handle.py:148)."""
    return (116 * fs * 1e-9) / (gauge_length * 2**13)


def get_metadata_silixa(filepath: str) -> AcquisitionMetadata:
    """Read acquisition parameters from a Silixa TDMS file
    (reference data_handle.py:113-154), via the native TDMS parser."""
    if not os.path.exists(filepath):
        raise FileNotFoundError(f"File {filepath} not found")
    f = TdmsFile.read(filepath)
    props = f.properties
    channels = f["Measurement"]
    data_lens = [len(v) for v in channels.values()]
    fs = float(props["SamplingFrequency[Hz]"])
    gl = float(props["GaugeLength"])
    return AcquisitionMetadata(
        fs=fs,
        dx=float(props["SpatialResolution[m]"]),
        nx=len(channels),
        ns=int(data_lens[0]) if data_lens else 0,
        n=float(props["FibreIndex"]),
        gauge_length=gl,
        scale_factor=silixa_scale_factor(fs, gl),
        interrogator="silixa",
    )


def _natural_key(name: str):
    """Sort key ordering embedded integers numerically ("ch2" < "ch10",
    regardless of zero padding), with lexicographic tie-breaking on the
    non-digit runs. This is the channel order a fiber layout means by its
    names; plain string sort would interleave ch1/ch10/ch2."""
    # tag each run so int/str never compare directly (TypeError otherwise
    # for names with different digit/text structure)
    return tuple(
        (0, int(part), "") if part.isdigit() else (1, 0, part)
        for part in re.split(r"(\d+)", name)
        if part != ""
    )


def load_silixa_data(filepath: str) -> np.ndarray:
    """Load the full ``[channel x time]`` raw block from a Silixa TDMS file
    (the reference materializes this inside get_metadata_silixa,
    data_handle.py:140), channels in natural (numeric-aware) name order."""
    f = TdmsFile.read(filepath)
    channels = f["Measurement"]
    return np.stack([channels[c] for c in sorted(channels, key=_natural_key)])


def get_metadata_mars(filepath: str) -> AcquisitionMetadata:
    """MARS observatory DAS metadata — declared by the reference but never
    implemented (data_handle.py:59-60 would raise NameError). Stub until a
    public schema sample exists; use ``get_metadata_generic`` with an
    explicit schema mapping in the meantime."""
    raise NotImplementedError(
        "The 'mars' interrogator schema is not published; pass interrogator="
        "'optasense' if the file follows the OptaSense layout, or use "
        "get_metadata_generic(filepath, schema=...)."
    )


def get_metadata_alcatel(filepath: str) -> AcquisitionMetadata:
    """ASN/Alcatel OptoDAS metadata — declared by the reference but never
    implemented (data_handle.py:62-63 would raise NameError)."""
    raise NotImplementedError(
        "The 'alcatel' (ASN OptoDAS) schema is not published; use "
        "get_metadata_generic(filepath, schema=...) with the file's HDF5 paths."
    )


def get_metadata_generic(filepath: str, schema: dict) -> AcquisitionMetadata:
    """Read metadata from an arbitrary HDF5 layout via a schema mapping.

    ``schema`` maps metadata fields to ``(hdf5_object_path, attr_name)``
    pairs (attr) or plain dataset paths (value), e.g.::

        schema = {
            "fs": ("Acquisition/Raw[0]", "OutputDataRate"),
            "dx": ("Acquisition", "SpatialSamplingInterval"),
            ...
            "scale_factor": 1e-9,        # literals allowed
        }
    """
    import h5py

    if not os.path.exists(filepath):
        raise FileNotFoundError(f"File {filepath} not found")
    out = {}
    with h5py.File(filepath, "r") as fp:
        for key, spec in schema.items():
            if isinstance(spec, tuple):
                obj, attr = spec
                out[key] = np.asarray(fp[obj].attrs[attr]).item()
            elif isinstance(spec, str):
                out[key] = np.asarray(fp[spec]).item()
            else:
                out[key] = spec
    return AcquisitionMetadata(
        fs=float(out["fs"]), dx=float(out["dx"]), nx=int(out["nx"]), ns=int(out["ns"]),
        n=float(out.get("n", 1.4681)), gauge_length=float(out.get("GL", 51.0)),
        scale_factor=float(out.get("scale_factor", 1.0)), interrogator="generic",
    )


def get_acquisition_parameters(filepath: str, interrogator: str = "optasense") -> AcquisitionMetadata:
    """Dispatch metadata reading by interrogator name
    (reference data_handle.py:26-68)."""
    if interrogator not in INTERROGATORS:
        raise ValueError("Interrogator name incorrect")
    reader = {
        "optasense": get_metadata_optasense,
        "silixa": get_metadata_silixa,
        "mars": get_metadata_mars,
        "alcatel": get_metadata_alcatel,
    }[interrogator]
    return reader(filepath)

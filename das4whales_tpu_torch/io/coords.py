"""Cable geometry ingest (host numpy; the port of
``das4whales_tpu.io.coords``).

The CSV parse needs no pandas: :func:`load_cable_coordinates` returns a
mapping of numpy columns ``chan_idx lat lon depth chan_m``, and
:func:`cable_positions_xyz` takes that mapping or a pandas DataFrame
(anything indexable by column name). The WGS84 -> UTM projection is the
port's own copy of the JAX package's ``viz.map.latlon_to_utm`` (the JAX
``cable_positions_xyz`` imports it from a module that does not exist, so
it raises on every call; this one projects).
"""

from __future__ import annotations

import csv
from typing import Dict

import numpy as np

#: WGS84 ellipsoid and the UTM scale factor.
_A = 6378137.0
_F = 1.0 / 298.257223563
_E2 = _F * (2.0 - _F)
_EP2 = _E2 / (1.0 - _E2)
_K0 = 0.9996

COLUMNS = ("chan_idx", "lat", "lon", "depth")


def _column(tokens) -> np.ndarray:
    """One CSV column as int64 when every cell is an integer literal,
    else float64 (pandas' inference for numeric columns)."""
    try:
        return np.asarray([int(t) for t in tokens], dtype=np.int64)
    except ValueError:
        return np.asarray([float(t) for t in tokens], dtype=np.float64)


def load_cable_coordinates(filepath: str, dx: float) -> Dict[str, np.ndarray]:
    """A headerless CSV of ``chan_idx, lat, lon, depth`` rows -> ``{column:
    numpy array}`` with the along-cable position ``chan_m = chan_idx *
    dx`` added."""
    with open(filepath, newline="") as fh:
        rows = [[cell.strip() for cell in row] for row in csv.reader(fh) if row]
    if any(len(r) != len(COLUMNS) for r in rows):
        raise ValueError(f"{filepath}: expected {len(COLUMNS)} columns "
                         f"({', '.join(COLUMNS)}) on every row")
    cols = {name: _column([r[i] for r in rows]) for i, name in enumerate(COLUMNS)}
    cols["chan_m"] = cols["chan_idx"] * dx
    return cols


def latlon_to_utm(lon, lat, zone: int = 10, northern: bool = True):
    """WGS84 lon/lat -> UTM easting/northing in ``zone`` (the
    transverse-Mercator series of Snyder 1987, eqs. 3-21 and 8-9..8-13),
    over scalars or arrays."""
    lon = np.asarray(lon, dtype=np.float64)
    lat = np.asarray(lat, dtype=np.float64)
    phi = np.radians(lat)
    lam = np.radians(lon)
    lam0 = np.radians(zone * 6.0 - 183.0)

    sin_phi = np.sin(phi)
    cos_phi = np.cos(phi)
    n_rad = _A / np.sqrt(1.0 - _E2 * sin_phi**2)
    t = np.tan(phi) ** 2
    c = _EP2 * cos_phi**2
    a_term = cos_phi * (lam - lam0)

    e4 = _E2 * _E2
    e6 = e4 * _E2
    m = _A * (
        (1 - _E2 / 4 - 3 * e4 / 64 - 5 * e6 / 256) * phi
        - (3 * _E2 / 8 + 3 * e4 / 32 + 45 * e6 / 1024) * np.sin(2 * phi)
        + (15 * e4 / 256 + 45 * e6 / 1024) * np.sin(4 * phi)
        - (35 * e6 / 3072) * np.sin(6 * phi)
    )

    easting = (
        _K0 * n_rad * (
            a_term
            + (1 - t + c) * a_term**3 / 6
            + (5 - 18 * t + t**2 + 72 * c - 58 * _EP2) * a_term**5 / 120
        )
        + 500000.0
    )
    northing = _K0 * (
        m
        + n_rad * np.tan(phi) * (
            a_term**2 / 2
            + (5 - t + 9 * c + 4 * c**2) * a_term**4 / 24
            + (61 - 58 * t + t**2 + 600 * c - 330 * _EP2) * a_term**6 / 720
        )
    )
    if not northern:
        northing = northing + 10000000.0
    return easting, northing


def cable_positions_xyz(coords, utm_zone: int = 10) -> np.ndarray:
    """Cable coordinates (the mapping of :func:`load_cable_coordinates` or
    a DataFrame with ``lat``, ``lon`` and ``depth`` columns) as a
    ``[channel x 3]`` UTM (x, y, depth) array, the localizer's geometry."""
    x, y = latlon_to_utm(np.asarray(coords["lon"]), np.asarray(coords["lat"]), zone=utm_zone)
    return np.stack([x, y, np.asarray(coords["depth"])], axis=1)

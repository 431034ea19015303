"""Port parity, host I/O: ``io.annotations`` (Raven selection tables) and
``io.coords`` (cable geometry) of the port against the JAX package's.

Tolerances: the selection tables are byte for byte the JAX package's and
read back to the same picks. The coordinate columns are parsed by
Python's correctly rounded ``float``: bitwise pandas' round-trip parser,
within 1 ulp of JAX's (pandas' default C parser is not correctly
rounded). The UTM projection is bitwise JAX's ``viz.map`` on the same
columns (the same float64 series).

The JAX package's ``io.coords.cable_positions_xyz`` imports
``..plot.geo``, a module that does not exist, so it raises
``ModuleNotFoundError`` on every call (a reference fault the port does
not reproduce, ROADMAP §3); the port is held against JAX's own
``viz.map.latlon_to_utm`` applied to the same CSV.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import pytest

from das4whales_tpu.io import annotations as jann
from das4whales_tpu.io import coords as jcoords
from das4whales_tpu.viz.map import latlon_to_utm as jlatlon_to_utm
from das4whales_tpu_torch.config import FIN_HF_NOTE, FIN_LF_NOTE
from das4whales_tpu_torch.io import annotations as tann
from das4whales_tpu_torch.io import coords as tcoords

FS = 200.0


def _picks(seed=0, n=(12, 5)):
    rng = np.random.default_rng(seed)
    return {name: np.stack([rng.integers(0, 64, k), rng.integers(0, 12000, k)])
            for name, k in zip(("HF", "LF", "X"), (*n, 3))}


@pytest.mark.parametrize("offset,cfgs", [(0.0, True), (1234.5, True), (0.0, False)])
def test_selection_table_bytes_match_jax(tmp_path, offset, cfgs):
    picks = _picks()
    configs = {"HF": FIN_HF_NOTE, "LF": FIN_LF_NOTE} if cfgs else None
    a = tann.to_raven_selection_table(str(tmp_path / "t.txt"), picks, FS,
                                      template_configs=configs, t_offset_s=offset)
    b = jann.to_raven_selection_table(str(tmp_path / "j.txt"), picks, FS,
                                      template_configs=configs, t_offset_s=offset)
    assert open(a, "rb").read() == open(b, "rb").read()
    got, want = tann.from_raven_selection_table(a, FS), jann.from_raven_selection_table(b, FS)
    assert set(got) == set(want) == set(picks)
    for name in got:
        assert got[name].dtype == np.int64
        np.testing.assert_array_equal(got[name], want[name])


def test_selection_table_reader_matches_jax_on_raven_variants(tmp_path):
    """A table from Raven itself (no extension columns, its own header
    spacing and capitalisation) and rows with unparseable cells."""
    path = tmp_path / "raven.txt"
    path.write_text("Selection\tView\tChannel\tbegin  time (S)\tEnd Time (s)\n"
                    "1\tSpectrogram 1\t1\t1.000\t2.000\n"
                    "2\tSpectrogram 1\t1\t\t3.000\n"
                    "3\tSpectrogram 1\t1\t4.5\t4.5\n")
    ts, js = [], []
    got = tann.from_raven_selection_table(str(path), FS, skipped=ts)
    want = jann.from_raven_selection_table(str(path), FS, skipped=js)
    assert ts == js and len(ts) == 1
    assert set(got) == set(want) == {"SELECTION"}
    np.testing.assert_array_equal(got["SELECTION"], want["SELECTION"])
    with pytest.warns(UserWarning, match="skipped"):
        tann.from_raven_selection_table(str(path), FS)
    bad = tmp_path / "bad.txt"
    bad.write_text("a\tb\n1\t2\n")
    with pytest.raises(ValueError, match="Begin Time"):
        tann.from_raven_selection_table(str(bad), FS)


def _csv(tmp_path, depth_int=False):
    rng = np.random.default_rng(3)
    n = 40
    lat = 44.6 + np.cumsum(rng.uniform(0, 1e-3, n))
    lon = -124.9 + np.cumsum(rng.uniform(0, 1e-3, n))
    depth = -np.round(rng.uniform(80, 600, n)) if depth_int else -rng.uniform(80, 600, n)
    path = tmp_path / "cable.csv"
    with open(path, "w") as fh:
        for i in range(n):
            d = f"{int(depth[i])}" if depth_int else repr(float(depth[i]))
            fh.write(f"{i * 3},{float(lat[i])!r},{float(lon[i])!r},{d}\n")
    return str(path)


@pytest.mark.parametrize("depth_int", [False, True])
def test_load_cable_coordinates_matches_jax(tmp_path, depth_int):
    path = _csv(tmp_path, depth_int)
    got = tcoords.load_cable_coordinates(path, 2.042)
    want = jcoords.load_cable_coordinates(path, 2.042)
    exact = pd.read_csv(path, delimiter=",", header=None, float_precision="round_trip")
    exact.columns = ["chan_idx", "lat", "lon", "depth"]
    exact["chan_m"] = exact["chan_idx"] * 2.042
    assert list(got) == list(want.columns) == ["chan_idx", "lat", "lon", "depth", "chan_m"]
    for col in got:
        assert got[col].dtype == want[col].to_numpy().dtype, col
        np.testing.assert_array_equal(got[col], exact[col].to_numpy())
        np.testing.assert_array_max_ulp(got[col].astype(np.float64),
                                        want[col].to_numpy().astype(np.float64), maxulp=1)


def test_jax_cable_positions_xyz_raises(tmp_path):
    df = jcoords.load_cable_coordinates(_csv(tmp_path), 2.042)
    with pytest.raises(ModuleNotFoundError):
        jcoords.cable_positions_xyz(df)


@pytest.mark.parametrize("zone,northern", [(10, True), (9, True), (10, False)])
def test_cable_positions_xyz_is_jax_latlon_to_utm(tmp_path, zone, northern):
    path = _csv(tmp_path)
    for coords in (tcoords.load_cable_coordinates(path, 2.042),
                   jcoords.load_cable_coordinates(path, 2.042)):
        lon, lat = np.asarray(coords["lon"]), np.asarray(coords["lat"])
        x, y = jlatlon_to_utm(lon, lat, zone=zone, northern=northern)
        tx, ty = tcoords.latlon_to_utm(lon, lat, zone=zone, northern=northern)
        np.testing.assert_array_equal(tx, x)
        np.testing.assert_array_equal(ty, y)
        if northern:
            got = tcoords.cable_positions_xyz(coords, utm_zone=zone)
            assert got.shape == (40, 3) and got.dtype == np.float64
            np.testing.assert_array_equal(got, np.stack([x, y, np.asarray(coords["depth"])], 1))


def test_latlon_to_utm_scalars_match_jax():
    for lon, lat in ((-125.39, 44.57), (-123.0, 47.0), (-126.5, 45.1)):
        assert tcoords.latlon_to_utm(lon, lat) == jlatlon_to_utm(lon, lat)
    e, n = tcoords.latlon_to_utm(-123.0, 0.0)       # zone 10's central meridian
    assert e == 500000.0 and n == 0.0


def test_coordinate_csv_rejects_ragged_rows(tmp_path):
    bad = tmp_path / "bad.csv"
    bad.write_text("0,44.6,-124.9,-100\n1,44.6\n")
    with pytest.raises(ValueError, match="columns"):
        tcoords.load_cable_coordinates(str(bad), 2.0)
    assert isinstance(jcoords.load_cable_coordinates(_csv(tmp_path), 2.0), pd.DataFrame)

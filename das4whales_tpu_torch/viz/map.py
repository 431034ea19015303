"""Bathymetry maps, cable geometry plots and geodesy (the port's copy of
``das4whales_tpu.viz.map``, reference map.py:20-310). Host numpy and
scipy; ``matplotlib`` is imported inside the plot functions.

Deviations from the reference, as in the JAX package:

- ``load_bathymetry`` honors its ``filepath`` argument (the reference
  hardcodes ``'data/GMRT_OOI_RCA_Cables.grd'``, map.py:65) and reads
  GMT/GMRT ``.grd`` grids with scipy's netCDF-3 reader or ``h5py``
  (netCDF-4) — no xarray dependency.
- ``latlon_to_utm`` is the native WGS84 -> UTM transverse-Mercator series
  (one copy in the port: ``io.coords``), not pyproj.
- Plot functions return the Figure and only ``show()`` on interactive
  backends (see ``viz.plot``).

And one of the port's own: :func:`load_cable_coordinates` (``io.coords``)
returns a mapping of numpy columns, not a pandas DataFrame; the plots
take that mapping, a DataFrame, or ``(x, y)`` array pairs.
"""

from __future__ import annotations

import numpy as np

from ..io.coords import latlon_to_utm, load_cable_coordinates  # noqa: F401
from .plot import _finish, _pyplot


def _read_grd(filepath: str):
    """Read a GMT/GMRT ``.grd`` grid (netCDF-3 classic or netCDF-4/HDF5).

    Returns ``(z, x_range, y_range, dimension)`` as host arrays.
    """
    try:
        from scipy.io import netcdf_file

        with netcdf_file(filepath, "r", mmap=False) as ds:
            return (
                ds.variables["z"][:].copy(),
                ds.variables["x_range"][:].copy(),
                ds.variables["y_range"][:].copy(),
                ds.variables["dimension"][:].copy(),
            )
    except (TypeError, ValueError, OSError):
        import h5py

        with h5py.File(filepath, "r") as ds:
            return (
                np.asarray(ds["z"]),
                np.asarray(ds["x_range"]),
                np.asarray(ds["y_range"]),
                np.asarray(ds["dimension"]),
            )


def load_bathymetry(filepath: str):
    """Load a GMRT bathymetry grid (reference map.py:45-94).

    Returns ``(bathy, xlon, ylat)`` where ``bathy[i, j]`` is the depth at
    ``(xlon[j], ylat[i])``.
    """
    z, x_range, y_range, dimension = _read_grd(filepath)
    bathy = np.asarray(z, dtype=np.float64)

    dim = np.flip(np.asarray(dimension)).astype(int)
    bathy = np.flipud(bathy.reshape(dim))

    x0, xf = np.asarray(x_range, dtype=np.float64)
    y0, yf = np.asarray(y_range, dtype=np.float64)
    xlon = np.linspace(x0, xf, bathy.shape[1])
    ylat = np.linspace(y0, yf, bathy.shape[0])

    # drop all-NaN no-data borders, keeping the coordinate axes aligned
    # with the surviving rows/cols (the reference re-spans the original
    # range over the trimmed grid, shifting every coordinate, map.py:79-93)
    keep_rows = ~np.isnan(bathy).all(axis=1)
    keep_cols = ~np.isnan(bathy).all(axis=0)
    return bathy[keep_rows][:, keep_cols], xlon[keep_cols], ylat[keep_rows]


def flatten_bathy(bathy: np.ndarray, threshold: float) -> np.ndarray:
    """Clamp the bathymetry above ``threshold`` (reference map.py:97-118)."""
    return np.minimum(bathy, threshold)


def _undersea_cmap():
    """Blues below sea level, white above (reference map.py:139-145)."""
    import matplotlib.colors as mcolors

    plt = _pyplot()
    colors_undersea = plt.cm.Blues_r(np.linspace(0, 0.5, 100))
    colors_land = np.array([[1, 1, 1, 1]] * 40)
    return mcolors.LinearSegmentedColormap.from_list(
        "custom_cmap", np.vstack((colors_undersea, colors_land)))


def _is_table(cable) -> bool:
    """A cable given by named columns (a mapping or a DataFrame), not an
    ``(x, y)`` pair."""
    return hasattr(cable, "keys")


def plot_cables2D(df_north, df_south, bathy, xlon, ylat, show=None):
    """Hillshaded 2-D bathymetry with the two cable routes
    (reference map.py:121-191). Accepts column tables (lon/lat columns) or
    (x, y) array pairs in UTM meters."""
    import matplotlib.colors as mcolors
    from matplotlib.colors import LightSource

    plt = _pyplot()
    custom_cmap = _undersea_cmap()
    extent = [xlon[0], xlon[-1], ylat[0], ylat[-1]]
    ls = LightSource(azdeg=350, altdeg=45)

    fig = plt.figure(figsize=(14, 7))
    ax = plt.gca()
    rgb = ls.shade(bathy, cmap=custom_cmap, vert_exag=0.1, blend_mode="overlay")
    ax.imshow(rgb, extent=extent, aspect="equal", origin="lower")

    frames = _is_table(df_north)
    if frames:
        ax.plot(df_north["lon"], df_north["lat"], "tab:red", label="North cable")
        ax.plot(df_south["lon"], df_south["lat"], "tab:orange", label="South cable")
    else:
        ax.plot(df_north[0], df_north[1], "tab:red", label="North cable")
        ax.plot(df_south[0], df_south[1], "tab:orange", label="South cable")

    ax.contour(bathy, levels=[0], colors="k", extent=extent)

    mappable = plt.cm.ScalarMappable(
        norm=mcolors.Normalize(np.nanmin(bathy), np.nanmax(bathy)), cmap=custom_cmap)
    plt.colorbar(mappable, ax=ax, label="Depth [m]", aspect=50, pad=0.1,
                 orientation="horizontal")

    plt.xlabel("Longitude" if frames else "UTM x [m]")
    plt.ylabel("Latitude" if frames else "UTM y [m]")
    plt.legend(loc="upper center")
    plt.tight_layout()
    return _finish(fig, show)


def _plot_cables3d(df_north, df_south, bathy, x, y, cols, labels, show):
    plt = _pyplot()
    fig = plt.figure(figsize=(16, 10))
    ax = fig.add_subplot(111, projection="3d")
    X, Y = np.meshgrid(x, y)
    rstride = max(X.shape[0] // 100, 1)
    cstride = max(X.shape[1] // 50, 1)
    ax.plot_surface(X, Y, bathy, cmap="Blues_r", alpha=0.7, antialiased=True,
                    rstride=rstride, cstride=cstride)
    cx, cy = cols
    ax.plot(df_north[cx], df_north[cy], df_north["depth"], "tab:red", label="North cable", lw=4)
    ax.plot(df_south[cx], df_south[cy], df_south["depth"], "tab:orange", label="South cable", lw=4)
    ax.set_xlabel(labels[0])
    ax.set_ylabel(labels[1])
    ax.set_zlabel("Depth [m]")
    ax.set_aspect("equalxy")
    ax.legend()
    return _finish(fig, show)


def plot_cables3D(df_north, df_south, bathy, xlon, ylat, show=None):
    """3-D bathymetry surface + cables in lon/lat (reference map.py:194-234)."""
    return _plot_cables3d(df_north, df_south, bathy, xlon, ylat,
                          ("lon", "lat"), ("Longitude", "Latitude"), show)


def plot_cables3D_m(df_north, df_south, bathy, x, y, show=None):
    """3-D bathymetry surface + cables in UTM meters (reference map.py:237-277)."""
    return _plot_cables3d(df_north, df_south, bathy, x, y,
                          ("x", "y"), ("x [m]", "y [m]"), show)

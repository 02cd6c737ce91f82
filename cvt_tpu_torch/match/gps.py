"""GPS coordinate transforms: ELL (lat/lon/alt) <-> ECEF <-> ENU.

Reference: vlindex/src/base/gps.{h,cc} — COLMAP's GPSTransform converts
geodetic coordinates for the spatial matcher (matching.h:498 SpatialMatcher
uses GPS positions as knn keys). These are host-side double-precision
index-prep transforms (the hot knn itself runs on device via FlatIndex),
so they are batched numpy, matching the reference's Eigen doubles;
WGS84/GRS80 ellipsoids.
"""

from __future__ import annotations

import numpy as np

# (a, b) semi-major / semi-minor axes in meters
ELLIPSOIDS = {
    "wgs84": (6378137.0, 6356752.314245),
    "grs80": (6378137.0, 6356752.314140),
}


def _ab(ellipsoid: str):
    try:
        return ELLIPSOIDS[ellipsoid]
    except KeyError:
        raise ValueError(f"unknown ellipsoid {ellipsoid!r}") from None


def ell_to_ecef(lla, ellipsoid: str = "wgs84") -> np.ndarray:
    """[..., 3] (lat deg, lon deg, alt m) -> ECEF xyz meters."""
    a, b = _ab(ellipsoid)
    e2 = 1.0 - (b * b) / (a * a)
    lla = np.asarray(lla, np.float64)
    lat = np.deg2rad(lla[..., 0])
    lon = np.deg2rad(lla[..., 1])
    alt = lla[..., 2]
    sin_lat, cos_lat = np.sin(lat), np.cos(lat)
    n = a / np.sqrt(1.0 - e2 * sin_lat * sin_lat)
    x = (n + alt) * cos_lat * np.cos(lon)
    y = (n + alt) * cos_lat * np.sin(lon)
    z = (n * (1.0 - e2) + alt) * sin_lat
    return np.stack([x, y, z], axis=-1)


def ecef_to_ell(xyz, ellipsoid: str = "wgs84",
                iters: int = 100) -> np.ndarray:
    """ECEF xyz meters -> (lat deg, lon deg, alt m).

    Fixed-point iteration on latitude (the reference iterates to 1e-14
    convergence in gps.cc; 100 iterations is far past that)."""
    a, b = _ab(ellipsoid)
    e2 = 1.0 - (b * b) / (a * a)
    xyz = np.asarray(xyz, np.float64)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    p = np.sqrt(x * x + y * y)
    lon = np.arctan2(y, x)
    lat = np.arctan2(z, p * (1.0 - e2))
    alt = np.zeros_like(lat)
    for _ in range(iters):
        sin_lat = np.sin(lat)
        n = a / np.sqrt(1.0 - e2 * sin_lat * sin_lat)
        alt = p / np.cos(lat) - n
        lat = np.arctan2(z, p * (1.0 - e2 * n / (n + alt)))
    return np.stack([np.rad2deg(lat), np.rad2deg(lon), alt], axis=-1)


def _enu_rotation(lat_rad: float, lon_rad: float) -> np.ndarray:
    sl, cl = np.sin(lat_rad), np.cos(lat_rad)
    so, co = np.sin(lon_rad), np.cos(lon_rad)
    return np.array([
        [-so, co, 0.0],
        [-sl * co, -sl * so, cl],
        [cl * co, cl * so, sl],
    ], np.float64)


def ecef_to_enu(xyz, lat0: float, lon0: float, alt0: float = 0.0,
                ellipsoid: str = "wgs84") -> np.ndarray:
    """ECEF -> local East-North-Up at reference (lat0, lon0, alt0) deg/m."""
    ref = ell_to_ecef(np.array([lat0, lon0, alt0]), ellipsoid)
    r = _enu_rotation(np.deg2rad(lat0), np.deg2rad(lon0))
    d = np.asarray(xyz, np.float64) - ref
    return d @ r.T


def enu_to_ecef(enu, lat0: float, lon0: float, alt0: float = 0.0,
                ellipsoid: str = "wgs84") -> np.ndarray:
    ref = ell_to_ecef(np.array([lat0, lon0, alt0]), ellipsoid)
    r = _enu_rotation(np.deg2rad(lat0), np.deg2rad(lon0))
    return np.asarray(enu, np.float64) @ r + ref


def ell_to_enu(lla, lat0: float, lon0: float, alt0: float = 0.0,
               ellipsoid: str = "wgs84") -> np.ndarray:
    """Geodetic -> local ENU (the spatial matcher's position key)."""
    return ecef_to_enu(ell_to_ecef(lla, ellipsoid), lat0, lon0, alt0,
                       ellipsoid)

"""GPS coordinate conversions: WGS84 ↔ ECEF ↔ ENU.

reference behavior: src/colmap/geometry/gps.{h,cc} — GPSTransform with
WGS84/GRS80 ellipsoids, used by pose priors and spatial pairing. A copy
of colmap_tpu/geometry/gps.py (numpy only), so that the port does not
import the JAX package.
"""

from __future__ import annotations

import numpy as np

# WGS84 ellipsoid (reference: gps.h kWGS84/kGRS80 constants).
WGS84_A = 6378137.0
WGS84_F = 1.0 / 298.257223563
WGS84_B = WGS84_A * (1.0 - WGS84_F)
WGS84_E2 = 1.0 - (WGS84_B / WGS84_A) ** 2

GRS80_A = 6378137.0
GRS80_F = 1.0 / 298.257222100882711
GRS80_B = GRS80_A * (1.0 - GRS80_F)
GRS80_E2 = 1.0 - (GRS80_B / GRS80_A) ** 2


def ellipsoid_to_ecef(lat_deg, lon_deg, alt, a=WGS84_A, e2=WGS84_E2):
    """Geodetic (deg, deg, m) -> ECEF (m). Broadcasts over arrays."""
    lat = np.deg2rad(np.asarray(lat_deg, dtype=np.float64))
    lon = np.deg2rad(np.asarray(lon_deg, dtype=np.float64))
    alt = np.asarray(alt, dtype=np.float64)
    sin_lat = np.sin(lat)
    N = a / np.sqrt(1.0 - e2 * sin_lat**2)
    x = (N + alt) * np.cos(lat) * np.cos(lon)
    y = (N + alt) * np.cos(lat) * np.sin(lon)
    z = (N * (1.0 - e2) + alt) * sin_lat
    return np.stack([x, y, z], axis=-1)


def ecef_to_ellipsoid(xyz, a=WGS84_A, e2=WGS84_E2, num_iterations=100):
    """ECEF (m) -> geodetic (deg, deg, m) via iterative latitude solve."""
    xyz = np.asarray(xyz, dtype=np.float64)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    lon = np.arctan2(y, x)
    p = np.sqrt(x**2 + y**2)
    lat = np.arctan2(z, p * (1.0 - e2))
    for _ in range(num_iterations):
        sin_lat = np.sin(lat)
        N = a / np.sqrt(1.0 - e2 * sin_lat**2)
        alt = p / np.cos(lat) - N
        new_lat = np.arctan2(z, p * (1.0 - e2 * N / (N + alt)))
        if np.all(np.abs(new_lat - lat) < 1e-14):
            lat = new_lat
            break
        lat = new_lat
    sin_lat = np.sin(lat)
    N = a / np.sqrt(1.0 - e2 * sin_lat**2)
    alt = p / np.cos(lat) - N
    return np.stack([np.rad2deg(lat), np.rad2deg(lon), alt], axis=-1)


def ecef_to_enu_rotation(lat_deg, lon_deg):
    """Rotation matrix taking ECEF deltas into the local ENU frame."""
    lat = np.deg2rad(lat_deg)
    lon = np.deg2rad(lon_deg)
    sl, cl = np.sin(lat), np.cos(lat)
    so, co = np.sin(lon), np.cos(lon)
    return np.array(
        [
            [-so, co, 0.0],
            [-sl * co, -sl * so, cl],
            [cl * co, cl * so, sl],
        ]
    )


def ellipsoid_to_enu(lat_deg, lon_deg, alt, ref_lat_deg, ref_lon_deg, ref_alt):
    """Geodetic -> local ENU about a reference point."""
    ecef = ellipsoid_to_ecef(lat_deg, lon_deg, alt)
    ref = ellipsoid_to_ecef(ref_lat_deg, ref_lon_deg, ref_alt)
    R = ecef_to_enu_rotation(ref_lat_deg, ref_lon_deg)
    return (ecef - ref) @ R.T


def enu_to_ellipsoid(enu, ref_lat_deg, ref_lon_deg, ref_alt):
    ref = ellipsoid_to_ecef(ref_lat_deg, ref_lon_deg, ref_alt)
    R = ecef_to_enu_rotation(ref_lat_deg, ref_lon_deg)
    ecef = np.asarray(enu) @ R + ref
    return ecef_to_ellipsoid(ecef)

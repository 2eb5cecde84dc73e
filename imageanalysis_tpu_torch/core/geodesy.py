"""WGS-84 geodesy: lla ↔ ECEF ↔ local NED.

Port of ``imageanalysis_tpu/core/geodesy.py`` (navpy's conventions:
lat/lon in degrees, altitude in metres above the WGS-84 ellipsoid, NED =
[north, east, down] metres from a reference lla):

- float64 numpy host functions, the same code as the reference's (1e-7
  deg is 1 cm, beyond float32);
- torch variants (suffix ``_j``, the reference's names) for device code on
  local NED offsets, where float32 suffices.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .rotations import as_tensor

# WGS-84 ellipsoid
_A = 6378137.0                # semi-major axis (m)
_F = 1.0 / 298.257223563      # flattening
_E2 = _F * (2.0 - _F)         # first eccentricity squared


def lla2ecef(lat_deg, lon_deg, alt_m):
    """Geodetic lat/lon/alt (deg, deg, m) → ECEF xyz (m). float64 numpy."""
    lat = np.radians(np.asarray(lat_deg, dtype=np.float64))
    lon = np.radians(np.asarray(lon_deg, dtype=np.float64))
    alt = np.asarray(alt_m, dtype=np.float64)
    sin_lat, cos_lat = np.sin(lat), np.cos(lat)
    n = _A / np.sqrt(1.0 - _E2 * sin_lat**2)
    x = (n + alt) * cos_lat * np.cos(lon)
    y = (n + alt) * cos_lat * np.sin(lon)
    z = (n * (1.0 - _E2) + alt) * sin_lat
    return np.stack([x, y, z], axis=-1)


def ecef2lla(xyz, iters=8):
    """ECEF xyz (m) → lat/lon/alt (deg, deg, m) by Bowring iteration."""
    xyz = np.asarray(xyz, dtype=np.float64)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    lon = np.arctan2(y, x)
    p = np.hypot(x, y)
    lat = np.arctan2(z, p * (1.0 - _E2))
    for _ in range(iters):
        sin_lat = np.sin(lat)
        n = _A / np.sqrt(1.0 - _E2 * sin_lat**2)
        alt = p / np.cos(lat) - n
        lat = np.arctan2(z, p * (1.0 - _E2 * n / (n + alt)))
    sin_lat = np.sin(lat)
    n = _A / np.sqrt(1.0 - _E2 * sin_lat**2)
    alt = p / np.cos(lat) - n
    return np.stack([np.degrees(lat), np.degrees(lon), alt], axis=-1)


def _ecef2ned_matrix(lat_deg, lon_deg):
    lat = np.radians(float(lat_deg))
    lon = np.radians(float(lon_deg))
    sl, cl = np.sin(lat), np.cos(lat)
    so, co = np.sin(lon), np.cos(lon)
    return np.array([[-sl * co, -sl * so, cl],
                     [-so, co, 0.0],
                     [-cl * co, -cl * so, -sl]], dtype=np.float64)


def lla2ned(lat_deg, lon_deg, alt_m, ref_lat_deg, ref_lon_deg, ref_alt_m):
    """lla → NED (m) relative to a reference lla (navpy.lla2ned)."""
    ecef = lla2ecef(lat_deg, lon_deg, alt_m)
    ref_ecef = lla2ecef(ref_lat_deg, ref_lon_deg, ref_alt_m)
    return (ecef - ref_ecef) @ _ecef2ned_matrix(ref_lat_deg, ref_lon_deg).T


def ned2lla(ned, ref_lat_deg, ref_lon_deg, ref_alt_m):
    """NED (m) relative to a reference lla → [lat_deg, lon_deg, alt_m]."""
    ned = np.asarray(ned, dtype=np.float64)
    C = _ecef2ned_matrix(ref_lat_deg, ref_lon_deg)
    return ecef2lla(lla2ecef(ref_lat_deg, ref_lon_deg, ref_alt_m) + ned @ C)


# ---------------------------------------------------------------------------
# torch variants for device code (float32-safe for local NED work)
# ---------------------------------------------------------------------------

def _radii(ref_lat_deg):
    """(prime-vertical, meridional) radii of curvature at the reference
    latitude, and its cosine."""
    lat0 = math.radians(float(ref_lat_deg))
    sin0 = math.sin(lat0)
    rn = _A / math.sqrt(1.0 - _E2 * sin0**2)
    rm = rn * (1.0 - _E2) / (1.0 - _E2 * sin0**2)
    return rn, rm, math.cos(lat0)


def lla2ned_j(lat_deg, lon_deg, alt_m, ref_lat_deg, ref_lon_deg, ref_alt_m):
    """lla → NED by the local-tangent small-angle expansion with the
    second-order Earth-curvature drop (~1e-4 relative, ≈10 cm at 1 km)."""
    lat_deg = as_tensor(lat_deg)
    rn, rm, cos0 = _radii(ref_lat_deg)
    dlat = torch.deg2rad(lat_deg - ref_lat_deg)
    dlon = torch.deg2rad(as_tensor(lon_deg, lat_deg) - ref_lon_deg)
    n = dlat * (rm + ref_alt_m)
    e = dlon * (rn + ref_alt_m) * cos0
    d = -(as_tensor(alt_m, lat_deg) - ref_alt_m) \
        + (n * n + e * e) / (2.0 * (rn + ref_alt_m))
    return torch.stack([n, e, d], dim=-1)


def ned2lla_j(ned, ref_lat_deg, ref_lon_deg, ref_alt_m):
    """NED → lla, the inverse of lla2ned_j (same tangent-plane
    approximation)."""
    ned = as_tensor(ned)
    rn, rm, cos0 = _radii(ref_lat_deg)
    lat = ref_lat_deg + torch.rad2deg(ned[..., 0] / (rm + ref_alt_m))
    lon = ref_lon_deg + torch.rad2deg(ned[..., 1] / ((rn + ref_alt_m) * cos0))
    s2 = ned[..., 0] ** 2 + ned[..., 1] ** 2
    alt = ref_alt_m - ned[..., 2] + s2 / (2.0 * (rn + ref_alt_m))
    return torch.stack([lat, lon, alt], dim=-1)

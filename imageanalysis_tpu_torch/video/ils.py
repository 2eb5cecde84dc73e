"""Illumination-sensor (ILS) sun-angle correction.

Systems with an up-pointing illumination sensor record per-image ILS
values used to normalize imagery brightness; the reading varies with the
angle between the aircraft's up axis and the sun (reference
tests/illumintation-sensor-test.py + README.md:184-189). This computes
the per-image sun angle from the pose + capture time (our Meeus
ephemeris, video/ephemeris.py) and a cos-model correction factor.

Port of the JAX package's ``video/ils.py``: a copy over the port's
``core/rotations.py`` (float32, as the reference's jnp).
"""

from __future__ import annotations

import numpy as np

from ..core.rotations import quat_from_ypr, quat_to_matrix
from . import ephemeris

D2R = np.pi / 180.0
R2D = 180.0 / np.pi


def sun_angle_deg(lat_deg, lon_deg, alt_m, ypr_deg, unixtime):
    """Angle between the aircraft 'up' axis and the sun direction (deg),
    the reference's rel_sun_angle (illumintation-sensor-test.py:71-89)."""
    sun_ned, _ = ephemeris.sun_moon_ned(lon_deg, lat_deg, alt_m, unixtime)
    q = np.asarray(quat_from_ypr(ypr_deg[0] * D2R, ypr_deg[1] * D2R,
                                 ypr_deg[2] * D2R))
    body2ned = np.asarray(quat_to_matrix(q))
    up_ned = body2ned @ np.array([0.0, 0.0, -1.0])
    c = np.clip(np.dot(np.asarray(sun_ned), up_ned)
                / max(np.linalg.norm(sun_ned) * np.linalg.norm(up_ned),
                      1e-12), -1.0, 1.0)
    return float(np.degrees(np.arccos(c)))


def correction_factors(rows, unixtime):
    """Per-image (name, sun_angle_deg, ils, factor) table.

    rows: [(name, lat, lon, alt, yaw, pitch, roll, ils), ...]. The
    correction normalizes each ILS reading by the cosine of its sun
    angle, referenced to the mission-median illumination — images tilted
    away from the sun are brightened accordingly."""
    out = []
    for name, lat, lon, alt, yaw, pitch, roll, ils in rows:
        ang = sun_angle_deg(lat, lon, alt, (yaw, pitch, roll), unixtime)
        out.append([name, ang, ils])
    cosv = np.cos(np.radians(np.clip([r[1] for r in out], 0.0, 89.0)))
    ils_v = np.array([r[2] for r in out], float)
    expected = cosv * np.median(ils_v / np.maximum(cosv, 1e-6))
    for r, e in zip(out, expected):
        r.append(float(e / r[2]) if r[2] > 0 else 1.0)
    return out

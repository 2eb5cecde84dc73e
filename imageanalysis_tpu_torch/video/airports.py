"""Airport database for HUD symbology.

The reference loads a CSV airport list (Ident/Lat/Lon/Alt columns) and
keeps the entries within range of the NED reference point (reference
video/airports.py:9-24); the HUD draws each as a labeled point with
distance callout (hud.py:619-621 draw_airports + 534-557 draw_lla_point).

Port of the JAX package's ``video/airports.py``: a copy over the port's
``core/geodesy.py``.
"""

from __future__ import annotations

import csv
import math

from ..core import geodesy


def load(path, ned_ref_lla, range_m=30000.0):
    """Airports within range_m of the reference lat/lon/alt.

    Returns a list of [ident, lat_deg, lon_deg, alt_m]."""
    result = []
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            lat = float(row["Lat"])
            lon = float(row["Lon"])
            alt = float(row["Alt"])
            ned = geodesy.lla2ned(lat, lon, alt, *ned_ref_lla)
            dist = math.sqrt(ned[0] ** 2 + ned[1] ** 2 + ned[2] ** 2)
            if dist <= range_m:
                result.append([row["Ident"], lat, lon, alt])
    return result

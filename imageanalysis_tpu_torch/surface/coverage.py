"""Image ground-coverage helpers (reference scripts/lib/image_list.py:8-98
and Image.coverage_xy/coverage_lla, image.py:380-410).

Port of ``imageanalysis_tpu/surface/coverage.py``: host numpy over the
port's core/geodesy, the same code.

Coverage rectangles come from each image's projected corner points (the
corner_list/grid_list the render stage computes); queries find which images
see a given NED point — used by the GeoTIFF compositor and review tools.
"""

from __future__ import annotations

import numpy as np

from ..core import geodesy


def image_coverage(grid_xyz):
    """Bounding rect (e_min, n_min, e_max, n_max) of projected grid points
    ([e, n, up], NaNs ignored)."""
    g = np.asarray(grid_xyz, float)
    g = g[~np.isnan(g).any(axis=1)]
    if len(g) == 0:
        return None
    return (float(g[:, 0].min()), float(g[:, 1].min()),
            float(g[:, 0].max()), float(g[:, 1].max()))


def coverage_union(rects):
    rects = [r for r in rects if r is not None]
    if not rects:
        return None
    a = np.asarray(rects)
    return (float(a[:, 0].min()), float(a[:, 1].min()),
            float(a[:, 2].max()), float(a[:, 3].max()))


def images_covering_point(rects_by_name, e, n):
    """Names of images whose coverage rect contains (e, n)
    (reference image_list.getImagesCoveringPoint)."""
    out = []
    for name, r in rects_by_name.items():
        if r and r[0] <= e <= r[2] and r[1] <= n <= r[3]:
            out.append(name)
    return sorted(out)


def coverage_lla(rect, ned_ref):
    """NED rect → (lon_min, lat_min, lon_max, lat_max)
    (reference image.py:405-410 coverage_lla)."""
    e0, n0, e1, n1 = rect
    lo = geodesy.ned2lla([n0, e0, 0.0], *ned_ref)
    hi = geodesy.ned2lla([n1, e1, 0.0], *ned_ref)
    return (lo[1], lo[0], hi[1], hi[0])

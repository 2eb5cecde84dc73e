"""AC3D (.ac) model writers.

Port of ``imageanalysis_tpu/render/ac3d.py``, the same two outputs:

- ``write_surface_ac``: the untextured global Delaunay terrain surface
  (``models/surface-global.ac``);
- ``generate_textured``: one textured object of grid quads per image
  (``models/direct.ac``), the legacy parallel of the .egg output.

AC3D is plain text: an AC3Db header, one world object, kids with
numvert/numsurf blocks. Coordinates are x = east, y = up, z = −north.
Host numpy and scipy, as in the reference.
"""

from __future__ import annotations

import os

import numpy as np

from ..io.logger import log


def write_surface_ac(path, points_en, values_down, max_edge=None):
    """Delaunay-triangulate (e, n) points and write an untextured surface.

    points_en: (N, 2) [e, n]; values_down: (N,) NED down (negated to up).
    max_edge: drop triangles with any edge longer than this (meters).
    """
    import scipy.spatial

    points_en = np.asarray(points_en, float)
    up = -np.asarray(values_down, float)
    tri = scipy.spatial.Delaunay(points_en)
    simplices = tri.simplices
    if max_edge is not None:
        keep = []
        for s in simplices:
            p = points_en[s]
            e = [np.linalg.norm(p[i] - p[(i + 1) % 3]) for i in range(3)]
            if max(e) <= max_edge:
                keep.append(s)
        simplices = np.asarray(keep)

    lines = ['AC3Db',
             'MATERIAL "terrain" rgb 0.6 0.6 0.55  amb 0.4 0.4 0.4  '
             'emis 0 0 0  spec 0.1 0.1 0.1  shi 8  trans 0',
             "OBJECT world", "kids 1",
             "OBJECT poly", 'name "surface"',
             f"numvert {len(points_en)}"]
    for (e, n), u in zip(points_en, up):
        lines.append(f"{e:.3f} {u:.3f} {-n:.3f}")
    lines.append(f"numsurf {len(simplices)}")
    for s in simplices:
        lines += ["SURF 0x20", "mat 0", "refs 3"]
        for vi in s:
            lines.append(f"{vi} 0 0")
    lines.append("kids 0")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    log("Wrote AC3D surface:", path,
        f"({len(points_en)} verts, {len(simplices)} tris)")
    return len(simplices)


def generate_textured(proj, group_images, grids, distorted_uvs, base_name="direct"):
    """Textured per-image quads (reference ac3d.py generate): one OBJECT per
    image, textures are the models/*.JPG files the egg path also uses.

    grids: dict name → (n_pts, 3) [e, n, up] grid vertices; distorted_uvs:
    dict name → (n_pts, 2) raw-image uv for texture coords.
    """
    width = int(proj.camera.get("width_px", 1))
    height = int(proj.camera.get("height_px", 1))
    path = os.path.join(proj.models_dir, base_name + ".ac")
    objs = []
    count = 0
    for name in group_images:
        if name not in grids:
            continue
        xyz = np.asarray(grids[name])
        uv = np.asarray(distorted_uvs[name])
        steps = int(np.sqrt(len(xyz))) - 1
        good = ~np.isnan(xyz).any(axis=1)
        body = ["OBJECT poly", f'name "{name}"',
                f'texture "{name}.JPG"', f"numvert {len(xyz)}"]
        for (e, n, u), g in zip(xyz, good):
            if not g:
                e = n = u = 0.0
            body.append(f"{e:.3f} {u:.3f} {-n:.3f}")
        quads = []
        for j in range(steps):
            for i in range(steps):
                c = j * (steps + 1) + i
                d = (j + 1) * (steps + 1) + i
                if good[c] and good[c + 1] and good[d] and good[d + 1]:
                    quads.append((d, d + 1, c + 1, c))
        body.append(f"numsurf {len(quads)}")
        for q in quads:
            body += ["SURF 0x20", "mat 0", "refs 4"]
            for vi in q:
                body.append(f"{vi} {uv[vi][0] / width:.5f} "
                            f"{1.0 - uv[vi][1] / height:.5f}")
        body.append("kids 0")
        objs.append("\n".join(body))
        count += 1
    lines = ["AC3Db",
             'MATERIAL "default" rgb 1 1 1  amb 1 1 1  emis 0 0 0  '
             'spec 0 0 0  shi 8  trans 0',
             "OBJECT world", f"kids {count}"] + objs
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    log("Wrote AC3D model:", path, f"({count} image objects)")
    return path

"""Zooniverse crowd-sourcing tile tools.

Reference 3rd_party/zooniverse/*.py: chop large mission images into
web-sized overlapping tiles for crowd annotation, then paste user marks
(tile pixel coords) back through the tile → image → ground projection to
lat/lon.

``chop``  — write tiles + a tiles.csv manifest (image, tile, x0, y0)
``paste`` — tile-space marks csv → annotations.json/csv/kml via each
            image's optimized pose and the project surface

Port of ``imageanalysis_tpu/apps/zooniverse.py``. ``chop`` is host cv2,
the same code. ``paste`` casts the rays of every mark in one device call
(undistortion, the body→NED matrices, view vectors and the ground plane,
in float32 as the reference), where the reference casts one mark at a
time. Usage: ``python -m imageanalysis_tpu_torch.apps.zooniverse chop|paste
...``; it runs on the CUDA card, ``IMGTPU_PLATFORM=cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys

import numpy as np
import torch

from ..core.camera import (intersect_ground_plane, pixel_vectors_ned,
                           undistort_pixels)
from ..core.device import checked
from ..core.rotations import quat_to_matrix
from ..io.logger import log
from .process import main_device


def chop(project_dir, out_dir, tile=512, overlap=64, max_images=None):
    import cv2

    from ..io.project import ProjectMgr

    proj = ProjectMgr(project_dir)
    proj.load_images_info()
    os.makedirs(out_dir, exist_ok=True)
    manifest = []
    for im in proj.image_list[:max_images]:
        img = cv2.imread(proj.image_path(im))
        h, w = img.shape[:2]
        step = tile - overlap
        ys = sorted({min(y0, max(h - tile, 0))
                     for y0 in range(0, max(h - overlap, 1), step)})
        xs = sorted({min(x0, max(w - tile, 0))
                     for x0 in range(0, max(w - overlap, 1), step)})
        for y0 in ys:
            for x0 in xs:
                crop = img[y0:y0 + tile, x0:x0 + tile]
                name = f"{im.name}_t{y0:05d}_{x0:05d}.jpg"
                cv2.imwrite(os.path.join(out_dir, name), crop,
                            [cv2.IMWRITE_JPEG_QUALITY, 90])
                manifest.append([name, im.name, x0, y0])
    with open(os.path.join(out_dir, "tiles.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["tile", "image", "x0", "y0"])
        w.writerows(manifest)
    log(f"chopped {len(manifest)} tiles → {out_dir}")
    return manifest


def cast_marks(uv, cam_ned, cam_quat, K, dist, ground=0.0):
    """Ground points (N, 3) NED of N marks in one batched call: uv (N, 2)
    distorted pixels, each mark's camera position cam_ned (N, 3) and
    attitude quaternion cam_quat (N, 4) (quat_to_matrix gives its
    body→NED matrix), all float32 tensors on one device; K (3, 3), dist
    (5,)."""
    und = undistort_pixels(uv, K, dist)
    vec = pixel_vectors_ned(und, quat_to_matrix(cam_quat), K)
    return intersect_ground_plane(cam_ned, ground, vec)


def paste(project_dir, marks_csv, tiles_csv, ground=0.0, device="cuda"):
    """marks_csv rows: tile, u, v[, comment] (tile-pixel coords) →
    project annotations at the ground intersection, every mark's ray cast
    on device in one call."""
    from ..io.project import ProjectMgr
    from ..render.annotations import Annotations

    dev = checked(device, "zooniverse paste")
    proj = ProjectMgr(project_dir)
    proj.load_images_info()
    model = proj.camera_model(optimized=True)
    tiles = {}
    with open(tiles_csv) as f:
        for row in csv.DictReader(f):
            tiles[row["tile"]] = (row["image"], int(row["x0"]), int(row["y0"]))

    ann = Annotations(proj.analysis_dir, proj.ned_reference_lla()).load()
    uv, neds, quats, comments = [], [], [], []
    with open(marks_csv) as f:
        for row in csv.DictReader(f):
            tile = row["tile"]
            if tile not in tiles:
                continue
            image_name, x0, y0 = tiles[tile]
            im = proj.image_by_name(image_name)
            if im is None:
                continue
            uv.append([float(row["u"]) + x0, float(row["v"]) + y0])
            ned, _, quat = im.get_camera_pose(opt=im.has_opt_pose())
            neds.append(ned)
            quats.append(quat)
            comments.append(row.get("comment", ""))
    if uv:
        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        hits = cast_marks(t(uv), t(neds), t(quats), model.K.to(dev),
                          model.dist.to(dev), ground).cpu().numpy()
        for hit, comment in zip(hits, comments):
            ann.add_marker_ned(hit.tolist(), comment)
    ann.save()
    log(f"pasted {len(uv)} marks into annotations")
    return len(uv)


def build_parser():
    p = argparse.ArgumentParser(prog="imageanalysis-zooniverse")
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("chop")
    s.add_argument("project")
    s.add_argument("out_dir")
    s.add_argument("--tile", type=int, default=512)
    s.add_argument("--overlap", type=int, default=64)
    s.set_defaults(fn=lambda a, dev: (chop(a.project, a.out_dir, a.tile,
                                           a.overlap), 0)[1])
    s = sub.add_parser("paste")
    s.add_argument("project")
    s.add_argument("marks_csv")
    s.add_argument("tiles_csv")
    s.add_argument("--ground", type=float, default=0.0)
    s.set_defaults(fn=lambda a, dev: (paste(a.project, a.marks_csv,
                                            a.tiles_csv, a.ground,
                                            device=dev), 0)[1])
    return p


def main(argv=None, device="cuda"):
    """The command line's entry point, on device (IMGTPU_PLATFORM in the
    environment overrides it, as in apps/process.py)."""
    args = build_parser().parse_args(argv)
    return args.fn(args, main_device(device))


if __name__ == "__main__":
    sys.exit(main())

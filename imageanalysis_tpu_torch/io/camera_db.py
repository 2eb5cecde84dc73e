"""Camera calibration database: ``cameras/<Make_Model_Lens>.json``.

Port of ``imageanalysis_tpu/io/camera_db.py`` with the same JSON contract:
row-major K (9 floats), 5 distortion coefficients [k1, k2, p1, p2, k3],
ccd dims (mm), focal length (mm), image size (px), optional mount ypr.
``to_model`` builds a torch ``CameraModel``; ``estimate_from_exif`` a
starting config from a JPEG's EXIF (``io/exif``: the focal length, and
the image size from the SOF marker).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..core.camera import CameraModel

# the package's own DB directory, searched after the caller's
PACKAGE_DB = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "cameras")


def config_from_dict(d: dict) -> dict:
    """Normalize a camera-config dict (fill defaults)."""
    mount = d.get("mount", {})
    cfg = {
        "make": d.get("make", "unknown"),
        "model": d.get("model", "unknown"),
        "lens_model": d.get("lens_model", "unknown"),
        "focal_len_mm": float(d.get("focal_len_mm", 0.0)),
        "ccd_width_mm": float(d.get("ccd_width_mm", 0.0)),
        "ccd_height_mm": float(d.get("ccd_height_mm", 0.0)),
        "K": [float(x) for x in d.get("K", [0.0] * 9)],
        "dist_coeffs": [float(x) for x in d.get("dist_coeffs", [0.0] * 5)],
        "width_px": int(d.get("width_px", 0)),
        "height_px": int(d.get("height_px", 0)),
        "mount": {
            "yaw_deg": float(mount.get("yaw_deg", 0.0)),
            "pitch_deg": float(mount.get("pitch_deg", 0.0)),
            "roll_deg": float(mount.get("roll_deg", 0.0)),
        },
    }
    for opt in ("K_opt", "dist_coeffs_opt"):
        if opt in d:
            cfg[opt] = [float(x) for x in d[opt]]
    return cfg


def load(camera_key: str, db_dirs=None) -> dict | None:
    """Look up cameras/<camera_key>.json in the given DB dirs."""
    for dd in list(db_dirs or []) + [PACKAGE_DB]:
        path = os.path.join(dd, camera_key + ".json")
        if os.path.isfile(path):
            with open(path) as f:
                return config_from_dict(json.load(f))
    return None


def save(camera_key: str, cfg: dict, db_dir: str):
    os.makedirs(db_dir, exist_ok=True)
    with open(os.path.join(db_dir, camera_key + ".json"), "w") as f:
        json.dump(cfg, f, indent=4, sort_keys=True)


def estimate_from_exif(image_file: str,
                       ccd_width_mm: float | None = None) -> dict:
    """A starting camera config from EXIF: fx = focal_mm · width_px /
    ccd_width_mm (6.17 mm, a 1/2.3" sensor, by default), the principal
    point at the centre, no distortion."""
    from . import exif as exif_mod

    width_px, height_px = exif_mod.jpeg_size(image_file)
    focal_mm = exif_mod.focal_length_mm(image_file)
    _, make, model, lens = exif_mod.get_camera_info(image_file)
    if ccd_width_mm is None:
        ccd_width_mm = 6.17
    ccd_height_mm = ccd_width_mm * height_px / max(width_px, 1)
    fx = focal_mm * width_px / ccd_width_mm if ccd_width_mm > 0 else 0.0
    return config_from_dict({
        "make": make, "model": model, "lens_model": lens or "unknown",
        "focal_len_mm": focal_mm,
        "ccd_width_mm": ccd_width_mm, "ccd_height_mm": ccd_height_mm,
        "K": [fx, 0.0, width_px / 2.0, 0.0, fx, height_px / 2.0, 0.0, 0.0,
              1.0],
        "width_px": width_px, "height_px": height_px,
    })


def to_model(cfg: dict, optimized=False) -> CameraModel:
    """Camera-config dict → CameraModel of float32 CPU tensors (K_opt and
    dist_coeffs_opt when optimized=True and present)."""
    K = cfg.get("K_opt") if optimized and cfg.get("K_opt") else cfg["K"]
    d = (cfg.get("dist_coeffs_opt") if optimized and cfg.get("dist_coeffs_opt")
         else cfg["dist_coeffs"])
    return CameraModel(
        K=torch.from_numpy(np.array(K, np.float32).reshape(3, 3)),
        dist=torch.from_numpy(np.array(d, np.float32)),
        width=int(cfg.get("width_px", 0)),
        height=int(cfg.get("height_px", 0)),
    )

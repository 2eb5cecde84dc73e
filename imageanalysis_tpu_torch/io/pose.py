"""Pose ingestion: pix4d.csv / image-metadata.txt → aircraft and camera poses.

Port of ``imageanalysis_tpu/io/pose.py``:

- ``set_aircraft_poses`` (pose.py:33-98): parse the pose file (pix4d order
  'rpy', Sentera order 'ypr'), skip images with extreme attitudes
  (|roll|, |pitch| > max_angle = 25°), except gimbaled DJI and Hasselblad
  cameras, which are skipped only when the gimbal is not near nadir
  (pitch > −45°);
- ``compute_camera_poses`` (pose.py:101-121): camera quat = aircraft
  ned2body ⊗ mount body2cam, position = lla2ned of the aircraft.

Host-side Python; the attitude math runs in float32 through
``core.rotations``, as the reference's does. ``make_pix4d`` reads EXIF,
which the port cannot read yet: it raises.
"""

from __future__ import annotations

import os
import re

import numpy as np

from .logger import log
from .project import ImageRecord, ProjectMgr
from ..core import geodesy
from ..core.rotations import quat_multiply, ypr_from_quat

R2D = 180.0 / np.pi


def set_aircraft_poses(proj: ProjectMgr, posefile: str, order="ypr",
                       max_angle=25.0):
    """Write each listed image's aircraft pose into its meta/*.json;
    returns the number of images set."""
    log("Setting aircraft poses")
    image_files = set(proj.image_files())
    gimbaled = proj.camera.get("make", "") in ("DJI", "Hasselblad")

    count = 0
    with open(posefile) as f:
        by_index = False
        file_list = None
        for line in f:
            if re.match(r"^\s*#", line) or re.match(r"^\s*File", line):
                continue
            if re.match(r"^\s*Image", line):
                by_index = True
                file_list = proj.image_files()
                continue
            field = line.strip().split(",")
            if len(field) < 7:
                continue
            name = file_list[int(field[0]) - 1] if by_index else field[0]
            lat_deg, lon_deg, alt_m = (float(x) for x in field[1:4])
            if order == "ypr":
                yaw_deg, pitch_deg, roll_deg = (float(x) for x in field[4:7])
            else:  # 'rpy' (pix4d)
                roll_deg, pitch_deg, yaw_deg = (float(x) for x in field[4:7])
            flight_time = float(field[7]) if len(field) >= 8 else -1.0

            if name not in image_files:
                log("No image file:", name, "skipping ...")
                continue
            if gimbaled:
                if pitch_deg > -45:
                    log("gimbal not looking down:", name, "roll:", roll_deg,
                        "pitch:", pitch_deg)
                    continue
            elif abs(roll_deg) > max_angle or abs(pitch_deg) > max_angle:
                log("extreme attitude:", name, "roll:", roll_deg,
                    "pitch:", pitch_deg)
                continue

            rec = ImageRecord(proj.analysis_dir, os.path.splitext(name)[0])
            rec.set_aircraft_pose(lat_deg, lon_deg, alt_m, yaw_deg, pitch_deg,
                                  roll_deg, flight_time)
            rec.save_meta()
            count += 1
    log("Set aircraft poses for", count, "images")
    return count


def compute_camera_poses(proj: ProjectMgr):
    """Camera pose = aircraft attitude ⊗ mount offset; position in the
    project's NED frame."""
    log("Setting camera poses (offset from aircraft pose.)")
    ref = proj.ned_reference_lla()
    body2cam = proj.get_body2cam()
    for image in proj.image_list:
        n = image.node.node("aircraft_pose", create=False)
        if n is None or not n.has("lat_deg"):
            continue
        ned2body = np.asarray(n.getlist("quat"))
        ned2cam = quat_multiply(ned2body, body2cam)
        yaw, pitch, roll = (float(x) for x in ypr_from_quat(ned2cam))
        ned = geodesy.lla2ned(n.get("lat_deg"), n.get("lon_deg"),
                              n.get("alt_m"), ref[0], ref[1], ref[2])
        image.set_camera_pose(list(np.asarray(ned).ravel()), yaw * R2D,
                              pitch * R2D, roll * R2D, quat=ned2cam.numpy())
        image.save_meta()


def make_pix4d(image_dir, camera_make="", camera_model="",
               force_altitude=None, force_heading=None,
               yaw_from_groundtrack=False):
    """pix4d.csv from the images' EXIF (reference pose.py:123-177): needs
    an EXIF reader, which the port does not have yet."""
    raise NotImplementedError(
        f"{image_dir} has no pix4d.csv or image-metadata.txt, and making "
        "pix4d.csv from EXIF is not ported yet (ROADMAP.md queue 1, EXIF: "
        "io/exif.py, make_pix4d); write the pose file, or run the "
        "imageanalysis_tpu package's Step 2 once")

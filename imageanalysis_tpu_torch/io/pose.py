"""Pose ingestion: pix4d.csv / image-metadata.txt → aircraft and camera poses.

Port of ``imageanalysis_tpu/io/pose.py``:

- ``set_aircraft_poses`` (pose.py:33-98): parse the pose file (pix4d order
  'rpy', Sentera order 'ypr'), skip images with extreme attitudes
  (|roll|, |pitch| > max_angle = 25°), except gimbaled DJI and Hasselblad
  cameras, which are skipped only when the gimbal is not near nadir
  (pitch > −45°);
- ``compute_camera_poses`` (pose.py:101-121): camera quat = aircraft
  ned2body ⊗ mount body2cam, position = lla2ned of the aircraft.

- ``make_pix4d`` (pose.py:123-205): pix4d.csv from each image's EXIF
  and XMP (``io/exif``), the heading from the GPS ground track where the
  images carry no yaw.

Host-side Python; the attitude math runs in float32 through
``core.rotations``, as the reference's does.
"""

from __future__ import annotations

import csv
import os
import re

import numpy as np

from . import exif
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


def make_pix4d(image_dir: str, camera_make="", camera_model="",
               force_altitude=None, force_heading=None,
               yaw_from_groundtrack=False):
    """Write image_dir/pix4d.csv from each image's EXIF/XMP pose; returns
    its path.

    Raises RuntimeError for Phantom 4 cameras without force_altitude (their
    geotag altitude is wrong) and FileExistsError when pix4d.csv exists.
    """
    if (not force_altitude and camera_make == "DJI"
            and camera_model in ("FC330", "FC6310", "FC6310S")):
        raise RuntimeError(
            "Phantom 4 altitude metadata is unreliable; rerun with "
            "force_altitude=<true flight altitude MSL in meters>.")

    files = sorted(f for f in os.listdir(image_dir)
                   if f.lower().endswith((".jpg", ".jpeg")))
    images = []
    images_have_yaw = False
    for fname in files:
        lon_deg, lat_deg, alt_m, unixtime, yaw_deg, pitch_deg, roll_deg = \
            exif.get_pose(os.path.join(image_dir, fname))
        alt = force_altitude if force_altitude else alt_m
        roll = roll_deg if roll_deg is not None else 0.0
        if camera_make == "DJI" and camera_model == "FC7303":
            pitch_deg = -90.0  # the Mavic Mini 2's gimbal looks down
        pitch = pitch_deg if pitch_deg is not None else 0.0
        if force_heading is not None:
            yaw = force_heading
        elif yaw_deg is not None:
            images_have_yaw = True
            yaw = yaw_deg
        else:
            yaw = 0.0
        images.append([fname, lat_deg, lon_deg, alt, roll, pitch, yaw])

    if (not force_heading and not images_have_yaw) or yaw_from_groundtrack:
        log("estimating yaw from gps ground track")
        _fill_yaw_from_groundtrack(images)

    out = os.path.join(image_dir, "pix4d.csv")
    if os.path.exists(out):
        raise FileExistsError(f"{out} exists, please rename it and rerun.")
    log("Creating pix4d image pose file:", out, "images:", len(files))
    with open(out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["File Name", "Lat (decimal degrees)",
                    "Lon (decimal degrees)", "Alt (meters MSL)",
                    "Roll (decimal degrees)", "Pitch (decimal degrees)",
                    "Yaw (decimal degrees)"])
        for name, lat, lon, alt, roll, pitch, yaw in images:
            w.writerow([os.path.basename(name), "%.10f" % lat, "%.10f" % lon,
                        "%.2f" % alt, "%.2f" % roll, "%.2f" % pitch,
                        "%.2f" % yaw])
    return out


def _fill_yaw_from_groundtrack(images):
    """Distance-weighted average heading of the legs into and out of each
    image, in place (images rows: [name, lat, lon, alt, roll, pitch,
    yaw])."""
    n = len(images)
    for i in range(n):
        lat, lon = images[i][1], images[i][2]
        hx = hy = 0.0
        legs = []
        if i > 0:
            legs.append((lat, lon, images[i - 1][1], images[i - 1][2]))
        if i < n - 1:
            legs.append((images[i + 1][1], images[i + 1][2], lat, lon))
        for la, lo, ref_la, ref_lo in legs:
            ned = geodesy.lla2ned(la, lo, 0.0, ref_la, ref_lo, 0.0)
            dist = float(np.hypot(ned[0], ned[1]))
            if dist > 0:
                hdg = np.arctan2(ned[1], ned[0])
                hx += np.cos(hdg) * dist
                hy += np.sin(hdg) * dist
        avg = np.degrees(np.arctan2(hy, hx))
        if avg < 0:
            avg += 360.0
        images[i][6] = float(avg)

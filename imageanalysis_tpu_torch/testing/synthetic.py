"""Synthetic aerial missions for tests and on-card runs, without OpenCV.

The counterpart of part of ``imageanalysis_tpu/testing/synthetic.py``: a
seeded ground texture (blurred noise plus noise upsampled from 1/8 and
1/32 scale, as ``make_ground_texture`` there, or the periodically tiled
texture of ``make_tiled_texture``) viewed by nadir-ish cameras flying
parallel strips. Each frame is an exact homography of the ground plane,
rendered with bilinear sampling, so the planted frame-to-frame homographies
are known exactly. Frames are made in memory on the given device.

``write_workspace`` turns a mission and its detections into a project
workspace (config.json, meta/*.json, cache/*.feat, cache/*.desc; no image
files: ``ProjectMgr.load_images_info`` reads meta/ only) that both
packages' ``find_matches`` can run on.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import geodesy
from ..core.camera import BODY2CAM
from ..core.rotations import matrix_to_quat, ypr_from_quat
from ..features.sift import _gauss_kernel, blur_plain

REF_LLA = (44.97, -93.26, 0.0)       # the reference generator's NED origin
R2D = 180.0 / math.pi


def _normalize_u8(tex, rounding):
    tex = (tex - tex.min()) * (255.0 / (tex.max() - tex.min()))
    return (torch.round(tex) if rounding else tex).to(torch.uint8)


def make_ground_texture(rng, shape, device="cpu"):
    """(h, w) uint8 texture from numpy Generator rng, built on device."""
    h, w = shape
    noise = rng.uniform(0, 255, (h, w)).astype(np.float32)
    tex = blur_plain(torch.from_numpy(noise).to(device)[None],
                     _gauss_kernel(2.0))[0]
    # multi-scale structure so SIFT has features at several octaves
    for s in (8, 32):
        coarse = rng.uniform(0, 255, (max(h // s, 4), max(w // s, 4)))
        c = torch.from_numpy(coarse.astype(np.float32)).to(device)
        tex = tex + F.interpolate(c[None, None], size=(h, w), mode="bicubic",
                                  align_corners=False)[0, 0]
    return _normalize_u8(tex, rounding=True)


def make_tiled_texture(rng, shape, period=140, blur=1.5, device="cpu"):
    """(h, w) uint8 texture that repeats every `period` px: one blurred
    noise cell (reflect-101 borders), tiled — the reference's synthetic
    'row crop / forest canopy', where every feature has a near-identical
    twin one period away. Normalized and truncated to uint8 as the
    reference's cv2.normalize + astype."""
    h, w = shape
    cell = torch.from_numpy(
        rng.uniform(0, 255, (period, period)).astype(np.float32)).to(device)
    cell = blur_plain(cell[None], _gauss_kernel(blur))[0]
    tex = cell.repeat(-(-h // period), -(-w // period))[:h, :w]
    return _normalize_u8(tex, rounding=False)


def _rot(yaw, pitch, roll):
    """Camera attitude (radians) as a 3×3 rotation Rz·Ry·Rx."""
    cy, sy = math.cos(yaw), math.sin(yaw)
    cp, sp = math.cos(pitch), math.sin(pitch)
    cr, sr = math.cos(roll), math.sin(roll)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1.0]])
    Ry = np.array([[cp, 0, sp], [0, 1.0, 0], [-sp, 0, cp]])
    Rx = np.array([[1.0, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return Rz @ Ry @ Rx


# camera flight: metres above the ground, along-track overlap of
# neighbouring frames, and per-frame jitter of attitude (degrees) and of
# position (metres), so every frame is a distinct homography of the ground
ALTITUDE = 100.0
OVERLAP = 0.75
YAW_JITTER, TILT_JITTER, POS_JITTER = 3.0, 1.0, 1.0


class Mission(NamedTuple):
    frames: torch.Tensor     # (n, H, W) uint8 on the device
    ned: np.ndarray          # (n, 3) camera positions [north, east, down] m
    H_ij: Callable           # H_ij(i, j): 3×3, frame-i px → frame-j px
    cam_quat: np.ndarray     # (n, 4) NED→camera-body quats (reference)
    aircraft_ypr: np.ndarray  # (n, 3) aircraft yaw, pitch, roll, degrees
    K: np.ndarray            # (3, 3) intrinsics


# the reference's nadir mount: camera body = aircraft body pitched −90°,
# so the aircraft's body→NED matrix is the camera's times Ry(+90°)
_MOUNT_INV = np.array([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]])


def _reference_attitude(rot):
    """A frame's camera→NED rotation → (NED→body quat of the camera, the
    aircraft's (yaw, pitch, roll) in degrees) in the reference's
    convention: x_cam = BODY2CAM·Bᵀ·(p − ned), B = the camera body→NED
    matrix, and the camera body = aircraft body ⊗ a nadir mount (pitch
    −90°). The image x axis runs along-track (north), so the aircraft's
    nominal yaw is −90°."""
    B = rot @ BODY2CAM.astype(np.float64)
    q = matrix_to_quat(torch.from_numpy(B)).numpy()
    ypr = ypr_from_quat(matrix_to_quat(torch.from_numpy(B @ _MOUNT_INV)))
    return q, np.array([float(v) * R2D for v in ypr])


def make_mission(strips=4, per_strip=16, size=(2176, 1440), strip_gap=2.5,
                 seed=0, device="cpu", texture_period=None):
    """Render a strips × per_strip frame mission over a flat textured ground.

    size is (W, H) px; the focal length scales as 1400 px at W = 2176, as
    in benchmarks/mission_bench.py. Frames advance along the image x axis
    (north) by (1 − OVERLAP) of the footprint width; strips sit strip_gap
    along-track spacings apart (east). The texture's texel is one frame
    ground-sample distance, fine enough that small frames carry hundreds
    of features; texture_period (texels) tiles it instead
    (make_tiled_texture). The ground is the plane down = 0.

    Returns a Mission. Frame index = strip · per_strip + position."""
    W, H = size
    fx = 1400.0 * W / 2176.0
    rng = np.random.default_rng(seed)
    K = np.array([[fx, 0, W / 2.0], [0, fx, H / 2.0], [0, 0, 1.0]])
    Kinv = np.linalg.inv(K)
    spacing = (1.0 - OVERLAP) * W / fx * ALTITUDE
    G, positions, quats, yprs = [], [], [], []
    for s in range(strips):
        for k in range(per_strip):
            c0 = k * spacing + rng.normal(0, POS_JITTER)
            c1 = s * spacing * strip_gap + rng.normal(0, POS_JITTER)
            a = ALTITUDE + rng.normal(0, POS_JITTER)
            rot = _rot(*np.radians(rng.normal(0, [YAW_JITTER, TILT_JITTER,
                                                  TILT_JITTER])))
            # ground point (g0, g1) of pixel p: along the ray rot·K⁻¹·p
            # (north, east, down) from the camera at height a,
            # projectively [a·d0 + c0·d2, ...]
            M = np.array([[a, 0, c0], [0, a, c1], [0, 0, 1.0]])
            G.append(M @ rot @ Kinv)
            positions.append([c0, c1, -a])
            q, ypr = _reference_attitude(rot)
            quats.append(q)
            yprs.append(ypr)
    G = np.stack(G)

    res = ALTITUDE / fx                 # one texel per frame pixel
    corners = np.array([[0, 0, 1], [W, 0, 1], [0, H, 1], [W, H, 1.0]]).T
    g = G @ corners
    g = g[:, :2] / g[:, 2:]
    margin = 8 * res
    lo = g.min(axis=(0, 2)) - margin
    hi = g.max(axis=(0, 2)) + margin
    tw, th = (int(math.ceil(v)) for v in (hi - lo) / res)
    if texture_period:
        tex = make_tiled_texture(rng, (th, tw), texture_period,
                                 device=device).float()
    else:
        tex = make_ground_texture(rng, (th, tw), device).float()

    # frame pixel → texture pixel (col, row), one matrix per frame
    S_inv = np.array([[1 / res, 0, -lo[0] / res], [0, 1 / res, -lo[1] / res],
                      [0, 0, 1.0]])
    T = torch.from_numpy((S_inv @ G).astype(np.float32)).to(device)
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                          torch.arange(W, dtype=torch.float32, device=device),
                          indexing="ij")
    frames = []
    for t in T:
        z = t[2, 0] * u + t[2, 1] * v + t[2, 2]
        tx = (t[0, 0] * u + t[0, 1] * v + t[0, 2]) / z
        ty = (t[1, 0] * u + t[1, 1] * v + t[1, 2]) / z
        x0 = tx.floor().clamp(0, tw - 2)
        y0 = ty.floor().clamp(0, th - 2)
        wx = (tx - x0).clamp(0, 1)
        wy = (ty - y0).clamp(0, 1)
        xi, yi = x0.long(), y0.long()
        top = tex[yi, xi] * (1 - wx) + tex[yi, xi + 1] * wx
        bot = tex[yi + 1, xi] * (1 - wx) + tex[yi + 1, xi + 1] * wx
        frames.append(torch.round(top * (1 - wy) + bot * wy)
                      .clamp(0, 255).to(torch.uint8))

    def H_ij(i, j):
        return np.linalg.inv(G[j]) @ G[i]

    return Mission(torch.stack(frames), np.asarray(positions), H_ij,
                   np.stack(quats), np.stack(yprs), K)


def image_name(i):
    return f"IMG_{i:04d}"


def write_workspace(project_dir, mission, dets):
    """Write a project workspace for the mission and its detections
    dets[i] = (kp (n, 2), meta (n, 4), desc (n, 128) 0..255): config.json
    (camera, nadir mount, NED reference), meta/IMG_nnnn.json (aircraft
    pose as lla + ypr, camera pose as NED + quat) and the .feat/.desc
    caches. Returns the ProjectMgr with its image list loaded."""
    from ..io import camera_db
    from ..io.project import ImageRecord, ProjectMgr

    proj = ProjectMgr(project_dir, create=True)
    K = mission.K
    H, W = mission.frames.shape[1:]
    cfg = camera_db.config_from_dict({
        "make": "Synthetic", "model": "TorchCam", "lens_model": "none",
        "K": K.ravel().tolist(), "dist_coeffs": [0.0] * 5,
        "width_px": int(W), "height_px": int(H),
        "mount": {"yaw_deg": 0.0, "pitch_deg": -90.0, "roll_deg": 0.0}})
    proj.set_camera_config(cfg)
    ref = proj.config.node("ned_reference")
    for key, v in zip(("lat_deg", "lon_deg", "alt_m"), REF_LLA):
        ref.set(key, float(v))
    proj.save()
    lla = geodesy.ned2lla(mission.ned, *REF_LLA)
    for i, (kp, meta, desc) in enumerate(dets):
        im = ImageRecord(proj.analysis_dir, image_name(i))
        y, p, r = mission.aircraft_ypr[i]
        im.set_aircraft_pose(*lla[i], y, p, r)
        cy, cp, cr = (float(v) * R2D for v in ypr_from_quat(
            torch.from_numpy(mission.cam_quat[i])))
        im.set_camera_pose(mission.ned[i], cy, cp, cr,
                           quat=mission.cam_quat[i])
        im.set_size(W, H)
        im.save_meta()
        im.kp = np.asarray(kp, np.float32)
        im.kp_meta = np.asarray(meta, np.float32)
        im.des = np.asarray(desc, np.float32)
        im.save_features()
        im.save_descriptors()
    proj.load_images_info()
    return proj

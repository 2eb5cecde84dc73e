"""Synthetic aerial missions for tests and on-card runs, without OpenCV.

Two generators. ``SyntheticMission`` and ``WorldTexture`` are the
reference's own (``imageanalysis_tpu/testing/synthetic.py:56-259``), with
its arguments and numpy draws, so poses and pix4d.csv come out byte for
byte; their textures (``cv_ground_texture``, ``cv_tiled_texture``) follow
the arithmetic of the OpenCV calls the reference makes, on any device,
and each frame is written as it is rendered, so a mission of thousands of
frames holds one frame and one texture patch on the card. The rest of
this module is the port's own generator, described below.

The port's own, ``make_mission``, follows the reference's recipe, not its
arithmetic: a seeded ground texture (blurred noise plus noise upsampled
from 1/8 and 1/32 scale, as ``make_ground_texture`` there, or the
periodically tiled texture of ``make_tiled_texture``) viewed by
nadir-ish cameras flying parallel strips. Each frame is an exact
homography of the ground plane, rendered with bilinear sampling, so the
planted frame-to-frame homographies are known exactly. Frames are made
in memory on the given device.

``write_workspace`` turns a mission and its detections into a project
workspace (config.json, meta/*.json, cache/*.feat, cache/*.desc; no image
files: ``ProjectMgr.load_images_info`` reads meta/ only) that both
packages' ``find_matches`` can run on.

``write_mission`` writes a mission as the folder a survey team hands to
``apps/process.py``: the frames as 3-channel JPEGs at quality 95
(``io/jpeg.encode_bgr``: nvJPEG for frames on the card), ``pix4d.csv``
and the camera's DB entry; the counterpart of the reference's
``SyntheticMission.generate`` (synthetic.py:138-250). With ``exif=True``
(test support the reference lacks) the poses go into each frame's EXIF
and DJI-style XMP instead of ``pix4d.csv``, written by ``io/exif``.

``make_ba_mission_graph`` and ``make_ba_grid_graph`` draw the synthetic
bundle-adjustment graphs of ``scripts_dev/ba_synth_scale.py`` (the
2812-camera mission) and ``scripts_dev/ba_f64_oracle.py`` (the f64
oracle's grid) with torch on the given device.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import geodesy
from ..core.camera import BODY2CAM
from ..core.rotations import matrix_to_quat, ypr_from_quat
from ..features.sift import _gauss_kernel, blur_plain
from ..io import jpeg

REF_LLA = (44.97, -93.26, 0.0)       # the reference generator's NED origin
R2D = 180.0 / math.pi


def _normalize_u8(tex, rounding):
    tex = (tex - tex.min()) * (255.0 / (tex.max() - tex.min()))
    return (torch.round(tex) if rounding else tex).to(torch.uint8)


def make_ground_texture(rng, shape, device="cuda"):
    """(h, w) uint8 texture from numpy Generator rng, built on device: the
    recipe of the reference's make_ground_texture, not its arithmetic. It
    blurs with K2's plain version (13 taps at σ = 2: radius ⌈3σ⌉, where
    cv2.GaussianBlur takes 17), draws max(h // s, 4) × max(w // s, 4)
    coarse noise, resizes it with F.interpolate's bicubic and rounds to
    uint8 where the reference truncates. make_mission's frames (phases
    7-21 of chip_smoke.py) rest on it, so it stays as it is;
    cv_ground_texture follows the reference's arithmetic."""
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


def make_tiled_texture(rng, shape, period=140, blur=1.5, device="cuda"):
    """(h, w) uint8 texture that repeats every `period` px: one blurred
    noise cell (reflect-101 borders), tiled — the reference's synthetic
    'row crop / forest canopy', where every feature has a near-identical
    twin one period away. Normalized and truncated to uint8 as the
    reference's cv2.normalize + astype, but blurred with K2's plain
    version (11 taps at σ = 1.5, where cv2.GaussianBlur takes 13);
    cv_tiled_texture follows the reference's arithmetic."""
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

    @property
    def names(self):
        """The frames' image names, in order."""
        return [image_name(i) for i in range(len(self.ned))]

    def true_camera_ned(self, ref_lla=None):
        """The cameras' true NED positions, optionally in another NED
        reference (the one the pipeline computed)."""
        if ref_lla is None:
            return self.ned
        lla = geodesy.ned2lla(self.ned, *REF_LLA)
        return geodesy.lla2ned(lla[:, 0], lla[:, 1], lla[:, 2], *ref_lla)


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
                 seed=0, device="cuda", texture_period=None):
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


CAMERA_KEY = "Synthetic_TestCam_none"   # write_mission's camera DB key


def camera_config(mission):
    """The mission camera's DB entry, in the reference's form
    (synthetic.py:241-250): an 8 mm lens, no distortion."""
    H, W = mission.frames.shape[1:]
    fx = float(mission.K[0, 0])
    return {
        "make": "Synthetic", "model": "TestCam", "lens_model": "none",
        "K": mission.K.ravel().tolist(), "dist_coeffs": [0.0] * 5,
        "width_px": int(W), "height_px": int(H),
        "focal_len_mm": 8.0, "ccd_width_mm": 8.0 * W / fx,
        "ccd_height_mm": 8.0 * H / fx,
    }


# the EXIF that write_mission(exif=True) writes: the camera's DB key
# Synthetic_TestCam_none, a 1/2.3" sensor (estimate_from_exif's default
# width) and capture times one second apart
EXIF_MAKE, EXIF_MODEL, EXIF_LENS = "Synthetic", "TestCam", "none"
EXIF_CCD_WIDTH_MM = 6.17
EXIF_T0 = 1_700_000_000.0


def xmp_segment(yaw, pitch, roll):
    """A DJI-style XMP APP1 segment holding the gimbal's attitude."""
    xmp = ('<x:xmpmeta xmlns:x="adobe:ns:meta/"><rdf:RDF xmlns:rdf='
           '"http://www.w3.org/1999/02/22-rdf-syntax-ns#"><rdf:Description '
           'rdf:about="" xmlns:drone-dji="http://www.dji.com/drone-dji/1.0/"'
           f' drone-dji:GimbalYawDegree="{yaw:.6f}"'
           f' drone-dji:GimbalPitchDegree="{pitch:.6f}"'
           f' drone-dji:GimbalRollDegree="{roll:.6f}"/></rdf:RDF>'
           '</x:xmpmeta>').encode()
    payload = b"http://ns.adobe.com/xap/1.0/\x00" + xmp
    return b"\xff\xe1" + (len(payload) + 2).to_bytes(2, "big") + payload


def tag_frame(path, lla, ypr, fx, unixtime):
    """Tag a JPEG as a drone's camera would: the XMP attitude ypr (yaw,
    pitch, roll degrees) after SOI, then (through io/exif's writer) Make,
    Model, LensModel, FocalLength (f_mm · width / EXIF_CCD_WIDTH_MM = fx),
    GPS from lla and DateTime from unixtime."""
    from ..io import exif

    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[:2] + xmp_segment(*ypr) + data[2:])
    f_mm = fx * EXIF_CCD_WIDTH_MM / exif.jpeg_size(path)[0]
    exif.write_segment(path, exif.exif_segment(
        {exif.MAKE: (exif.ASCII, EXIF_MAKE.encode() + b"\0"),
         exif.MODEL: (exif.ASCII, EXIF_MODEL.encode() + b"\0")},
        {exif.FOCAL_LENGTH: (exif.RATIONAL, ((round(f_mm * 1e6), 10 ** 6),)),
         exif.LENS_MODEL: (exif.ASCII, EXIF_LENS.encode() + b"\0")}, {}))
    exif.write_geotag(path, lla[0], lla[1], lla[2], unixtime=unixtime)


def write_mission(project_dir, mission, db_dir, quality=95, exif=False):
    """Write the mission as a project folder: IMG_nnnn.jpg (each gray frame
    as B = G = R, JPEG at quality, encoded on the frames' device) and the
    camera's DB entry db_dir/<CAMERA_KEY>.json; then either pix4d.csv (lat,
    lon, alt and the aircraft's roll, pitch, yaw, in the reference's
    format, synthetic.py:230-239) or, with exif=True, no pose file and the
    same poses in each frame's EXIF and DJI-style XMP (tag_frame).
    Returns the image paths."""
    from ..io import camera_db

    os.makedirs(project_dir, exist_ok=True)
    paths = []
    for i, frame in enumerate(mission.frames):
        paths.append(os.path.join(project_dir, image_name(i) + ".jpg"))
        jpeg.encode_bgr(frame[..., None].expand(-1, -1, 3), paths[-1],
                        quality)
    lla = geodesy.ned2lla(mission.ned, *REF_LLA)
    camera_db.save(CAMERA_KEY, camera_config(mission), db_dir)
    if exif:
        for i, path in enumerate(paths):
            tag_frame(path, lla[i], mission.aircraft_ypr[i],
                      float(mission.K[0, 0]), EXIF_T0 + i)
        return paths
    lines = ["File Name,Lat (decimal degrees),Lon (decimal degrees),"
             "Alt (meters MSL),Roll (decimal degrees),"
             "Pitch (decimal degrees),Yaw (decimal degrees)"]
    for path, (lat, lon, alt), (y, p, r) in zip(paths, lla,
                                                mission.aircraft_ypr):
        lines.append(f"{os.path.basename(path)},{lat:.10f},{lon:.10f},"
                     f"{alt:.2f},{r:.2f},{p:.2f},{y:.2f}")
    with open(os.path.join(project_dir, "pix4d.csv"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return paths


class BAProblem(NamedTuple):
    """A synthetic bundle-adjustment graph, tensors on one device:
    truth and perturbed start ([ned, NED→body quat] cameras, NED points),
    observations (ba.bundle.BAObservations) and the intrinsics."""

    cams_true: torch.Tensor
    pts_true: torch.Tensor
    cams0: torch.Tensor
    pts0: torch.Tensor
    obs: tuple
    K: torch.Tensor
    dist: torch.Tensor


def make_ba_mission_graph(n_cam=2812, n_pt=1_354_000, obs_per_pt=3,
                          px_noise=0.5, seed=0, device="cuda",
                          dtype=torch.float32, observers="distinct"):
    """The mission-scale BA graph of scripts_dev/ba_synth_scale.py, drawn
    with torch on device: n_cam nadir cameras on a 30 m lawnmower grid at
    60 m, n_pt ground points (±40 m around a random camera, ±8 m of
    height), each seen by obs_per_pt cameras up to two grid steps from
    that camera along its row (observations sorted by point), f = 2000
    px, no distortion, uv noise px_noise px; the start perturbs cameras
    by N(0, 1 m) and N(0, 0.01) per quaternion component, points by
    N(0, 2 m). The defaults give 4,062,000 observations.

    observers says how a point's cameras are drawn:

    - "flat", as the script: each the flat index ±2 clipped to the grid,
      which at a row's end wraps to the far end of the next row, 1,590 m
      away at 60 m height. Under the start's ~1° attitude noise such rays
      graze the image plane (camera z → 0, residuals of 1e8 px), and f32
      LM accepts no first step in either package;
    - "row": each the column ±2 clipped to the point's row. As in the
      script, the draws repeat: 4% of the points are seen three times by
      one camera, their depth unobservable, and LM's steps slide them
      hundreds of metres along their rays;
    - "distinct" (the default): obs_per_pt different cameras of the
      row, each within two steps of the point's camera, as a chain of
      matches sees each image once."""
    from ..ba.bundle import BAObservations
    from ..core.camera import project_ned_quat
    from ..core.rotations import quat_from_ypr, quat_multiply

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float64) * std

    side = math.ceil(math.sqrt(n_cam))
    i = torch.arange(n_cam, device=dev, dtype=torch.float64)
    cam_ned = torch.stack([(i % side) * 30.0, (i // side) * 30.0,
                           torch.full_like(i, -60.0)], dim=1)
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    q_nadir = quat_multiply(quat_from_ypr(zero, zero, zero),
                            quat_from_ypr(zero, zero - math.pi / 2, zero))
    cams = torch.cat([cam_ned, q_nadir.expand(n_cam, 4)], dim=1)
    pt_cam = torch.randint(0, n_cam, (n_pt,), generator=gen, device=dev)
    off = (torch.rand((n_pt, 3), generator=gen, device=dev,
                      dtype=torch.float64) * 80.0 - 40.0)
    pts = cam_ned[pt_cam] * cam_ned.new_tensor([1.0, 1.0, 0.0]) \
        + off * off.new_tensor([1.0, 1.0, 0.2])
    row, col = pt_cam // side * side, pt_cam % side
    if observers == "distinct":
        lo = (col - 2).clamp(min=0)
        width = torch.minimum(col + 2, (n_cam - row).clamp(max=side) - 1) \
            - lo + 1
        if int(width.min()) < obs_per_pt:
            raise ValueError("fewer cameras within two steps than "
                             "obs_per_pt")
        keys = torch.rand((n_pt, 5), generator=gen, device=dev)
        keys[torch.arange(5, device=dev)[None, :] >= width[:, None]] = 2.0
        near = (row + lo)[:, None] + keys.argsort(dim=1)[:, :obs_per_pt]
    else:
        step = torch.randint(-2, 3, (n_pt, obs_per_pt), generator=gen,
                             device=dev)
        near = (pt_cam[:, None] + step if observers == "flat" else
                row[:, None] + (col[:, None] + step).clamp(0, side - 1))
    cam_idx = near.clamp(0, n_cam - 1).reshape(-1)
    pt_idx = torch.arange(n_pt, device=dev).repeat_interleave(obs_per_pt)
    K = torch.tensor([[2000.0, 0, 1088], [0, 2000.0, 720], [0, 0, 1]],
                     dtype=torch.float64, device=dev)
    dist = torch.zeros(5, dtype=torch.float64, device=dev)
    uv, _ = project_ned_quat(pts[pt_idx], cams[cam_idx, :3],
                             cams[cam_idx, 3:7], K, dist)
    uv = uv + normal(uv.shape, px_noise)
    cams0 = cams + normal(cams.shape, 1.0) * cams.new_tensor(
        [1, 1, 1, 0.01, 0.01, 0.01, 0.01])
    pts0 = pts + normal(pts.shape, 2.0)
    obs = BAObservations(cam_idx, pt_idx, uv.to(dtype),
                         torch.ones(len(cam_idx), dtype=dtype, device=dev))
    return BAProblem(cams.to(dtype), pts.to(dtype), cams0.to(dtype),
                     pts0.to(dtype), obs, K.to(dtype), dist.to(dtype))


def make_ba_grid_graph(n_cam=300, n_pt=6000, obs_per_pt=4, px_noise=0.3,
                       seed=1, device="cuda", dtype=torch.float64):
    """The aerial grid of scripts_dev/ba_f64_oracle.py (tests/test_ba.py's
    synth_problem, vectorized), drawn with torch on device: n_cam cameras
    on a 40 m grid at ~120 m, near-nadir attitudes (pitch −88°, N(0, 0.2)
    rad yaw, N(0, 0.03) pitch and roll), n_pt points over the grid ±8 m in
    height, each seen by its obs_per_pt nearest cameras where it lands in
    the 1920×1440 frame (f = 1800 px); uv noise px_noise px; the start
    perturbs positions by N(0, 1.5 m), attitudes by N(0, 0.01) rad ypr and
    points by N(0, 3 m). Built in float64, returned in dtype."""
    from ..ba.bundle import BAObservations
    from ..core.camera import project_ned_quat
    from ..core.rotations import quat_from_ypr, quat_multiply

    dev = torch.device(device)
    f64 = torch.float64
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=dev, dtype=f64) * std

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=dev,
                          dtype=f64) * (hi - lo) + lo

    side = math.ceil(math.sqrt(n_cam))
    i = torch.arange(n_cam, device=dev)
    ned = torch.stack([(i // side).to(f64) * 40.0, (i % side).to(f64) * 40.0,
                       -120.0 + normal((n_cam,), 2.0)], dim=1)
    quats = quat_from_ypr(normal((n_cam,), 0.2),
                          math.radians(-88) + normal((n_cam,), 0.03),
                          normal((n_cam,), 0.03))
    cams_true = torch.cat([ned, quats], dim=1)
    span = side * 40.0
    pts_true = torch.cat([uniform((n_pt, 2), -30.0, span + 30.0),
                          uniform((n_pt, 1), -8.0, 8.0)], dim=1)
    d = torch.cdist(pts_true[:, :2], ned[:, :2])
    near = torch.topk(d, obs_per_pt, dim=1, largest=False).indices
    pt_idx = torch.arange(n_pt, device=dev).repeat_interleave(obs_per_pt)
    cam_idx = near.reshape(-1)
    K = torch.tensor([[1800.0, 0, 960.0], [0, 1800.0, 720.0], [0, 0, 1.0]],
                     dtype=f64, device=dev)
    dist = torch.zeros(5, dtype=f64, device=dev)
    pred, z = project_ned_quat(pts_true[pt_idx], cams_true[cam_idx, :3],
                               cams_true[cam_idx, 3:7], K, dist)
    keep = ((z > 0) & (pred[:, 0] >= 0) & (pred[:, 0] < 1920)
            & (pred[:, 1] >= 0) & (pred[:, 1] < 1440))
    uv = pred[keep] + normal((int(keep.sum()), 2), px_noise)
    cams0 = cams_true.clone()
    cams0[:, :3] += normal((n_cam, 3), 1.5)
    dq = quat_from_ypr(*normal((3, n_cam), 0.01))
    cams0[:, 3:7] = quat_multiply(cams0[:, 3:7], dq)
    pts0 = pts_true + normal(pts_true.shape, 3.0)
    obs = BAObservations(cam_idx[keep], pt_idx[keep], uv.to(dtype),
                         torch.ones(len(uv), dtype=dtype, device=dev))
    return BAProblem(cams_true.to(dtype), pts_true.to(dtype),
                     cams0.to(dtype), pts0.to(dtype), obs, K.to(dtype),
                     dist.to(dtype))


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


# ---------------------------------------------------------------------------
# the reference's generator: imageanalysis_tpu/testing/synthetic.py:26-259
# ---------------------------------------------------------------------------
#
# The textures follow what OpenCV's CPU code computes there (its AVX2
# loops), in float32 on any device: cv2.GaussianBlur's float kernel
# (cv2.getGaussianKernel, round(8σ + 1) | 1 taps; the row pass a chain of
# fmas from the first tap, the column pass symmetric, the two taps at ±k
# added before their fma; the loops' scalar tails unfused), reflect-101
# borders; cv2.resize INTER_CUBIC (a = −0.75, half-pixel centres, the
# source index clamped, coefficients in float64 rounded to float32, each
# pass (t0 + t1) + (t2 + t3)); cv2.normalize NORM_MINMAX (x·α + β as an
# fma, α = 255·(1/(max − min)) and β = −min·α rounded to float32) and the
# reference's truncating astype(np.uint8). An fma is emulated in float64,
# where the product of two float32 values is exact, so the card and the
# CPU give the same bits. OpenCV's optimized resize (IPP) sums in an order
# of its own, so a texture differs from the reference's by one gray level
# on a few texels in a million.

def cv_gaussian_taps(sigma):
    """cv2.getGaussianKernel(n, sigma, CV_32F) with cv2.GaussianBlur's n
    for a float image and ksize (0, 0): round(8σ + 1) | 1."""
    n = int(round(sigma * 8 + 1)) | 1
    x = np.arange(n) - (n - 1) * 0.5
    k = np.exp(-0.5 * x * x / (sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def cv_gaussian_blur(img, sigma):
    """cv2.GaussianBlur(img, (0, 0), sigma) of an (H, W) float32 tensor.
    OpenCV's vector loops fuse each tap into an fma; its scalar tails (the
    row pass past a multiple of 4 columns, the column pass past a multiple
    of 8) multiply and add."""
    k = [float(v) for v in cv_gaussian_taps(sigma)]
    r = len(k) // 2
    H, W = img.shape

    def rows(x, w, fused):
        s = x[:, :w] * k[0]
        for j in range(1, len(k)):
            if fused:
                s = s.double().add_(x[:, j:j + w].double(), alpha=k[j]) \
                    .float()
            else:
                s = s + x[:, j:j + w] * k[j]
        return s

    def cols(y, fused):
        out = y[r:r + H] * k[r]
        for j in range(1, r + 1):
            pair = y[r + j:r + j + H] + y[r - j:r - j + H]
            if fused:
                out = out.double().add_(pair.double(), alpha=k[r + j]) \
                    .float()
            else:
                out = out + pair * k[r + j]
        return out

    x = F.pad(img[None, None], (r, r, 0, 0), mode="reflect")[0, 0]
    s = rows(x, W, True)
    t = W - W % 4
    s[:, t:] = rows(x[:, t:], W - t, False)
    y = F.pad(s[None, None], (0, 0, r, r), mode="reflect")[0, 0]
    out = cols(y, True)
    t = W - W % 8
    out[:, t:] = cols(y[:, t:], False)
    return out


def _cubic_taps(n_in, n_out, device):
    """cv2.resize INTER_CUBIC along one axis: (n_out, 4) source indices,
    clamped, and their float32 coefficients."""
    fx = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    sx = np.floor(fx)
    x = fx - sx
    A = -0.75
    c0 = ((A * (x + 1) - 5 * A) * (x + 1) + 8 * A) * (x + 1) - 4 * A
    c1 = ((A + 2) * x - (A + 3)) * x * x + 1
    c2 = ((A + 2) * (1 - x) - (A + 3)) * (1 - x) * (1 - x) + 1
    c = np.stack([c0, c1, c2, 1 - c0 - c1 - c2], axis=1).astype(np.float32)
    idx = np.clip(sx.astype(np.int64)[:, None] + np.arange(-1, 3), 0,
                  n_in - 1)
    return (torch.from_numpy(idx).to(device),
            torch.from_numpy(c).to(device))


def cv_resize_cubic(img, size):
    """cv2.resize(img, (w, h), interpolation=INTER_CUBIC) of an (H, W)
    float32 tensor; size is (h, w)."""
    H, W = img.shape
    xi, xc = _cubic_taps(W, size[1], img.device)
    yi, yc = _cubic_taps(H, size[0], img.device)

    def taps4(t):
        return (t[0] + t[1]) + (t[2] + t[3])

    g = img[:, xi]
    rows = taps4([g[..., k] * xc[:, k] for k in range(4)])
    return taps4([rows[yi[:, k]] * yc[:, k:k + 1] for k in range(4)])


def cv_normalize_u8(img):
    """cv2.normalize(img, None, 0, 255, NORM_MINMAX).astype(np.uint8)."""
    lo, hi = float(img.min()), float(img.max())
    scale = 255.0 * (1.0 / (hi - lo)) if hi - lo > 2.220446049250313e-16 \
        else 0.0
    a, b = (float(np.float32(v)) for v in (scale, -lo * scale))
    # x·α + β as one fma: the float64 product of two float32 is exact
    return (img.double() * a + b).float().to(torch.uint8)


def cv_ground_texture(rng, size=2048, blur=2.0, device="cuda"):
    """The reference's make_ground_texture (synthetic.py:26-38) on device:
    the same draws of numpy Generator rng ((size, size), then size//8 and
    size//32 squares), blurred noise plus the coarse noise resized
    INTER_CUBIC, normalized and truncated. (size, size) uint8."""
    def uniform(n):
        return torch.from_numpy(
            rng.uniform(0, 255, (n, n)).astype(np.float32)).to(device)

    tex = cv_gaussian_blur(uniform(size), blur)
    for s in (8, 32):
        tex = tex + cv_resize_cubic(uniform(size // s), (size, size))
    return cv_normalize_u8(tex)


def cv_tiled_texture(rng, size=2048, period=140, blur=1.5, device="cuda"):
    """The reference's make_tiled_texture (synthetic.py:41-53) on device:
    one blurred (period, period) noise cell of rng, tiled to (size, size),
    normalized and truncated."""
    cell = torch.from_numpy(rng.uniform(0, 255, (period, period))
                            .astype(np.float32)).to(device)
    cell = cv_gaussian_blur(cell, blur)
    reps = -(-size // period)
    return cv_normalize_u8(cell.repeat(reps, reps)[:size, :size])


class WorldTexture:
    """The reference's unbounded ground (synthetic.py:56-107): tile_m-metre
    tiles of cv_ground_texture, each seeded by its indices, built on device
    when first seen and kept in a first-in first-out cache of cache_tiles;
    patch concatenates the tiles under a ground rectangle."""

    def __init__(self, seed, res=0.15, tile_m=256.0, cache_tiles=32,
                 device="cuda"):
        self.seed = int(seed)
        self.res = res
        self.tile_m = tile_m
        self.tile_px = int(round(tile_m / res))
        self.cache_tiles = cache_tiles
        self.device = torch.device(device)
        self._cache = {}        # (ti, tj) → tile, oldest first

    def tile_seed(self, ti, tj):
        """The tile's seed, in Python integers: ti and tj go negative west
        and south of the origin."""
        return (self.seed * 1_000_003 + ti * 7919 + tj * 104729) \
            & 0x7FFFFFFF

    def _tile(self, ti, tj):
        key = (ti, tj)
        if key not in self._cache:
            rng = np.random.default_rng(self.tile_seed(ti, tj))
            self._cache[key] = cv_ground_texture(rng, self.tile_px,
                                                 device=self.device)
            if len(self._cache) > self.cache_tiles:
                del self._cache[next(iter(self._cache))]
        return self._cache[key]

    def patch(self, n_min, e_min, n_max, e_max):
        """(tex (h, w) uint8 on the device, S 3×3 mapping texture px →
        world (n, e, 1)) covering the NED-aligned ground rectangle."""
        ti0, ti1 = (int(math.floor(v / self.tile_m)) for v in (n_min, n_max))
        tj0, tj1 = (int(math.floor(v / self.tile_m)) for v in (e_min, e_max))
        tex = torch.cat([torch.cat([self._tile(ti, tj)
                                    for tj in range(tj0, tj1 + 1)], dim=1)
                         for ti in range(ti0, ti1 + 1)], dim=0)
        # pixel (px, py) → n = n0 + py·res, e = e0 + px·res
        S = np.array([[0.0, self.res, ti0 * self.tile_m],
                      [self.res, 0.0, tj0 * self.tile_m],
                      [0.0, 0.0, 1.0]])
        return tex, S


@functools.lru_cache(maxsize=None)
def _libm():
    """The C library's sinf and cosf, which XLA's CPU backend calls: the
    reference's float32 attitude."""
    import ctypes
    import ctypes.util

    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    for name in ("sinf", "cosf"):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    return lib


def _quat_multiply_f32(q1, q0):
    """Hamilton product q1 ⊗ q0 of float32 [w, x, y, z] quats."""
    w1, x1, y1, z1 = q1
    w0, x0, y0, z0 = q0
    return np.array([w1 * w0 - x1 * x0 - y1 * y0 - z1 * z0,
                     w1 * x0 + x1 * w0 + y1 * z0 - z1 * y0,
                     w1 * y0 - x1 * z0 + y1 * w0 + z1 * x0,
                     w1 * z0 + x1 * y0 - y1 * x0 + z1 * w0], np.float32)


def _quat_from_ypr_f32(yaw, pitch, roll):
    """The reference's float32 quat_from_ypr of radians on the host:
    qz(yaw) ⊗ qy(pitch) ⊗ qx(roll). Equal to it bit for bit where each
    component of a product has one nonzero term (pitch = roll = 0, as in
    every mission): XLA contracts the sums into fmas."""
    qs = []
    for axis, angle in ((2, yaw), (1, pitch), (0, roll)):
        half = float(np.float32(angle) * np.float32(0.5))
        q = np.array([_libm().cosf(half), 0.0, 0.0, 0.0], np.float32)
        q[1 + axis] = _libm().sinf(half)
        qs.append(q)
    return _quat_multiply_f32(_quat_multiply_f32(qs[0], qs[1]), qs[2])


def _quat_to_matrix_f32(q):
    """The reference's float32 quat_to_matrix on the host: q normalized by
    its norm as XLA's CPU code computes it (a chain of fmas), then the
    body→NED matrix."""
    f32 = np.float32

    def fma(a, b, c):
        return f32(np.float64(a) * np.float64(b) + np.float64(c))

    w, x, y, z = q
    n = max(np.sqrt(fma(z, z, fma(y, y, fma(x, x, w * w)))), f32(1e-12))
    w, x, y, z = (f32(v / n) for v in (w, x, y, z))
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    one, two = f32(1.0), f32(2.0)
    return np.array([
        [one - two * (yy + zz), two * (xy - wz), two * (xz + wy)],
        [two * (xy + wz), one - two * (xx + zz), two * (yz - wx)],
        [two * (xz - wy), two * (yz + wx), one - two * (xx + yy)]],
        np.float32)


class SyntheticMission:
    """The reference's SyntheticMission (synthetic.py:109-259) with the
    same arguments and numpy draws, rendering on device: poses and
    pix4d.csv come out as the reference's, byte for byte; each frame is
    the reference's cv2.warpPerspective(tex, world_to_image_H · S, INTER
    _LINEAR) as render/geotiff.warp_frame computes it, written as a
    3-channel JPEG at quality 95 by io/jpeg.encode_bgr (nvJPEG on the
    card, cv2.imwrite on the CPU) before the next is made. The device
    holds the texture (or the current patch of a WorldTexture, and its
    tile cache) and one frame."""

    def __init__(self, project_dir, n_images=6, img_size=(800, 600),
                 altitude=100.0, spacing=18.0, fx=700.0, texture_res=0.25,
                 yaw_jitter=3.0, pos_jitter=1.0, seed=7, rows=1,
                 texture_px=2048, world_tiles=False, texture_period=None,
                 device="cuda"):
        self.project_dir = project_dir
        self.n_images = n_images
        self.w, self.h = img_size
        self.alt = altitude
        self.fx = fx
        self.K = np.array([[fx, 0, self.w / 2.0], [0, fx, self.h / 2.0],
                           [0, 0, 1.0]])
        self.rng = np.random.default_rng(seed)
        self.texture_res = texture_res
        self.spacing = spacing
        self.yaw_jitter = yaw_jitter
        self.pos_jitter = pos_jitter
        self.rows = rows
        self.texture_px = texture_px
        self.world_tiles = world_tiles
        self.texture_period = texture_period
        self.device = torch.device(device)
        self.world = None  # generate's WorldTexture in world-tiles mode
        self.poses = []  # (name, ned, aircraft ypr_deg)

    def generate(self, skip_existing=False):
        """Render the frames and write pix4d.csv; returns the records
        (name, ned, aircraft ypr degrees). skip_existing keeps frames
        already on disk (their draws are still made, so the records come
        out the same)."""
        os.makedirs(self.project_dir, exist_ok=True)
        dev = self.device
        if self.world_tiles:
            world = WorldTexture(self.rng.integers(1 << 30),
                                 res=self.texture_res, device=dev)
            tex, S = None, None
        else:
            world = None
            if self.texture_period:
                tex = cv_tiled_texture(self.rng, self.texture_px,
                                       self.texture_period, device=dev)
            else:
                tex = cv_ground_texture(self.rng, self.texture_px,
                                        device=dev)
            c = -tex.shape[0] / 2.0 * self.texture_res
            S = np.array([[0.0, self.texture_res, c],
                          [self.texture_res, 0.0, c],
                          [0.0, 0.0, 1.0]])
        self.world = world
        per_row = self.n_images // self.rows or 1
        # the grid centred on the texture's origin
        n_off = (per_row - 1) * self.spacing * 0.5
        e_off = (self.rows - 1) * self.spacing * 2.5 * 0.5
        records = []
        for i in range(self.n_images):
            row, col = divmod(i, per_row)
            ned = np.array([
                col * self.spacing - n_off
                + self.rng.normal(0, self.pos_jitter),
                row * self.spacing * 2.5 - e_off
                + self.rng.normal(0, self.pos_jitter),
                -self.alt + self.rng.normal(0, self.pos_jitter),
            ])
            ac_ypr = (self.rng.normal(0, self.yaw_jitter), 0.0, 0.0)
            name = f"IMG_{i:04d}.jpg"
            if skip_existing and os.path.isfile(
                    os.path.join(self.project_dir, name)):
                pass
            elif world is not None:
                # the footprint with a margin at this altitude
                half = (max(self.w, self.h) / self.fx) * self.alt * 0.8 + 30
                tex_i, S_i = world.patch(ned[0] - half, ned[1] - half,
                                         ned[0] + half, ned[1] + half)
                self._render(tex_i, S_i, ned, ac_ypr, name)
                del tex_i       # freed before the next patch is built
            else:
                self._render(tex, S, ned, ac_ypr, name)
            records.append((name, ned, ac_ypr))
        self.poses = records
        self._write_pix4d(records)
        return records

    def camera_quat(self, ac_ypr_deg):
        """NED→virtual-camera-body quat (float32 numpy) for the aircraft's
        ypr and the nadir mount, as the reference's float32 math."""
        d2r = np.pi / 180.0
        q_ac = _quat_from_ypr_f32(ac_ypr_deg[0] * d2r, ac_ypr_deg[1] * d2r,
                                  ac_ypr_deg[2] * d2r)
        q_mount = _quat_from_ypr_f32(0.0, -90.0 * d2r, 0.0)
        return _quat_multiply_f32(q_ac, q_mount)

    def world_to_image_H(self, ned, ac_ypr):
        """Ground-truth homography world plane (n, e, 1) → image pixels:
        the map the renderer uses."""
        B = _quat_to_matrix_f32(self.camera_quat(ac_ypr))   # body→NED
        R = BODY2CAM @ B.T                          # NED→cam
        t = -R @ ned
        return self.K @ np.column_stack([R[:, 0], R[:, 1], t])

    def _render(self, tex, S, ned, ac_ypr, name):
        from ..render.geotiff import warp_frame

        M = np.linalg.inv(self.world_to_image_H(ned, ac_ypr) @ S)
        frame = warp_frame(tex[..., None], M, (0, self.h, 0, self.w))[0]
        # 3-channel JPEGs, as the reference writes them
        jpeg.encode_bgr(frame.expand(-1, -1, 3),
                        os.path.join(self.project_dir, name), 95)

    def _write_pix4d(self, records):
        lines = ["File Name,Lat (decimal degrees),Lon (decimal degrees),"
                 "Alt (meters MSL),Roll (decimal degrees),"
                 "Pitch (decimal degrees),Yaw (decimal degrees)"]
        for name, ned, ac_ypr in records:
            lla = geodesy.ned2lla(ned, *REF_LLA)
            lines.append(f"{name},{lla[0]:.10f},{lla[1]:.10f},{lla[2]:.2f},"
                         f"{ac_ypr[2]:.2f},{ac_ypr[1]:.2f},{ac_ypr[0]:.2f}")
        with open(os.path.join(self.project_dir, "pix4d.csv"), "w") as f:
            f.write("\n".join(lines) + "\n")

    def camera_config(self):
        return {
            "make": "Synthetic", "model": "TestCam", "lens_model": "none",
            "K": [self.fx, 0.0, self.w / 2.0, 0.0, self.fx, self.h / 2.0,
                  0.0, 0.0, 1.0],
            "dist_coeffs": [0.0] * 5,
            "width_px": self.w, "height_px": self.h,
            "focal_len_mm": 8.0, "ccd_width_mm": 8.0 * self.w / self.fx,
            "ccd_height_mm": 8.0 * self.h / self.fx,
        }

    @property
    def names(self):
        """The generated frames' image names (no extension), in order."""
        return [os.path.splitext(name)[0] for name, _, _ in self.poses]

    def true_camera_ned(self, ref_lla=None):
        """The cameras' true NED positions, optionally in another NED
        reference (the one the pipeline computed)."""
        ned = np.array([n for _, n, _ in self.poses])
        if ref_lla is None:
            return ned
        lla = geodesy.ned2lla(ned, *REF_LLA)
        return geodesy.lla2ned(lla[:, 0], lla[:, 1], lla[:, 2], *ref_lla)

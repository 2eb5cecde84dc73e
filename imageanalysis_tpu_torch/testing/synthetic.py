"""Synthetic aerial missions for tests and on-card runs, without OpenCV.

The counterpart of part of ``imageanalysis_tpu/testing/synthetic.py``: a
seeded ground texture (blurred noise plus noise upsampled from 1/8 and
1/32 scale, as ``make_ground_texture`` there) viewed by nadir-ish cameras
flying parallel strips. Each frame is an exact homography of the ground
plane, rendered with bilinear sampling, so the planted frame-to-frame
homographies are known exactly. Frames are made in memory on the given
device; nothing is written to disk.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..features.sift import _gauss_kernel, blur_plain


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
    tex = (tex - tex.min()) * (255.0 / (tex.max() - tex.min()))
    return torch.round(tex).to(torch.uint8)


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


def make_mission(strips=4, per_strip=16, size=(2176, 1440), strip_gap=2.5,
                 seed=0, device="cpu"):
    """Render a strips × per_strip frame mission over a flat textured ground.

    size is (W, H) px; the focal length scales as 1400 px at W = 2176, as
    in benchmarks/mission_bench.py. Frames advance along the image x axis
    by (1 − OVERLAP) of the footprint width; strips sit strip_gap
    along-track spacings apart. The texture's texel is one frame
    ground-sample distance, fine enough that small frames carry hundreds
    of features.

    Returns (frames (n, H, W) uint8 on device, positions (n, 3) camera
    positions [along, across, −altitude] metres, H_ij) where H_ij(i, j)
    is the 3×3 numpy homography taking frame-i pixels (x = column, y =
    row) to frame-j pixels. Frame index = strip · per_strip + position."""
    W, H = size
    fx = 1400.0 * W / 2176.0
    rng = np.random.default_rng(seed)
    Kinv = np.linalg.inv(np.array([[fx, 0, W / 2.0], [0, fx, H / 2.0],
                                   [0, 0, 1.0]]))
    spacing = (1.0 - OVERLAP) * W / fx * ALTITUDE
    G, positions = [], []
    for s in range(strips):
        for k in range(per_strip):
            c0 = k * spacing + rng.normal(0, POS_JITTER)
            c1 = s * spacing * strip_gap + rng.normal(0, POS_JITTER)
            a = ALTITUDE + rng.normal(0, POS_JITTER)
            att = np.radians(rng.normal(0, [YAW_JITTER, TILT_JITTER,
                                            TILT_JITTER]))
            # ground point (g0, g1) of pixel p: along the ray R·K⁻¹·p from
            # the camera at height a, projectively [a·d0 + c0·d2, ...]
            M = np.array([[a, 0, c0], [0, a, c1], [0, 0, 1.0]])
            G.append(M @ _rot(*att) @ Kinv)
            positions.append([c0, c1, -a])
    G = np.stack(G)

    res = ALTITUDE / fx                 # one texel per frame pixel
    corners = np.array([[0, 0, 1], [W, 0, 1], [0, H, 1], [W, H, 1.0]]).T
    g = G @ corners
    g = g[:, :2] / g[:, 2:]
    margin = 8 * res
    lo = g.min(axis=(0, 2)) - margin
    hi = g.max(axis=(0, 2)) + margin
    tw, th = (int(math.ceil(v)) for v in (hi - lo) / res)
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

    return torch.stack(frames), np.asarray(positions), H_ij

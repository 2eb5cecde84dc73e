"""Pinhole + Brown–Conrady camera model, NED pose plumbing, projection.

Port of ``imageanalysis_tpu/core/camera.py``. Frames:

- **NED**: local north/east/down, origin at the project reference lla;
- **body**: the camera's virtual aircraft-body frame; pose files store its
  attitude quaternion (NED→body, 'rzyx' Euler);
- **cam**: the optical frame, x right, y down (image), z forward.
  ``CAM2BODY`` maps cam→body: body_x = cam_z, body_y = cam_x,
  body_z = cam_y.

A NED point p seen by a camera at ``ned`` with body→NED matrix B:
``x_cam = R (p − ned)`` with ``R = BODY2CAM @ Bᵀ``; then pinhole and
distortion.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .rotations import as_tensor, quat_to_matrix, rodrigues, rodrigues_inv

# cam→body axis permutation; body→cam = CAM2BODY⁻¹ = CAM2BODYᵀ
CAM2BODY = np.array([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
                    dtype=np.float32)
BODY2CAM = CAM2BODY.T


def _const(m, like):
    return torch.as_tensor(m, dtype=like.dtype, device=like.device)


class CameraModel(NamedTuple):
    """Intrinsics: K (3, 3), dist (5,) = [k1, k2, p1, p2, k3], size px —
    the cameras/<name>.json contract."""

    K: torch.Tensor
    dist: torch.Tensor
    width: int = 0
    height: int = 0

    @property
    def fx(self):
        return self.K[..., 0, 0]

    @property
    def fy(self):
        return self.K[..., 1, 1]

    @property
    def cx(self):
        return self.K[..., 0, 2]

    @property
    def cy(self):
        return self.K[..., 1, 2]

    @staticmethod
    def from_params(fx, fy, cx, cy, dist=None, width=0, height=0):
        K = as_tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])
        d = torch.zeros(5) if dist is None else as_tensor(dist)
        return CameraModel(K=K, dist=d, width=width, height=height)


def _coeffs(dist, xy):
    dist = as_tensor(dist, xy)
    return dist.expand(xy.shape[:-1] + (5,)).unbind(-1)


def distort_normalized(xy, dist):
    """Brown–Conrady forward model on normalized image coords: radial
    (k1, k2, k3) + tangential (p1, p2). xy (..., 2), dist (..., 5)."""
    xy = as_tensor(xy)
    x, y = xy[..., 0], xy[..., 1]
    k1, k2, p1, p2, k3 = _coeffs(dist, xy)
    r2 = x * x + y * y
    r4 = r2 * r2
    r6 = r4 * r2
    radial = 1.0 + k1 * r2 + k2 * r4 + k3 * r6
    xd = radial * x + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = radial * y + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_normalized(xy_dist, dist, iters=10):
    """Iterative inverse of distort_normalized (cv2.undistortPoints'
    fixed point): x ← (x_d − tangential(x)) / radial(x), ``iters``
    rounds."""
    xy_dist = as_tensor(xy_dist)
    k1, k2, p1, p2, k3 = _coeffs(dist, xy_dist)
    xy = xy_dist
    for _ in range(iters):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        r4 = r2 * r2
        r6 = r4 * r2
        radial = 1.0 + k1 * r2 + k2 * r4 + k3 * r6
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        xy = torch.stack([(xy_dist[..., 0] - dx) / radial,
                          (xy_dist[..., 1] - dy) / radial], dim=-1)
    return xy


def _focal_center(K):
    f = torch.stack([K[..., 0, 0], K[..., 1, 1]], dim=-1)
    c = torch.stack([K[..., 0, 2], K[..., 1, 2]], dim=-1)
    return f, c


def pixels_to_normalized(uv, K):
    uv = as_tensor(uv)
    f, c = _focal_center(as_tensor(K, uv))
    return (uv - c) / f


def normalized_to_pixels(xy, K):
    xy = as_tensor(xy)
    f, c = _focal_center(as_tensor(K, xy))
    return xy * f + c


def undistort_pixels(uv, K, dist, iters=10):
    """Distorted pixel coords → undistorted pixel coords (P = K)."""
    return normalized_to_pixels(
        undistort_normalized(pixels_to_normalized(uv, K), dist, iters), K)


def redistort_pixels(uv, K, dist):
    """Undistorted pixel coords → distorted."""
    return normalized_to_pixels(
        distort_normalized(pixels_to_normalized(uv, K), dist), K)


def undistort_pixels_np(uv, K, dist, iters=10):
    """undistort_pixels in numpy on the host (float32), the same fixed point
    and operation order: the whole project's keypoints in one vectorised
    pass, with no device round trip."""
    uv = np.asarray(uv, np.float32)
    K = np.asarray(K, np.float32)
    d = np.asarray(dist, np.float32)
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    k1, k2, p1, p2, k3 = (float(v) for v in d[:5])
    xd = (uv[:, 0] - cx) / fx
    yd = (uv[:, 1] - cy) / fy
    x, y = xd.copy(), yd.copy()
    for _ in range(iters):
        r2 = x * x + y * y
        r4 = r2 * r2
        radial = 1.0 + k1 * r2 + k2 * r4 + k3 * r4 * r2
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    return np.stack([x * fx + cx, y * fy + cy], axis=1).astype(np.float32)


def undistort_pixels_flat(u, v, K, dist, iters=10):
    """undistort_pixels on separate 1-D u/v tensors → (u', v')."""
    u = as_tensor(u)
    v = as_tensor(v, u)
    K = as_tensor(K, u)
    dist = as_tensor(dist, u)
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    k1, k2, p1, p2, k3 = dist.unbind(-1)
    xd = (u - cx) / fx
    yd = (v - cy) / fy
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        r4 = r2 * r2
        radial = 1.0 + k1 * r2 + k2 * r4 + k3 * r4 * r2
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x, y = (xd - dx) / radial, (yd - dy) / radial
    return x * fx + cx, y * fy + cy


# ---------------------------------------------------------------------------
# Pose plumbing
# ---------------------------------------------------------------------------

def ned_quat_to_rt(ned, quat):
    """(camera NED position, NED→body quat) → (R, t) with x_cam = R p + t:
    R = BODY2CAM @ quat_to_matrix(quat)ᵀ, t = −R·ned. Batched over
    leading dims."""
    quat = as_tensor(quat)
    ned = as_tensor(ned, quat)
    R = _const(BODY2CAM, quat) @ quat_to_matrix(quat).transpose(-1, -2)
    t = -torch.einsum("...ij,...j->...i", R, ned)
    return R, t


def ned_quat_to_rvec_tvec(ned, quat):
    R, t = ned_quat_to_rt(ned, quat)
    return rodrigues_inv(R), t


def rvec_tvec_to_ned_quat(rvec, tvec):
    """Inverse of ned_quat_to_rvec_tvec: R = BODY2CAM @ ned2body, so
    body2ned = (CAM2BODY R)ᵀ."""
    from .rotations import matrix_to_quat

    R = rodrigues(rvec)
    tvec = as_tensor(tvec, R)
    ned = -torch.einsum("...ji,...j->...i", R, tvec)
    body2ned = (_const(CAM2BODY, R) @ R).transpose(-1, -2)
    return ned, matrix_to_quat(body2ned)


def project_points(points_ned, R, t, K, dist):
    """NED 3D points → distorted pixel coords (cv2.projectPoints), and the
    camera-frame z. Points behind the camera stay finite through a z floor;
    callers mask them."""
    R = as_tensor(R)
    pc = torch.einsum("...ij,...j->...i", R, as_tensor(points_ned, R)) \
        + as_tensor(t, R)
    z = pc[..., 2]
    z_safe = torch.where(z.abs() < 1e-6, torch.where(z < 0, -1e-6, 1e-6), z)
    xy = pc[..., :2] / z_safe[..., None]
    return normalized_to_pixels(distort_normalized(xy, dist), K), z


def project_ned_quat(points_ned, cam_ned, cam_quat, K, dist):
    R, t = ned_quat_to_rt(cam_ned, cam_quat)
    return project_points(points_ned, R, t, K, dist)


def pixel_vectors_ned(uv, body2ned, K):
    """Undistorted pixel coords → unit view vectors in NED:
    v = body2ned @ CAM2BODY @ K⁻¹ @ [u, v, 1], normalized."""
    uv = as_tensor(uv)
    uvh = torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)
    IK = torch.linalg.inv(as_tensor(K, uv))
    M = as_tensor(body2ned, uv) @ _const(CAM2BODY, uv) @ IK
    v = torch.einsum("...ij,...j->...i", M, uvh)
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def intersect_ground_plane(cam_ned, ground_m, vectors):
    """Ray ∩ horizontal plane at down = −ground_m. Rays pointing skyward
    (v_down ≤ 0) return the camera position. vectors (..., 3) NED unit."""
    vectors = as_tensor(vectors)
    cam_ned = as_tensor(cam_ned, vectors)
    ground_m = as_tensor(ground_m, vectors)
    vz = vectors[..., 2]
    up = vz > 1e-8
    factor = -(cam_ned[..., 2] + ground_m) / torch.where(up, vz, 1.0)
    hit = cam_ned + vectors * factor[..., None]
    down = (-ground_m).expand(hit[..., 2].shape)
    hit = torch.cat([hit[..., :2], down[..., None]], dim=-1)
    return torch.where(up[..., None], hit, cam_ned.expand(hit.shape))

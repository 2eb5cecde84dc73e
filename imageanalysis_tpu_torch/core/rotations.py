"""Rotation math: quaternions, Euler angles, axis-angle (Rodrigues).

Port of ``imageanalysis_tpu/core/rotations.py``, with the same conventions:

- quaternions are ``[w, x, y, z]`` Hamilton products;
- aerospace Euler angles use the 'rzyx' order: ``quat_from_ypr(yaw,
  pitch, roll)`` is the NED→body attitude quaternion, and
  ``quat_to_matrix`` of it is the body→NED direction-cosine matrix;
- ``rodrigues`` / ``rodrigues_inv`` stand in for cv2.Rodrigues.

Every function takes trailing-dim shapes (``(..., 4)`` quats, ``(..., 3,
3)`` matrices). A tensor argument keeps its dtype and device; anything
else (a Python float, a numpy array) becomes a float32 tensor, the
reference's default precision.
"""

from __future__ import annotations

import numpy as np
import torch


def as_tensor(x, like=None):
    """x as a tensor: tensors pass through; other values become float32
    (or like's dtype and device when like is a tensor)."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(np.asarray(x), dtype=like.dtype,
                               device=like.device)
    return torch.as_tensor(np.asarray(x, np.float32))


def quat_multiply(q1, q0):
    """Hamilton product q1 ⊗ q0 of [w,x,y,z] quaternions: rotates by q0
    first, then q1, when quats act as ``quat_to_matrix(q) @ v``."""
    q1 = as_tensor(q1)
    q0 = as_tensor(q0, q1)
    w1, x1, y1, z1 = q1.unbind(-1)
    w0, x0, y0, z0 = q0.unbind(-1)
    return torch.stack([
        w1 * w0 - x1 * x0 - y1 * y0 - z1 * z0,
        w1 * x0 + x1 * w0 + y1 * z0 - z1 * y0,
        w1 * y0 - x1 * z0 + y1 * w0 + z1 * x0,
        w1 * z0 + x1 * y0 - y1 * x0 + z1 * w0,
    ], dim=-1)


def quat_conjugate(q):
    q = as_tensor(q)
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quat_inverse(q):
    q = as_tensor(q)
    return quat_conjugate(q) / (q * q).sum(-1, keepdim=True)


def quat_normalize(q, eps=1e-12):
    q = as_tensor(q)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True) \
        .clamp_min(eps)


def _axis_quat(angle, axis_index):
    """Unit quaternion for rotation by ``angle`` about coordinate axis
    0/1/2."""
    half = as_tensor(angle) * 0.5
    s = torch.sin(half)
    zero = torch.zeros_like(s)
    comps = [torch.cos(half), zero, zero, zero]
    comps[1 + axis_index] = s
    return torch.stack(comps, dim=-1)


def quat_from_ypr(yaw, pitch, roll):
    """NED→body attitude quaternion from aerospace yaw/pitch/roll (radians):
    q = qz(yaw) ⊗ qy(pitch) ⊗ qx(roll)."""
    return quat_multiply(quat_multiply(_axis_quat(yaw, 2),
                                       _axis_quat(pitch, 1)),
                         _axis_quat(roll, 0))


def quat_to_matrix(q):
    """3×3 rotation matrix of a [w,x,y,z] quaternion (non-unit safe): for an
    attitude quat from quat_from_ypr, the body→NED matrix."""
    w, x, y, z = quat_normalize(q).unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
    ], dim=-2)


def matrix_to_quat(m):
    """Rotation matrix → [w,x,y,z] quaternion, w ≥ 0: of four candidate
    constructions, the one with the largest denominator."""
    m = as_tensor(m)
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], -1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10,
                      m02 + m20], -1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22,
                      m12 + m21], -1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21,
                      1.0 - m00 - m11 + m22], -1)
    scores = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                          1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], -1)
    idx = scores.argmax(-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)          # (..., 4, 4)
    q = torch.take_along_dim(cands, idx[..., None, None], dim=-2) \
        .squeeze(-2)
    q = quat_normalize(q)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def ypr_from_quat(q):
    """Inverse of quat_from_ypr: (yaw, pitch, roll) radians."""
    w, x, y, z = quat_normalize(q).unbind(-1)
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    pitch = torch.asin(torch.clamp(2 * (w * y - z * x), -1.0, 1.0))
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    return yaw, pitch, roll


def rotation_matrix(angle, axis):
    """3×3 rotation by ``angle`` (radians) about an arbitrary ``axis``."""
    axis = as_tensor(axis)
    axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    return rodrigues(axis * as_tensor(angle, axis)[..., None])


def rodrigues(rvec):
    """Axis-angle vector → rotation matrix (cv2.Rodrigues forward),
    first-order at θ → 0."""
    rvec = as_tensor(rvec)
    theta2 = (rvec * rvec).sum(-1)
    theta = torch.sqrt(theta2 + 1e-24)
    k = rvec / theta[..., None]
    kx, ky, kz = k.unbind(-1)
    zero = torch.zeros_like(kx)
    K = torch.stack([
        torch.stack([zero, -kz, ky], -1),
        torch.stack([kz, zero, -kx], -1),
        torch.stack([-ky, kx, zero], -1),
    ], dim=-2)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(K.shape)
    th = theta[..., None, None]
    R_full = eye + torch.sin(th) * K + (1 - torch.cos(th)) * (K @ K)
    R_small = eye + th * K
    return torch.where((theta2 < 1e-12)[..., None, None], R_small, R_full)


def rodrigues_inv(R):
    """Rotation matrix → axis-angle vector, by way of the quaternion."""
    q = matrix_to_quat(R)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    v = q[..., 1:]
    sin_half = torch.linalg.vector_norm(v, dim=-1)
    theta = 2.0 * torch.atan2(sin_half, w)
    return v / sin_half.clamp_min(1e-12)[..., None] * theta[..., None]


def quat_slerp(q0, q1, t):
    """Spherical linear interpolation between unit quaternions."""
    q0 = quat_normalize(q0)
    q1 = quat_normalize(as_tensor(q1, q0))
    t = as_tensor(t, q0)
    d = (q0 * q1).sum(-1, keepdim=True)
    q1 = torch.where(d < 0, -q1, q1)
    d = torch.clamp(d, -1.0, 1.0).abs()
    theta = torch.acos(d)
    sin_t = torch.sin(theta)
    near = sin_t < 1e-6
    safe = torch.where(near, 1.0, sin_t)
    w0 = torch.where(near, 1.0 - t, torch.sin((1.0 - t) * theta) / safe)
    w1 = torch.where(near, t, torch.sin(t * theta) / safe)
    return quat_normalize(w0 * q0 + w1 * q1)


def quat_average(quats, weights=None):
    """Weighted chordal-mean quaternion (Markley): the largest eigenvector
    of Σ wᵢ qᵢ qᵢᵀ, w ≥ 0."""
    quats = quat_normalize(quats)
    if weights is None:
        weights = torch.ones(quats.shape[:-1], dtype=quats.dtype,
                             device=quats.device)
    A = torch.einsum("...n,...ni,...nj->...ij", as_tensor(weights, quats),
                     quats, quats)
    _, vecs = torch.linalg.eigh(A)
    q = vecs[..., :, -1]
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)

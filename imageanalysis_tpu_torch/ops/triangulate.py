"""Triangulation: two-view DLT and N-ray least-squares intersection.

Port of ``imageanalysis_tpu/ops/triangulate.py`` (cv2.triangulatePoints
and the reference's ls_lines_intersection). Batched over points by
trailing-dim conventions; masked for ragged chains.
"""

from __future__ import annotations

import torch


def projection_matrix(R, t, K):
    """P = K [R | t], (…, 3, 4)."""
    return K @ torch.cat([R, t[..., None]], dim=-1)


def solve3x3(A, b):
    """Closed-form batched 3×3 solve by the adjugate. A (..., 3, 3),
    b (..., 3)."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c01 + a02 * c02
    det = torch.where(det.abs() < 1e-20, 1e-20, det)
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    x0 = c00 * b0 + c01 * b1 + c02 * b2
    x1 = c10 * b0 + c11 * b1 + c12 * b2
    x2 = c20 * b0 + c21 * b1 + c22 * b2
    return torch.stack([x0, x1, x2], dim=-1) / det[..., None]


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def triangulate_two_view(P1, P2, uv1, uv2, gn_iters=2):
    """DLT triangulation of correspondences seen by two cameras.

    P1/P2 (..., 3, 4) projection matrices; uv1/uv2 (..., N, 2)
    (undistorted, normalized or pixel to match P). Returns (..., N, 3): the
    inhomogeneous DLT (w = 1) by 3×3 normal equations in closed form, then
    ``gn_iters`` Gauss–Newton reprojection refinements."""
    def rows(P, uv):
        # u·P[2] − P[0],  v·P[2] − P[1]
        p2 = P[..., None, 2, :]
        return (uv[..., 0:1] * p2 - P[..., None, 0, :],
                uv[..., 1:2] * p2 - P[..., None, 1, :])

    a0, a1 = rows(P1, uv1)
    b0, b1 = rows(P2, uv2)
    A4 = torch.stack([a0, a1, b0, b1], dim=-2)               # (..., N, 4, 4)
    A4 = A4 / torch.linalg.vector_norm(A4, dim=-1, keepdim=True) \
        .clamp_min(1e-12)
    A = A4[..., :3]
    b = -A4[..., 3]
    AtA = torch.einsum("...ki,...kj->...ij", A, A) + 1e-12 * _eye3(A)
    pts = solve3x3(AtA, torch.einsum("...ki,...k->...i", A, b))

    def residual_jac(P, uv, p):
        Pm = P[..., None, :, :]                                # (..., 1, 3, 4)
        q = torch.einsum("...ij,...j->...i", Pm[..., :3], p) + Pm[..., 3]
        z = torch.where(q[..., 2].abs() < 1e-9, 1e-9, q[..., 2])
        u = q[..., :2] / z[..., None]
        J = (Pm[..., :2, :3] - u[..., None] * Pm[..., 2:3, :3]) \
            / z[..., None, None]
        return u - uv, J

    for _ in range(gn_iters):
        r1, J1 = residual_jac(P1, uv1, pts)
        r2, J2 = residual_jac(P2, uv2, pts)
        J = torch.cat([J1, J2], dim=-2)                        # (..., N, 4, 3)
        r = torch.cat([r1, r2], dim=-1)                        # (..., N, 4)
        JtJ = torch.einsum("...ki,...kj->...ij", J, J) + 1e-9 * _eye3(J)
        pts = pts - solve3x3(JtJ, torch.einsum("...ki,...k->...i", J, r))
    return pts


def triangulate_rays(origins, dirs, mask=None):
    """Least-squares point closest to N rays (origin + s·dir): minimizes
    Σᵢ ‖(I − dᵢdᵢᵀ)(p − oᵢ)‖². origins/dirs (..., N, 3), mask (..., N).
    Returns (..., 3)."""
    d = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True) \
        .clamp_min(1e-12)
    Pm = _eye3(origins) - d[..., :, None] * d[..., None, :]  # (..., N, 3, 3)
    if mask is not None:
        Pm = Pm * mask[..., None, None]
    A = Pm.sum(-3) + 1e-9 * _eye3(origins)
    b = torch.einsum("...nij,...nj->...ni", Pm, origins).sum(-2)
    return solve3x3(A, b)


def reprojection_depths(R, t, pts):
    """Camera-frame z of NED points (positive = in front)."""
    return (torch.einsum("...ij,...j->...i", R, pts) + t)[..., 2]

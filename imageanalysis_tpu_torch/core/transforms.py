"""Point-set alignment: Umeyama similarity, 2-D similarity and affine.

Port of ``imageanalysis_tpu/core/transforms.py``: weighted, batched over
leading dims. ``umeyama`` re-registers cameras onto GPS positions;
``fit_similarity_2d`` and ``decompose_affine_2d`` feed the smart yaw-error
estimate.
"""

from __future__ import annotations

import torch

from .rotations import as_tensor


def _weights(src, weights, floor):
    if weights is None:
        return torch.full(src.shape[:-1], 1.0 / src.shape[-2],
                          dtype=src.dtype, device=src.device)
    w = as_tensor(weights, src)
    s = w.sum(-1, keepdim=True)
    return w / (s.clamp_min(floor) if floor else s)


def umeyama(src, dst, weights=None, with_scale=True):
    """Weighted Umeyama alignment: (s, R, t) minimizing
    Σw‖dst − (sR·src + t)‖². src, dst (N, 3) or (N, 2)."""
    src = as_tensor(src)
    dst = as_tensor(dst, src)
    d = src.shape[-1]
    w = _weights(src, weights, 0.0)
    mu_s = torch.einsum("...n,...ni->...i", w, src)
    mu_d = torch.einsum("...n,...ni->...i", w, dst)
    sc = src - mu_s[..., None, :]
    dc = dst - mu_d[..., None, :]
    cov = torch.einsum("...n,...ni,...nj->...ij", w, dc, sc)  # dst × srcᵀ
    U, S, Vt = torch.linalg.svd(cov)
    sign = torch.where(torch.linalg.det(U) * torch.linalg.det(Vt) < 0,
                       -1.0, 1.0)
    D = torch.cat([torch.ones(S.shape[:-1] + (d - 1,), dtype=src.dtype,
                              device=src.device), sign[..., None]], dim=-1)
    R = torch.einsum("...ik,...k,...kj->...ij", U, D, Vt)
    var_s = torch.einsum("...n,...ni,...ni->...", w, sc, sc)
    if with_scale:
        scale = (S * D).sum(-1) / var_s.clamp_min(1e-12)
    else:
        scale = torch.ones_like(var_s)
    t = mu_d - scale[..., None] * torch.einsum("...ij,...j->...i", R, mu_s)
    return scale, R, t


def apply_similarity(scale, R, t, pts):
    return (scale[..., None, None] * torch.einsum("...ij,...nj->...ni", R, pts)
            + t[..., None, :])


def fit_similarity_2d(src, dst, weights=None):
    """Weighted least-squares 2-D similarity (rotation + uniform scale +
    translation), closed form for [[a, −b], [b, a]] + t. Returns the 2×3
    matrix [[a, −b, tx], [b, a, ty]]."""
    src = as_tensor(src)
    dst = as_tensor(dst, src)
    w = _weights(src, weights, 1e-12)
    mu_s = torch.einsum("...n,...ni->...i", w, src)
    mu_d = torch.einsum("...n,...ni->...i", w, dst)
    sc = src - mu_s[..., None, :]
    dc = dst - mu_d[..., None, :]
    var = torch.einsum("...n,...ni,...ni->...", w, sc, sc).clamp_min(1e-12)
    sxx = torch.einsum("...n,...n,...n->...", w, sc[..., 0], dc[..., 0])
    syy = torch.einsum("...n,...n,...n->...", w, sc[..., 1], dc[..., 1])
    sxy = torch.einsum("...n,...n,...n->...", w, sc[..., 0], dc[..., 1])
    syx = torch.einsum("...n,...n,...n->...", w, sc[..., 1], dc[..., 0])
    a = (sxx + syy) / var
    b = (sxy - syx) / var
    tx = mu_d[..., 0] - (a * mu_s[..., 0] - b * mu_s[..., 1])
    ty = mu_d[..., 1] - (b * mu_s[..., 0] + a * mu_s[..., 1])
    return torch.stack([torch.stack([a, -b, tx], -1),
                        torch.stack([b, a, ty], -1)], dim=-2)


def decompose_affine_2d(A):
    """2×3 affine → (rotation_rad, tx, ty, scale_x, scale_y): rotation from
    the first column, scales as column norms, scale_x signed by the
    determinant."""
    A = as_tensor(A)
    a, b = A[..., 0, 0], A[..., 1, 0]
    c, d = A[..., 0, 1], A[..., 1, 1]
    sx = torch.sqrt(a * a + b * b) * torch.where(a * d - b * c < 0, -1.0, 1.0)
    return (torch.atan2(b, a), A[..., 0, 2], A[..., 1, 2], sx,
            torch.sqrt(c * c + d * d))

"""Batched-hypothesis RANSAC over a batch of pairs: homography,
fundamental, essential and 2-D similarity.

Port of ``imageanalysis_tpu/ops/ransac.py``: per pair, draw n_hyp minimal
sets (4 points for H, 8 for F, 12 for E) from a fixed, evenly spread
subset of the valid points, solve them all at once, score them all on the
subset, take the best, refine it twice on every point weighted by its
inliers, and report the final inliers. F and E solve the (weighted)
8-point system by inverse iteration and project onto rank 2 (F) or onto
singular values (1, 1, 0) (E) by ``torch.linalg.svd`` of the 3×3
matrices; they score by the symmetric epipolar distance. The similarity
draws its 2-point sets from all valid points. Every tensor carries a
leading pair dimension B (the reference vmaps over pairs).

The reference's one-hot matmuls (a TPU gather workaround, bit-identical to
gathers by its own docstrings) are ``searchsorted`` and gathers here, and
its ``lax.scan`` refine is a loop. Randomness comes from a
``torch.Generator``, or from ``PairDraws`` (draws keyed by the pair, the
same whatever batch or rank carries it); ``pick`` overrides the draw so
tests can feed exactly the picks that ``jax.random`` draws.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class RansacResult(NamedTuple):
    model: torch.Tensor      # (B, 3, 3) H, F or E, or (B, 2, 3) similarity
    inliers: torch.Tensor    # (B, N) bool
    n_inliers: torch.Tensor  # (B,) int32
    ok: torch.Tensor         # (B,) bool — enough points and inliers


def _valid_cumsum(valid):
    """Inclusive rank of each entry among the valid ones, (B, N) int32."""
    return torch.cumsum(valid.int(), dim=-1, dtype=torch.int32)


def _score_subset(valid, ranks, max_points):
    """Fixed-size, evenly spread subset of the valid points for scoring
    (and for drawing minimal sets). Slot t holds the valid entry of rank
    r_t = ceil(t·n_valid/m) + 1 (or t + 1 when n_valid < m); the first
    position whose rank reaches r_t is that entry. Slots past n_valid hold
    index N − 1 and are masked. Returns (indices (B, m), mask (B, m))."""
    n = valid.shape[-1]
    m = min(max_points, n)
    n_valid = ranks[:, -1:]
    t = torch.arange(m, dtype=torch.int32, device=valid.device)[None, :]
    r_t = torch.where(n_valid >= m, (t * n_valid + m - 1) // m + 1, t + 1)
    pos = torch.searchsorted(ranks, r_t.contiguous())
    sub = torch.where(r_t <= n_valid, pos, n - 1)
    return sub, t < n_valid


def _as_int64(c):
    """A 64-bit constant as a signed int64 value (two's complement)."""
    return c - (1 << 64) if c >= 1 << 63 else c


_GAMMA = _as_int64(0x9E3779B97F4A7C15)
_MIX1 = _as_int64(0xBF58476D1CE4E5B9)
_MIX2 = _as_int64(0x94D049BB133111EB)


def _shr(z, s):
    """Logical right shift of int64 z by s."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def _mix64(z):
    """splitmix64's finalizer on int64 tensors (products wrap mod 2⁶⁴)."""
    z = (z ^ _shr(z, 30)) * _MIX1
    z = (z ^ _shr(z, 27)) * _MIX2
    return z ^ _shr(z, 31)


class PairDraws:
    """Uniform draws keyed by pair, in place of a torch.Generator: pair
    b's draws are a function of (seed, keys[b]) and the draw's shape
    only (splitmix64 of a per-pair state and a counter), so a pair draws
    the same samples in any batch, on any rank and on either device.
    keys None makes a factory: keyed(keys) gives the draws of a batch."""

    def __init__(self, seed, keys=None):
        self.seed = int(seed)
        self.keys = keys

    def keyed(self, keys):
        return PairDraws(self.seed, keys)

    def rand(self, shape, device):
        """float32 in [0, 1), shape (B, ...) with B = len(keys)."""
        keys = self.keys.to(device=device, dtype=torch.int64)
        n = math.prod(shape[1:])
        state = _mix64(keys * _GAMMA + _as_int64(
            (self.seed * 0xD1B54A32D192ED03) % (1 << 64)))
        ctr = torch.arange(1, n + 1, device=device, dtype=torch.int64)
        z = _mix64(state[:, None] + ctr[None, :] * _GAMMA)
        return (_shr(z, 40).float() / float(1 << 24)).reshape(shape)


def _uniform(shape, generator, device):
    """torch.rand(shape) from generator (a torch.Generator, None, or
    PairDraws)."""
    if isinstance(generator, PairDraws):
        return generator.rand(shape, device)
    return torch.rand(shape, generator=generator, device=device)


def _draw_picks(n_valid, m, n_hyp, k, generator):
    """(B, n_hyp, k) uniform indices in [0, max(min(n_valid, m), 1))."""
    hi = n_valid.clamp(max=m).clamp(min=1).long()[:, None, None]
    u = _uniform((n_valid.shape[0], n_hyp, k), generator, n_valid.device)
    return torch.minimum((u * hi).long(), hi - 1)


def _sample_indices(valid, ranks, n_hyp, k, generator):
    """(B, n_hyp, k) point indices, uniform over each pair's valid entries
    (the reference's _sample_indices): target rank ⌊u·n_valid⌋ + 1, found
    by searchsorted on the ranks."""
    B, n = valid.shape
    n_valid = ranks[:, -1:]
    u = _uniform((B, n_hyp * k), generator, valid.device)
    tgt = torch.minimum((u * n_valid).int() + 1, n_valid.clamp(min=1))
    idx = torch.searchsorted(ranks, tgt.contiguous())
    return idx.clamp(max=n - 1).reshape(B, n_hyp, k)


def _minimal_sets_from_subset(tab_a, tab_b, picks):
    """Gather the picked subset rows: tab (B, m, 2), picks (B, n_hyp, k) →
    coordinates (B, n_hyp, k, 2) of each side."""
    B, n_hyp, k = picks.shape
    idx = picks.reshape(B, n_hyp * k, 1).expand(-1, -1, 2)
    return (torch.gather(tab_a, 1, idx).reshape(B, n_hyp, k, 2),
            torch.gather(tab_b, 1, idx).reshape(B, n_hyp, k, 2))


def _eye3(like, batch):
    return torch.eye(3, dtype=like.dtype, device=like.device) \
        .expand(*batch, 3, 3).clone()


def _normalize_2d(pts, valid):
    """Hartley normalization over the valid points of each pair: T with
    T·pts zero-mean at RMS distance √2. Returns (pts_norm, T (B, 3, 3))."""
    w = valid.to(pts.dtype)
    wsum = w.sum(-1).clamp_min(1.0)
    mean = (pts * w[..., None]).sum(-2) / wsum[:, None]
    centered = (pts - mean[:, None]) * w[..., None]
    rms = torch.sqrt((centered * centered).sum((-2, -1)) / wsum + 1e-12)
    s = math.sqrt(2.0) / rms.clamp_min(1e-8)
    T = _eye3(pts, (pts.shape[0],))
    T[:, 0, 0] = s
    T[:, 1, 1] = s
    T[:, 0, 2] = -s * mean[:, 0]
    T[:, 1, 2] = -s * mean[:, 1]
    return (pts - mean[:, None]) * s[:, None, None], T


def _similarity_inv(T):
    """Closed-form inverse of Hartley transforms [[s,0,tx],[0,s,ty],[0,0,1]]."""
    inv_s = 1.0 / T[:, 0, 0]
    Ti = _eye3(T, (T.shape[0],))
    Ti[:, 0, 0] = inv_s
    Ti[:, 1, 1] = inv_s
    Ti[:, 0, 2] = -T[:, 0, 2] * inv_s
    Ti[:, 1, 2] = -T[:, 1, 2] * inv_s
    return Ti


def _gauss_solve(A, b):
    """Unrolled no-pivot Gaussian elimination, batched over leading dims
    (inputs are Hartley-normalized; a singular system gives inf/nan and the
    hypothesis scores zero)."""
    n = A.shape[-1]
    Ab = torch.cat([A, b[..., None]], -1)
    rows = [Ab[..., i, :] for i in range(n)]
    for i in range(n):
        rows[i] = rows[i] / rows[i][..., i:i + 1]
        for j in range(i + 1, n):
            rows[j] = rows[j] - rows[j][..., i:i + 1] * rows[i]
    x = [None] * n
    for i in reversed(range(n)):
        acc = rows[i][..., n]
        for j in range(i + 1, n):
            acc = acc - rows[i][..., j] * x[j]
        x[i] = acc
    return torch.stack(x, -1)


def _smallest_eigvec(A, iters=3):
    """Null vector of AᵀA for A (B, m, n) by regularized inverse iteration
    from a fixed non-structured start vector."""
    M = A.transpose(-1, -2) @ A
    n = M.shape[-1]
    eps = 1e-6 * M.diagonal(dim1=-2, dim2=-1).sum(-1) / n + 1e-12
    Mr = M + eps[:, None, None] * torch.eye(n, dtype=M.dtype, device=M.device)
    v = torch.sin(torch.arange(1, n + 1, dtype=M.dtype, device=M.device) * 1.7)
    v = (v / torch.linalg.vector_norm(v)).expand(M.shape[0], n)
    for _ in range(iters):
        v = _gauss_solve(Mr, v)
        v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True) \
            .clamp_min(1e-20)
    return v


def _homography_dlt(pa, pb, w):
    """Weighted DLT: H (B, 3, 3) with pb ~ H·pa. pa/pb (B, N, 2), w (B, N)."""
    x, y = pa[..., 0], pa[..., 1]
    u, v = pb[..., 0], pb[..., 1]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    r1 = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y, -u], -1)
    r2 = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y, -v], -1)
    A = torch.cat([r1 * w[..., None], r2 * w[..., None]], -2)   # (B, 2N, 9)
    return _smallest_eigvec(A).reshape(-1, 3, 3)


def _adj3(c):
    """Adjugate of a 3×3 given as nested lists of (…,) tensors."""
    return [
        [c[1][1] * c[2][2] - c[1][2] * c[2][1],
         c[0][2] * c[2][1] - c[0][1] * c[2][2],
         c[0][1] * c[1][2] - c[0][2] * c[1][1]],
        [c[1][2] * c[2][0] - c[1][0] * c[2][2],
         c[0][0] * c[2][2] - c[0][2] * c[2][0],
         c[0][2] * c[1][0] - c[0][0] * c[1][2]],
        [c[1][0] * c[2][1] - c[1][1] * c[2][0],
         c[0][1] * c[2][0] - c[0][0] * c[2][1],
         c[0][0] * c[1][1] - c[0][1] * c[1][0]],
    ]


def _homography_4pt_scalar(x, y, u, v):
    """Minimal 4-point homographies by the projective-basis method, on
    length-4 lists of (…,) coordinate tensors: H = B·adj(A), where A and B
    map the canonical projective basis to the source and target quads.
    Degenerate samples give a singular H that scores ~0 inliers."""
    one = torch.ones_like(x[0])

    def basis(xs, ys):
        c = [[xs[0], xs[1], xs[2]], [ys[0], ys[1], ys[2]], [one, one, one]]
        adj = _adj3(c)
        p4 = [xs[3], ys[3], one]
        lam = [sum(adj[i][j] * p4[j] for j in range(3)) for i in range(3)]
        return [[lam[j] * c[i][j] for j in range(3)] for i in range(3)]

    A = basis(x, y)
    B = basis(u, v)
    adjA = _adj3(A)
    H = [[sum(B[i][k] * adjA[k][j] for k in range(3)) for j in range(3)]
         for i in range(3)]
    return torch.stack([torch.stack(r, -1) for r in H], -2)


def _homography_error(H, pa, pb):
    """Forward transfer error ‖H·pa − pb‖ (cv2.findHomography's metric).
    H (..., 3, 3) broadcasts against pa/pb (..., N, 2) → (..., N); the
    products are written out elementwise."""
    x, y = pa[..., 0], pa[..., 1]

    def h(i, j):
        return H[..., i, j, None]

    qx = x * h(0, 0) + y * h(0, 1) + h(0, 2)
    qy = x * h(1, 0) + y * h(1, 1) + h(1, 2)
    z = x * h(2, 0) + y * h(2, 1) + h(2, 2)
    z = torch.where(z.abs() < 1e-8, 1e-8, z)
    dx = qx / z - pb[..., 0]
    dy = qy / z - pb[..., 1]
    return torch.sqrt(dx * dx + dy * dy)


def ransac_homography(pts_a, pts_b, valid, thresh=3.0, n_hyp=512,
                      refine_iters=2, score_points=512, generator=None,
                      pick=None):
    """RANSAC homography pts_a → pts_b for a batch of pairs.

    pts_a/pts_b (B, N, 2) padded; valid (B, N) bool. generator draws the
    minimal sets; pick (B, n_hyp, 4) integer subset indices replaces the
    draw. Returns RansacResult with model (B, 3, 3) normalized to
    H[2, 2] = 1."""
    B = pts_a.shape[0]
    pa_n, Ta = _normalize_2d(pts_a, valid)
    pb_n, Tb = _normalize_2d(pts_b, valid)
    ranks = _valid_cumsum(valid)
    sub, sub_ok = _score_subset(valid, ranks, score_points)
    idx = sub[..., None].expand(-1, -1, 2)
    pa_s = torch.gather(pa_n, 1, idx)
    pb_s = torch.gather(pb_n, 1, idx)
    if pick is None:
        pick = _draw_picks(ranks[:, -1], sub.shape[1], n_hyp, 4, generator)
    ga, gb = _minimal_sets_from_subset(pa_s, pb_s, pick.long())
    Hs = _homography_4pt_scalar(
        [ga[..., i, 0] for i in range(4)], [ga[..., i, 1] for i in range(4)],
        [gb[..., i, 0] for i in range(4)], [gb[..., i, 1] for i in range(4)])
    errs = _homography_error(Hs, pa_s[:, None], pb_s[:, None])
    # threshold in normalized units: scale by Tb's isotropic scale
    t_norm = thresh * Tb[:, 0, 0]
    scores = ((errs < t_norm[:, None, None]) & sub_ok[:, None, :]).sum(-1)
    best = scores.argmax(-1)
    H = Hs[torch.arange(B, device=Hs.device), best]
    for _ in range(refine_iters):
        e = _homography_error(H, pa_n, pb_n)
        w = ((e < t_norm[:, None]) & valid).to(pts_a.dtype)
        H = _homography_dlt(pa_n, pb_n, w)
    err = _homography_error(H, pa_n, pb_n)
    inl = (err < t_norm[:, None]) & valid
    # denormalize: pb = Tb⁻¹ Ĥ Ta pa
    H_full = _similarity_inv(Tb) @ H @ Ta
    h22 = H_full[:, 2:, 2:]
    H_full = H_full / torch.where(h22.abs() < 1e-12, 1.0, h22)
    n_inl = inl.sum(-1, dtype=torch.int32)
    ok = (valid.sum(-1) >= 4) & (n_inl >= 4)
    return RansacResult(H_full, inl, n_inl, ok)


# ---------------------------------------------------------------------------
# Fundamental / essential
# ---------------------------------------------------------------------------

def _fundamental_8pt(pa, pb, w=None):
    """(Weighted) 8-point F with pb ~ F·pa, rank 2 enforced by SVD, for
    pa/pb (..., k, 2) pre-normalized and w (..., k): (..., 3, 3)."""
    lead = pa.shape[:-2]
    x, y = pa[..., 0], pa[..., 1]
    u, v = pb[..., 0], pb[..., 1]
    one = torch.ones_like(x)
    A = torch.stack([u * x, u * y, u, v * x, v * y, v, x, y, one], -1)
    if w is not None:
        A = A * w[..., None]
    f = _smallest_eigvec(A.reshape(-1, *A.shape[-2:]))
    U, S, Vt = torch.linalg.svd(f.reshape(-1, 3, 3))
    S = torch.cat([S[:, :2], torch.zeros_like(S[:, 2:])], -1)
    return ((U * S[:, None, :]) @ Vt).reshape(*lead, 3, 3)


def _essential_project(E):
    """E (..., 3, 3) onto singular values (1, 1, 0)."""
    lead = E.shape[:-2]
    U, _, Vt = torch.linalg.svd(E.reshape(-1, 3, 3))
    s = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return ((U * s) @ Vt).reshape(*lead, 3, 3)


def _epipolar_dist(F, pa, pb):
    """Symmetric epipolar distance (the larger of the two point-line
    distances) of pb ~ F·pa. F (..., 3, 3) broadcasts against pa/pb
    (..., N, 2) → (..., N)."""
    x, y = pa[..., 0], pa[..., 1]
    u, v = pb[..., 0], pb[..., 1]

    def f(i, j):
        return F[..., i, j, None]

    lb = [x * f(i, 0) + y * f(i, 1) + f(i, 2) for i in range(3)]
    la = [u * f(0, j) + v * f(1, j) + f(2, j) for j in range(2)]
    num = (u * lb[0] + v * lb[1] + lb[2]).abs()
    db = num / torch.sqrt(lb[0] * lb[0] + lb[1] * lb[1]).clamp_min(1e-8)
    da = num / torch.sqrt(la[0] * la[0] + la[1] * la[1]).clamp_min(1e-8)
    return torch.maximum(da, db)


def _epipolar_ransac(pa_n, pb_n, valid, t_norm, k, solve, n_hyp,
                     refine_iters, score_points, generator, pick):
    """The shared F/E loop on normalized points: draw, solve, score on the
    subset, refine on every point. Returns (model, inliers)."""
    B = pa_n.shape[0]
    ranks = _valid_cumsum(valid)
    sub, sub_ok = _score_subset(valid, ranks, score_points)
    idx = sub[..., None].expand(-1, -1, 2)
    pa_s = torch.gather(pa_n, 1, idx)
    pb_s = torch.gather(pb_n, 1, idx)
    if pick is None:
        pick = _draw_picks(ranks[:, -1], sub.shape[1], n_hyp, k, generator)
    ga, gb = _minimal_sets_from_subset(pa_s, pb_s, pick.long())
    Ms = solve(ga, gb, None)                       # (B, n_hyp, 3, 3)
    errs = _epipolar_dist(Ms, pa_s[:, None], pb_s[:, None])
    scores = ((errs < t_norm[:, None, None]) & sub_ok[:, None, :]).sum(-1)
    best = scores.argmax(-1)
    M = Ms[torch.arange(B, device=Ms.device), best]
    for _ in range(refine_iters):
        e = _epipolar_dist(M, pa_n, pb_n)
        w = ((e < t_norm[:, None]) & valid).to(pa_n.dtype)
        M = solve(pa_n, pb_n, w)
    inl = (_epipolar_dist(M, pa_n, pb_n) < t_norm[:, None]) & valid
    return M, inl


def ransac_fundamental(pts_a, pts_b, valid, thresh=3.0, n_hyp=512,
                       refine_iters=2, score_points=512, generator=None,
                       pick=None):
    """RANSAC fundamental matrix pts_a → pts_b for a batch of pairs
    (8-point hypotheses on Hartley-normalized points, symmetric epipolar
    distance; cv2.findFundamentalMat(FM_RANSAC)'s role). pick (B, n_hyp,
    8) subset indices replaces the draw. Returns RansacResult with model
    (B, 3, 3) in pixels, unit Frobenius norm."""
    pa_n, Ta = _normalize_2d(pts_a, valid)
    pb_n, Tb = _normalize_2d(pts_b, valid)
    F, inl = _epipolar_ransac(pa_n, pb_n, valid, thresh * Tb[:, 0, 0], 8,
                              _fundamental_8pt, n_hyp, refine_iters,
                              score_points, generator, pick)
    F_full = Tb.transpose(-1, -2) @ F @ Ta
    nrm = torch.linalg.matrix_norm(F_full)[:, None, None]
    F_full = F_full / torch.where(nrm < 1e-12, 1.0, nrm)
    n_inl = inl.sum(-1, dtype=torch.int32)
    ok = (valid.sum(-1) >= 8) & (n_inl >= 8)
    return RansacResult(F_full, inl, n_inl, ok)


def ransac_essential(pts_a, pts_b, valid, K, thresh=1.0, n_hyp=512,
                     refine_iters=2, score_points=512, generator=None,
                     pick=None):
    """RANSAC essential matrix for a batch of pairs sharing K (3, 3):
    12-point hypotheses on K-normalized points (8-point system, projected
    onto singular values (1, 1, 0)); thresh in px, divided by the mean
    focal length. Like every 8-point variant it degenerates on planar
    scenes. pick (B, n_hyp, 12) subset indices replaces the draw. Returns
    RansacResult with model (B, 3, 3) in normalized coordinates."""
    f = 0.5 * (K[0, 0] + K[1, 1])
    c = K[:2, 2]
    pa_n = (pts_a - c) / f
    pb_n = (pts_b - c) / f

    def solve(pa, pb, w):
        return _essential_project(_fundamental_8pt(pa, pb, w))

    t_norm = (thresh / f).expand(pts_a.shape[0])
    E, inl = _epipolar_ransac(pa_n, pb_n, valid, t_norm, 12, solve, n_hyp,
                              refine_iters, score_points, generator, pick)
    n_inl = inl.sum(-1, dtype=torch.int32)
    ok = (valid.sum(-1) >= 8) & (n_inl >= 8)
    return RansacResult(E, inl, n_inl, ok)


# ---------------------------------------------------------------------------
# 2-D similarity
# ---------------------------------------------------------------------------

def ransac_similarity_2d(pts_a, pts_b, valid, thresh=3.0, n_hyp=256,
                         refine_iters=2, generator=None, pick=None):
    """RANSAC 2-D similarity pts_a → pts_b for a batch of pairs
    (cv2.estimateAffinePartial2D's role): 2-point hypotheses drawn from
    all valid points, transfer error in px. pick (B, n_hyp, 2) point
    indices replaces the draw. Returns RansacResult with model (B, 2, 3)."""
    from ..core.transforms import fit_similarity_2d

    B = pts_a.shape[0]
    if pick is None:
        pick = _sample_indices(valid, _valid_cumsum(valid), n_hyp, 2,
                               generator)
    idx = pick.long().reshape(B, -1, 1).expand(-1, -1, 2)
    ga = torch.gather(pts_a, 1, idx).reshape(B, n_hyp, 2, 2)
    gb = torch.gather(pts_b, 1, idx).reshape(B, n_hyp, 2, 2)
    As = fit_similarity_2d(ga, gb)                 # (B, n_hyp, 2, 3)

    def err(A, pa, pb):
        pred = pa @ A[..., :2].transpose(-1, -2) + A[..., None, :, 2]
        return torch.linalg.vector_norm(pred - pb, dim=-1)

    errs = err(As, pts_a[:, None], pts_b[:, None])
    scores = ((errs < thresh) & valid[:, None, :]).sum(-1)
    best = scores.argmax(-1)
    A = As[torch.arange(B, device=As.device), best]
    for _ in range(refine_iters):
        w = ((err(A, pts_a, pts_b) < thresh) & valid).to(pts_a.dtype)
        A = fit_similarity_2d(pts_a, pts_b, w)
    inl = (err(A, pts_a, pts_b) < thresh) & valid
    n_inl = inl.sum(-1, dtype=torch.int32)
    ok = (valid.sum(-1) >= 2) & (n_inl >= 2)
    return RansacResult(A, inl, n_inl, ok)

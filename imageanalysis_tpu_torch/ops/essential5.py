"""Nistér/Stewénius 5-point essential-matrix solver (host, float64).

A copy of ``imageanalysis_tpu/ops/essential5.py`` (host numpy, no JAX),
kept as the port's own module with the same seeded numpy ``Generator``
draw, so its results equal the reference's bit for bit. The matcher's
``essential5`` filter runs it on the host over the device's 2-NN
survivors: the batched device RANSAC (``ops/ransac.py``) uses the 8-point
algorithm, which degenerates on planar scenes, the common aerial case
(the reference's cv2.findEssentialMat is Nistér's 5-point).

The minimal problem is a 5×9 SVD, a 10×20 Gauss–Jordan and a 10×10
nonsymmetric eigendecomposition per hypothesis, batched over all
hypotheses in one vectorized numpy call per stage.

Method (Stewénius et al., "Recent developments on direct relative
orientation", ISPRS 2006): null space E = xX + yY + zZ + W; the ten cubic
constraints det(E)=0 and 2·E·EᵀE − tr(EEᵀ)·E = 0 expand over the 20
monomials of degree ≤ 3 in (x, y, z); Gauss–Jordan to [I | B]; the action
matrix of multiplication-by-x on the 10-dim quotient basis has the
monomial-evaluation vectors as left eigenvectors, eigenvalue x — read
(x, y, z) off each (near-)real eigenvector.
"""

from __future__ import annotations

import itertools

import numpy as np

# ---------------------------------------------------------------------------
# Monomial bookkeeping: 20 monomials of degree <= 3 in (x, y, z).
# First the 10 of total degree 3 ("leading"), then the 10 of degree <= 2
# (the quotient-ring basis).  Within each group: lexicographic on exponents.
# ---------------------------------------------------------------------------
_MONOS3 = sorted((e for e in itertools.product(range(4), repeat=3)
                  if sum(e) == 3), reverse=True)
_MONOS_LE2 = sorted((e for e in itertools.product(range(3), repeat=3)
                     if sum(e) <= 2), reverse=True)
MONOS = _MONOS3 + _MONOS_LE2                      # len 20
MIDX = {e: i for i, e in enumerate(MONOS)}
_BASIS = _MONOS_LE2                               # quotient basis, len 10
_BIDX = {e: i for i, e in enumerate(_BASIS)}

# degree-1 monomial vectors for x, y, z, 1 in a compact (4,) representation
# poly1: coeff over [x, y, z, 1]
_D1 = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]

# multiplication tables ------------------------------------------------------
# deg1 x deg1 -> index into the 10 monomials of degree <= 2
_MUL11 = np.zeros((4, 4), np.int64)
for a in range(4):
    for b in range(4):
        e = tuple(np.add(_D1[a], _D1[b]))
        _MUL11[a, b] = _BIDX[e]
# (deg<=2 basis) x deg1 -> index into the 20 monomials
_MUL21 = np.zeros((10, 4), np.int64)
for t in range(10):
    for b in range(4):
        e = tuple(np.add(_BASIS[t], _D1[b]))
        _MUL21[t, b] = MIDX[e]


def _poly_mul11(p, q):
    """(…,4) x (…,4) -> (…,10) coefficients over the degree<=2 basis."""
    out = np.zeros(p.shape[:-1] + (10,), p.dtype)
    for a in range(4):
        for b in range(4):
            out[..., _MUL11[a, b]] += p[..., a] * q[..., b]
    return out


def _poly_mul21(p2, q1):
    """(…,10) x (…,4) -> (…,20) coefficients over all 20 monomials."""
    out = np.zeros(p2.shape[:-1] + (20,), p2.dtype)
    for t in range(10):
        for b in range(4):
            out[..., _MUL21[t, b]] += p2[..., t] * q1[..., b]
    return out


def _nullspace4(q1, q2):
    """Nullspace basis X, Y, Z, W of the epipolar constraints.

    q1, q2: (..., 5, 3) homogeneous normalized image points.
    Returns (..., 4, 3, 3): the 4 least-singular right vectors reshaped.
    """
    # each row: kron(q2_i, q1_i) so that row · vec(E) = q2ᵀ E q1
    A = (q2[..., :, :, None] * q1[..., :, None, :]).reshape(
        *q1.shape[:-2], 5, 9)
    _, _, vt = np.linalg.svd(A)
    null = vt[..., 5:9, :]                       # (...,4,9)
    return null.reshape(*null.shape[:-1], 3, 3)


def _essential_polynomials(basis):
    """Expand the 10 cubic constraints over the 20 monomials.

    basis: (..., 4, 3, 3) with order (X, Y, Z, W) so that
    E = x·X + y·Y + z·Z + 1·W and E[i,j] is the degree-1 polynomial with
    coefficient vector basis[..., :, i, j] over [x, y, z, 1].
    Returns M: (..., 10, 20).
    """
    E = np.moveaxis(basis, -3, -1)                # (...,3,3,4) coeff last

    # EEt[i,j] = sum_k E[i,k]·E[j,k]  → degree-2 polys (...,3,3,10)
    EEt = np.zeros(E.shape[:-3] + (3, 3, 10), E.dtype)
    for i in range(3):
        for j in range(3):
            for k in range(3):
                EEt[..., i, j, :] += _poly_mul11(E[..., i, k, :],
                                                 E[..., j, k, :])
    tr = EEt[..., 0, 0, :] + EEt[..., 1, 1, :] + EEt[..., 2, 2, :]

    rows = []
    # 2·EEᵀ·E − tr(EEᵀ)·E = 0 (nine cubic equations)
    for i in range(3):
        for j in range(3):
            acc = np.zeros(E.shape[:-3] + (20,), E.dtype)
            for k in range(3):
                acc += _poly_mul21(2.0 * EEt[..., i, k, :], E[..., k, j, :])
            acc -= _poly_mul21(tr, E[..., i, j, :])
            rows.append(acc)
    # det(E) = 0
    det = np.zeros(E.shape[:-3] + (20,), E.dtype)
    for (a, b, c), s in [((0, 1, 2), 1), ((1, 2, 0), 1), ((2, 0, 1), 1),
                         ((2, 1, 0), -1), ((0, 2, 1), -1), ((1, 0, 2), -1)]:
        det += s * _poly_mul21(_poly_mul11(E[..., 0, a, :], E[..., 1, b, :]),
                               E[..., 2, c, :])
    rows.append(det)
    return np.stack(rows, axis=-2)                # (...,10,20)


def _action_matrix(B):
    """Multiplication-by-x action matrix on the quotient basis.

    B: (..., 10, 10) from the reduced system [I | B], i.e. for the i-th
    degree-3 monomial ℓ_i:  ℓ_i = −Σ_j B[i, j]·t_j.
    Returns A with x·t_j = Σ_i A[..., i, j]·t_i.
    """
    batch = B.shape[:-2]
    A = np.zeros(batch + (10, 10), B.dtype)
    for j, t in enumerate(_BASIS):
        e = (t[0] + 1, t[1], t[2])                # x · t_j
        if e in _BIDX:                            # still in the basis
            A[..., _BIDX[e], j] = 1.0
        else:                                     # a leading monomial
            A[..., :, j] = -B[..., _MONOS3.index(e), :]
    return A


def solve_5pt(q1: np.ndarray, q2: np.ndarray):
    """Minimal 5-point solve, batched.

    q1, q2: (..., 5, 2) normalized image coordinates (K already applied).
    Returns (E, valid): E (..., 10, 3, 3) candidate essential matrices with
    a validity mask (..., 10) — up to 10 real solutions per problem.
    """
    q1 = np.asarray(q1, np.float64)
    q2 = np.asarray(q2, np.float64)
    q1h = np.concatenate([q1, np.ones_like(q1[..., :1])], axis=-1)
    q2h = np.concatenate([q2, np.ones_like(q2[..., :1])], axis=-1)
    basis = _nullspace4(q1h, q2h)                 # (...,4,3,3) rows V4..V1
    # order (X, Y, Z, W): any assignment works; keep svd order
    M = _essential_polynomials(basis)             # (...,10,20)

    A1 = M[..., :10]
    A2 = M[..., 10:]
    ok = np.abs(np.linalg.det(A1)) > 1e-18
    A1 = np.where(ok[..., None, None], A1, np.eye(10))
    B = np.linalg.solve(A1, A2)                   # (...,10,10)
    Ax = _action_matrix(B)
    # left eigenvectors of Ax = eigenvectors of Axᵀ
    w, v = np.linalg.eig(np.swapaxes(Ax, -1, -2))
    # v[..., :, k] is the monomial-evaluation vector for solution k
    one = v[..., _BIDX[(0, 0, 0)], :]
    x = v[..., _BIDX[(1, 0, 0)], :] / np.where(np.abs(one) < 1e-12, 1, one)
    y = v[..., _BIDX[(0, 1, 0)], :] / np.where(np.abs(one) < 1e-12, 1, one)
    z = v[..., _BIDX[(0, 0, 1)], :] / np.where(np.abs(one) < 1e-12, 1, one)
    real = (np.abs(w.imag) < 1e-6) & (np.abs(one) > 1e-12)
    real &= ok[..., None]
    x, y, z = x.real, y.real, z.real

    Xb, Yb, Zb, Wb = (basis[..., 0, :, :], basis[..., 1, :, :],
                      basis[..., 2, :, :], basis[..., 3, :, :])
    E = (x[..., :, None, None] * Xb[..., None, :, :]
         + y[..., :, None, None] * Yb[..., None, :, :]
         + z[..., :, None, None] * Zb[..., None, :, :]
         + Wb[..., None, :, :])
    norm = np.linalg.norm(E, axis=(-2, -1), keepdims=True)
    E = E / np.where(norm < 1e-12, 1.0, norm)
    return E, real


def sampson_error(E, q1, q2):
    """Sampson distance of normalized point pairs under E.

    E: (..., 3, 3); q1, q2: (N, 2). Returns (..., N)."""
    q1h = np.concatenate([q1, np.ones_like(q1[..., :1])], axis=-1)
    q2h = np.concatenate([q2, np.ones_like(q2[..., :1])], axis=-1)
    Eq1 = np.einsum("...ij,nj->...ni", E, q1h)
    Etq2 = np.einsum("...ji,nj->...ni", E, q2h)
    num = np.einsum("ni,...ni->...n", q2h, Eq1)
    den = (Eq1[..., 0] ** 2 + Eq1[..., 1] ** 2
           + Etq2[..., 0] ** 2 + Etq2[..., 1] ** 2)
    return num ** 2 / np.maximum(den, 1e-12)


def ransac_essential_5pt(q1, q2, thresh=1e-3, n_hyp=256, seed=0):
    """RANSAC essential matrix from normalized coordinates (host f64).

    q1, q2: (N, 2) normalized image coordinates. thresh is the Sampson
    threshold in normalized units ((px / f)² scale). Returns
    (E (3,3), inlier_mask (N,), n_inliers).
    """
    q1 = np.asarray(q1, np.float64)
    q2 = np.asarray(q2, np.float64)
    n = len(q1)
    if n < 5:
        return np.eye(3), np.zeros(n, bool), 0
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, (n_hyp, 5))
    E, valid = solve_5pt(q1[idx], q2[idx])        # (H,10,3,3), (H,10)
    err = sampson_error(E.reshape(-1, 3, 3), q1, q2).reshape(n_hyp, 10, n)
    inl = (err < thresh) & valid[..., None]
    scores = inl.sum(-1)
    h, k = np.unravel_index(np.argmax(scores), scores.shape)
    best_inl = inl[h, k]
    E_best = E[h, k]
    # local refinement: re-solve on inliers via 8-point-style least squares
    if best_inl.sum() >= 6:
        q1i, q2i = q1[best_inl], q2[best_inl]
        q1h = np.c_[q1i, np.ones(len(q1i))]
        q2h = np.c_[q2i, np.ones(len(q2i))]
        A = (q2h[:, :, None] * q1h[:, None, :]).reshape(len(q1i), 9)
        _, _, vt = np.linalg.svd(A, full_matrices=False)
        Ecand = vt[-1].reshape(3, 3)
        # project to essential manifold: equal singular values
        U, s, Vt = np.linalg.svd(Ecand)
        Eref = U @ np.diag([1.0, 1.0, 0.0]) @ Vt
        err_ref = sampson_error(Eref, q1, q2)
        if (err_ref < thresh).sum() >= best_inl.sum():
            E_best = Eref
            best_inl = err_ref < thresh
    return E_best, best_inl, int(best_inl.sum())


def decompose_essential(E, q1, q2):
    """Recover (R, t) with cheirality from E and inlier correspondences.

    Returns (R, t_unit) mapping frame-1 points into frame 2
    (p2 = R p1 + t)."""
    U, _, Vt = np.linalg.svd(E)
    if np.linalg.det(U) < 0:
        U = -U
    if np.linalg.det(Vt) < 0:
        Vt = -Vt
    W = np.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]])
    cands = [(U @ W @ Vt, U[:, 2]), (U @ W @ Vt, -U[:, 2]),
             (U @ W.T @ Vt, U[:, 2]), (U @ W.T @ Vt, -U[:, 2])]
    q1h = np.c_[q1, np.ones(len(q1))]
    q2h = np.c_[q2, np.ones(len(q2))]
    best, best_good = None, -1
    for R, t in cands:
        # midpoint triangulation depth test
        good = 0
        for a, b in zip(q1h, q2h):
            # depth of point along ray 1 via linear triangulation:
            # λ1·R·a + t = λ2·b  →  λ1·a − λ2·Rᵀb = −Rᵀt
            A = np.stack([a, -R.T @ b], axis=1)
            rhs = -R.T @ t
            lam, *_ = np.linalg.lstsq(A, rhs, rcond=None)
            if lam[0] > 0 and lam[1] > 0:
                good += 1
        if good > best_good:
            best_good, best = good, (R, t)
    return best

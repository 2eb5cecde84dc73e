"""Port parity: batched homography RANSAC.

jax.random streams cannot be reproduced in torch, so each pair's minimal
sets are drawn with JAX exactly as the reference draws them
(ransac.py:96-97) and handed to the port through ``pick``. Tolerances:
``ok`` equal; the normalized H to 1e-4; inlier masks equal on ≥ 99.5% of
the points (the refine is f32 inverse iteration whose sums run in another
order, so points on the threshold may flip).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageanalysis_tpu.ops import ransac as jr
from imageanalysis_tpu_torch.ops import ransac as tr

N_HYP = 64


def _scene(rng, B, N, outlier_frac, valid_frac, noise=0.7):
    """B pairs of points under one perspective homography each, with
    outliers and invalid (padding) slots."""
    pa = rng.uniform(0, 1000, (B, N, 2)).astype(np.float32)
    pb = np.empty_like(pa)
    for b in range(B):
        H = np.array([[1.0 + 0.02 * b, 0.03, 20.0 - b],
                      [-0.02, 0.98, -30.0], [1e-5, -2e-5 * b, 1.0]])
        q = np.c_[pa[b], np.ones(N)] @ H.T
        pb[b] = q[:, :2] / q[:, 2:] + rng.normal(0, noise, (N, 2))
        out = rng.random(N) < outlier_frac
        pb[b, out] = rng.uniform(0, 1000, (out.sum(), 2))
    valid = rng.random((B, N)) < valid_frac
    return pa, pb, valid


def _jax_picks(key, valid, score_points=512):
    m = min(score_points, valid.shape[0])
    hi = max(min(int(valid.sum()), m), 1)
    return np.asarray(jax.random.randint(key, (N_HYP, 4), 0, hi))


def _run_both(pa, pb, valid, thresh):
    picks, want = [], []
    for b in range(pa.shape[0]):
        key = jax.random.PRNGKey(100 + b)
        picks.append(_jax_picks(key, valid[b]))
        want.append([np.asarray(x) for x in jr.ransac_homography(
            key, jnp.asarray(pa[b]), jnp.asarray(pb[b]),
            jnp.asarray(valid[b]), thresh=thresh, n_hyp=N_HYP)])
    got = tr.ransac_homography(
        torch.from_numpy(pa), torch.from_numpy(pb), torch.from_numpy(valid),
        thresh=thresh, n_hyp=N_HYP, pick=torch.from_numpy(np.stack(picks)))
    return want, got


def _normalized(H):
    return H / np.linalg.norm(H)


@pytest.mark.parametrize("N,outlier_frac,valid_frac", [
    (700, 0.4, 0.8),     # more valid points than the 512-point subset
    (300, 0.3, 0.9),     # fewer: subset slots map 1:1, tail masked
    (600, 0.5, 0.6),     # half outliers, 40% padding
])
def test_ransac_homography_matches_reference(rng, N, outlier_frac,
                                             valid_frac):
    pa, pb, valid = _scene(rng, 4, N, outlier_frac, valid_frac)
    want, got = _run_both(pa, pb, valid, thresh=4.0)
    for b, (H, inl, n_inl, ok) in enumerate(want):
        assert bool(got.ok[b]) == bool(ok)
        np.testing.assert_allclose(_normalized(got.model[b].numpy()),
                                   _normalized(H), atol=1e-4)
        agree = (got.inliers[b].numpy() == inl).mean()
        assert agree >= 0.995, (b, agree)
        assert abs(int(got.n_inliers[b]) - int(n_inl)) <= 0.005 * N


def test_ransac_few_inliers_matches_reference(rng):
    """60% outliers and half the slots padding leave ~70 inliers: the
    hypotheses' errors crowd the threshold, and one refine weight flipped
    by a last-bit difference (the reference sums in another order) moves
    the 2-step refine's H by ~1e-3 while the final inliers still agree."""
    pa, pb, valid = _scene(rng, 4, 600, 0.6, 0.5)
    want, got = _run_both(pa, pb, valid, thresh=4.0)
    for b, (H, inl, _, ok) in enumerate(want):
        assert bool(got.ok[b]) == bool(ok)
        np.testing.assert_allclose(_normalized(got.model[b].numpy()),
                                   _normalized(H), atol=1e-2)
        assert (got.inliers[b].numpy() == inl).mean() >= 0.995


def test_ransac_too_few_points_matches_reference(rng):
    pa, pb, valid = _scene(rng, 2, 64, 0.0, 1.0)
    valid[:] = False
    valid[0, :3] = True                    # 3 valid points: not ok
    want, got = _run_both(pa, pb, valid, thresh=4.0)
    for b, (_, inl, _, ok) in enumerate(want):
        assert not ok and not bool(got.ok[b])
        np.testing.assert_array_equal(got.inliers[b].numpy(), inl)


@pytest.mark.parametrize("N,valid_frac", [(700, 0.8), (300, 0.9), (50, 0.2)])
def test_score_subset_bit_exact_vs_reference(rng, N, valid_frac):
    valid = rng.random((3, N)) < valid_frac
    ranks = tr._valid_cumsum(torch.from_numpy(valid))
    sub, sub_ok = tr._score_subset(torch.from_numpy(valid), ranks, 512)
    for b in range(3):
        jv = jnp.asarray(valid[b])
        js, jok = jr._score_subset(jv, jr._valid_cumsum(jv), 512)
        np.testing.assert_array_equal(sub[b].numpy(), np.asarray(js))
        np.testing.assert_array_equal(sub_ok[b].numpy(), np.asarray(jok))


def test_minimal_solvers_match_reference(rng):
    quads_a = rng.uniform(-1, 1, (5, 4, 2)).astype(np.float32)
    quads_b = quads_a * 1.1 + rng.normal(0, 0.05, (5, 4, 2)).astype(
        np.float32)
    lanes = lambda q, c: [q[:, i, c] for i in range(4)]  # noqa: E731
    want = np.asarray(jr._homography_4pt_scalar(
        *(lanes(jnp.asarray(q), c) for q, c in
          ((quads_a, 0), (quads_a, 1), (quads_b, 0), (quads_b, 1)))))
    got = tr._homography_4pt_scalar(
        *(lanes(torch.from_numpy(q), c) for q, c in
          ((quads_a, 0), (quads_a, 1), (quads_b, 0), (quads_b, 1))))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)

    A = rng.normal(0, 1, (3, 40, 9)).astype(np.float32)
    want_v = np.stack([np.asarray(jr._smallest_eigvec(jnp.asarray(a)))
                       for a in A])
    got_v = tr._smallest_eigvec(torch.from_numpy(A)).numpy()
    np.testing.assert_allclose(got_v, want_v, rtol=1e-4, atol=1e-5)


def test_ransac_with_generator_recovers_planted_homography(rng):
    pa, pb, valid = _scene(rng, 3, 600, 0.4, 0.9, noise=0.3)
    gen = torch.Generator().manual_seed(7)
    res = tr.ransac_homography(torch.from_numpy(pa), torch.from_numpy(pb),
                               torch.from_numpy(valid), thresh=3.0,
                               n_hyp=256, generator=gen)
    assert bool(res.ok.all())
    for b in range(3):
        H = np.array([[1.0 + 0.02 * b, 0.03, 20.0 - b],
                      [-0.02, 0.98, -30.0], [1e-5, -2e-5 * b, 1.0]])
        np.testing.assert_allclose(res.model[b].numpy(), H, rtol=2e-2,
                                   atol=2e-3 * np.abs(H).max())
    # the same seed draws the same samples
    again = tr.ransac_homography(torch.from_numpy(pa), torch.from_numpy(pb),
                                 torch.from_numpy(valid), thresh=3.0,
                                 n_hyp=256,
                                 generator=torch.Generator().manual_seed(7))
    assert torch.equal(again.inliers, res.inliers)


# --- fundamental, essential, similarity ------------------------------------

K_CAM = np.array([[800.0, 0, 500], [0, 800, 400], [0, 0, 1]], np.float32)


def _two_views(rng, B, N, outlier_frac, valid_frac, noise=0.5):
    """B pairs of a non-planar scene (depths 80–160) seen by two cameras
    rotated and translated apart, with outliers and padding slots: the
    8-point filters degenerate on a plane."""
    pa = np.empty((B, N, 2), np.float32)
    pb = np.empty_like(pa)
    for b in range(B):
        X = np.c_[rng.uniform(-50, 50, (N, 2)), rng.uniform(80, 160, N)]
        a = 0.05 + 0.1 * b
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]])
        xa = X @ K_CAM.T
        xb = (X @ R.T + [10.0 + b, 2.0, 1.0]) @ K_CAM.T
        pa[b] = xa[:, :2] / xa[:, 2:]
        pb[b] = xb[:, :2] / xb[:, 2:] + rng.normal(0, noise, (N, 2))
        out = rng.random(N) < outlier_frac
        pb[b, out] = rng.uniform(0, 1000, (out.sum(), 2))
    return pa, pb, rng.random((B, N)) < valid_frac


def _hartley(pts, valid):
    p = pts[valid].astype(np.float64)
    m = p.mean(0)
    s = np.sqrt(2.0) / np.sqrt(((p - m) ** 2).sum(1).mean())
    return np.array([[s, 0, -s * m[0]], [0, s, -s * m[1]], [0, 0, 1.0]])


def _unit(M):
    M = np.asarray(M, np.float64)
    return M / np.linalg.norm(M)


@pytest.mark.parametrize("kind,k", [("fundamental", 8), ("essential", 12)])
def test_ransac_epipolar_matches_reference(rng, kind, k):
    """The reference's draws through pick: ok equal, inlier masks equal on
    ≥ 99.5% of the points (a point within a hair of the threshold may
    flip) and the counts within 0.5%; the matrices, up to sign and scale,
    within 5e-3. Closer is not reachable in f32: a minimal 8-point solve
    is near-singular by construction, so the two packages' hypotheses
    differ by ~1e-3 (their subset scores by up to 18 points of 512), and
    two weighted refinements from those starts stop ~1e-3 apart, with the
    same inliers. test_epipolar_solvers_match_reference holds the solvers
    themselves to 1e-4 on the same inputs. F is compared in the Hartley
    frame both solve in (Tb⁻ᵀ F Ta⁻¹, entries O(1)): in pixels its
    entries span five decades; E is in normalized coordinates already."""
    pa, pb, valid = _two_views(rng, 3, 700, 0.3, 0.8)
    picks, want = [], []
    for b in range(3):
        key = jax.random.PRNGKey(100 + b)
        hi = max(min(int(valid[b].sum()), 512), 1)
        picks.append(np.asarray(jax.random.randint(key, (N_HYP, k), 0, hi)))
        args = (key, jnp.asarray(pa[b]), jnp.asarray(pb[b]),
                jnp.asarray(valid[b]))
        res = (jr.ransac_fundamental(*args, thresh=2.0, n_hyp=N_HYP)
               if kind == "fundamental" else
               jr.ransac_essential(*args, jnp.asarray(K_CAM), thresh=2.0,
                                   n_hyp=N_HYP))
        want.append([np.asarray(x) for x in res])
    targs = (torch.from_numpy(pa), torch.from_numpy(pb),
             torch.from_numpy(valid))
    pick = torch.from_numpy(np.stack(picks))
    got = (tr.ransac_fundamental(*targs, thresh=2.0, n_hyp=N_HYP, pick=pick)
           if kind == "fundamental" else
           tr.ransac_essential(*targs, torch.from_numpy(K_CAM), thresh=2.0,
                               n_hyp=N_HYP, pick=pick))
    for b, (M, inl, n_inl, ok) in enumerate(want):
        assert bool(got.ok[b]) == bool(ok) and bool(ok)
        assert (got.inliers[b].numpy() == inl).mean() >= 0.995
        assert abs(int(got.n_inliers[b]) - int(n_inl)) <= 0.005 * len(inl)
        g = got.model[b].numpy()
        if kind == "fundamental":
            Ta, Tb = _hartley(pa[b], valid[b]), _hartley(pb[b], valid[b])
            M = np.linalg.inv(Tb).T @ M @ np.linalg.inv(Ta)
            g = np.linalg.inv(Tb).T @ g @ np.linalg.inv(Ta)
        M, g = _unit(M), _unit(g)
        g = g if (M * g).sum() > 0 else -g
        np.testing.assert_allclose(g, M, atol=5e-3)


def test_epipolar_solvers_match_reference(rng):
    """The pieces on identical f32 inputs: the weighted 8-point F (rank 2
    by SVD) and E's (1, 1, 0) projection within 1e-4 up to sign and scale;
    the symmetric epipolar distances within 1e-4 relative or 1e-6 (the
    inliers' distances are ~1e-4 here, differences of near-equal f32
    products summed in another order; the threshold is ~1e-2)."""
    pa, pb, valid = _two_views(rng, 2, 300, 0.0, 1.0, noise=0.3)
    w = rng.uniform(0, 1, (2, 300)).astype(np.float32)
    f8, dist = jax.jit(jr._fundamental_8pt), jax.jit(jr._epipolar_dist)
    for b in range(2):
        pa_n, _ = jr._normalize_2d(jnp.asarray(pa[b]), jnp.asarray(valid[b]))
        pb_n, _ = jr._normalize_2d(jnp.asarray(pb[b]), jnp.asarray(valid[b]))
        F = np.asarray(f8(pa_n, pb_n, jnp.asarray(w[b])))
        ta, tb = (torch.from_numpy(np.array(x))[None] for x in (pa_n, pb_n))
        got = tr._fundamental_8pt(ta, tb, torch.from_numpy(w[b:b + 1]))[0]
        g = _unit(got.numpy())
        np.testing.assert_allclose(g if (g * _unit(F)).sum() > 0 else -g,
                                   _unit(F), atol=1e-4)
        np.testing.assert_allclose(
            tr._epipolar_dist(got[None], ta, tb)[0].numpy(),
            np.asarray(dist(jnp.asarray(got.numpy()), pa_n, pb_n)),
            rtol=1e-4, atol=1e-6)
    E = rng.normal(0, 1, (4, 3, 3)).astype(np.float32)
    for e, g in zip(E, tr._essential_project(torch.from_numpy(E))):
        U, _, Vt = jnp.linalg.svd(jnp.asarray(e))
        want = np.asarray((U * jnp.array([1.0, 1.0, 0.0])) @ Vt)
        np.testing.assert_allclose(g.numpy(), want, atol=1e-4)


def test_ransac_similarity_matches_reference(rng):
    """2-point draws over all valid points (the reference's
    _sample_indices, fed through pick): the same masks, the 2×3 model
    within 1e-4 of its largest entry."""
    B, N = 3, 600
    pa = rng.uniform(0, 1000, (B, N, 2)).astype(np.float32)
    th = 0.3
    A = np.array([[1.1 * np.cos(th), -1.1 * np.sin(th), 20.0],
                  [1.1 * np.sin(th), 1.1 * np.cos(th), -5.0]])
    pb = (pa @ A[:, :2].T + A[:, 2]
          + rng.normal(0, 0.5, (B, N, 2))).astype(np.float32)
    out = rng.random((B, N)) < 0.4
    pb[out] = rng.uniform(0, 1000, (out.sum(), 2))
    valid = rng.random((B, N)) < 0.8
    picks, want = [], []
    for b in range(B):
        key = jax.random.PRNGKey(7 + b)
        picks.append(np.asarray(jr._sample_indices(
            key, jnp.asarray(valid[b]), N_HYP, 2)))
        want.append([np.asarray(x) for x in jr.ransac_similarity_2d(
            key, jnp.asarray(pa[b]), jnp.asarray(pb[b]),
            jnp.asarray(valid[b]), n_hyp=N_HYP)])
    got = tr.ransac_similarity_2d(
        torch.from_numpy(pa), torch.from_numpy(pb), torch.from_numpy(valid),
        n_hyp=N_HYP, pick=torch.from_numpy(np.stack(picks)))
    for b, (M, inl, _, ok) in enumerate(want):
        assert bool(got.ok[b]) == bool(ok)
        np.testing.assert_array_equal(got.inliers[b].numpy(), inl)
        np.testing.assert_allclose(got.model[b].numpy(), M,
                                   atol=1e-4 * np.abs(M).max())
    # the port's own draw over the valid points finds the planted model
    mine = tr.ransac_similarity_2d(
        torch.from_numpy(pa), torch.from_numpy(pb), torch.from_numpy(valid),
        n_hyp=N_HYP, generator=torch.Generator().manual_seed(3))
    np.testing.assert_allclose(mine.model.numpy(), np.stack([A] * B),
                               atol=0.05 * np.abs(A).max())


def test_essential5_bit_exact(rng):
    """The host 5-point RANSAC and its decomposition: the port's copy
    equals the reference's bit for bit (the same numpy seeded draw)."""
    from imageanalysis_tpu.ops import essential5 as je5
    from imageanalysis_tpu_torch.ops import essential5 as te5

    pa, pb, valid = _two_views(rng, 1, 200, 0.2, 1.0, noise=0.3)
    Kinv = np.linalg.inv(K_CAM.astype(np.float64))
    q1 = (np.c_[pa[0], np.ones(200)] @ Kinv.T)[:, :2]
    q2 = (np.c_[pb[0], np.ones(200)] @ Kinv.T)[:, :2]
    want = je5.ransac_essential_5pt(q1, q2, thresh=1e-5, n_hyp=64, seed=4)
    got = te5.ransac_essential_5pt(q1, q2, thresh=1e-5, n_hyp=64, seed=4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(te5.decompose_essential(got[0], q1[got[1]], q2[got[1]]),
                    je5.decompose_essential(want[0], q1[want[1]],
                                            q2[want[1]])):
        np.testing.assert_array_equal(g, w)


def test_essential5_post_filter_matches_reference(rng):
    """BatchMatcher's host refilter of a pair's device survivors
    (transform "essential5"): K⁻¹-normalised points, (thresh / f)², 128
    hypotheses, the config's seed; the kept rows and columns equal the
    reference's."""
    import types

    from imageanalysis_tpu.match import matcher as jmatcher
    from imageanalysis_tpu_torch.match import matcher as tmatcher

    pa, pb, _ = _two_views(rng, 1, 300, 0.3, 1.0, noise=0.3)
    perm = rng.permutation(300)
    i1 = types.SimpleNamespace(uv_list=pa[0].astype(np.float64),
                               kp=[None] * 300)
    i2 = types.SimpleNamespace(uv_list=pb[0][perm].astype(np.float64),
                               kp=[None] * 300)
    rows = np.arange(300)
    cols = np.argsort(perm)
    out = []
    for matcher, K in ((jmatcher, jnp.asarray(K_CAM)),
                       (tmatcher, torch.from_numpy(K_CAM))):
        bm = types.SimpleNamespace(
            config=matcher.MatchConfig(transform="essential5"), K=K,
            thresh=3.0)
        out.append(matcher.BatchMatcher._post_filter(bm, i1, i2, rows, cols))
    (wr, wc), (gr, gc) = out
    assert 150 < len(wr) < 300
    np.testing.assert_array_equal(gr, wr)
    np.testing.assert_array_equal(gc, wc)

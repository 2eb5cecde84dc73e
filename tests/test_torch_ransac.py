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

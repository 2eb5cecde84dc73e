"""Port parity: core/ (rotations, camera, geodesy, transforms) and
ops/triangulate.py.

Seeded numpy inputs go through the JAX package and through
imageanalysis_tpu_torch, both in float32 (the float64 geodesy host
functions are the same numpy code and agree exactly). Transcendentals and
sums round differently in XLA and PyTorch, so the f32 results agree to
rtol 1e-5 with an absolute floor for values near zero: 2e-5 for unit
quantities, 2e-4 for the iterative and least-squares ones (inputs
ill-conditioned by ~10²), 1e-3 m and 2e-3 px for metre- and pixel-scale
outputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageanalysis_tpu.core import camera as jcam
from imageanalysis_tpu.core import geodesy as jgeo
from imageanalysis_tpu.core import rotations as jrot
from imageanalysis_tpu.core import transforms as jtr
from imageanalysis_tpu.ops import triangulate as jtri
from imageanalysis_tpu_torch.core import camera as tcam
from imageanalysis_tpu_torch.core import geodesy as tgeo
from imageanalysis_tpu_torch.core import rotations as trot
from imageanalysis_tpu_torch.core import transforms as ttr
from imageanalysis_tpu_torch.ops import triangulate as ttri
from torch_threads import one_torch_thread  # noqa: F401


def _close(got, want, rtol=1e-5, atol=1e-5):
    if isinstance(got, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, rtol, atol)
        return
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(g, np.asarray(want), rtol=rtol, atol=atol)


def _both(fn_j, fn_t, *args):
    """fn_j on jnp arrays, fn_t on torch tensors, of the same numpy args."""
    return (fn_t(*(torch.from_numpy(np.array(a)) for a in args)),
            fn_j(*(jnp.asarray(a) for a in args)))


def _quats(rng, n=16):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _rotmats(rng, n=16):
    return np.asarray(jrot.quat_to_matrix(jnp.asarray(_quats(rng, n))))


ROTATION_CASES = {
    "quat_multiply": lambda rng: (_quats(rng), _quats(rng)),
    "quat_conjugate": lambda rng: (_quats(rng),),
    "quat_inverse": lambda rng: (_quats(rng) * 1.7,),
    "quat_normalize": lambda rng: (_quats(rng) * 3.0,),
    "quat_from_ypr": lambda rng: tuple(
        rng.uniform(-3, 3, 16).astype(np.float32) for _ in range(3)),
    "quat_to_matrix": lambda rng: (_quats(rng) * 2.0,),
    "matrix_to_quat": lambda rng: (_rotmats(rng),),
    "ypr_from_quat": lambda rng: (_quats(rng),),
    "rodrigues": lambda rng: (rng.uniform(-2, 2, (16, 3)).astype(np.float32),),
    "rodrigues_inv": lambda rng: (_rotmats(rng),),
    "rotation_matrix": lambda rng: (
        rng.uniform(-3, 3, 16).astype(np.float32),
        rng.normal(size=(16, 3)).astype(np.float32)),
    "quat_slerp": lambda rng: (_quats(rng), _quats(rng),
                               rng.uniform(0, 1, (16, 1)).astype(np.float32)),
}


@pytest.mark.parametrize("name", sorted(ROTATION_CASES))
def test_rotations_match_reference(rng, name):
    args = ROTATION_CASES[name](rng)
    got, want = _both(getattr(jrot, name), getattr(trot, name), *args)
    _close(got, want, atol=2e-5)


def test_quat_average_matches_reference(rng):
    base = _quats(rng, 1)
    qs = base + rng.normal(0, 0.05, (12, 4)).astype(np.float32)
    w = rng.uniform(0.5, 2, 12).astype(np.float32)
    got, want = _both(jrot.quat_average, trot.quat_average, qs, w)
    _close(got, want, atol=1e-5)


def _cam_inputs(rng):
    K = np.array([[1400.0, 0, 1088], [0, 1400.0, 720], [0, 0, 1]],
                 np.float32)
    dist = np.array([-0.12, 0.05, 1e-3, -5e-4, -0.01], np.float32)
    uv = rng.uniform([0, 0], [2176, 1440], (64, 2)).astype(np.float32)
    return K, dist, uv


CAMERA_CASES = {
    "distort_normalized": lambda K, d, uv, rng: (
        (uv - K[:2, 2]) / K[0, 0], d),
    "undistort_normalized": lambda K, d, uv, rng: (
        (uv - K[:2, 2]) / K[0, 0], d),
    "pixels_to_normalized": lambda K, d, uv, rng: (uv, K),
    "normalized_to_pixels": lambda K, d, uv, rng: ((uv - 1000) / 1400, K),
    "undistort_pixels": lambda K, d, uv, rng: (uv, K, d),
    "redistort_pixels": lambda K, d, uv, rng: (uv, K, d),
    "ned_quat_to_rt": lambda K, d, uv, rng: (
        rng.uniform(-100, 100, (16, 3)).astype(np.float32), _quats(rng)),
    "ned_quat_to_rvec_tvec": lambda K, d, uv, rng: (
        rng.uniform(-100, 100, (16, 3)).astype(np.float32), _quats(rng)),
    "rvec_tvec_to_ned_quat": lambda K, d, uv, rng: (
        rng.uniform(-2, 2, (16, 3)).astype(np.float32),
        rng.uniform(-100, 100, (16, 3)).astype(np.float32)),
    "pixel_vectors_ned": lambda K, d, uv, rng: (uv, _rotmats(rng, 1)[0], K),
    "intersect_ground_plane": lambda K, d, uv, rng: (
        np.array([10.0, -5.0, -100.0], np.float32), np.float32(3.0),
        np.asarray(jcam.pixel_vectors_ned(
            jnp.asarray(uv), jnp.asarray(_rotmats(rng, 1)[0]),
            jnp.asarray(K)))),
}


@pytest.mark.parametrize("name", sorted(CAMERA_CASES))
def test_camera_matches_reference(rng, name):
    K, d, uv = _cam_inputs(rng)
    args = CAMERA_CASES[name](K, d, uv, rng)
    got, want = _both(getattr(jcam, name), getattr(tcam, name), *args)
    _close(got, want, atol=2e-4)


def test_camera_projection_and_host_undistort(rng):
    K, d, uv = _cam_inputs(rng)
    pts = rng.uniform([-50, -50, -5], [50, 50, 5], (64, 3)).astype(np.float32)
    ned = np.array([1.0, 2.0, -100.0], np.float32)
    q = np.asarray(jrot.quat_from_ypr(0.3, -1.5, 0.05), np.float32)
    got, want = _both(jcam.project_ned_quat, tcam.project_ned_quat, pts, ned,
                      q, K, d)
    _close(got, want, rtol=1e-5, atol=2e-3)
    np.testing.assert_allclose(tcam.undistort_pixels_np(uv, K, d),
                               jcam.undistort_pixels_np(uv, K, d), rtol=0,
                               atol=0)
    got, want = _both(jcam.undistort_pixels_flat, tcam.undistort_pixels_flat,
                      uv[:, 0], uv[:, 1], K, d)
    _close(got, want, atol=2e-4)
    model = tcam.CameraModel.from_params(1400.0, 1401.0, 1088.0, 720.0)
    assert float(model.fy) == 1401.0 and float(model.cx) == 1088.0


def test_geodesy_matches_reference(rng):
    ref = (44.97, -93.26, 250.0)
    ned = rng.uniform([-3000, -3000, -200], [3000, 3000, 50], (32, 3))
    lla = jgeo.ned2lla(ned, *ref)
    np.testing.assert_array_equal(tgeo.ned2lla(ned, *ref), lla)
    np.testing.assert_array_equal(
        tgeo.lla2ned(lla[:, 0], lla[:, 1], lla[:, 2], *ref),
        jgeo.lla2ned(lla[:, 0], lla[:, 1], lla[:, 2], *ref))
    np.testing.assert_array_equal(tgeo.ecef2lla(tgeo.lla2ecef(*lla.T)),
                                  jgeo.ecef2lla(jgeo.lla2ecef(*lla.T)))
    lla32 = lla.astype(np.float32)
    _close(tgeo.lla2ned_j(*(torch.from_numpy(c) for c in lla32.T), *ref),
           jgeo.lla2ned_j(*(jnp.asarray(c) for c in lla32.T), *ref),
           rtol=1e-5, atol=1e-3)
    ned32 = ned.astype(np.float32)
    _close(tgeo.ned2lla_j(torch.from_numpy(ned32), *ref),
           jgeo.ned2lla_j(jnp.asarray(ned32), *ref), rtol=1e-6, atol=1e-4)


def test_transforms_match_reference(rng):
    src = rng.uniform(-10, 10, (40, 3)).astype(np.float32)
    R = _rotmats(rng, 1)[0]
    dst = (1.3 * src @ R.T + np.array([1.0, -2.0, 3.0])
           + rng.normal(0, 0.01, src.shape)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 40).astype(np.float32)
    got, want = _both(jtr.umeyama, ttr.umeyama, src, dst, w)
    _close(got, want, atol=2e-4)
    s2, d2 = src[:, :2], dst[:, 1:]
    w2 = np.r_[w[:30], np.zeros(10, np.float32)]
    got, want = _both(jtr.fit_similarity_2d, ttr.fit_similarity_2d, s2, d2,
                      w2)
    _close(got, want, atol=1e-4)
    _close(*_both(jtr.decompose_affine_2d, ttr.decompose_affine_2d,
                  np.asarray(want)))
    _close(ttr.apply_similarity(*(torch.from_numpy(np.array(x))
                                  for x in jtr.umeyama(src, dst)),
                                torch.from_numpy(src)),
           jtr.apply_similarity(*jtr.umeyama(src, dst), src), atol=2e-4)


def test_triangulation_matches_reference(rng):
    """Two nadir cameras 20 m apart over ground points; batched in the
    port, vmapped in the reference."""
    pts = rng.uniform([-30, -30, -3], [30, 30, 3], (2, 64, 3)) \
        .astype(np.float32)
    q = np.asarray(jrot.quat_from_ypr(0.1, -1.55, 0.02), np.float32)
    Ps, uvs = [], []
    for c in ([0.0, 0.0, -100.0], [20.0, 1.0, -101.0]):
        R, t = jcam.ned_quat_to_rt(jnp.asarray(c, jnp.float32),
                                   jnp.asarray(q))
        P = np.asarray(jnp.concatenate([R, t[:, None]], 1))
        xc = pts @ P[:, :3].T + P[:, 3]
        uvs.append((xc[..., :2] / xc[..., 2:] + rng.normal(
            0, 1e-5, xc[..., :2].shape)).astype(np.float32))
        Ps.append(np.broadcast_to(P, (2, 3, 4)).copy())
    import jax

    want = jax.vmap(jtri.triangulate_two_view)(*(jnp.asarray(x) for x in
                                                 (*Ps, *uvs)))
    got = ttri.triangulate_two_view(*(torch.from_numpy(x) for x in
                                      (*Ps, *uvs)))
    _close(got, want, rtol=1e-4, atol=2e-3)
    np.testing.assert_allclose(got.numpy(), pts, atol=0.05)
    origins = rng.uniform(-5, 5, (8, 3)).astype(np.float32)
    target = np.array([1.0, 2.0, 3.0], np.float32)
    dirs = (target - origins + rng.normal(0, 1e-3, origins.shape)) \
        .astype(np.float32)
    mask = np.r_[np.ones(6), np.zeros(2)].astype(np.float32)
    _close(*_both(jtri.triangulate_rays, ttri.triangulate_rays, origins,
                  dirs, mask), atol=1e-4)


def test_projection_helpers_match_reference(rng):
    """projection_matrix and reprojection_depths, batched."""
    R = np.asarray(jrot.quat_to_matrix(jnp.asarray(
        jrot.quat_from_ypr(0.3, -1.5, 0.1))), np.float32)
    R = np.broadcast_to(R, (3, 3, 3)).copy()
    t = rng.uniform(-50, 50, (3, 3)).astype(np.float32)
    K = np.array([[800.0, 0, 320], [0, 800, 240], [0, 0, 1]], np.float32)
    _close(ttri.projection_matrix(*(torch.from_numpy(x) for x in (R, t, K))),
           jtri.projection_matrix(*(jnp.asarray(x) for x in (R, t, K))),
           rtol=1e-6, atol=1e-3)
    pts = rng.uniform(-30, 30, (3, 3)).astype(np.float32)
    _close(*_both(jtri.reprojection_depths, ttri.reprojection_depths, R, t,
                  pts), rtol=1e-6, atol=1e-4)

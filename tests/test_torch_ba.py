"""Port parity: Step 4's Schur-complement LM bundle adjustment.

tests/test_ba.py's 16-camera synth_problem (and its smaller variants)
goes through the JAX package's ba/bundle.py and the port's on the CPU,
both in f32. Tolerances, each with its reason:

- cost and mre: 1e-5 relative (the same f32 residuals, summed in
  another order);
- jacobians: 1e-4 of each parameter column's largest entry (both are
  exact forward-mode derivatives; the two frameworks' derivative formulas
  round differently);
- one lm_solve step at λ = 1e-2: within 2e-3 of the step's largest entry
  (CG in f32 amplifies rounding along the weakly constrained gauge
  directions), predicted decrease 1e-5 relative;
- solve, 10 iterations: the mre within 2% and the final cost within 3%
  of the reference's, iterations within one. After the first two steps
  both crawl along the weakly constrained similarity gauge, where the two
  f32 paths part (about 1% apart in mre at 10 iterations); so the poses
  are held to the truth, up to a similarity, as tests/test_ba.py holds
  them;
- refit, reweight_huber and cull_outliers: f32 rounding (1e-4 m, 1e-5).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_ba
import torch

from imageanalysis_tpu.ba import bundle as jb
from imageanalysis_tpu.core import camera as jcam
from imageanalysis_tpu.core import rotations as jrot
from imageanalysis_tpu.core.transforms import umeyama
from imageanalysis_tpu_torch.ba import bundle as tb
from imageanalysis_tpu_torch.testing.synthetic import (make_ba_grid_graph,
                                                       make_ba_mission_graph)
from test_ba import DIST, K, synth_problem


@pytest.fixture(scope="module")
def problem():
    """The 16-camera problem (1600 observations) as numpy, for both. Its
    generator projects one observation at a time; jitted projections make
    that a second rather than ten."""
    fast = types.SimpleNamespace(
        ned_quat_to_rt=jax.jit(jcam.ned_quat_to_rt),
        project_points=jax.jit(jcam.project_points))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(test_ba, "cam", fast)
        ct, pt, c0, p0, obs = synth_problem(np.random.default_rng(42))
    return ct, pt, c0, p0, tb.BAObservations(*(np.asarray(x) for x in obs))


def _jobs(obs):
    return jb.BAObservations(*(jnp.asarray(x) for x in obs))


def _port(c, p, obs):
    o = tb.observations_on(obs, "cpu")
    return (torch.from_numpy(c), torch.from_numpy(p), o,
            torch.from_numpy(K), torch.from_numpy(DIST))


def test_ba_cost_matches_reference(problem):
    _, _, c0, p0, obs = problem
    want = jb.ba_cost(jnp.asarray(c0), jnp.asarray(p0), _jobs(obs),
                      jnp.asarray(K), jnp.asarray(DIST))
    got = tb.ba_cost(*_port(c0, p0, obs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)


def _cols(J, rows, cols):
    """The reference's [rows][cols] lists of (n,) → (n, rows, cols)."""
    return np.stack([np.stack([np.asarray(J[i][k]) for k in range(cols)],
                              -1) for i in range(rows)], 1)


def test_lm_jacobians_match_reference(problem):
    _, _, c0, p0, obs = problem
    n_cam, n_pt = len(c0), len(p0)
    want = jb.lm_jacobians(jnp.asarray(c0), jnp.asarray(p0), _jobs(obs),
                           jnp.asarray(K), jnp.asarray(DIST), n_cam, n_pt)
    got = tb.lm_jacobians(*_port(c0, p0, obs), n_cam, n_pt)
    for g, w in ((got.Jc, _cols(want[0], 2, 7)),
                 (got.Jp, _cols(want[1], 2, 3))):
        scale = np.abs(w).max(axis=(0, 1))
        assert (np.abs(g.numpy() - w) <= 1e-4 * scale).all()
    np.testing.assert_allclose(got.r.numpy(),
                               np.stack([np.asarray(x) for x in want[2]], 1),
                               rtol=1e-5, atol=1e-3)
    for g, w in ((got.g_c, want[3]),
                 (got.g_p, np.stack([np.asarray(x) for x in want[4]], 1)),
                 (got.Hcc, want[5])):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())
    hpp = got.Hpp.numpy()
    for k, (a, b) in enumerate([(0, 0), (0, 1), (0, 2), (1, 1), (1, 2),
                                (2, 2)]):
        w = np.asarray(want[6][k])
        np.testing.assert_allclose(hpp[:, a, b], w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())
        np.testing.assert_array_equal(hpp[:, a, b], hpp[:, b, a])


def test_lm_solve_matches_reference_and_dense_model(problem):
    """The step and predicted decrease at λ = 1e-2 against the
    reference's; then the port's predicted decrease against the dense
    Gauss–Newton model −(gᵀΔ + ½ΔᵀJᵀJΔ) (tests/test_ba.py:78), J built in
    f64 from the port's blocks, and the gain ratio of the step."""
    _, _, c0, p0, obs = problem
    n_cam, n_pt = len(c0), len(p0)
    jobs = _jobs(obs)
    jac = jb.lm_jacobians(jnp.asarray(c0), jnp.asarray(p0), jobs,
                          jnp.asarray(K), jnp.asarray(DIST), n_cam, n_pt)
    dc, dp, pred = jb.lm_solve(jac, jobs.cam_idx, jobs.pt_idx,
                               jnp.float32(1e-2))
    args = _port(c0, p0, obs)
    tjac = tb.lm_jacobians(*args, n_cam, n_pt)
    tdc, tdp, tpred = tb.lm_solve(tjac, args[2].cam_idx, args[2].pt_idx,
                                  1e-2)
    for g, w in ((tdc, dc), (tdp, dp)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=2e-3 * np.abs(w).max())
    np.testing.assert_allclose(float(tpred), float(pred), rtol=1e-5)

    n = len(obs.uv)
    J = np.zeros((2 * n, 7 * n_cam + 3 * n_pt))
    rows = np.arange(2 * n).reshape(n, 2)
    cols_c = obs.cam_idx[:, None] * 7 + np.arange(7)
    cols_p = 7 * n_cam + obs.pt_idx[:, None] * 3 + np.arange(3)
    J[rows[:, :, None], cols_c[:, None, :]] = tjac.Jc.numpy()
    J[rows[:, :, None], cols_p[:, None, :]] = tjac.Jp.numpy()
    r = tjac.r.numpy().astype(np.float64).ravel()
    delta = np.concatenate([tdc.numpy().ravel(), tdp.numpy().ravel()])
    model = -((J.T @ r) @ delta + 0.5 * delta @ (J.T @ (J @ delta)))
    np.testing.assert_allclose(float(tpred), model, rtol=1e-3)
    c1 = tb.ba_cost(args[0] + tdc, args[1] + tdp, *args[2:])[0]
    rho = (float(tb.ba_cost(*args)[0]) - float(c1)) / float(tpred)
    assert 0.5 < rho < 1.5, rho


def _aligned_err(pts, truth):
    s, R, t = umeyama(jnp.asarray(pts), jnp.asarray(truth))
    al = float(s) * pts @ np.asarray(R).T + np.asarray(t)
    return float(np.median(np.linalg.norm(al - truth, axis=1)))


def test_solve_matches_reference(problem):
    ct, pt, c0, p0, obs = problem
    cfg = dict(max_iters=10, ftol=1e-5)
    want = jb.solve(c0, p0, _jobs(obs), jnp.asarray(K), jnp.asarray(DIST),
                    jb.BAConfig(**cfg), verbose=False)
    got = tb.solve(c0, p0, obs, K, DIST, tb.BAConfig(**cfg), verbose=False,
                   device="cpu")
    assert got.cams.dtype == np.float32 and got.cams.shape == c0.shape
    np.testing.assert_allclose(got.mre, want.mre, rtol=2e-2)
    assert abs(got.iters - want.iters) <= 1
    np.testing.assert_allclose(got.cost_history[0], want.cost_history[0],
                               rtol=1e-5)
    np.testing.assert_allclose(got.cost_history[-1], want.cost_history[-1],
                               rtol=3e-2)
    assert got.mre < 0.5
    assert _aligned_err(got.pts, pt) < 1.0
    # the box bounds around the start positions hold
    d = got.cams[:, :3] - c0[:, :3]
    assert np.all(np.abs(d[:, :2]) <= 3.0 + 1e-4)
    assert np.all(np.abs(d[:, 2]) <= 9.0 + 1e-4)


def test_refit_matches_reference(problem):
    """tests/test_ba.py:144's drift: a known similarity applied to the
    truth; both refits undo it the same way, with and without a camera
    mask."""
    ct, pt, _, _, _ = problem
    Rg = np.asarray(jrot.quat_to_matrix(jrot.quat_from_ypr(0.05, 0.01,
                                                           -0.02)))
    s, t = 1.02, np.array([5.0, -3.0, 2.0], np.float32)
    cams = ct.copy()
    cams[:, :3] = s * ct[:, :3] @ Rg.T + t
    qg = np.asarray(jrot.matrix_to_quat(jnp.asarray(Rg)))
    cams[:, 3:7] = np.asarray(jrot.quat_multiply(qg[None], ct[:, 3:7]))
    pts = (s * pt @ Rg.T + t).astype(np.float32)
    use = np.arange(len(ct)) % 3 != 0
    for mask in (None, use):
        want = jb.refit(cams, pts, ct[:, :3], use_cams=mask)
        got = tb.refit(cams, pts, ct[:, :3], use_cams=mask, device="cpu")
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-4)
        np.testing.assert_allclose(got[2][0], want[2][0], rtol=1e-5)
    np.testing.assert_allclose(got[0][:, :3], ct[:, :3], atol=1e-2)


def _corrupted(problem):
    """10% of the observations moved by 40–200 px (tests/test_ba.py:194)."""
    _, _, c0, p0, obs = problem
    rng = np.random.default_rng(3)
    n = len(obs.uv)
    bad = rng.choice(n, n // 10, replace=False)
    uv = obs.uv.copy()
    uv[bad] += (rng.uniform(40, 200, (len(bad), 2))
                * rng.choice([-1, 1], (len(bad), 2)))
    return c0, p0, obs._replace(uv=uv.astype(np.float32)), bad


def test_reweight_and_cull_match_reference(problem):
    c0, p0, obs, bad = _corrupted(problem)
    jobs = _jobs(obs)
    want = jb.reweight_huber(jnp.asarray(c0), jnp.asarray(p0), jobs,
                             jnp.asarray(K), jnp.asarray(DIST), delta_px=1.5)
    got = tb.reweight_huber(c0, p0, obs, K, DIST, delta_px=1.5,
                            device="cpu")
    np.testing.assert_allclose(got.weight.numpy(), np.asarray(want.weight),
                               rtol=1e-5)
    active = np.arange(len(obs.uv)) % 7 != 0
    for kw in ({}, {"robust": False}, {"active": active}):
        keep_w, th_w = jb.cull_outliers(c0, p0, jobs, jnp.asarray(K),
                                        jnp.asarray(DIST), **kw)
        keep_g, th_g = tb.cull_outliers(c0, p0, obs, K, DIST, device="cpu",
                                        **kw)
        np.testing.assert_allclose(th_g, th_w, rtol=1e-5)
        np.testing.assert_array_equal(keep_g, keep_w)


def test_graduated_irls_and_cull_reject_outliers(problem):
    """The port's robust paths alone (no reference run): solve_culled's
    graduated IRLS leaves Huber weights that single out the planted
    outliers (tests/test_ba.py:228), and its cull drops most of them while
    keeping most inliers."""
    c0, p0, obs, bad = _corrupted(problem)
    res, keep = tb.solve_culled(c0, p0, obs, K, DIST, tb.BAConfig(max_iters=4),
                                huber_px=1.5, cull_rounds=1, verbose=False,
                                device="cpu")
    w = tb.reweight_huber(res.cams, res.pts, obs, K, DIST, delta_px=1.5,
                          device="cpu").weight.numpy() ** 2
    good = np.setdiff1d(np.arange(len(w)), bad)
    assert np.median(w[bad]) < 0.25 * np.median(w[good])
    assert (~keep[bad]).mean() > 0.9 and keep[good].mean() > 0.8


def test_f32_against_f64_on_a_grid_graph():
    """The dtype path: the same 36-camera grid (make_ba_grid_graph, the
    graph of scripts_dev/ba_f64_oracle.py) solved in f32 and in f64 on
    the CPU, 8 iterations: mre within 0.01 px (the oracle's bound) and
    camera positions within 5 mm on average (short of convergence the
    paths part more than the oracle's 1 mm, which chip_smoke.py holds at
    300 cameras)."""
    g = make_ba_grid_graph(n_cam=36, n_pt=1200, device="cpu")
    cfg = tb.BAConfig(max_iters=8, ftol=1e-6)
    r32, r64 = (tb.solve(g.cams0, g.pts0, g.obs, g.K, g.dist, cfg,
                         verbose=False, dtype=dt, device="cpu")
                for dt in (torch.float32, torch.float64))
    assert r64.cams.dtype == np.float64 and r32.cams.dtype == np.float32
    assert abs(r32.mre - r64.mre) < 0.01 and r64.mre < 0.5
    d = np.linalg.norm(r32.cams[:, :3] - r64.cams[:, :3], axis=1)
    assert d.mean() < 5e-3


def test_mission_graph_keeps_observers_in_their_row():
    """testing/synthetic.make_ba_mission_graph's changes from
    scripts_dev/ba_synth_scale.py: a point's observing cameras stay in
    its home camera's row (the script's flat index ±2 wraps to the far
    end of the next row), and they are distinct (the script's draws
    repeat, leaving points seen by one camera). Every observing camera
    lies within two grid steps (60 m) plus the point's 40 m offset along
    the row, and within the 40 m offset across it."""
    g = make_ba_mission_graph(n_cam=100, n_pt=2000, device="cpu")
    cam = g.cams_true[g.obs.cam_idx, :2]
    pt = g.pts_true[g.obs.pt_idx, :2]
    d = (cam - pt).abs()
    assert float(d[:, 0].max()) <= 100.0 + 1e-3
    assert float(d[:, 1].max()) <= 40.0 + 1e-3
    assert len(g.obs.uv) == 3 * 2000
    per_pt = g.obs.cam_idx.view(2000, 3).sort(dim=1).values
    assert bool((per_pt.diff(dim=1) != 0).all())


@pytest.mark.parametrize("observers", ["flat", "distinct"])
def test_mission_graph_start_matches_reference(observers):
    """The mission graph's 2812 cameras with 5,624 points, in f32 through
    both packages' solve, two iterations. With the script's own observers
    ("flat") rays wrapped across rows graze the image plane (residuals
    of 1e7 px), and both packages end far from a solution, their mre
    above 100 px (their f32 paths part from the first step on this
    graph). With the port's distinct in-row observers both take two
    steps, each cutting the cost at least tenfold. Start costs agree within 1e-5,
    1e-4 on the flat graph: its cost is that of a few rays with camera z
    near 0, where the f32 projections' rounding is relatively large."""
    g = make_ba_mission_graph(n_pt=5624, device="cpu", observers=observers)
    c0, p0 = g.cams0.numpy(), g.pts0.numpy()
    obs = tb.BAObservations(*(x.numpy() for x in g.obs))
    cfg = dict(max_iters=2)
    want = jb.solve(c0, p0, _jobs(obs), jnp.asarray(g.K.numpy()),
                    jnp.asarray(g.dist.numpy()), jb.BAConfig(**cfg),
                    verbose=False)
    got = tb.solve(c0, p0, obs, g.K, g.dist, tb.BAConfig(**cfg),
                   verbose=False, device="cpu")
    np.testing.assert_allclose(got.cost_history[0], want.cost_history[0],
                               rtol=1e-4 if observers == "flat" else 1e-5)
    if observers == "flat":
        assert want.mre > 100.0 and got.mre > 100.0
        return
    for h in (want.cost_history, got.cost_history):
        assert len(h) == 3 and h[1] < 0.1 * h[0] and h[2] < 0.1 * h[1]


def test_solve_f64_follows_reference_on_the_mission_graph():
    """In f64 the two packages take one LM path: the mission graph's 2812
    cameras (distinct in-row observers) with 5,624 points, five
    iterations; every accepted cost within 1e-6 relative, the final mre
    and camera positions within 1e-6 px and 1e-6 m."""
    g = make_ba_mission_graph(n_pt=5624, device="cpu", dtype=torch.float64)
    c0, p0 = g.cams0.numpy(), g.pts0.numpy()
    obs = tb.BAObservations(*(x.numpy() for x in g.obs))
    cfg = dict(max_iters=5)
    with jax.enable_x64(True):
        want = jb.solve(c0, p0, _jobs(obs), jnp.asarray(g.K.numpy()),
                        jnp.asarray(g.dist.numpy()), jb.BAConfig(**cfg),
                        verbose=False, dtype=jnp.float64)
    got = tb.solve(c0, p0, obs, g.K, g.dist, tb.BAConfig(**cfg),
                   verbose=False, dtype=torch.float64, device="cpu")
    assert want.cams.dtype == got.cams.dtype == np.float64
    assert len(got.cost_history) == len(want.cost_history) == 6
    np.testing.assert_allclose(got.cost_history, want.cost_history,
                               rtol=1e-6)
    np.testing.assert_allclose(got.mre, want.mre, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.cams[:, :3], want.cams[:, :3], rtol=0,
                               atol=1e-6)


# --- the calibration path (--cam-calibration) --------------------------------

@pytest.fixture(scope="module")
def calib_problem():
    """tests/test_ba.py's test_calibration_refinement problem (12 cameras,
    300 points, 0.2 px noise, its rng fixture's seed) and its wrong start:
    f 60 px low, k1 = 0.03."""
    fast = types.SimpleNamespace(
        ned_quat_to_rt=jax.jit(jcam.ned_quat_to_rt),
        project_points=jax.jit(jcam.project_points))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(test_ba, "cam", fast)
        _, _, c0, p0, obs = synth_problem(np.random.default_rng(42),
                                          n_cam=12, n_pt=300, px_noise=0.2)
    K_bad = K.copy()
    K_bad[0, 0] = K_bad[1, 1] = 1740.0
    dist_bad = np.array([0.03, 0, 0, 0, 0], np.float32)
    return c0, p0, tb.BAObservations(*(np.asarray(x) for x in obs)), \
        K_bad, dist_bad


def test_lm_step_calib_f64_matches_reference(calib_problem):
    """One bordered-Schur step (7-wide cameras, 3×3 points, the 8-wide
    calibration block, the GPS prior, block-Jacobi PCG) at the start of
    test_calibration_refinement's solve, λ = 1e-3, cg_iters 40 as
    solve_with_calibration runs it. In f64: within 1e-6 of each output's
    largest entry. In f32, against that f64 step: the port's Δf within
    0.5 px (0.06 here), where the reference's own f32 step is 2.3 px off;
    the f32 paths' whole-batch sums run in other orders, and the system is
    ill-conditioned along the f·h gauge."""
    c0, p0, obs, K_bad, dist_bad = calib_problem
    calib = np.r_[1740.0, K[0, 2], K[1, 2], dist_bad].astype(np.float64)
    args = (1e-3, None, 0.25, len(c0), len(p0))
    with jax.enable_x64(True):
        jobs = jb.BAObservations(
            jnp.asarray(obs.cam_idx), jnp.asarray(obs.pt_idx),
            jnp.asarray(obs.uv, jnp.float64),
            jnp.asarray(obs.weight, jnp.float64))
        want = [np.asarray(x) for x in jb.lm_step_calib(
            jnp.asarray(c0, jnp.float64), jnp.asarray(p0, jnp.float64),
            jnp.asarray(calib), jobs, args[0],
            jnp.asarray(c0[:, :3], jnp.float64), *args[2:], cg_iters=40)]
    for dtype in (torch.float64, torch.float32):
        got = tb.lm_step_calib(
            torch.from_numpy(c0).to(dtype), torch.from_numpy(p0).to(dtype),
            torch.from_numpy(calib).to(dtype),
            tb.observations_on(obs, "cpu", dtype), args[0],
            torch.from_numpy(c0[:, :3]).to(dtype), *args[2:], cg_iters=40)
        if dtype == torch.float64:
            for g, w in zip(got, want):
                assert w.dtype == np.float64
                np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                           atol=1e-6 * np.abs(w).max())
        else:
            assert abs(float(got[2][0]) - want[2][0]) <= 0.5


def test_solve_with_calibration_meets_the_reference_criteria(calib_problem):
    """solve_with_calibration in f32 as tests/test_ba.py's
    test_calibration_refinement runs the reference (25 iterations, ftol
    1e-6), held to that test's criteria: k1 within 0.01 of 0, f at least
    25% of the way back to 1800 (f trades against the flight altitude on
    a near-planar scene, ba/calibrate.py), mre under 0.2 px. The step it
    iterates is held to the reference's above."""
    from imageanalysis_tpu_torch.ba import calibrate as tcal

    c0, p0, obs, K_bad, dist_bad = calib_problem
    result, K_fit, dist_fit = tcal.solve_with_calibration(
        c0, p0, obs, K_bad, dist_bad,
        config=tb.BAConfig(max_iters=25, ftol=1e-6), verbose=False,
        device="cpu")
    assert abs(dist_fit[0]) < 0.01, dist_fit[0]
    assert K_fit[0, 0] > 1755.0, K_fit[0, 0]
    assert result.mre < 0.2

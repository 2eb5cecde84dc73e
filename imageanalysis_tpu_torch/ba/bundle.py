"""Sparse bundle adjustment: matrix-free Schur-complement Levenberg–Marquardt.

Port of ``imageanalysis_tpu/ba/bundle.py`` (Step 4 of ``apps/process.py``)
less the calibration path (``lm_step_calib``, ``solve_global_calib``,
``ba_cost_calib``; ROADMAP). What it computes is the reference's:

- residuals: the reprojection error of every observation through
  ``core/camera.py::project_ned_quat`` (distortion applied, raw uv);
- per-observation jacobians Jc (n, 2, 7) over the camera's NED position
  and NED→body quaternion and Jp (n, 2, 3) over the point: one
  ``torch.func.jvp`` of the whole-batch residual per parameter direction,
  exact forward-mode derivatives;
- the normal equations are never formed. The camera-reduced (Schur)
  system S·Δc = b is solved by preconditioned CG, each product with S two
  segment sums over the observations (``index_add_``) and closed-form 3×3
  point-block solves; the damped 7×7 camera blocks are the block-Jacobi
  preconditioner. CG stops at the reference's iterate: before each
  iteration the host reads ‖r‖/‖b‖ and stops at ``cg_tol`` or after
  ``cg_iters`` (one device sync per iteration);
- Levenberg–Marquardt damping λ·diag(H) with Nielsen's gain-ratio update;
  camera positions box-clamped to ±3 m horizontal / ±9 m vertical of the
  initial (GPS) positions after every step, quaternions renormalized.

Layout: the reference keeps every observation-sized quantity strictly
1-D, a TPU tiling limit; here they are tensors (n, 2, 7), (n, 2, 3) and
(n, 2), about 0.4 GB in f32 at 4.06M observations. On CUDA ``index_add_``
sums with atomics in no fixed order, so results vary from run to run in
the last bits of f32. The LM outer loop runs on the host and reads the
cost once per trial step, as the reference. Everything else runs on
``device``, in ``dtype`` (``torch.float64`` is the conditioning oracle).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jvp

from ..core.camera import project_ned_quat
from ..core.rotations import matrix_to_quat, quat_multiply
from ..core.transforms import umeyama


class BAObservations(NamedTuple):
    """Observation arrays (pad with weight 0): cam_idx, pt_idx (n,) ints;
    uv (n, 2) observed distorted pixels; weight (n,) — 0 for padding, 1
    (or a robust weight) otherwise. numpy arrays or tensors."""

    cam_idx: object
    pt_idx: object
    uv: object
    weight: object


class BAConfig(NamedTuple):
    max_iters: int = 50
    ftol: float = 1e-4          # relative cost decrease stop
    lam0: float = 1e-3
    lam_up: float = 4.0
    lam_down: float = 3.0
    cg_iters: int = 40
    cg_tol: float = 1e-3
    max_retries: int = 6
    bound_horiz: float = 3.0
    bound_vert: float = 9.0


class BAJacobians(NamedTuple):
    """The λ-independent half of an LM step (lm_jacobians): Jc (n, 2, 7),
    Jp (n, 2, 3), r (n, 2); gradients g_c (n_cam, 7), g_p (n_pt, 3);
    undamped blocks Hcc (n_cam, 7, 7) and Hpp (n_pt, 3, 3)."""

    Jc: torch.Tensor
    Jp: torch.Tensor
    r: torch.Tensor
    g_c: torch.Tensor
    g_p: torch.Tensor
    Hcc: torch.Tensor
    Hpp: torch.Tensor


def _on(x, device, dtype=None):
    """x (numpy, list or tensor) as a tensor on device, in dtype (x's own
    when None)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    return x.to(device=device, dtype=dtype or x.dtype)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def observations_on(obs, device="cuda", dtype=torch.float32):
    """obs with tensors on device: int64 indices, uv and weight in dtype."""
    dev = torch.device(device)
    return BAObservations(_on(obs.cam_idx, dev, torch.int64),
                          _on(obs.pt_idx, dev, torch.int64),
                          _on(obs.uv, dev, dtype), _on(obs.weight, dev, dtype))


def _problem_on(cams, pts, obs, K, dist, device, dtype):
    dev = torch.device(device)
    return (_on(cams, dev, dtype), _on(pts, dev, dtype),
            observations_on(obs, dev, dtype), _on(K, dev, dtype),
            _on(dist, dev, dtype))


def _residuals(cams, pts, obs, K, dist):
    """(n_obs, 2) weighted residuals (pred − observed); all tensors on one
    device, in one dtype."""
    c = cams[obs.cam_idx]
    p = pts[obs.pt_idx]
    pred, _ = project_ned_quat(p, c[:, :3], c[:, 3:7], K, dist)
    return (pred - obs.uv) * obs.weight[:, None]


def _per_obs_jacobians(cams, pts, obs, K, dist):
    """(Jc (n, 2, 7), Jp (n, 2, 3), r (n, 2)): one forward-mode JVP of the
    whole-batch residual per parameter direction, one tangent chain live
    at a time."""
    c = cams[obs.cam_idx]
    p = pts[obs.pt_idx]
    uv, w = obs.uv, obs.weight

    def F(c_, p_):
        pred, _ = project_ned_quat(p_, c_[:, :3], c_[:, 3:7], K, dist)
        return (pred - uv) * w[:, None]

    n = c.shape[0]
    Jc = c.new_empty((n, 2, 7))
    Jp = c.new_empty((n, 2, 3))
    r = None
    for k in range(10):
        if k < 7:
            e = torch.zeros_like(c)
            e[:, k] = 1.0
            out, col = jvp(lambda c_: F(c_, p), (c,), (e,))
            Jc[:, :, k] = col
        else:
            e = torch.zeros_like(p)
            e[:, k - 7] = 1.0
            out, col = jvp(lambda p_: F(c, p_), (p,), (e,))
            Jp[:, :, k - 7] = col
        if r is None:
            r = out
    return Jc, Jp, r


def _seg(x, idx, num):
    """segment_sum: rows of x added into num rows by idx (index_add_)."""
    return x.new_zeros((num,) + tuple(x.shape[1:])).index_add_(0, idx, x)


def _outer2(J):
    """Σ_i J[:, i, k]·J[:, i, l] over the two residual rows: (n, k, k)."""
    return (J[:, 0, :, None] * J[:, 0, None, :]
            + J[:, 1, :, None] * J[:, 1, None, :])


def _apply_T(J, r):
    """Σ_i J[:, i, k]·r[:, i]: (n, k)."""
    return J[:, 0] * r[:, 0:1] + J[:, 1] * r[:, 1:2]


def lm_jacobians(cams, pts, obs, K, dist, n_cam, n_pt):
    """The λ-independent half of the LM step: per-observation jacobians,
    gradients and undamped normal-equation blocks, computed once per outer
    iteration and reused by lm_solve across λ retries (the ten JVPs are
    the costly part at mission scale). Tensors on one device; obs from
    observations_on. Returns BAJacobians."""
    Jc, Jp, r = _per_obs_jacobians(cams, pts, obs, K, dist)
    g_c = _seg(_apply_T(Jc, r), obs.cam_idx, n_cam)
    g_p = _seg(_apply_T(Jp, r), obs.pt_idx, n_pt)
    Hcc = _seg(_outer2(Jc), obs.cam_idx, n_cam)
    Hpp = _seg(_outer2(Jp), obs.pt_idx, n_pt)
    return BAJacobians(Jc, Jp, r, g_c, g_p, Hcc, Hpp)


def _hpp_inverse(Hpp, lam):
    """Closed-form inverses of the damped symmetric 3×3 point blocks
    (cofactors over the determinant, floored at 1e-20): (n_pt, 3, 3)."""
    a = Hpp[:, 0, 0] + lam * Hpp[:, 0, 0] + 1e-8
    d = Hpp[:, 1, 1] + lam * Hpp[:, 1, 1] + 1e-8
    f = Hpp[:, 2, 2] + lam * Hpp[:, 2, 2] + 1e-8
    b3, c3, e3 = Hpp[:, 0, 1], Hpp[:, 0, 2], Hpp[:, 1, 2]
    A_ = d * f - e3 * e3
    B_ = c3 * e3 - b3 * f
    C_ = b3 * e3 - c3 * d
    det = a * A_ + b3 * B_ + c3 * C_
    det = torch.where(det.abs() < 1e-20, 1e-20, det)
    i11 = a * f - c3 * c3
    i12 = b3 * c3 - a * e3
    i22 = a * d - b3 * b3
    cof = torch.stack([A_, B_, C_, B_, i11, i12, C_, i12, i22], dim=-1)
    return (cof / det[:, None]).view(-1, 3, 3)


def _matvec(M, v):
    """Batched M·v: (m, k, l) × (m, l) → (m, k)."""
    return (M * v[:, None, :]).sum(-1)


def lm_solve(jac, cam_idx, pt_idx, lam, cg_iters=40, cg_tol=1e-3,
             info=None):
    """The per-λ half of the LM step: damp the blocks of jac, solve the
    camera-reduced (Schur) system by PCG, back-substitute the points.
    Returns (Δcams (n_cam, 7), Δpts (n_pt, 3), predicted decrease), the
    last a 0-dim tensor: −(gᵀΔ + ½‖JΔ‖²), exact whatever CG's tolerance.
    info (a dict, optional) receives the CG iterations run ("cg_iters")
    and the final ‖r‖/‖b‖ ("cg_rel")."""
    Jc, Jp, _, g_c, g_p, Hcc, Hpp = jac
    n_cam, n_pt = g_c.shape[0], g_p.shape[0]
    eye7 = torch.eye(7, dtype=g_c.dtype, device=g_c.device)
    dc = torch.diagonal(Hcc, dim1=1, dim2=2)
    Hcc_d = Hcc + lam * torch.diag_embed(dc) + 1e-8 * eye7
    Hpp_inv = _hpp_inverse(Hpp, lam)

    def obs_cam(v):          # Jc · v[cam]: (n, 2)
        return _matvec(Jc, v[cam_idx])

    def obs_pt(y):           # Jp · y[pt]: (n, 2)
        return _matvec(Jp, y[pt_idx])

    def cam_T(z):            # Σ_obs Jcᵀ z: (n_cam, 7)
        return _seg(_apply_T(Jc, z), cam_idx, n_cam)

    def pt_T(u):             # Σ_obs Jpᵀ u: (n_pt, 3)
        return _seg(_apply_T(Jp, u), pt_idx, n_pt)

    def schur_matvec(v):
        y = _matvec(Hpp_inv, pt_T(obs_cam(v)))
        return _matvec(Hcc_d, v) - cam_T(obs_pt(y))

    def dot(a_, b_):
        return (a_ * b_).sum()

    # rhs: b = −(g_c − H_cp Hpp⁻¹ g_p)
    b = -(g_c - cam_T(obs_pt(_matvec(Hpp_inv, g_p))))
    Pc = torch.linalg.inv(Hcc_d + 1e-6 * eye7)
    x = torch.zeros_like(b)
    rr = b
    p = _matvec(Pc, rr)
    rz = dot(rr, p)
    b_norm = torch.sqrt(dot(b, b)) + 1e-30
    it = 0
    while it < cg_iters and bool(torch.sqrt(dot(rr, rr)) / b_norm > cg_tol):
        Ap = schur_matvec(p)
        alpha = rz / dot(p, Ap).clamp_min(1e-30)
        x = x + alpha * p
        rr = rr - alpha * Ap
        zz = _matvec(Pc, rr)
        rz_new = dot(rr, zz)
        beta = rz_new / rz.clamp_min(1e-30)
        p = zz + beta * p
        rz = rz_new
        it += 1
    if info is not None:
        info["cg_iters"] = it
        info["cg_rel"] = float(torch.sqrt(dot(rr, rr)) / b_norm)

    # back-substitute points: Δp = Hpp⁻¹ (−g_p − H_pc Δc)
    u = obs_cam(x)
    dp = _matvec(Hpp_inv, -g_p - pt_T(u))
    j_delta = u + obs_pt(dp)
    g_dot_d = dot(x, g_c) + dot(dp, g_p)
    pred_dec = -(g_dot_d + 0.5 * dot(j_delta, j_delta))
    return x, dp, pred_dec


def lm_step(cams, pts, obs, K, dist, lam, n_cam, n_pt, cg_iters=40,
            cg_tol=1e-3):
    """One damped Gauss–Newton step: lm_jacobians then lm_solve."""
    jac = lm_jacobians(cams, pts, obs, K, dist, n_cam, n_pt)
    return lm_solve(jac, obs.cam_idx, obs.pt_idx, lam, cg_iters=cg_iters,
                    cg_tol=cg_tol)


def ba_cost(cams, pts, obs, K, dist):
    """(cost = ½‖r‖², mre = Σ|r| / (2 Σw), max |r|) as 0-dim tensors."""
    r = _residuals(cams, pts, obs, K, dist)
    cost = 0.5 * (r * r).sum()
    wsum = obs.weight.sum().clamp_min(1.0)
    a = r.abs()
    return cost, a.sum() / (2.0 * wsum), a.max()


class BAResult(NamedTuple):
    cams: np.ndarray
    pts: np.ndarray
    mre: float
    iters: int
    cost_history: list


def _median(x):
    """The median as numpy's: the mean of the two middle values for an
    even count (torch.median returns the lower one)."""
    s = torch.sort(x.reshape(-1)).values
    n = s.numel()
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


def reweight_huber(cams, pts, obs, K, dist, delta_px=4.0, device="cuda"):
    """One IRLS pass: Huber weights w = min(1, δ/|r|) folded into the
    observation weights (as √w, the residual's factor), from f32
    residuals. Returns obs with its arrays as f32 tensors on device."""
    cams, pts, obs, K, dist = _problem_on(cams, pts, obs, K, dist, device,
                                          torch.float32)
    mag = torch.linalg.vector_norm(_residuals(cams, pts, obs, K, dist),
                                   dim=-1)
    base = (obs.weight > 0).float()
    w = base * torch.clamp_max(delta_px / mag.clamp_min(1e-6), 1.0)
    return obs._replace(weight=torch.sqrt(w))


def cull_outliers(cams, pts, obs, K, dist, sigma=5.0, robust=True,
                  active=None, device="cuda"):
    """Observation outlier mask at the current solution: |r| > median +
    sigma·1.4826·MAD (robust) or > mean + sigma·std. Residuals are taken
    unweighted in f32; active (bool mask) limits the statistics, and
    inactive rows come back True. Returns (keep_mask, threshold) numpy."""
    cams, pts, obs, K, dist = _problem_on(cams, pts, obs, K, dist, device,
                                          torch.float32)
    obs = obs._replace(weight=torch.ones_like(obs.weight))
    mag = torch.linalg.vector_norm(_residuals(cams, pts, obs, K, dist),
                                   dim=-1).cpu().numpy()
    sel = mag if active is None else mag[np.asarray(active)]
    if len(sel) == 0:
        return np.ones(len(mag), bool), float("inf")
    if robust:
        med = float(np.median(sel))
        mad = float(np.median(np.abs(sel - med)))
        thresh = med + sigma * 1.4826 * mad
    else:
        thresh = float(sel.mean() + sigma * sel.std())
    keep = mag <= thresh
    if active is not None:
        keep |= ~np.asarray(active)
    return keep, thresh


def solve_culled(cams0, pts0, obs, K, dist, config=None, huber_px=4.0,
                 cull_sigma=5.0, cull_rounds=3, verbose=True, log_fn=print,
                 bound_anchor=None, device="cuda"):
    """A graduated-IRLS solve, then up to cull_rounds of (robust cull →
    refine), culling by zeroing weights. Returns (BAResult, keep_mask)."""
    config = config or BAConfig()
    anchor = (np.asarray(bound_anchor) if bound_anchor is not None
              else np.asarray(cams0)[:, :3])
    result = solve(cams0, pts0, obs, K, dist, config, verbose=verbose,
                   log_fn=log_fn, huber_px=huber_px, bound_anchor=anchor,
                   device=device)
    active = np.ones(len(obs.uv), bool)
    base_w = _np(obs.weight)
    for rnd in range(cull_rounds):
        keep, thresh = cull_outliers(result.cams, result.pts, obs, K, dist,
                                     sigma=cull_sigma, active=active,
                                     device=device)
        drop = active & ~keep
        if not drop.any():
            break
        active &= keep
        if verbose:
            log_fn(f"cull round {rnd}: threshold {thresh:.2f}px, dropped "
                   f"{int(drop.sum())} obs ({int(active.sum())} remain)")
        obs2 = obs._replace(
            weight=np.where(active, base_w, 0.0).astype(np.float32))
        result = solve(result.cams, result.pts, obs2, K, dist, config,
                       verbose=verbose, log_fn=log_fn, huber_px=huber_px,
                       irls_rounds=1, bound_anchor=anchor, device=device)
    return result, active


def solve(cams0, pts0, obs, K, dist, config: BAConfig = BAConfig(),
          verbose=True, log_fn=print, huber_px=None, irls_rounds=2,
          dtype=None, bound_anchor=None, device="cuda"):
    """The LM outer loop, driven from the host; every inner computation
    runs on device in dtype (torch.float32 when None).

    cams0 (n_cam, 7) [ned, quat]; pts0 (n_pt, 3); obs BAObservations
    (numpy or tensors). huber_px turns on graduated IRLS: the first Huber
    scale is the median residual (annealed by /6 per round down to
    huber_px), then irls_rounds + 1 reweighted solves. Returns BAResult
    (numpy cams and pts). Logs mre/max/cost per accepted iteration."""
    dtype = dtype or torch.float32
    if huber_px is not None:
        c32, p32, o32, K32, d32 = _problem_on(cams0, pts0, obs, K, dist,
                                              device, torch.float32)
        r0 = _residuals(c32, p32, o32, K32, d32)
        delta = max(float(_median(torch.linalg.vector_norm(r0, dim=-1))),
                    float(huber_px))
        # bounds stay anchored at the original GPS positions across rounds
        anchor = (np.asarray(bound_anchor) if bound_anchor is not None
                  else np.asarray(cams0)[:, :3])
        cams, pts = cams0, pts0
        result = None
        for _ in range(irls_rounds + 1):
            obs_w = reweight_huber(cams, pts, obs, K, dist, delta_px=delta,
                                   device=device)
            result = solve(cams, pts, obs_w, K, dist, config,
                           verbose=verbose, log_fn=log_fn, dtype=dtype,
                           bound_anchor=anchor, device=device)
            cams, pts = result.cams, result.pts
            delta = max(delta / 6.0, float(huber_px))
        return result
    cams, pts, obs, K, dist = _problem_on(cams0, pts0, obs, K, dist, device,
                                          dtype)
    n_cam, n_pt = cams.shape[0], pts.shape[0]
    ned0 = (_on(bound_anchor, cams.device, dtype)
            if bound_anchor is not None else cams[:, :3])
    box = torch.tensor([config.bound_horiz, config.bound_horiz,
                        config.bound_vert], dtype=dtype, device=cams.device)
    lo, hi = ned0 - box, ned0 + box

    lam = config.lam0
    nu = 2.0
    cost, mre, mx = ba_cost(cams, pts, obs, K, dist)
    cost = float(cost)
    history = [cost]
    if verbose:
        log_fn(f"BA start: cost={cost:.4g} mre={float(mre):.3f}px "
               f"max={float(mx):.2f}px")
    it = 0
    for it in range(config.max_iters):
        accepted = False
        jac = lm_jacobians(cams, pts, obs, K, dist, n_cam, n_pt)
        for _ in range(config.max_retries):
            dc, dp, pred_dec = lm_solve(jac, obs.cam_idx, obs.pt_idx, lam,
                                        cg_iters=config.cg_iters,
                                        cg_tol=config.cg_tol)
            cams_new = cams + dc
            ned = torch.clamp(cams_new[:, :3], lo, hi)
            q = cams_new[:, 3:7]
            q = q / torch.linalg.vector_norm(q, dim=-1,
                                             keepdim=True).clamp_min(1e-12)
            cams_new = torch.cat([ned, q], dim=1)
            pts_new = pts + dp
            new_cost, new_mre, new_mx = ba_cost(cams_new, pts_new, obs, K,
                                                dist)
            new_cost = float(new_cost)
            if np.isfinite(new_cost) and new_cost < cost:
                # Nielsen gain-ratio damping: actual against predicted
                rho = (cost - new_cost) / max(float(pred_dec), 1e-30)
                cams, pts = cams_new, pts_new
                rel = 1.0 - new_cost / cost
                cost = new_cost
                lam = max(lam * max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3),
                          1e-9)
                nu = 2.0
                accepted = True
                if verbose:
                    log_fn(f"  iter {it}: mre={float(new_mre):.3f}px "
                           f"max={float(new_mx):.2f}px cost={cost:.4g} "
                           f"lam={lam:.1e}")
                history.append(cost)
                if rel < config.ftol:
                    it += 1
                    accepted = "converged"
                break
            if verbose:
                log_fn(f"  iter {it}: step rejected at lam={lam:.1e} "
                       f"(cost {new_cost:.4g}, predicted decrease "
                       f"{float(pred_dec):.4g})")
            lam = min(lam * nu, 1e6)
            nu = min(nu * 2.0, 64.0)
        if accepted == "converged" or not accepted:
            break

    _, mre, _ = ba_cost(cams, pts, obs, K, dist)
    return BAResult(cams.cpu().numpy(), pts.cpu().numpy(), float(mre), it + 1,
                    history)


def refit(cams, pts, gps_ned, use_cams=None, device="cuda"):
    """Similarity re-registration of the optimized solution onto the GPS
    positions: fit scale/R/t (Umeyama) mapping optimized camera positions
    onto gps_ned, then apply it to cameras (position and attitude) and
    points. use_cams: bool mask of the cameras in the fit. Runs in cams'
    dtype; returns (cams, pts, (s, R, t)) as numpy."""
    dev = torch.device(device)
    cams = _on(cams, dev)
    pts = _on(pts, dev, cams.dtype)
    gps = _on(gps_ned, dev, cams.dtype)
    w = None if use_cams is None else _on(use_cams, dev, cams.dtype)
    s, R, t = umeyama(cams[:, :3], gps, weights=w)
    new_ned = s * cams[:, :3] @ R.T + t
    new_pts = s * pts @ R.T + t
    # rotate attitudes: body2ned' = R · body2ned
    new_q = quat_multiply(matrix_to_quat(R)[None, :], cams[:, 3:7])
    new_cams = torch.cat([new_ned, new_q], dim=1)
    return (new_cams.cpu().numpy(), new_pts.cpu().numpy(),
            (float(s), R.cpu().numpy(), t.cpu().numpy()))

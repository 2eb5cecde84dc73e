"""Trace every trial step of bundle.solve's LM loop on the mission-scale BA
graph, to see why a solve stops.

Runs the loop of ``imageanalysis_tpu_torch/ba/bundle.py::solve`` (same
damping, retries, box clamp and stopping rule, no IRLS) on
``testing/synthetic.make_ba_mission_graph`` and prints one JSON line per
trial step:

- ``lam``, ``pred_dec`` (the Gauss–Newton model's decrease), ``cost`` and
  ``new_cost`` (the step as solve takes it: positions box-clamped),
  ``free_cost`` (the same step without the clamp) and ``accepted``;
- ``cg_iters`` and ``cg_rel`` (‖r‖/‖b‖ where CG stopped), ``clamped``
  (cameras whose position the box clamped);
- the largest camera position step and point step, m.

Then a summary: the stop reason, the final cost against the noise floor
½σ²(2·n_obs − 7·n_cam − 3·n_pt), the max residual, and for the ten
largest residuals the number of distinct cameras that see the point and
the horizontal camera-to-point distance.

Usage (the card by default):
    python scripts_torch/ba_lm_probe.py [--graph distinct|row|flat] [--dtype f32|f64]
        [--n-pt N] [--iters N] [--retries N] [--device cuda|cpu]
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from imageanalysis_tpu_torch.ba import bundle  # noqa: E402
from imageanalysis_tpu_torch.testing.synthetic import (  # noqa: E402
    make_ba_mission_graph)


def trace_solve(g, cfg, dtype, device, out=print):
    """solve's LM loop on the graph g with a line per trial step; returns
    (cams, pts, history, stop) with stop in converged/stalled/max_iters."""
    cams, pts, obs, K, dist = bundle._problem_on(
        g.cams0, g.pts0, g.obs, g.K, g.dist, device, dtype)
    n_cam, n_pt = cams.shape[0], pts.shape[0]
    box = torch.tensor([cfg.bound_horiz, cfg.bound_horiz, cfg.bound_vert],
                       dtype=dtype, device=cams.device)
    lo, hi = cams[:, :3] - box, cams[:, :3] + box
    lam, nu = cfg.lam0, 2.0
    cost = float(bundle.ba_cost(cams, pts, obs, K, dist)[0])
    history, stop = [cost], "max_iters"
    for it in range(cfg.max_iters):
        t0 = time.perf_counter()
        jac = bundle.lm_jacobians(cams, pts, obs, K, dist, n_cam, n_pt)
        accepted = False
        for retry in range(cfg.max_retries):
            info = {}
            dc, dp, pred = bundle.lm_solve(jac, obs.cam_idx, obs.pt_idx, lam,
                                           cfg.cg_iters, cfg.cg_tol, info)
            free = cams + dc
            q = free[:, 3:7] / torch.linalg.vector_norm(
                free[:, 3:7], dim=-1, keepdim=True).clamp_min(1e-12)
            free = torch.cat([free[:, :3], q], dim=1)
            ned = torch.clamp(free[:, :3], lo, hi)
            new = torch.cat([ned, q], dim=1)
            new_cost = float(bundle.ba_cost(new, pts + dp, obs, K, dist)[0])
            free_cost = float(bundle.ba_cost(free, pts + dp, obs, K, dist)[0])
            ok = bool(np.isfinite(new_cost) and new_cost < cost)
            out(json.dumps({
                "it": it, "retry": retry, "lam": lam,
                "pred_dec": float(pred), "cost": cost, "new_cost": new_cost,
                "free_cost": free_cost, "accepted": ok, **info,
                "clamped": int((ned != free[:, :3]).any(1).sum()),
                "max_cam_step_m": float(dc[:, :3].abs().max()),
                "max_pt_step_m": float(dp.abs().max()),
                "s": round(time.perf_counter() - t0, 4)}), flush=True)
            if ok:
                rho = (cost - new_cost) / max(float(pred), 1e-30)
                rel = 1.0 - new_cost / cost
                cams, pts, cost = new, pts + dp, new_cost
                lam = max(lam * max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3),
                          1e-9)
                nu, accepted = 2.0, True
                history.append(cost)
                if rel < cfg.ftol:
                    stop = "converged"
                break
            lam = min(lam * nu, 1e6)
            nu = min(nu * 2.0, 64.0)
        if not accepted:
            stop = "stalled"
        if stop != "max_iters":
            break
    return cams, pts, obs, history, stop


def summary(g, cams, pts, obs, history, stop, px_noise):
    n_cam, n_pt, n_obs = len(g.cams0), len(g.pts0), len(g.obs.uv)
    floor = 0.5 * px_noise ** 2 * (2 * n_obs - 7 * n_cam - 3 * n_pt)
    r = bundle._residuals(cams, pts, obs, g.K.to(cams), g.dist.to(cams))
    mag = torch.linalg.vector_norm(r, dim=-1)
    worst = torch.topk(mag, 10).indices
    cam_idx, pt_idx = obs.cam_idx, obs.pt_idx
    # distinct cameras per point (observations are sorted by point)
    per_pt = cam_idx.view(n_pt, -1)
    distinct = 1 + (per_pt.sort(1).values.diff(dim=1) != 0).sum(1)
    rows = []
    for o in worst.tolist():
        p, c = pt_idx[o], cam_idx[o]
        rows.append({"px": round(float(mag[o]), 2),
                     "distinct_cams": int(distinct[p]),
                     "horiz_m": round(float(torch.linalg.vector_norm(
                         g.pts_true[p, :2].double()
                         - g.cams_true[c, :2].double())), 1)})
    print(json.dumps({
        "stop": stop, "accepted_steps": len(history) - 1,
        "cost_start": history[0], "cost_final": history[-1],
        "noise_floor": floor, "cost_over_floor": history[-1] / floor,
        "mre_px": float(r.abs().sum() / (2 * n_obs)),
        "max_px": float(mag.max()),
        "points_one_camera": int((distinct == 1).sum()),
        "worst": rows}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", choices=("distinct", "row", "flat"),
                    default="distinct")
    ap.add_argument("--dtype", choices=("f32", "f64"), default="f32")
    ap.add_argument("--n-pt", type=int, default=1_354_000)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--retries", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    dtype = {"f32": torch.float32, "f64": torch.float64}[a.dtype]
    g = make_ba_mission_graph(n_pt=a.n_pt, device=a.device, dtype=dtype,
                              observers=a.graph)
    cfg = bundle.BAConfig(max_iters=a.iters, max_retries=a.retries)
    print(json.dumps({"graph": a.graph, "dtype": a.dtype,
                      "n_cam": len(g.cams0), "n_pt": len(g.pts0),
                      "n_obs": len(g.obs.uv), "config": cfg._asdict()}),
          flush=True)
    t0 = time.perf_counter()
    cams, pts, obs, history, stop = trace_solve(g, cfg, dtype, a.device)
    print(json.dumps({"wall_s": round(time.perf_counter() - t0, 3)}))
    summary(g, cams, pts, obs, history, stop, 0.5)


if __name__ == "__main__":
    main()

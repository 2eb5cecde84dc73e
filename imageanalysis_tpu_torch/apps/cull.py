"""Outlier culling tools — the reference's 4b/4c script family.

Port of ``imageanalysis_tpu/apps/cull.py``:

- ``mre`` — recompute reprojection residuals with the optimized solution
  (projected on the device), report per-image mean/max error, delete
  observations with |error| > mre + nσ (default n=5), median + n·MAD
  (``--robust``) or an absolute cap;
- ``colocated`` — delete feature chains whose view rays are all nearly
  parallel (every pairwise angle < 1°);
- ``remove-image`` — drop all observations of one image;
- ``depth`` — cull chains whose mean |depth − the image's mean depth| is
  an outlier;
- ``movers`` — image pairs whose features subtend small angles (average
  < 5°): mark all their observations;
- ``colocated-cams`` — image pairs with degenerate geometry (angle
  average < 2°, minimum < 0.5° or σ > 10°);
- ``surface`` — Delaunay-neighbour slope outliers, iterated until clean.

Deleting an observation drops the whole chain when fewer than
``min_chain_len`` observations remain; ``--strong`` drops the whole chain
for any marked observation. Every subcommand that changes the chains
saves matches_grouped and clears STEP4, so ``process`` (or ``stages
optimize --refine``) resumes at Step 4.

Usage: ``python -m imageanalysis_tpu_torch.apps.cull <project> mre
--stddev 5``; it runs on the CUDA card, ``IMGTPU_PLATFORM=cpu`` asks for
the CPU.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..core.camera import project_ned_quat
from ..io.logger import log
from ..io.project import ProjectMgr
from .process import main_device


def compute_errors(proj, matches, optimized=True, device="cuda"):
    """Per-observation reprojection |error| (px) of the chains' points
    through the (optimized) poses and camera, projected on device.

    Returns (errors (n_obs,) numpy, obs_index list of (match_idx,
    obs_slot)).
    """
    model = proj.camera_model(optimized=optimized)
    n_img = len(proj.image_list)
    cam_ned = np.zeros((n_img, 3), np.float32)
    cam_quat = np.zeros((n_img, 4), np.float32)
    for i, im in enumerate(proj.image_list):
        use_opt = optimized and im.has_opt_pose()
        ned, _, quat = im.get_camera_pose(opt=use_opt)
        cam_ned[i] = ned
        cam_quat[i] = quat

    obs_img, obs_uv, obs_pt, index = [], [], [], []
    for mi, match in enumerate(matches):
        if match[0] is None:
            continue
        for slot, (img, uv) in enumerate(match[2:]):
            obs_img.append(img)
            obs_uv.append(uv)
            obs_pt.append(match[0])
            index.append((mi, slot))
    if not index:
        return np.zeros(0), []
    obs_img = torch.from_numpy(np.asarray(obs_img, np.int64)).to(device)
    pred, _ = project_ned_quat(
        torch.from_numpy(np.asarray(obs_pt, np.float32)).to(device),
        torch.from_numpy(cam_ned).to(device)[obs_img],
        torch.from_numpy(cam_quat).to(device)[obs_img],
        model.K.to(device), model.dist.to(device))
    err = np.linalg.norm(pred.cpu().numpy()
                         - np.asarray(obs_uv, np.float32), axis=1)
    return err, index


def report_by_image(proj, errors, index, matches):
    stats = {}
    for e, (mi, slot) in zip(errors, index):
        img = matches[mi][2 + slot][0]
        stats.setdefault(img, []).append(e)
    rows = []
    for img, es in sorted(stats.items(), key=lambda kv: -np.mean(kv[1])):
        rows.append((proj.image_list[img].name, float(np.mean(es)),
                     float(np.max(es)), len(es)))
    log("%-24s %8s %8s %8s" % ("image", "mean", "max", "count"))
    for name, mean, mx, n in rows:
        log("%-24s %8.3f %8.2f %8d" % (name, mean, mx, n))
    return rows


def mark_outliers(errors, index, stddev=5.0, max_error=None, robust=False):
    """Observations with error > mre + n·σ (reference 4b:117-150).

    robust=True thresholds at median + n·1.4826·MAD instead: on heavily
    contaminated data the outliers inflate mean and σ above themselves,
    so the reference formula marks almost nothing in one pass (it relies
    on interactive review + repeated runs); the robust threshold gets
    there unattended (measured on benchmarks/ba_hard_bench.py)."""
    if len(errors) == 0:
        return []
    mre = float(np.mean(errors))
    std = float(np.std(errors))
    if max_error is not None:
        thresh = max_error
    elif robust:
        med = float(np.median(errors))
        mad = float(np.median(np.abs(errors - med)))
        thresh = med + stddev * 1.4826 * mad
    else:
        thresh = mre + stddev * std
    marked = [index[i] for i in np.nonzero(errors > thresh)[0]]
    log(f"mre={mre:.3f}px std={std:.3f} threshold={thresh:.2f}px "
        f"→ {len(marked)} observations marked")
    return marked


def delete_marked(matches, marked, min_chain_len=3, strong=False):
    """Remove marked observations; drop depleted chains
    (reference match_culling.py:115-131)."""
    by_match = {}
    for mi, slot in marked:
        by_match.setdefault(mi, set()).add(slot)
    new_matches = []
    dropped_chains = dropped_obs = 0
    for mi, match in enumerate(matches):
        if mi not in by_match:
            new_matches.append(match)
            continue
        if strong:
            dropped_chains += 1
            continue
        obs = [o for slot, o in enumerate(match[2:])
               if slot not in by_match[mi]]
        dropped_obs += len(match[2:]) - len(obs)
        if len(obs) >= min_chain_len:
            new_matches.append(match[:2] + obs)
        else:
            dropped_chains += 1
    log(f"deleted {dropped_obs} observations, {dropped_chains} whole chains; "
        f"{len(new_matches)} chains remain")
    return new_matches


def mark_colocated(proj, matches, min_angle_deg=1.0, optimized=True):
    """Chains whose observation rays are nearly parallel (every pairwise
    angle below min_angle_deg): triangulation is unstable, remove
    entirely. Returns the chains' indices."""
    n_img = len(proj.image_list)
    cam_ned = np.zeros((n_img, 3))
    for i, im in enumerate(proj.image_list):
        use_opt = optimized and im.has_opt_pose()
        ned, _, _ = im.get_camera_pose(opt=use_opt)
        cam_ned[i] = ned
    cos_min = np.cos(np.radians(min_angle_deg))
    marked = []
    for mi, match in enumerate(matches):
        if match[0] is None:
            continue
        p = np.asarray(match[0])
        rays = []
        for img, _ in match[2:]:
            v = p - cam_ned[img]
            n = np.linalg.norm(v)
            if n > 1e-6:
                rays.append(v / n)
        if len(rays) < 2:
            continue
        R = np.asarray(rays)
        cosangles = R @ R.T
        iu = np.triu_indices(len(rays), k=1)
        if np.all(cosangles[iu] > cos_min):
            marked.append(mi)
    log(f"{len(marked)} chains with max ray angle < {min_angle_deg}°")
    return marked


def _camera_positions(proj, optimized=True):
    n_img = len(proj.image_list)
    cam_ned = np.zeros((n_img, 3))
    for i, im in enumerate(proj.image_list):
        use_opt = optimized and im.has_opt_pose()
        ned, _, _ = im.get_camera_pose(opt=use_opt)
        cam_ned[i] = ned
    return cam_ned


def _obs_arrays(matches):
    """Flatten chains → (pt_idx, img_idx, pts) arrays; skips chains
    without a triangulated point."""
    pt_idx, img_idx, pts = [], [], []
    for mi, match in enumerate(matches):
        if match[0] is None:
            continue
        for img, _uv in match[2:]:
            pt_idx.append(mi)
            img_idx.append(img)
        pts.append((mi, np.asarray(match[0], np.float64)))
    return (np.asarray(pt_idx, np.int64), np.asarray(img_idx, np.int64),
            dict(pts))


def mark_depth_outliers(proj, matches, stddev=3.0, optimized=True):
    """Chains whose mean |camera distance − per-image mean depth| is more
    than ``stddev``·σ above the population mean (reference 4c-by-depth.py:
    66-130 computes per-image z_avg then a per-match avg error metric)."""
    cam_ned = _camera_positions(proj, optimized)
    pt_idx, img_idx, _ = _obs_arrays(matches)
    if len(pt_idx) == 0:
        return []
    pt_ned = np.zeros((len(matches), 3))
    for mi, match in enumerate(matches):
        if match[0] is not None:
            pt_ned[mi] = match[0]
    dist = np.linalg.norm(pt_ned[pt_idx] - cam_ned[img_idx], axis=1)
    n_img = len(proj.image_list)
    cnt = np.bincount(img_idx, minlength=n_img).astype(np.float64)
    z_avg = np.bincount(img_idx, weights=dist, minlength=n_img)
    z_avg = np.divide(z_avg, cnt, out=np.zeros_like(z_avg), where=cnt > 0)
    dist_err = np.abs(dist - z_avg[img_idx])
    m_cnt = np.bincount(pt_idx, minlength=len(matches)).astype(np.float64)
    m_sum = np.bincount(pt_idx, weights=dist_err, minlength=len(matches))
    valid = m_cnt >= 2
    metric = np.divide(m_sum, m_cnt, out=np.zeros_like(m_sum),
                       where=m_cnt > 0)
    vals = metric[valid]
    if len(vals) == 0:
        return []
    mre, std = float(np.mean(vals)), float(np.std(vals))
    marked = np.nonzero(valid & (metric > mre + stddev * std))[0]
    log(f"depth metric mean={mre:.2f}m std={std:.2f} → "
        f"{len(marked)} chains marked")
    return marked.tolist()


def _pair_angles(proj, matches, optimized=True, quick=False):
    """Per image-pair angle samples (deg) subtended at each shared point.

    quick=True uses the reference movers approximation atan2(baseline,
    dist-to-midpoint) (4c-movers.py:62-68); quick=False the exact
    ray-to-ray angle (4c-colocated-cams.py:44-59).
    Returns dict {(i, j): [angles_deg]} with i < j, plus per-sample list
    [(angle_deg, match_idx, slot_i, slot_j)]."""
    cam_ned = _camera_positions(proj, optimized)
    pair = {}
    samples = []
    for mi, match in enumerate(matches):
        if match[0] is None:
            continue
        p = np.asarray(match[0], np.float64)
        obs = match[2:]
        for a in range(len(obs)):
            for b in range(a + 1, len(obs)):
                i1, i2 = obs[a][0], obs[b][0]
                if i1 == i2:
                    continue
                lo, hi = (i1, i2) if i1 < i2 else (i2, i1)
                n1 = cam_ned[i1]
                n2 = cam_ned[i2]
                if quick:
                    mid = 0.5 * (n1 + n2)
                    y = np.linalg.norm(n2 - n1)
                    x = np.linalg.norm(mid - p)
                    ang = np.degrees(np.arctan2(y, x))
                else:
                    v1 = p - n1
                    v2 = p - n2
                    denom = np.linalg.norm(v1) * np.linalg.norm(v2)
                    if denom < 1e-9:
                        ang = 0.0
                    else:
                        c = np.clip(np.dot(v1, v2) / denom, -1.0, 1.0)
                        ang = np.degrees(np.arccos(c))
                pair.setdefault((lo, hi), []).append(ang)
                samples.append((ang, mi, a, b))
    return pair, samples


def mark_movers(proj, matches, avg_cutoff_deg=5.0, optimized=True):
    """Mark all observations of image pairs whose *average* subtended
    angle is below the cutoff (reference 4c-movers.py by_pair mode,
    0.087 rad = 5°). Returns (mi, slot) marks."""
    pair, _ = _pair_angles(proj, matches, optimized, quick=True)
    bad = {k for k, v in pair.items() if np.mean(v) < avg_cutoff_deg}
    if bad:
        log("shaky pairs: " + ", ".join(
            f"{proj.image_list[i].name}↔{proj.image_list[j].name} "
            f"avg={np.mean(pair[(i, j)]):.2f}°" for i, j in sorted(bad)))
    marked = set()
    for mi, match in enumerate(matches):
        obs = match[2:]
        for a in range(len(obs)):
            for b in range(a + 1, len(obs)):
                i1, i2 = obs[a][0], obs[b][0]
                key = (i1, i2) if i1 < i2 else (i2, i1)
                if key in bad:
                    marked.add((mi, a))
                    marked.add((mi, b))
    log(f"{len(bad)} small-angle pairs → {len(marked)} observations marked")
    return sorted(marked)


def mark_colocated_cams(proj, matches, avg_cutoff_deg=2.0,
                        min_cutoff_deg=0.5, std_cutoff_deg=10.0,
                        optimized=True):
    """Image pairs with degenerate geometry: avg angle < 2°, min < 0.5°,
    or σ > 10° (reference 4c-colocated-cams.py:110-117)."""
    pair, _ = _pair_angles(proj, matches, optimized, quick=False)
    bad = set()
    for k, v in pair.items():
        a = np.asarray(v)
        if (a.mean() < avg_cutoff_deg or a.min() < min_cutoff_deg
                or a.std() > std_cutoff_deg):
            bad.add(k)
    marked = set()
    for mi, match in enumerate(matches):
        obs = match[2:]
        for a in range(len(obs)):
            for b in range(a + 1, len(obs)):
                i1, i2 = obs[a][0], obs[b][0]
                key = (i1, i2) if i1 < i2 else (i2, i1)
                if key in bad:
                    marked.add((mi, a))
                    marked.add((mi, b))
    log(f"{len(bad)} colocated-camera pairs → {len(marked)} obs marked")
    return sorted(marked)


def cull_surface_outliers(matches, stddev=5.0):
    """Iteratively remove points sticking out of the Delaunay-neighbor
    surface: per-point mean slope to neighbors, cull |slope − mean| ≥ nσ
    (reference 4c-surface-outliers1.py:58-134, repeated until clean)."""
    import scipy.spatial

    matches = list(matches)
    total = 0
    while True:
        idx = [mi for mi, m in enumerate(matches) if m[0] is not None]
        if len(idx) < 4:
            break
        ned = np.asarray([matches[mi][0] for mi in idx], np.float64)
        pts_en = ned[:, [1, 0]]            # x=east, y=north
        up = -ned[:, 2]
        try:
            tri = scipy.spatial.Delaunay(pts_en)
        except scipy.spatial.QhullError:
            break
        indices, indptr = tri.vertex_neighbor_vertices
        slopes = np.full(len(idx), np.nan)
        for i in range(len(idx)):
            nbrs = indptr[indices[i]:indices[i + 1]]
            if len(nbrs) == 0:
                continue
            d = pts_en[nbrs] - pts_en[i]
            hdist = np.hypot(d[:, 0], d[:, 1])
            dz = up[nbrs] - up[i]
            s = np.where(hdist > 1e-5, dz / np.maximum(hdist, 1e-5), 0.0)
            slopes[i] = s.mean()
        ok = np.isfinite(slopes)
        if not ok.any():
            break
        avg, std = slopes[ok].mean(), slopes[ok].std()
        if std < 1e-12:
            break
        bad = np.nonzero(ok & (np.abs(slopes - avg) >= stddev * std))[0]
        if len(bad) == 0:
            break
        total += len(bad)
        drop = {idx[i] for i in bad}
        matches = [m for mi, m in enumerate(matches) if mi not in drop]
    log(f"surface-outlier cull removed {total} chains; "
        f"{len(matches)} remain")
    return matches, total


def remove_camera_matches(matches, image_idx, min_chain_len=3):
    """Drop all observations of one image (reference
    4b-remove-camera-matches.py)."""
    new_matches = []
    for match in matches:
        obs = [o for o in match[2:] if o[0] != image_idx]
        if len(obs) >= min_chain_len:
            new_matches.append(match[:2] + obs)
    return new_matches


def _commit(proj, matches):
    """Save the culled chains and clear STEP4, so Step 4 runs again."""
    proj.save_matches_grouped(matches)
    proj.state.clear("STEP4")


def build_parser():
    p = argparse.ArgumentParser(description="reprojection-error culling tools")
    p.add_argument("project")
    sub = p.add_subparsers(dest="cmd", required=True)
    p_mre = sub.add_parser("mre", help="cull by reprojection error")
    p_mre.add_argument("--stddev", type=float, default=5.0)
    p_mre.add_argument("--max", type=float, help="absolute error cap (px)")
    p_mre.add_argument("--robust", action="store_true",
                       help="median + n*1.4826*MAD threshold instead of "
                            "mean + n*std (contamination-proof)")
    p_mre.add_argument("--strong", action="store_true",
                       help="drop whole chains, not just observations")
    p_mre.add_argument("--dry-run", action="store_true")
    p_col = sub.add_parser("colocated", help="cull near-parallel-ray chains")
    p_col.add_argument("--min-angle", type=float, default=1.0)
    p_col.add_argument("--dry-run", action="store_true")
    p_rm = sub.add_parser("remove-image", help="drop one image's matches")
    p_rm.add_argument("name")
    p_dep = sub.add_parser("depth", help="cull per-image depth outliers")
    p_dep.add_argument("--stddev", type=float, default=3.0)
    p_dep.add_argument("--dry-run", action="store_true")
    p_mov = sub.add_parser("movers", help="cull small-angle 'shaker' pairs")
    p_mov.add_argument("--angle", type=float, default=5.0,
                       help="avg pair angle cutoff (deg)")
    p_mov.add_argument("--strong", action="store_true")
    p_mov.add_argument("--dry-run", action="store_true")
    p_cc = sub.add_parser("colocated-cams",
                          help="cull degenerate-geometry image pairs")
    p_cc.add_argument("--avg", type=float, default=2.0)
    p_cc.add_argument("--min", type=float, default=0.5)
    p_cc.add_argument("--std", type=float, default=10.0)
    p_cc.add_argument("--dry-run", action="store_true")
    p_srf = sub.add_parser("surface", help="cull Delaunay-slope outliers")
    p_srf.add_argument("--stddev", type=float, default=5.0)
    p_srf.add_argument("--dry-run", action="store_true")
    return p


def main(argv=None, device="cuda"):
    """The command line's entry point, on device (IMGTPU_PLATFORM in the
    environment overrides it, as in apps/process.py)."""
    args = build_parser().parse_args(argv)
    device = main_device(device)
    proj = ProjectMgr(args.project)
    proj.load_images_info()
    matches = proj.load_matches_grouped()

    if args.cmd == "mre":
        errors, index = compute_errors(proj, matches, device=device)
        report_by_image(proj, errors, index, matches)
        marked = mark_outliers(errors, index, stddev=args.stddev,
                               max_error=args.max, robust=args.robust)
        if not args.dry_run and marked:
            _commit(proj, delete_marked(matches, marked, strong=args.strong))
            log("matches_grouped updated; rerun Step 4 with --refine")
    elif args.cmd in ("colocated", "depth"):
        marked_chains = (
            mark_colocated(proj, matches, min_angle_deg=args.min_angle)
            if args.cmd == "colocated"
            else mark_depth_outliers(proj, matches, stddev=args.stddev))
        if not args.dry_run and marked_chains:
            drop = set(marked_chains)
            _commit(proj, [m for i, m in enumerate(matches)
                           if i not in drop])
    elif args.cmd in ("movers", "colocated-cams"):
        if args.cmd == "movers":
            marked = mark_movers(proj, matches, avg_cutoff_deg=args.angle)
        else:
            marked = mark_colocated_cams(proj, matches,
                                         avg_cutoff_deg=args.avg,
                                         min_cutoff_deg=args.min,
                                         std_cutoff_deg=args.std)
        if not args.dry_run and marked:
            _commit(proj, delete_marked(matches, marked,
                                        strong=getattr(args, "strong",
                                                       False)))
    elif args.cmd == "surface":
        matches, n = cull_surface_outliers(matches, stddev=args.stddev)
        if not args.dry_run and n:
            _commit(proj, matches)
    elif args.cmd == "remove-image":
        idx = [i for i, im in enumerate(proj.image_list)
               if im.name == args.name]
        if not idx:
            log("unknown image:", args.name)
            return 1
        _commit(proj, remove_camera_matches(matches, idx[-1]))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Individual pipeline stage CLIs — the reference's numbered scripts.

Port of ``imageanalysis_tpu/apps/stages.py``. Each subcommand runs one
standalone stage script, so any step can be run, inspected or redone in
isolation:

  1a-create-project  → ``create-project``
  1b-set-camera      → ``set-camera``
  1c-make-pix4d      → ``make-pix4d``
  2a-set-poses       → ``set-poses``
  3a-matching        → ``matching``
  3b-clean…          → ``clean``
  3c-…triangulation  → ``triangulate``
  3d-image-groups    → ``groups``
  4a-optimize        → ``optimize``
  4b-mre-by-image…   → apps/cull.py (separate tool)
  5a-render-model…   → ``render``

``process`` (apps/process.py) remains the all-in-one driver. Every
subcommand sets its stage marker, which makes the later ones stale, so
the driver picks up from there.

Usage: ``python -m imageanalysis_tpu_torch.apps.stages <stage> <project>
[options]``. It runs on the CUDA card; ``IMGTPU_PLATFORM=cpu`` asks for
the CPU. ``matching`` defaults to the reference's host SIFT (``--detector
SIFT|ORB|TPU``). ``optimize --mesh`` takes 0, 1 or ``all`` on a machine
with one card (one ``bundle.solve``); a larger mesh, or a run across
processes, raises NotImplementedError.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..io.logger import log
from .process import MULTI_HOST_MSG, main_device, multi_host


def _proj(path, create=False):
    from ..io.project import ProjectMgr

    p = ProjectMgr(path, create=create)
    p.load_images_info()
    return p


def cmd_create_project(args, device):
    _proj(args.project, create=True)
    log("created analysis workspace under", args.project)
    return 0


def cmd_set_camera(args, device):
    from ..io import camera_db

    proj = _proj(args.project, create=True)
    cfg = camera_db.load(args.camera, db_dirs=args.camera_db or [])
    if cfg is None:
        log("unknown camera:", args.camera)
        return 1
    cfg["mount"] = {"yaw_deg": args.yaw_deg, "pitch_deg": args.pitch_deg,
                    "roll_deg": args.roll_deg}
    proj.set_camera_config(cfg)
    proj.save()
    proj.state.update("STEP1")
    return 0


def cmd_make_pix4d(args, device):
    from ..io import pose as pose_mod

    proj = _proj(args.project)
    pose_mod.make_pix4d(args.project,
                        camera_make=proj.camera.get("make", ""),
                        camera_model=proj.camera.get("model", ""),
                        force_altitude=args.force_altitude,
                        force_heading=args.force_heading,
                        yaw_from_groundtrack=args.yaw_from_groundtrack)
    return 0


def cmd_set_poses(args, device):
    from ..io import pose as pose_mod

    proj = _proj(args.project)
    posefile = args.pose_file or os.path.join(args.project, "pix4d.csv")
    order = "rpy" if "pix4d" in os.path.basename(posefile) else "ypr"
    pose_mod.set_aircraft_poses(proj, posefile, order=order,
                                max_angle=args.max_angle)
    proj.load_images_info()
    proj.compute_ned_reference_lla()
    pose_mod.compute_camera_poses(proj)
    proj.save()
    proj.state.update("STEP2")
    return 0


def cmd_matching(args, device):
    from ..features.detect import DetectorConfig, detect_project_features
    from ..match.matcher import MatchConfig, find_matches
    from ..match.smart import SmartState

    proj = _proj(args.project)
    det = DetectorConfig(detector=args.detector, scale=args.scale,
                         max_features=args.max_features,
                         backend="tpu" if args.detector == "TPU" else "cv")
    detect_project_features(proj, det, batch_size=args.batch_size,
                            device=device)
    cfg = MatchConfig(ratio=args.match_ratio, transform=args.filter,
                      batch_size=args.batch_size)
    find_matches(proj, cfg, smart_state=SmartState(proj.analysis_dir),
                 device=device)
    proj.state.update("STEP3a")
    return 0


def cmd_clean(args, device):
    from ..match import cleanup

    proj = _proj(args.project)
    for im in proj.image_list:
        im.load_features()
        im.load_matches()
    matches = cleanup.link_matches(proj)
    proj.save_matches_grouped(matches)
    proj.state.update("STEP3b")
    return 0


def cmd_triangulate(args, device):
    from ..match import cleanup
    from ..match.smart import SmartState
    from ..surface import srtm

    proj = _proj(args.project)
    matches = proj.load_matches_grouped()
    if args.method == "srtm":
        terrain = srtm.project_terrain(proj, device=device)
        smart_state = SmartState(proj.analysis_dir)

        def base(image):
            n = smart_state.node(image.name)
            return n.get("tri_surface_m", terrain.base_elevation(image))
        cleanup.triangulate_ground(proj, matches, get_base_elev=base,
                                   device=device)
    elif args.method == "ground":
        cleanup.triangulate_ground(proj, matches,
                                   get_base_elev=lambda im: args.ground,
                                   device=device)
    else:  # 'triangulate': N-ray least squares with optimized poses
        _triangulate_rays(proj, matches, device)
    proj.save_matches_grouped(matches)
    proj.state.update("STEP3c")
    return 0


def _triangulate_rays(proj, matches, device="cuda"):
    """3c --method triangulate: each chain's point as the least-squares
    intersection of its view rays, from the (optimized) poses, on device
    (ops/triangulate.triangulate_rays)."""
    from ..core.camera import pixel_vectors_ned, undistort_pixels
    from ..core.rotations import quat_to_matrix
    from ..ops.triangulate import triangulate_rays

    model = proj.camera_model(optimized=True)
    n_img = len(proj.image_list)
    cam_ned = np.zeros((n_img, 3), np.float32)
    cam_quat = np.zeros((n_img, 4), np.float32)
    for i, im in enumerate(proj.image_list):
        ned, _, quat = im.get_camera_pose(opt=im.has_opt_pose())
        cam_ned[i] = ned
        cam_quat[i] = quat

    max_obs = max((len(m) - 2 for m in matches), default=0)
    if max_obs < 2:
        return
    n = len(matches)
    origins = np.zeros((n, max_obs, 3), np.float32)
    uvs = np.zeros((n, max_obs, 2), np.float32)
    imgs = np.zeros((n, max_obs), np.int64)
    mask = np.zeros((n, max_obs), bool)
    for mi, match in enumerate(matches):
        for k, (img, uv) in enumerate(match[2:]):
            origins[mi, k] = cam_ned[img]
            uvs[mi, k] = uv
            imgs[mi, k] = img
            mask[mi, k] = True

    def dev(x):
        return torch.from_numpy(x).to(device)

    K, dist = model.K.to(device), model.dist.to(device)
    und = undistort_pixels(dev(uvs.reshape(-1, 2)), K, dist)
    body2ned = quat_to_matrix(dev(cam_quat))[dev(imgs.reshape(-1))]
    dirs = pixel_vectors_ned(und, body2ned, K).reshape(n, max_obs, 3)
    pts = triangulate_rays(dev(origins), dirs,
                           dev(mask).to(dirs.dtype)).cpu().numpy()
    for mi, match in enumerate(matches):
        match[0] = pts[mi].tolist()


def cmd_groups(args, device):
    from ..match import groups as groups_mod

    proj = _proj(args.project)
    matches = proj.load_matches_grouped()
    grps = groups_mod.compute(proj.image_list, matches,
                              min_chain_len=args.min_chain_len)
    groups_mod.save(proj.analysis_dir, grps)
    proj.save_matches_grouped(matches)
    proj.state.update("STEP3d")
    return 0


def _mesh_size(mesh, device):
    """The devices --mesh asks BA to shard over: 'all' is every card of
    the machine (1 on the CPU), else the number given (0 and 1: none)."""
    if mesh == "all":
        return torch.cuda.device_count() if device.type == "cuda" else 1
    return int(mesh or 0)


def cmd_optimize(args, device):
    from ..ba import bundle, setup as ba_setup
    from ..match import groups as groups_mod

    if multi_host() or _mesh_size(args.mesh, device) > 1:
        raise NotImplementedError(
            f"--mesh {args.mesh}: BA sharded over several cards is not "
            "ported (ROADMAP.md queue 1 item 2); " + MULTI_HOST_MSG)
    proj = _proj(args.project)
    matches = proj.load_matches_grouped()
    grps = groups_mod.load(proj.analysis_dir)
    group_images = grps[args.group] if grps else None
    cams0, pts0, obs, cam_names, match_map = ba_setup.setup_from_matches(
        proj, matches, group_images=group_images, optimized=args.refine)
    model = proj.camera_model()
    cfg = bundle.BAConfig(ftol=args.ftol)
    result = bundle.solve(cams0, pts0, obs, model.K, model.dist, cfg,
                          log_fn=log, device=device)
    new_cams, new_pts, _ = bundle.refit(result.cams, result.pts, cams0[:, :3],
                                        device=device)
    result = result._replace(cams=new_cams, pts=new_pts)
    ba_setup.write_back(proj, matches, result, cam_names, match_map)
    proj.save_matches_grouped(matches)
    log(f"BA finished: mre={result.mre:.3f}px")
    proj.state.update("STEP4")
    return 0


def cmd_render(args, device):
    from ..match import groups as groups_mod
    from ..render import build_map

    proj = _proj(args.project)
    matches = proj.load_matches_grouped()
    grps = groups_mod.load(proj.analysis_dir)
    build_map.build(proj, matches, grps, group_index=args.group,
                    device=device)
    proj.state.update("STEP5")
    return 0


def build_parser():
    p = argparse.ArgumentParser(prog="imageanalysis-stage",
                                description="run individual pipeline stages")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add(name, fn, conf):
        sp = sub.add_parser(name)
        sp.add_argument("project")
        conf(sp)
        sp.set_defaults(fn=fn)

    add("create-project", cmd_create_project, lambda sp: None)
    add("set-camera", cmd_set_camera, lambda sp: (
        sp.add_argument("--camera", required=True),
        sp.add_argument("--camera-db", action="append"),
        sp.add_argument("--yaw-deg", type=float, default=0.0),
        sp.add_argument("--pitch-deg", type=float, default=-90.0),
        sp.add_argument("--roll-deg", type=float, default=0.0)))
    add("make-pix4d", cmd_make_pix4d, lambda sp: (
        sp.add_argument("--force-altitude", type=float),
        sp.add_argument("--force-heading", type=float),
        sp.add_argument("--yaw-from-groundtrack", action="store_true")))
    add("set-poses", cmd_set_poses, lambda sp: (
        sp.add_argument("--pose-file"),
        sp.add_argument("--max-angle", type=float, default=25.0)))
    add("matching", cmd_matching, lambda sp: (
        sp.add_argument("--detector", default="SIFT",
                        choices=["SIFT", "ORB", "TPU"]),
        sp.add_argument("--scale", type=float, default=0.4),
        sp.add_argument("--max-features", type=int, default=0),
        sp.add_argument("--match-ratio", type=float, default=0.75),
        sp.add_argument("--filter", default="homography"),
        sp.add_argument("--batch-size", type=int, default=16)))
    add("clean", cmd_clean, lambda sp: None)
    add("triangulate", cmd_triangulate, lambda sp: (
        sp.add_argument("--method", default="srtm",
                        choices=["srtm", "ground", "triangulate"]),
        sp.add_argument("--ground", type=float, default=0.0)))
    add("groups", cmd_groups, lambda sp:
        sp.add_argument("--min-chain-len", type=int, default=3))
    add("optimize", cmd_optimize, lambda sp: (
        sp.add_argument("--group", type=int, default=0),
        sp.add_argument("--refine", action="store_true"),
        sp.add_argument("--ftol", type=float, default=1e-4),
        sp.add_argument("--mesh", default=0,
                        help="shard BA over N devices, or 'all' for every "
                             "device: 0, 1 or 'all' on one card run one "
                             "solve; more is not ported")))
    add("render", cmd_render, lambda sp:
        sp.add_argument("--group", type=int, default=0))
    return p


def main(argv=None, device="cuda"):
    """The command line's entry point, on device (IMGTPU_PLATFORM in the
    environment overrides it, as in apps/process.py)."""
    args = build_parser().parse_args(argv)
    return args.fn(args, main_device(device))


if __name__ == "__main__":
    sys.exit(main())

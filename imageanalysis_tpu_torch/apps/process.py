"""End-to-end pipeline: a folder of JPEGs and a pose file → models.

Port of ``imageanalysis_tpu/apps/process.py``, with the same stages,
state gating and workspace files:

  Step 1   project creation + camera config            (state STEP1)
  Step 2   poses + NED reference + terrain priors      (state STEP2)
  Step 3a  feature detection + pair matching           (state STEP3a)
  Step 3b  match cleanup + chain linking               (state STEP3b)
  Step 3c  initial triangulation                       (state STEP3c)
  Step 3d  image grouping                              (state STEP3d)
  Step 4   bundle adjustment + refit                   (state STEP4)
  Step 5   surface/render outputs                      (state STEP5)

Usage: ``python -m imageanalysis_tpu_torch.apps.process <image_dir>
[--camera <key>] [--detector SIFT|ORB|TPU] [options]``; any stage can be
redone with ``--refresh STEPn``. It runs on the CUDA card;
``IMGTPU_PLATFORM=cpu`` asks for the CPU. The default detector is the
reference's, OpenCV's SIFT on the host (ORB likewise); ``TPU`` detects on
the device. Matching runs on the device either way. Without ``--camera``,
Step 1 finds the camera from the first image's EXIF (and estimates its
config from EXIF when the DB lacks it); without a pose file, Step 2
writes ``pix4d.csv`` from the images' EXIF.

The same command runs on several ranks (``torchrun --nproc-per-node N
-m imageanalysis_tpu_torch.apps.process <dir> ...``, or the reference's
JAX_COORDINATOR variables; parallel/multihost.py): rank 0 runs the host
stages (Steps 1–2, 3b–3d, the write-backs), detection and matching split
the images and pairs by rank, Step 4 is one BA sharded over the ranks
(parallel/sharded.py; ``--cam-calibration`` stays on rank 0) and Step 5
renders each rank's images.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..ba import bundle, calibrate, setup as ba_setup
from ..core.device import checked
from ..features.detect import DetectorConfig, detect_project_features
from ..io import camera_db, pose as pose_mod
from ..io.logger import log
from ..io.project import ProjectMgr
from ..match import cleanup, groups as groups_mod, matcher, smart as smart_mod
from ..parallel import multihost, sharded
from ..render import build_map, geotiff
from ..render.texture import build_histograms
from ..surface import srtm


def build_parser():
    p = argparse.ArgumentParser(
        description="aerial survey pipeline on a CUDA card")
    p.add_argument("project", help="directory with geotagged images")
    p.add_argument("--camera", help="camera config key (cameras/<key>.json)")
    p.add_argument("--camera-db", action="append", default=[],
                   help="extra camera DB directory")
    p.add_argument("--yaw-deg", type=float, default=0.0,
                   help="camera mount yaw")
    p.add_argument("--pitch-deg", type=float, default=-90.0,
                   help="camera mount pitch")
    p.add_argument("--roll-deg", type=float, default=0.0,
                   help="camera mount roll")
    p.add_argument("--max-angle", type=float, default=25.0,
                   help="max pose roll/pitch angle")
    p.add_argument("--force-altitude", type=float)
    p.add_argument("--force-heading", type=float)
    p.add_argument("--yaw-from-groundtrack", action="store_true")
    p.add_argument("--detector", default="SIFT",
                   choices=["SIFT", "ORB", "TPU"])
    p.add_argument("--scale", type=float, default=0.4,
                   help="detection image scale")
    p.add_argument("--max-features", type=int, default=0)
    p.add_argument("--match-strategy", default="traditional",
                   choices=["traditional", "smart", "bestratio",
                            "bruteforce"])
    p.add_argument("--match-ratio", type=float, default=0.75)
    p.add_argument("--filter", default="homography",
                   choices=["homography", "fundamental", "essential",
                            "essential5", "none"])
    p.add_argument("--min-chain-len", type=int, default=3)
    p.add_argument("--worklist", default="full",
                   choices=["full", "sequential"],
                   help="pair work-list policy: 'full' = distance window + "
                        "sequential neighbors; 'sequential' = neighbors "
                        "|i-j|<=4 only")
    p.add_argument("--ground", type=float,
                   help="flat ground elevation (m MSL) instead of SRTM")
    p.add_argument("--group", type=int, default=0,
                   help="group index to optimize")
    p.add_argument("--refine", action="store_true",
                   help="start BA from previously optimized poses")
    p.add_argument("--cam-calibration", action="store_true",
                   help="include global camera calibration in BA")
    p.add_argument("--refresh", action="append", default=[],
                   help="redo a stage (STEP1..STEP5)")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--geotiff", action="store_true",
                   help="also composite an orthomosaic GeoTIFF in Step 5")
    p.add_argument("--geotiff-res", type=float, default=0.25,
                   help="orthomosaic resolution (m/px)")
    p.add_argument("--histogram", action="store_true",
                   help="build neighborhood histogram-matching tables in "
                        "Step 5")
    p.add_argument("--trace", metavar="DIR",
                   help="write a torch.profiler trace of the whole pipeline "
                        "run into DIR (trace.json, for chrome://tracing or "
                        "Perfetto)")
    return p


def main_device(device):
    """The device a command line runs on: IMGTPU_PLATFORM (cpu or cuda) in
    the environment, else device. The card is never swapped for the CPU:
    without one, asking for it raises."""
    dev = checked(os.environ.get("IMGTPU_PLATFORM") or device, "the pipeline")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card (torch.cuda.is_available() is "
                           "false); set IMGTPU_PLATFORM=cpu to run on the CPU")
    return dev


def run(args, device="cuda") -> int:
    """Run the pipeline for parsed args on device; --trace wraps the run
    in torch.profiler."""
    if not args.trace:
        return _run(args, device)
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        rc = _run(args, device)
    os.makedirs(args.trace, exist_ok=True)
    path = os.path.join(args.trace, "trace.json")
    prof.export_chrome_trace(path)
    log(f"torch.profiler trace written to {path}")
    return rc


def _run(args, device) -> int:
    # across processes: join the group before any work; host stages then
    # run on rank 0, detection and matching split by rank, BA is sharded
    # over the ranks and rendering split by image
    multi = multihost.maybe_initialize_distributed(device)
    if multi:
        device = multihost.rank_device(device)
    rank0 = multihost.is_rank0()

    # per-stage wall clocks in the run log, "stage wall: <name> <s>s"
    t_start = time.perf_counter()
    t_prev = [t_start]

    def mark(name):
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        log(f"stage wall: {name} {now - t_prev[0]:.2f}s")
        t_prev[0] = now

    # every rank branches on rank 0's reading of a STEP marker
    def gate(step):
        return multihost.agree(proj.state.check(step), step)

    proj = ProjectMgr(args.project, create=True)
    if rank0:
        for step in args.refresh:
            proj.state.clear(step)
    multihost.barrier("refresh")

    # ---- Steps 1–2 on rank 0; the others read its files after -----------
    rc = _step1(args, proj) if rank0 else 0
    mark("step1_setup")
    if rank0 and rc == 0:
        _step2(args, proj, device)
    if multihost.agree(rc != 0, "steps12"):
        return rc or 1
    if not rank0:
        proj = ProjectMgr(args.project, create=True)
        proj.load_images_info()
    mark("step2_poses")

    # ---- Step 3a: detection + matching ------------------------------------
    def terrain_base():
        """Step 3c's and 4's ground prior: the image's triangulated smart
        surface, else the SRTM terrain under it."""
        terrain = srtm.project_terrain(proj, device=device)
        state = smart_mod.SmartState(proj.analysis_dir)

        def base(image):
            n = state.node(image.name)
            if "tri_surface_m" in n:
                return n["tri_surface_m"]
            return terrain.base_elevation(image)
        return base

    if not gate("STEP3a"):
        log("Step 3a: feature detection + pair matching")
        det_cfg = DetectorConfig(
            detector="SIFT" if args.detector == "TPU" else args.detector,
            scale=args.scale, max_features=args.max_features,
            backend="tpu" if args.detector == "TPU" else "cv")
        proj.config.node("detector").update(det_cfg.to_dict())
        detect_project_features(proj, det_cfg, batch_size=args.batch_size,
                                device=device)
        mark("step3a_detect")
        mcfg = matcher.MatchConfig(strategy=args.match_strategy,
                                   ratio=args.match_ratio,
                                   transform=args.filter,
                                   batch_size=args.batch_size)
        proj.config.node("matcher").set("min_chain_len", args.min_chain_len)
        smart_state = smart_mod.SmartState(proj.analysis_dir)
        matcher.find_matches(proj, mcfg, smart_state=smart_state,
                             use_distance=args.worklist == "full",
                             device=device)
        mark("step3a_match")
        if rank0:
            if args.match_strategy == "smart":
                # fold the accumulated yaw-error estimates into the poses
                body2cam = proj.get_body2cam()
                n_fix = 0
                for im in proj.image_list:
                    err = smart_state.get_yaw_error(im.name)
                    if abs(err) > 0.5:
                        im.set_aircraft_yaw_error_estimate(err, body2cam)
                        im.save_meta()
                        n_fix += 1
                if n_fix:
                    log(f"applied yaw-error corrections to {n_fix} images")
            # bad-geometry rejection with the final poses, on the merged
            # match files
            smart_mod.requalify_pairs(proj, smart_state, device=device)
            proj.save()
            proj.state.update("STEP3a")
        multihost.barrier("step3a")
        if not rank0:
            proj.load_images_info()
    mark("step3a_finish")

    # ---- Steps 3b–3d on rank 0; the others wait at "steps3bcd" ------------
    # the chains are carried in memory across 3b → 4; the saves are the
    # resume checkpoints
    matches = (_steps3bcd(args, proj, terrain_base, device, mark) if rank0
               else None)
    multihost.barrier("steps3bcd")
    mark("step3d_groups")

    # ---- Step 4: bundle adjustment ----------------------------------------
    if not gate("STEP4"):
        log("Step 4: sparse bundle adjustment")
        if matches is None:
            matches = proj.load_matches_grouped()
        grps = groups_mod.load(proj.analysis_dir)
        cams0, pts0, obs, cam_names, match_map = ba_setup.setup_from_matches(
            proj, matches, group_images=grps[args.group] if grps else None,
            min_chain_len=args.min_chain_len, optimized=args.refine)
        if len(cam_names) < 2 or len(pts0) == 0:
            log(f"Not enough structure to optimize ({len(cam_names)} cameras,"
                f" {len(pts0)} points) — check matching stage output")
            return 1
        model = proj.camera_model()
        result = None
        if args.cam_calibration:
            # the calibration's bordered Schur system runs on rank 0; the
            # other ranks wait at "step4"
            if rank0:
                result, K_opt, dist_opt = calibrate.solve_with_calibration(
                    cams0, pts0, obs, model.K, model.dist, log_fn=log,
                    device=device)
                proj.camera.setlist("K_opt", np.asarray(K_opt).ravel())
                proj.camera.setlist("dist_coeffs_opt", dist_opt)
                proj.save()
        elif multi:
            # every rank runs the one BA, sharded over the ranks
            result = sharded.solve_sharded(
                cams0, pts0, obs, model.K, model.dist,
                sharded.ProcessMesh(device), bundle.BAConfig(),
                verbose=rank0, log_fn=log)
        else:
            result = bundle.solve(cams0, pts0, obs, model.K, model.dist,
                                  bundle.BAConfig(), log_fn=log,
                                  device=device)
        if rank0:
            # re-register onto the GPS solution
            new_cams, new_pts, _ = bundle.refit(result.cams, result.pts,
                                                cams0[:, :3], device=device)
            result = result._replace(cams=new_cams, pts=new_pts)
            ba_setup.write_back(proj, matches, result, cam_names, match_map)
            # re-triangulate the chains BA did not optimize (short chains,
            # other groups) that touch an optimized camera, against the
            # optimized poses: their pre-BA points reproject badly under
            # them
            active = set(int(mi) for mi in match_map)
            by_name = {im.name: i for i, im in enumerate(proj.image_list)}
            opt_imgs = {by_name[n] for n in cam_names if n in by_name}
            stale = [mi for mi, mm in enumerate(matches)
                     if mi not in active
                     and any(o[0] in opt_imgs for o in mm[2:])]
            if stale:
                cleanup.triangulate_ground(proj, matches,
                                           get_base_elev=terrain_base(),
                                           subset=stale, optimized=True,
                                           device=device)
            proj.save_matches_grouped(matches)
            log(f"BA finished: mre={result.mre:.3f}px over "
                f"{len(cam_names)} cameras")
            proj.state.update("STEP4")
        multihost.barrier("step4")
        if not rank0:
            # rank 0's optimized poses, for the render stage
            proj.load_images_info()
    mark("step4_ba")

    # ---- Step 5: render ---------------------------------------------------
    if not gate("STEP5"):
        if rank0:
            log("Step 5: building surface/render outputs")
        grps = groups_mod.load(proj.analysis_dir)
        matches = proj.load_matches_grouped()
        # each rank writes its images' eggs and textures (one rank: all of
        # them); rank 0 also the surface and the AC3D models
        group = (grps[args.group] if grps
                 else [im.name for im in proj.image_list])
        build_map.build(proj, matches, grps, group_index=args.group,
                        only_images=multihost.process_shard(sorted(group)),
                        global_outputs=rank0, device=device)
        multihost.barrier("step5_render")
        if rank0:
            if args.histogram:
                build_histograms(proj, device=device)
                log("histogram-matching tables built (explorer applies "
                    "them at texture load)")
            if args.geotiff:
                geotiff.build_geotiff(proj,
                                      grps[args.group] if grps else None,
                                      resolution=args.geotiff_res,
                                      ground=args.ground or 0.0,
                                      device=device)
            proj.state.update("STEP5")
    multihost.barrier("step5")
    mark("step5_render")
    log(f"stage wall: TOTAL {time.perf_counter() - t_start:.2f}s")
    log("Pipeline complete.")
    return 0


def _step1(args, proj):
    """Step 1, the camera config, unless its marker is set. Returns 0, or
    1 when it finds no usable camera."""
    if not proj.state.check("STEP1"):
        log("Step 1: setting up camera config")
        cam_key = args.camera or proj.detect_camera()
        cfg = (camera_db.load(cam_key, db_dirs=args.camera_db)
               if cam_key else None)
        if cfg is None:
            files = proj.image_files()
            if not files:
                log("no images found in", args.project)
                return 1
            log("camera not in DB, estimating from EXIF:", cam_key)
            cfg = camera_db.estimate_from_exif(
                os.path.join(args.project, files[0]))
        cfg["mount"] = {"yaw_deg": args.yaw_deg, "pitch_deg": args.pitch_deg,
                        "roll_deg": args.roll_deg}
        # a zero focal length (no EXIF FocalLength, no DB entry) would NaN
        # every undistorted coordinate: fail here with the cause
        K = cfg.get("K") or []
        if len(K) < 5 or not (float(K[0]) > 0.0 and float(K[4]) > 0.0):
            log(f"camera '{cam_key}' has no usable focal length "
                f"(fx={K[0] if len(K) else 'missing'}): the images carry no "
                "EXIF FocalLength and the camera is not in the DB; pass "
                "--camera <key> (with --camera-db)")
            return 1
        proj.set_camera_config(cfg)
        proj.save()
        proj.state.update("STEP1")
    return 0


def _step2(args, proj, device):
    """Step 2 (the poses, the NED reference and the terrain priors) unless
    its marker is set; else the images' records."""
    if not proj.state.check("STEP2"):
        log("Step 2: setting aircraft/camera poses")
        pix4d = os.path.join(args.project, "pix4d.csv")
        meta_txt = os.path.join(args.project, "image-metadata.txt")
        if os.path.exists(pix4d):
            pose_mod.set_aircraft_poses(proj, pix4d, order="rpy",
                                        max_angle=args.max_angle)
        elif os.path.exists(meta_txt):
            pose_mod.set_aircraft_poses(proj, meta_txt, order="ypr",
                                        max_angle=args.max_angle)
        else:
            log("No pose file found, generating pix4d.csv from image EXIF")
            pose_mod.make_pix4d(args.project,
                                camera_make=proj.camera.get("make", ""),
                                camera_model=proj.camera.get("model", ""),
                                force_altitude=args.force_altitude,
                                force_heading=args.force_heading,
                                yaw_from_groundtrack=args.yaw_from_groundtrack)
            pose_mod.set_aircraft_poses(proj, pix4d, order="rpy",
                                        max_angle=args.max_angle)
        proj.load_images_info()
        proj.compute_ned_reference_lla()
        pose_mod.compute_camera_poses(proj)
        terrain = srtm.project_terrain(proj, fallback_elev=args.ground,
                                       device=device)
        smart_state = smart_mod.SmartState(proj.analysis_dir)
        smart_state.update_srtm_elevations(proj, terrain)
        smart_state.save()
        proj.save()
        proj.state.update("STEP2")
    else:
        proj.load_images_info()


def _steps3bcd(args, proj, terrain_base, device, mark):
    """Steps 3b (linking), 3c (the first triangulation) and 3d (groups),
    each unless its marker is set; the chains stay in memory between
    them. mark(name) logs a stage's wall. Returns the chains (None when
    no step ran)."""
    matches = None
    if not proj.state.check("STEP3b"):
        log("Step 3b: linking matches into chains")
        for im in proj.image_list:
            if im.kp is None:
                im.load_features()
            if not im.match_list:
                im.load_matches()
        matches = cleanup.link_matches(proj)
        proj.save_matches_grouped(matches)
        proj.state.update("STEP3b")
    mark("step3b_link")

    if not proj.state.check("STEP3c"):
        log("Step 3c: initial triangulation")
        if matches is None:
            matches = proj.load_matches_grouped()
        if args.ground is not None:
            def base(image):
                return args.ground
        else:
            base = terrain_base()
        cleanup.triangulate_ground(proj, matches, get_base_elev=base,
                                   device=device)
        proj.save_matches_grouped(matches)
        proj.state.update("STEP3c")
    mark("step3c_triangulate")

    if not proj.state.check("STEP3d"):
        log("Step 3d: connectivity grouping")
        if matches is None:
            matches = proj.load_matches_grouped()
        grps = groups_mod.compute(proj.image_list, matches,
                                  min_chain_len=args.min_chain_len)
        groups_mod.save(proj.analysis_dir, grps)
        proj.save_matches_grouped(matches)
        log("Groups:", [len(g) for g in grps])
        proj.state.update("STEP3d")
    return matches


def main(argv=None, device="cuda"):
    """The command line's entry point: parse argv and run on device.
    IMGTPU_PLATFORM (cpu or cuda) in the environment overrides device. The
    card is never swapped for the CPU: without one, asking for it raises."""
    dev = main_device(device)
    args = build_parser().parse_args(argv)
    return run(args, device=dev)


if __name__ == "__main__":
    sys.exit(main())

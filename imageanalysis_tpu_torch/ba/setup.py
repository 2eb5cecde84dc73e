"""BA problem assembly from the chain structure, and the write-back.

Port of ``imageanalysis_tpu/ba/setup.py``: the group's images become
contiguous camera indices, chains with fewer than ``min_chain_len``
in-group observations are skipped, and the cameras, points and
observation arrays are assembled (host numpy). Observations keep the RAW
(distorted) uv; the projection applies the distortion. ``write_back``
stores the optimized poses (``camera_pose_opt`` in meta/) and points;
the reference pins its host math to the CPU backend there
(``core/hostmath``), which the port needs no counterpart for: it converts
on the host.
"""

from __future__ import annotations

import numpy as np

from ..core.rotations import ypr_from_quat
from ..io.logger import log
from .bundle import BAObservations


def setup_from_matches(proj, matches, group_images=None, min_chain_len=3,
                       optimized=False):
    """Returns (cams0 (n, 7) f32, pts0 (m, 3) f32, obs BAObservations of
    numpy arrays, cam_names, match_map).

    group_images: the image names to optimize (None = all);
    match_map[k] = the index into ``matches`` of point k (for the
    write-back). optimized=True starts from each image's optimized pose
    where it is valid."""
    if group_images is None:
        group_images = [im.name for im in proj.image_list]
    group_set = set(group_images)
    name_to_cam = {}
    cam_names = []
    cams0 = []
    for im in proj.image_list:
        if im.name in group_set:
            name_to_cam[im.name] = len(cam_names)
            cam_names.append(im.name)
            use_opt = optimized and im.has_opt_pose()
            ned, _, quat = im.get_camera_pose(opt=use_opt)
            cams0.append(np.r_[np.asarray(ned, np.float64),
                               np.asarray(quat, np.float64)])
    idx_to_cam = {i: name_to_cam[im.name]
                  for i, im in enumerate(proj.image_list)
                  if im.name in name_to_cam}

    flat = _flat_obs(matches)
    if flat is not None:
        cam_idx, pt_idx, uvs, match_map, skipped_short = \
            _assemble_flat(matches, flat, idx_to_cam, len(proj.image_list),
                           min_chain_len)
        pts0 = np.asarray([matches[mi][0] for mi in match_map],
                          np.float64).reshape(-1, 3)
    else:
        pts0, cam_idx, pt_idx, uvs, match_map = [], [], [], [], []
        skipped_short = 0
        for mi, match in enumerate(matches):
            obs = [(img, uv) for img, uv in match[2:] if img in idx_to_cam]
            if len(obs) < min_chain_len:
                skipped_short += 1
                continue
            if match[0] is None:
                continue
            k = len(pts0)
            pts0.append(match[0])
            match_map.append(mi)
            for img, uv in obs:
                cam_idx.append(idx_to_cam[img])
                pt_idx.append(k)
                uvs.append(uv)
        pts0 = np.asarray(pts0, np.float64).reshape(-1, 3)
    log(f"BA setup: {len(cam_names)} cameras, {len(pts0)} points, "
        f"{len(uvs)} observations ({skipped_short} short chains skipped)")

    obs = BAObservations(
        cam_idx=np.asarray(cam_idx, np.int32),
        pt_idx=np.asarray(pt_idx, np.int32),
        uv=np.asarray(uvs, np.float32),
        weight=np.ones(len(uvs), np.float32),
    )
    return (np.asarray(cams0, np.float32), pts0.astype(np.float32), obs,
            cam_names, np.asarray(match_map, np.int64))


def _flat_obs(matches):
    """The flat observation arrays link_matches attaches (cleanup.MatchList),
    checked against the chains (culls edit chains without refreshing them).
    Returns (obs_img, obs_uv, obs_match) or None."""
    obs_img = getattr(matches, "obs_img", None)
    if obs_img is None:
        return None
    total_obs = sum(len(m) - 2 for m in matches)
    obs_match = getattr(matches, "obs_match", ())
    if len(obs_img) != total_obs or len(obs_match) != total_obs:
        return None
    if total_obs and int(obs_match[-1]) != len(matches) - 1:
        return None
    return obs_img, matches.obs_uv, obs_match


def _assemble_flat(matches, flat, idx_to_cam, n_images, min_chain_len):
    """Array-at-a-time assembly with the per-observation loop's output:
    chain-major observation order, chains with < min_chain_len in-group
    observations skipped, untriangulated chains (match[0] None) skipped
    without counting as short."""
    obs_img, obs_uv, obs_match = flat
    cam_of_img = np.full(n_images, -1, np.int64)
    for i, c in idx_to_cam.items():
        cam_of_img[i] = c
    obs_cam = cam_of_img[obs_img]
    valid = obs_cam >= 0

    n_chain = len(matches)
    counts = np.bincount(obs_match[valid], minlength=n_chain)
    long_enough = counts >= min_chain_len
    skipped_short = int(n_chain - long_enough.sum())
    has_pt = np.fromiter((m[0] is not None for m in matches), bool,
                         count=n_chain)
    keep_chain = long_enough & has_pt

    new_id = np.cumsum(keep_chain, dtype=np.int64) - 1
    kept = valid & keep_chain[obs_match]
    cam_idx = obs_cam[kept]
    pt_idx = new_id[obs_match[kept]]
    uvs = np.asarray(obs_uv)[kept]
    match_map = np.nonzero(keep_chain)[0]
    return cam_idx, pt_idx, uvs, match_map, skipped_short


def write_back(proj, matches, result, cam_names, match_map):
    """Store the optimized camera poses (camera_pose_opt, saved to meta/)
    and the optimized points (match[0])."""
    r2d = 180.0 / np.pi
    for ci, name in enumerate(cam_names):
        im = proj.image_by_name(name)
        if im is None:
            continue
        ned = result.cams[ci, :3].tolist()
        quat = np.asarray(result.cams[ci, 3:7])
        y, p, r = (float(a) * r2d for a in ypr_from_quat(quat))
        im.set_camera_pose(ned, y, p, r, opt=True, quat=quat)
        im.save_meta()
    for k, mi in enumerate(match_map):
        matches[mi][0] = result.pts[k].tolist()

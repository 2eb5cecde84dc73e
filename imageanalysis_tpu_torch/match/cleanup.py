"""Match consolidation: chain linking and the initial ground triangulation.

Port of ``imageanalysis_tpu/match/cleanup.py`` (Steps 3b and 3c of
``apps/process.py``):

- ``canonical_kp_maps``: per image, keypoints at identical uv collapse to
  the first of them before linking;
- ``link_matches``: the pair match lists become multi-image chains, by
  connected components over (image, canonical keypoint) nodes (scipy, on
  the host, as the reference). Where transitivity puts two keypoints of one
  image in a chain, the lowest keypoint index stays. Chains hold raw uv and
  come sorted longest first;
- ``triangulate_ground``: each chain's first 3D estimate, the mean of its
  observations' rays cut with the ground plane at each image's base
  elevation; the rays run on ``device`` through ``core/camera.py``.
  ``subset`` and ``optimized`` serve the refresh of stale chains after BA.

The chain structure, pickled as ``matches_grouped``, is the same in both
packages: ``[ned | None, group_id, [img_idx, [u, v]], ...]``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.camera import (intersect_ground_plane, pixel_vectors_ned,
                           undistort_pixels)
from ..core.rotations import quat_to_matrix
from ..io.logger import log


class MatchList(list):
    """The chain structure, plus optional flat observation arrays
    (obs_img, obs_uv, obs_match — aligned, chain-major in list order) that
    let the next stage skip flattening the Python lists again. Pickles as a
    PLAIN list, so a ``matches_grouped`` file loads in either package; the
    arrays are derived data, and consumers check them against the chains
    (culls edit chains without refreshing them) and rebuild them when
    absent or stale."""

    obs_img = obs_uv = obs_match = None

    def __reduce__(self):
        return (list, (), None, iter(self))


class UnionFind:
    def __init__(self, n):
        self.parent = np.arange(n, dtype=np.int64)

    def find(self, x):
        root = x
        p = self.parent
        while p[root] != root:
            root = p[root]
        while p[x] != root:
            p[x], x = root, p[x]
        return root

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def canonical_kp_maps(proj):
    """Per image: kp index → canonical kp index (the first with identical
    uv)."""
    maps = []
    total_dup = 0
    for image in proj.image_list:
        if image.kp is None:
            image.load_features()
        kp = image.kp if image.kp is not None else np.zeros((0, 2), np.float32)
        if len(kp):
            _, first_idx, inverse = np.unique(kp, axis=0, return_index=True,
                                              return_inverse=True)
            canon = first_idx[inverse.reshape(-1)].astype(np.int64)
            total_dup += int((canon != np.arange(len(kp))).sum())
        else:
            canon = np.zeros(0, np.int64)
        maps.append(canon)
    log("Canonicalized duplicate keypoints:", total_dup)
    return maps


def link_matches(proj):
    """Pair match lists → the chain structure, by connected components.

    Returns a MatchList of [None, -1, [i, [u, v]], ...] sorted longest
    first, with its flat observation arrays attached."""
    import scipy.sparse
    import scipy.sparse.csgraph

    name_to_idx = {im.name: i for i, im in enumerate(proj.image_list)}
    canon = canonical_kp_maps(proj)

    # edges as flat node ids: node = offset[i] + canonical kp
    offsets = np.zeros(len(proj.image_list) + 1, np.int64)
    for i, c in enumerate(canon):
        offsets[i + 1] = offsets[i] + len(c)
    n_nodes = int(offsets[-1])

    ea, eb = [], []
    for i, image in enumerate(proj.image_list):
        if not image.match_list:
            image.load_matches()
        for other, pairs in image.match_list.items():
            j = name_to_idx.get(other)
            if j is None or j <= i or len(pairs) == 0:
                continue
            arr = np.asarray(pairs, np.int64).reshape(-1, 2)
            ea.append(offsets[i] + canon[i][arr[:, 0]])
            eb.append(offsets[j] + canon[j][arr[:, 1]])
    if ea:
        ea = np.concatenate(ea)
        eb = np.concatenate(eb)
    else:
        ea = eb = np.zeros(0, np.int64)
    log("Total feature pairs in image set:", len(ea))

    g = scipy.sparse.coo_matrix(
        (np.ones(len(ea), np.int8), (ea, eb)), shape=(n_nodes, n_nodes))
    _, labels = scipy.sparse.csgraph.connected_components(g, directed=False)

    used = np.unique(np.concatenate([ea, eb]))
    lab = labels[used]
    order = np.lexsort((used, lab))        # by component, then node id
    nodes = used[order]
    lab = lab[order]
    imgs = np.searchsorted(offsets, nodes, side="right") - 1

    # within each (component, image) the lowest kp index stays (nodes are
    # sorted, so the first row of each group); the rest are dropped
    grp_first = np.ones(len(nodes), bool)
    if len(nodes):
        grp_first[1:] = (lab[1:] != lab[:-1]) | (imgs[1:] != imgs[:-1])
    dropped_obs = int((~grp_first).sum())
    lab_f = lab[grp_first]
    imgs_f = imgs[grp_first]

    # uv per observation: node ids index the concatenated kp table
    all_kp = np.concatenate(
        [im.kp if im.kp is not None and len(im.kp)
         else np.zeros((0, 2), np.float32) for im in proj.image_list])
    uvs = all_kp[nodes[grp_first]]

    # chains built directly in longest-first order (stable, as
    # list.sort(key=len, reverse=True)), so the flat arrays can be attached
    # in final order
    _, comp_starts, comp_sizes = np.unique(
        lab_f, return_index=True, return_counts=True)
    obs_items = [[i, uv] for i, uv in zip(imgs_f.tolist(), uvs.tolist())]
    keep = comp_sizes >= 2
    k_starts = comp_starts[keep]
    k_sizes = comp_sizes[keep]
    order = np.argsort(-k_sizes, kind="stable")
    k_starts = k_starts[order]
    k_sizes = k_sizes[order]
    matches = MatchList()
    for s, size in zip(k_starts.tolist(), k_sizes.tolist()):
        matches.append([None, -1] + obs_items[s:s + size])

    total = int(k_sizes.sum())
    within = np.arange(total, dtype=np.int64) \
        - np.repeat(np.cumsum(k_sizes) - k_sizes, k_sizes)
    sel = np.repeat(k_starts, k_sizes) + within
    matches.obs_img = imgs_f[sel].astype(np.int32)
    matches.obs_uv = uvs[sel].astype(np.float32)
    matches.obs_match = np.repeat(
        np.arange(len(k_sizes), dtype=np.int64), k_sizes)
    if dropped_obs:
        log("Dropped inconsistent extra observations:", dropped_obs)
    if matches:
        log("Total unique features in image set:", len(matches))
        log("Keypoint average instances: %.2f" % (total / len(matches)))
    return matches


def _flat_or_rebuilt(matches):
    """(obs_img, obs_uv, obs_match) of the chains: the arrays link_matches
    attached when they still agree with the chains, else flattened anew."""
    total_obs = sum(len(m) - 2 for m in matches)
    flat = getattr(matches, "obs_img", None)
    if flat is not None and len(flat) == total_obs \
            and len(getattr(matches, "obs_match", ())) == total_obs \
            and (total_obs == 0
                 or int(matches.obs_match[-1]) == len(matches) - 1):
        return matches.obs_img, matches.obs_uv, matches.obs_match
    obs_img, obs_uv, obs_match = [], [], []
    for mi, match in enumerate(matches):
        for img, uv in match[2:]:
            obs_img.append(img)
            obs_uv.append(uv)
            obs_match.append(mi)
    return (np.asarray(obs_img, np.int32),
            np.asarray(obs_uv, np.float32).reshape(-1, 2),
            np.asarray(obs_match, np.int64))


def triangulate_ground(proj, matches, get_base_elev=None, subset=None,
                       optimized=False, device="cuda"):
    """Initial 3D estimate of every chain: the mean of its observations'
    rays cut with the ground plane, the rays batched on ``device``.

    get_base_elev(image) → terrain elevation (m MSL, up) under the image,
    0 when not given; never above the camera less 1 m. subset: chain
    indices to recompute (the others are untouched). optimized=True reads
    each image's optimized pose where it is valid (the raw one otherwise).
    Together they serve the refresh after BA: chains BA did not optimize
    keep points derived from the pre-BA poses, which the optimized poses
    can reproject badly. Undistorted uv are projected (the reference's
    convention). Edits matches in place and returns it."""
    dev = torch.device(device)
    cam = proj.camera_model()
    K = torch.as_tensor(np.asarray(cam.K, np.float32), device=dev)
    dist = torch.as_tensor(np.asarray(cam.dist, np.float32), device=dev)
    ref_alt = proj.ned_reference_lla()[2]

    n_img = len(proj.image_list)
    cam_ned = np.zeros((n_img, 3), np.float32)
    cam_quat = np.zeros((n_img, 4), np.float32)
    base_elev = np.zeros(n_img, np.float32)
    for i, image in enumerate(proj.image_list):
        opt = optimized and image.has_opt_pose()
        ned, _, quat = image.get_camera_pose(opt=opt)
        cam_ned[i] = ned
        cam_quat[i] = quat
        elev = float(get_base_elev(image)) if get_base_elev else 0.0
        if -ned[2] - 1 < elev:
            elev = -ned[2] - 1
        base_elev[i] = elev

    obs_img, obs_uv, obs_match = _flat_or_rebuilt(matches)
    if subset is not None:
        keep = np.zeros(len(matches), bool)
        idx = np.fromiter(subset, dtype=np.int64)
        if len(idx):
            keep[idx] = True
        sel = keep[obs_match]
        obs_img, obs_uv, obs_match = obs_img[sel], obs_uv[sel], \
            obs_match[sel]
    if len(obs_img) == 0:
        return matches

    img = torch.from_numpy(np.asarray(obs_img, np.int64)).to(dev)
    uv = torch.from_numpy(np.ascontiguousarray(obs_uv, np.float32)).to(dev)
    uv_und = undistort_pixels(uv, K, dist)
    body2ned = quat_to_matrix(torch.from_numpy(cam_quat).to(dev))[img]
    vecs = pixel_vectors_ned(uv_und, body2ned, K)
    # ground_m is the terrain elevation above the NED reference (the plane
    # sits at down = −ground_m)
    elev_rel = torch.from_numpy(base_elev - np.float32(ref_alt)).to(dev)[img]
    pts = intersect_ground_plane(torch.from_numpy(cam_ned).to(dev)[img],
                                 elev_rel, vecs).cpu().numpy()

    # per-chain means in float64 on the host
    n_m = len(matches)
    counts = np.bincount(obs_match, minlength=n_m)
    denom = np.maximum(counts, 1)
    means = np.stack([np.bincount(obs_match, weights=pts[:, k].astype(
        np.float64), minlength=n_m) / denom for k in range(3)], axis=1)
    means_l = means.tolist()
    for mi in np.nonzero(counts)[0].tolist():
        matches[mi][0] = means_l[mi]
    return matches

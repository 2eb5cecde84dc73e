""""Smart" priors: per-image surface elevation and yaw-error estimates.

Port of ``imageanalysis_tpu/match/smart.py``. After each chunk of pairs is
matched, (a) triangulate each pair's matches and keep a distance²-weighted
average ground elevation per image (``tri_surface_m``; pairs with stddev
≥ 25 m are distrusted), and (b) fit a 2-D similarity between the matched
uv sets, project image 2's center into image 1, and compare the implied
course with the GPS ground course to estimate a per-image heading bias
(``yaw_error``). ``SmartState`` persists them as smart.json, the same file
the reference writes. The triangulation and similarity fits run batched
on the device in one call per chunk (``_pair_stats_fused``); the per-pair
estimators (``triangulate_pair``, ``estimate_surface_elevation``,
``estimate_yaw_error``, ``update_pair``) run the same math on one pair.
The reference's jit wrappers of the two-view triangulation and the
similarity fit have no counterpart: PyTorch runs eagerly. Across ranks
(parallel/multihost.py) each rank's evidence goes to a shard file
(``save_shard``) and rank 0 unions them (``merge_shard_data``).
"""

from __future__ import annotations

import json
import os
from math import atan2, pi

import numpy as np
import torch

from ..core.camera import ned_quat_to_rt, pixels_to_normalized
from ..core.transforms import fit_similarity_2d
from ..io.logger import log, qlog
from ..ops.triangulate import triangulate_two_view

R2D = 180.0 / pi
CUTOFF_STD = 25.0      # reference smart.py:221
YAW_MAX = 30.0         # reference smart.py:276
YAW_MIN_DIST = 0.5     # reference smart.py:276


class SmartState:
    """The /smart property tree, as plain dicts."""

    def __init__(self, analysis_dir: str):
        self.analysis_dir = analysis_dir
        self.data: dict = {}
        self.load()

    # -- persistence (smart.json contract) --------------------------------
    def path(self):
        return os.path.join(self.analysis_dir, "smart.json")

    def load(self):
        if os.path.isfile(self.path()):
            with open(self.path()) as f:
                self.data = json.load(f)

    def save(self):
        with open(self.path(), "w") as f:
            json.dump(self.data, f, indent=4, sort_keys=True)

    def node(self, image_name: str) -> dict:
        return self.data.setdefault(image_name, {})

    # -- surface ----------------------------------------------------------
    def update_surface_pair(self, name1, name2, surface_m, stddev, dist_m):
        """Record a pairwise triangulated elevation and refresh both images'
        weighted ``tri_surface_m``."""
        weight = int(dist_m * dist_m)
        for a, b in ((name1, name2), (name2, name1)):
            pairs = self.node(a).setdefault("tri_surface_pairs", {})
            pairs[b] = {"surface_m": round(float(surface_m), 1),
                        "weight": weight,
                        "stddev": round(float(stddev), 1),
                        "dist_m": int(dist_m)}
            self._refresh_surface(a)

    def _refresh_surface(self, name):
        s = c = 0.0
        for rec in self.node(name).get("tri_surface_pairs", {}).values():
            if rec["stddev"] < CUTOFF_STD:
                s += rec["surface_m"] * rec["weight"]
                c += rec["weight"]
        if c > 0:
            self.node(name)["tri_surface_m"] = round(s / c, 1)

    def get_surface(self, name1, name2=None):
        """Average triangulated elevation under the pair; the SRTM value
        (srtm_surface_m, 0 when absent) before any triangulation."""
        names = [name1] + ([name2] if name2 else [])
        vals = [self.node(n)["tri_surface_m"] for n in names
                if "tri_surface_m" in self.node(n)]
        if vals:
            return float(np.mean(vals))
        ground = float(np.mean([self.node(n).get("srtm_surface_m", 0.0)
                                for n in names]))
        qlog("  SRTM ground (no triangulation yet): %.1f" % ground)
        return ground

    # -- yaw error --------------------------------------------------------
    def update_yaw_pair(self, name1, name2, yaw_error, dist_m, crs_aff,
                        weight):
        yaw_pairs = self.node(name1).setdefault("yaw_pairs", {})
        yaw_pairs[name2] = {"yaw_error": round(float(yaw_error), 1),
                            "dist_m": round(float(dist_m), 1),
                            "relative_crs": round(float(crs_aff), 1),
                            "weight": round(float(weight), 1)}
        return self._refresh_yaw(name1)

    def _refresh_yaw(self, name):
        s = c = 0.0
        for rec in self.node(name).get("yaw_pairs", {}).values():
            if rec["dist_m"] >= YAW_MIN_DIST \
                    and abs(rec["yaw_error"]) <= YAW_MAX:
                s += rec["yaw_error"] * rec["weight"]
                c += rec["weight"]
        if c > 0:
            self.node(name)["yaw_error"] = round(s / c, 1)
            return s / c
        return 0.0

    def get_yaw_error(self, name):
        return float(self.node(name).get("yaw_error", 0.0))

    # -- the shard merge of a run across ranks ----------------------------
    def save_shard(self, path):
        """Write this rank's state as a shard file (atomically)."""
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.data, f)
        os.replace(tmp, path)

    def merge_shard_data(self, other: dict):
        """Union another rank's pairwise evidence into this state and
        refresh the per-image means from the union. The ranks' pairs are
        disjoint (the match work list is split by rank), so a key-wise
        union of tri_surface_pairs and yaw_pairs is exact; the other keys
        are taken where this state lacks them."""
        touched = set()
        for name, node in other.items():
            mine = self.node(name)
            for key in ("tri_surface_pairs", "yaw_pairs"):
                if node.get(key):
                    mine.setdefault(key, {}).update(node[key])
                    touched.add(name)
            for k, v in node.items():
                if k not in ("tri_surface_pairs", "yaw_pairs",
                             "tri_surface_m", "yaw_error") and k not in mine:
                    mine[k] = v
        for name in touched:
            self._refresh_surface(name)
            self._refresh_yaw(name)

    def update_srtm_elevations(self, proj, terrain):
        """srtm_surface_m under each camera, from the terrain's host grid
        (one batched query)."""
        neds = np.array([image.get_camera_pose()[0]
                         for image in proj.image_list], np.float32)
        if len(neds) == 0:
            return
        elevs = np.asarray(terrain.interp_host(neds[:, 0], neds[:, 1]))
        for image, e in zip(proj.image_list, np.atleast_1d(elevs)):
            self.node(image.name)["srtm_surface_m"] = round(float(e), 1)


# ---------------------------------------------------------------------------
# per-pair estimators
# ---------------------------------------------------------------------------

def _pair_uv(i1, i2):
    """The matched keypoints of a pair, (uv1 (n, 2), uv2 (n, 2)) f32
    numpy, features loaded where they are not; None for no matches."""
    pairs = i1.match_list.get(i2.name, [])
    if len(pairs) == 0:
        return None
    if i1.kp is None:
        i1.load_features()
    if i2.kp is None:
        i2.load_features()
    arr = np.asarray(pairs, np.int64).reshape(-1, 2)
    return (np.asarray(i1.kp, np.float32)[arr[:, 0]],
            np.asarray(i2.kp, np.float32)[arr[:, 1]])


def triangulate_pair(proj, i1, i2, device="cuda"):
    """Triangulate one pair's matches with the current poses → (N, 3) NED
    numpy, or None without matches: the two-view DLT with Gauss–Newton
    refinement on K⁻¹-normalized uv, on device."""
    uv = _pair_uv(i1, i2)
    if uv is None:
        return None
    K = proj.camera_model().K.to(device)
    P = []
    for im in (i1, i2):
        ned, _, q = im.get_camera_pose()
        R, t = ned_quat_to_rt(torch.tensor(ned, dtype=torch.float32),
                              torch.tensor(q, dtype=torch.float32))
        P.append(torch.cat([R, t[:, None]], dim=1).to(device))
    n1, n2 = (pixels_to_normalized(torch.from_numpy(u).to(device), K)
              for u in uv)
    return triangulate_two_view(P[0], P[1], n1, n2).cpu().numpy()


def estimate_surface_elevation(proj, i1, i2, device="cuda"):
    """(avg_elev_m, std, baseline_m) for a pair; elevation is −down of
    the triangulated points; (None, None, baseline) without matches."""
    pts = triangulate_pair(proj, i1, i2, device)
    ned1, _, _ = i1.get_camera_pose()
    ned2, _, _ = i2.get_camera_pose()
    dist_m = float(np.linalg.norm(np.asarray(ned2) - np.asarray(ned1)))
    if pts is None:
        return None, None, dist_m
    return float(-np.mean(pts[:, 2])), float(np.std(pts[:, 2])), dist_m


def estimate_yaw_error(proj, i1, i2, device="cuda"):
    """(yaw_error_deg, dist_m, crs_aff, weight) of a pair from the
    uv2→uv1 similarity of its matches (fit on device); None with fewer
    than two matches or a zero baseline."""
    uv = _pair_uv(i1, i2)
    if uv is None or len(uv[0]) < 2:
        return None
    A = fit_similarity_2d(torch.from_numpy(uv[1]).to(device),
                          torch.from_numpy(uv[0]).to(device))
    return _yaw_from_affine(proj, i1, i2, A.cpu().numpy())


def update_pair(proj, smart: SmartState, i1, i2, device="cuda"):
    """Run both estimators for a freshly matched pair and record them.
    Returns (avg_elev_m, std), None for both without matches."""
    avg, std, dist_m = estimate_surface_elevation(proj, i1, i2, device)
    if avg is not None:
        smart.update_surface_pair(i1.name, i2.name, avg, std, dist_m)
    res = estimate_yaw_error(proj, i1, i2, device)
    if res is not None:
        smart.update_yaw_pair(i1.name, i2.name, *res)
    return avg, std


# ---------------------------------------------------------------------------
# batched pair estimators
# ---------------------------------------------------------------------------

def pair_surface_stats_batched(proj, pair_list, chunk=256, device="cuda"):
    """Triangulated (avg_elev, std, baseline) and the uv2→uv1 similarity
    for many pairs in few device calls: each pair's matches are subsampled
    to 256 evenly strided ones, and chunks of pairs go through one batched
    _pair_stats_fused call.

    pair_list: [(i1, i2), ...] ImageRecord pairs with non-empty match
    lists. Returns (stats, affines), lists aligned with pair_list."""
    if not pair_list:  # a mission with zero surviving matches
        return [], []
    K = proj.camera_model().K.to(device)
    uniq = {}
    for i1, i2 in pair_list:
        for im in (i1, i2):
            uniq.setdefault(im.name, im)
    names = list(uniq)
    neds = np.array([uniq[nm].get_camera_pose()[0] for nm in names],
                    np.float32)
    quats = np.array([uniq[nm].get_camera_pose()[2] for nm in names],
                     np.float32)
    R_all, t_all = ned_quat_to_rt(torch.from_numpy(neds),
                                  torch.from_numpy(quats))
    P_all = torch.cat([R_all, t_all[..., None]], dim=-1).numpy()
    P_by_name = {nm: P_all[i] for i, nm in enumerate(names)}
    ned_by_name = {nm: neds[i] for i, nm in enumerate(names)}

    cap = 256
    results = [None] * len(pair_list)
    affines = [None] * len(pair_list)
    for s in range(0, len(pair_list), chunk):
        group = list(range(s, min(s + chunk, len(pair_list))))
        n_real = len(group)
        # two padded batch shapes only (64 / chunk), as the reference
        B = 64 if n_real <= 64 else chunk
        group = group + [group[-1]] * (B - n_real)
        uv1 = np.zeros((B, cap, 2), np.float32)
        uv2 = np.zeros((B, cap, 2), np.float32)
        msk = np.zeros((B, cap), np.float32)
        P1 = np.zeros((B, 3, 4), np.float32)
        P2 = np.zeros((B, 3, 4), np.float32)
        dists = np.zeros(B)
        for bi, k in enumerate(group):
            i1, i2 = pair_list[k]
            if i1.kp is None:
                i1.load_features()
            if i2.kp is None:
                i2.load_features()
            arr = np.asarray(i1.match_list[i2.name], np.int64).reshape(-1, 2)
            if len(arr) > cap:
                arr = arr[np.linspace(0, len(arr) - 1, cap).astype(int)]
            n = len(arr)
            uv1[bi, :n] = i1.kp[arr[:, 0]]
            uv2[bi, :n] = i2.kp[arr[:, 1]]
            msk[bi, :n] = 1.0
            P1[bi] = P_by_name[i1.name]
            P2[bi] = P_by_name[i2.name]
            dists[bi] = np.linalg.norm(ned_by_name[i2.name]
                                       - ned_by_name[i1.name])
        mean_z, std_z, A, cnt = (x.cpu().numpy() for x in _pair_stats_fused(
            *(torch.from_numpy(x).to(device) for x in (P1, P2, uv1, uv2,
                                                       msk)), K))
        for bi, k in enumerate(group[:n_real]):
            if cnt[bi] > 0:
                results[k] = (float(-mean_z[bi]), float(std_z[bi]),
                              float(dists[bi]))
                affines[k] = A[bi]
    return results, affines


def _pair_stats_fused(P1, P2, uv1, uv2, msk, K):
    """Normalize → triangulate → masked z stats + uv2→uv1 similarity for
    a chunk of pairs: P1/P2 (B, 3, 4), uv1/uv2 (B, n, 2), msk (B, n).
    Returns per-pair (mean_z, std_z, A (2, 3), count) only."""
    n1 = pixels_to_normalized(uv1, K)
    n2 = pixels_to_normalized(uv2, K)
    pts = triangulate_two_view(P1, P2, n1, n2)
    cnt = msk.sum(-1)
    denom = cnt.clamp_min(1.0)
    z = pts[..., 2]
    mean_z = (z * msk).sum(-1) / denom
    var_z = (msk * (z - mean_z[:, None]) ** 2).sum(-1) / denom
    A = fit_similarity_2d(uv2, uv1, msk)
    return mean_z, torch.sqrt(var_z), A, cnt


def requalify_pairs(proj, smart: SmartState, std_cutoff=50.0, device="cuda"):
    """Re-triangulate every matched pair with the current poses and
    discard pairs whose surface stddev still exceeds the cutoff (the
    reference's bad-geometry rejection, run after the yaw-error correction
    so a heading bias does not condemn good pairs). Saves the touched
    match files and smart.json; returns the number of pairs dropped."""
    name_idx = {im.name: im for im in proj.image_list}
    pair_list = []
    for i1 in proj.image_list:
        for other in list(i1.match_list.keys()):
            i2 = name_idx.get(other)
            if i2 is None or len(i1.match_list[other]) == 0:
                continue
            if i1.name < other:  # each pair once
                pair_list.append((i1, i2))
    stats, _ = pair_surface_stats_batched(proj, pair_list, device=device)
    n_drop = 0
    for (i1, i2), st in zip(pair_list, stats):
        if st is None:
            continue
        avg, std, dist_m = st
        smart.update_surface_pair(i1.name, i2.name, avg, std, dist_m)
        if std >= std_cutoff:
            log("Matches suspect, big surface std:", i1.name, i2.name,
                "%.1f" % std, "- discarding pair")
            i1.match_list[i2.name] = []
            i2.match_list[i1.name] = []
            i1.matches_clean = False
            i2.matches_clean = False
            n_drop += 1
    for im in proj.image_list:
        if not im.matches_clean:
            im.save_matches()
    smart.save()
    return n_drop


def _yaw_from_affine(proj, i1, i2, A):
    """Yaw error (deg), baseline, affine course and weight of a pair from
    its uv2→uv1 similarity A (2, 3); None for a zero baseline. Host
    numpy."""
    A = np.asarray(A)
    tx, ty = float(A[0, 2]), float(A[1, 2])
    weight = abs(ty / tx) if abs(ty) > 0 and tx != 0 else abs(tx)
    ned1, _, _ = i1.get_camera_pose()
    ned2, _, _ = i2.get_camera_pose()
    diff = np.asarray(ned2) - np.asarray(ned1)
    dist = float(np.linalg.norm(diff))
    if dist < 1e-6:
        return None
    dirv = diff / dist
    crs_gps = (90 - atan2(dirv[0], dirv[1]) * R2D) % 360
    w = int(proj.camera.get("width_px", 0))
    h = int(proj.camera.get("height_px", 0))
    c = np.array([w * 0.5, h * 0.5, 1.0])
    newc = A @ c
    cdiff = [newc[0] - c[0], c[1] - newc[1]]
    crs_aff = 90 - atan2(cdiff[1], cdiff[0]) * R2D
    _, air_ypr1, _ = i1.get_aircraft_pose()
    yaw_error = crs_gps - (air_ypr1[0] + crs_aff)
    while yaw_error < -180:
        yaw_error += 360
    while yaw_error > 180:
        yaw_error -= 360
    return yaw_error, dist, crs_aff, weight


def update_pairs_batched(proj, smart: SmartState, pair_list, device="cuda"):
    """Surface + yaw updates for many freshly matched pairs with a few
    device calls."""
    pair_list = [(i1, i2) for i1, i2 in pair_list
                 if len(i1.match_list.get(i2.name, ())) > 0]
    if not pair_list:
        return
    stats, affines = pair_surface_stats_batched(proj, pair_list,
                                                device=device)
    for (i1, i2), st, A in zip(pair_list, stats, affines):
        if st is None:
            continue
        smart.update_surface_pair(i1.name, i2.name, *st)
        if A is not None:
            res = _yaw_from_affine(proj, i1, i2, A)
            if res is not None:
                smart.update_yaw_pair(i1.name, i2.name, *res)

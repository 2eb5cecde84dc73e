"""The match engine: batched pair matching on the device.

Port of ``imageanalysis_tpu/match/matcher.py``. For a
batch of pairs: exact mutual 2-NN (kernels K1/K3, or the CPU arm), the
Lowe ratio test and a RANSAC filter (homography, fundamental or
essential: ``MatchConfig.transform``), as batched tensor work over a
leading pair dimension; then the host unpack into per-pair match arrays
with the reference's ``min_pairs`` rule. ``essential5`` filters on the
host instead: the device keeps every ratio + mutual survivor, and the
unpack refilters each pair by the 5-point essential RANSAC
(``ops/essential5``) on K⁻¹-normalised points.

- ``traditional`` (and its aliases) matches every pair ungated;
- ``smart`` gates the 2-NN candidates to ``gate_radius_frac · hypot(w,
  h)`` px around a ground-projected position prior (``_predict_uv_in_a``)
  inside K1, retries the pairs that came up empty ungated, and updates the
  smart priors (``match.smart``) after every chunk.

``BatchMatcher`` has the reference's two data paths: per-chunk host
assembly of f32 descriptors (missions under 64 images) and the resident
``DescriptorStore`` with device-side gathers (int8, uint8 or float32:
match/store.py; the 2-NN runs in bf16 for the integer modes and for
float32 unless ``MatchConfig.bf16`` is off, as the reference's rule). ``find_matches`` is
Step 3a's matching stage over a project workspace. ``match_pairs_store``
is the store path with the workspace lifted out. Across ranks
(parallel/multihost.py) each rank matches its slice of the work list,
writes a shard, and rank 0 merges the shards into the per-image files.
"""

from __future__ import annotations

import glob
import json
import os
import pickle
import time
import types

import numpy as np
import torch

from ..core.camera import ned_quat_to_rt
from ..io.logger import log, qlog
from ..ops import essential5, knn, ransac
from ..parallel import multihost
from . import worklist


class MatchConfig:
    """Matching knobs, as the reference's MatchConfig.

    use_pallas picks the 2-NN arm: True the kernels (K1/K3, the
    reference's Pallas arm), False the materialized ``knn_top2_ref`` (its
    CPU arm). None, the default, decides by device where the reference
    decides by backend: the kernel arm for a CUDA device, the CPU arm for
    the CPU. A CUDA device takes only the kernel arm (False raises there);
    on the CPU, True runs the kernels' plain versions. As in the
    reference, the arms differ beyond 8192 rows: the kernel arm drops the
    smart gate there, the CPU arm keeps it."""

    def __init__(self, strategy="traditional", ratio=0.75,
                 transform="homography", match_ratio=None, min_pairs=25,
                 filter_thresh=None, batch_size=16, n_hyp=512,
                 detector_width=None, bf16=True, use_pallas=None, seed=42,
                 gate_radius_frac=0.2, compact_downloads=False, store_scan=4):
        self.strategy = strategy
        self.ratio = match_ratio if match_ratio is not None else ratio
        # homography | fundamental | essential | essential5 | none
        self.transform = transform
        self.min_pairs = min_pairs          # reference matcher.py:131 (25)
        self.filter_thresh = filter_thresh  # None → w^0.25
        self.batch_size = batch_size
        self.n_hyp = n_hyp
        self.bf16 = bf16
        self.use_pallas = use_pallas
        self.seed = seed
        # smart strategy: 2-NN candidates gated to within
        # gate_radius_frac·diag px of the ground-projected prior; 0
        # disables gating (priors + requalification only)
        self.gate_radius_frac = gate_radius_frac
        # compact the match results on the device before the download
        self.compact_downloads = compact_downloads
        # store path: S sub-batches of B pairs per group
        self.store_scan = store_scan


_TRANSFORMS = ("homography", "fundamental", "essential", "essential5",
               "none")


def _filter(best_j, ok, pb, uv_a, generator, thresh, transform, n_hyp,
            K=None, pick=None):
    """The geometric filter after the 2-NN: RANSAC inliers of ok (K, the
    (3, 3) intrinsics, for the essential matrix). "none" and the host
    "essential5" keep ok as it is."""
    if transform not in _TRANSFORMS:
        raise ValueError(f"unknown transform {transform!r} (one of "
                         f"{_TRANSFORMS})")
    kw = dict(thresh=thresh, n_hyp=n_hyp, generator=generator, pick=pick)
    if transform == "homography":
        res = ransac.ransac_homography(uv_a, pb, ok, **kw)
    elif transform == "fundamental":
        res = ransac.ransac_fundamental(uv_a, pb, ok, **kw)
    elif transform == "essential":
        res = ransac.ransac_essential(uv_a, pb, ok, K, **kw)
    else:
        return best_j, ok
    return best_j, ok & res.inliers & res.ok[:, None]


def match_pair_batch(desc_a, desc_b, uv_a, uv_b, n_a, n_b, generator=None,
                     ratio=0.75, thresh=3.0, transform="homography",
                     n_hyp=512, use_pallas=None, bf16=True, pick=None,
                     K=None):
    """Match a batch of image pairs end to end on the device.

    desc_a/desc_b (B, npad, 128) int8 or float; uv_a/uv_b (B, npad, 2)
    undistorted keypoints; n_a/n_b (B,) real counts; generator draws the
    RANSAC minimal sets (pick (B, n_hyp, k) replaces the draw); K (3, 3)
    the intrinsics, which transform="essential" needs. Returns
    (best_j (B, npad), ok (B, npad)) where ok marks ratio + mutual +
    RANSAC survivors."""
    best_j, ok, pb = knn.match_pair_dense(desc_a, desc_b, n_a, n_b,
                                          ratio=ratio, mutual=True,
                                          use_pallas=use_pallas, bf16=bf16,
                                          uv_b=uv_b)
    return _filter(best_j, ok, pb, uv_a, generator, thresh, transform,
                   n_hyp, K, pick)


def _pack(best_j, ok):
    """(B, npad) int16: the best B index of each survivor, −1 elsewhere."""
    if best_j.shape[-1] >= 32768:
        raise ValueError(f"npad {best_j.shape[-1]} does not fit the int16 "
                         "packing")
    return torch.where(ok, best_j, -1).to(torch.int16)


def match_pair_batch_packed(desc_a, desc_b, uv_a, uv_b, n_a, n_b,
                            generator=None, ratio=0.75, thresh=3.0,
                            transform="homography", n_hyp=512,
                            use_pallas=None, bf16=True, K=None):
    """match_pair_batch packed into one (B, npad) int16 tensor: the best B
    index of each survivor, −1 elsewhere. npad must stay below 32768."""
    return _pack(*match_pair_batch(
        desc_a, desc_b, uv_a, uv_b, n_a, n_b, generator, ratio=ratio,
        thresh=thresh, transform=transform, n_hyp=n_hyp,
        use_pallas=use_pallas, bf16=bf16, K=K))


def _predict_uv_in_a(uv_b, cam_a, cam_b, ground_z, K):
    """Ground-projected position prior, for a batch of pairs: cast rays
    from camera B through its (undistorted) keypoints uv_b (B, n, 2),
    intersect the horizontal plane down = ground_z (B,) (NED, so ground_z
    = −elevation), and project the ground points into camera A. cam_a /
    cam_b (B, 7) are [ned, NED→body quat]; K (3, 3). Invalid rays (upward,
    behind camera A) predict (−1e7, −1e7), which gates them out."""
    R_b, _ = ned_quat_to_rt(cam_b[:, :3], cam_b[:, 3:7])
    R_a, t_a = ned_quat_to_rt(cam_a[:, :3], cam_a[:, 3:7])
    Kinv = torch.linalg.inv(K)
    ones = torch.ones_like(uv_b[..., :1])
    dirs_ned = (torch.cat([uv_b, ones], dim=-1) @ Kinv.T) @ R_b
    c = cam_b[:, :3]
    # ground must sit below camera B (reference matcher.py:421-422)
    gz = torch.maximum(ground_z, c[:, 2] + 2.0)
    dz = dirs_ned[..., 2]
    s = (gz - c[:, 2])[:, None] / torch.where(dz.abs() < 1e-9, 1e-9, dz)
    p = c[:, None, :] + s[..., None] * dirs_ned
    pc = p @ R_a.transpose(-1, -2) + t_a[:, None, :]
    uvh = pc @ K.T
    w = uvh[..., 2]
    pred = uvh[..., :2] / torch.where(w.abs() < 1e-6, 1e-6, w)[..., None]
    valid = (s > 0) & (w > 0.5)
    return torch.where(valid[..., None], pred, -1e7)


def match_pair_batch_gated(desc_a, desc_b, uv_a, uv_b, n_a, n_b, generator,
                           K, cam_a, cam_b, ground_z, ratio=0.75, thresh=3.0,
                           transform="homography", n_hyp=512,
                           use_pallas=None, bf16=True, gate_radius=300.0):
    """Smart-strategy matching: like match_pair_batch, but the 2-NN
    candidates are restricted to gate_radius px around the ground-projected
    prior (cam_a/cam_b (B, 7) ned + quat poses, ground_z (B,) NED-z of the
    surface prior under each pair). Returns the packed int16 result of
    match_pair_batch_packed. The prior masks the candidate set inside the
    2-NN itself, so the ratio test compares only spatially plausible
    candidates: what disambiguates repetitive texture."""
    pred = _predict_uv_in_a(uv_b, cam_a, cam_b, ground_z, K)
    best_j, ok, pb = knn.match_pair_dense(
        desc_a, desc_b, n_a, n_b, ratio=ratio, mutual=True,
        use_pallas=use_pallas, bf16=bf16, gate_uv_a=uv_a, gate_pred_b=pred,
        gate_radius=gate_radius, uv_b=uv_b)
    return _pack(*_filter(best_j, ok, pb, uv_a, generator, thresh, transform,
                          n_hyp, K))


def match_pair_batch_store_scan(store_desc, store_uv, store_counts, idx_a,
                                idx_b, generator=None, ratio=0.75,
                                thresh=3.0, transform="homography",
                                n_hyp=512, K=None, cam_a=None, cam_b=None,
                                ground_z=None, use_pallas=None, bf16=True,
                                uint8_cast=False, gate_radius=0.0,
                                gated=False):
    """The store match step, gathers included, over S sub-batches.

    idx_a/idx_b (S, B) image indices into the resident store arrays;
    uint8_cast casts the gathered rows to bfloat16 (a uint8 store's);
    gated=True takes cam_a/cam_b (S, B, 7) and ground_z (S, B) with K for
    the smart gate. generator: a torch.Generator, or ransac.PairDraws
    without keys, which each sub-batch keys by its pairs (a · n + b for
    n stored images). Returns (S, B, npad) packed int16. Padding slots
    (0, 0) are not computed: their rows stay −1 (the reference computes
    them, for static shapes, and drops them in the host unpack)."""
    S, B = idx_a.shape
    dev = store_desc.device
    out = torch.full((S, B, store_desc.shape[1]), -1, dtype=torch.int16,
                     device=dev)
    real = ((idx_a != 0) | (idx_b != 0)).cpu()
    for s in range(S):
        slots = torch.nonzero(real[s])[:, 0]
        if not len(slots):
            continue
        ia = idx_a[s, slots].to(dev).long()
        ib = idx_b[s, slots].to(dev).long()
        gen = generator
        if isinstance(generator, ransac.PairDraws) and generator.keys is None:
            gen = generator.keyed(ia * store_desc.shape[0] + ib)
        da, db = store_desc.index_select(0, ia), store_desc.index_select(0, ib)
        if uint8_cast:
            da, db = da.bfloat16(), db.bfloat16()
        args = (da, db,
                store_uv.index_select(0, ia), store_uv.index_select(0, ib),
                store_counts.index_select(0, ia),
                store_counts.index_select(0, ib), gen)
        kw = dict(ratio=ratio, thresh=thresh, transform=transform,
                  n_hyp=n_hyp, use_pallas=use_pallas, bf16=bf16)
        if gated:
            sl = slots.to(dev)
            packed = match_pair_batch_gated(
                *args, K, cam_a[s, sl], cam_b[s, sl], ground_z[s, sl],
                gate_radius=gate_radius, **kw)
        else:
            packed = match_pair_batch_packed(*args, K=K, **kw)
        out[s, slots.to(dev)] = packed
    return out


_COMPACT_BITS = 13              # row/col each < 8192 in a compact entry


def _compact_packed(packed, n_real, cap):
    """Compact a (B, npad) packed match tensor (−1 = no match) into ONE
    int32 vector [counts (B,) | entries (cap,)] for a single download.

    Each entry is (row << 13) | col, pair-major in batch order, so the host
    splits by counts' cumsum. Pairs at index ≥ n_real are padding slots
    and are masked here. Entries past cap are dropped; the host sees
    sum(counts) > cap and downloads the full tensor instead."""
    B, npad = packed.shape
    dev = packed.device
    valid = packed >= 0
    valid &= torch.arange(B, device=dev)[:, None] < n_real
    counts = valid.sum(1, dtype=torch.int32)
    flat = valid.reshape(-1)
    pos = torch.cumsum(flat.int(), 0) - 1
    # invalid and overflowing entries land in slot cap, which is cut off
    dest = torch.where(flat & (pos < cap), pos, cap).long()
    rows = torch.arange(npad, dtype=torch.int32, device=dev)[None, :]
    vals = (rows << _COMPACT_BITS) | (packed.int()
                                      & ((1 << _COMPACT_BITS) - 1))
    out = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
    out.scatter_(0, dest, vals.reshape(-1))
    return torch.cat([counts, out[:cap]])


def _round_up(x, m):
    return ((int(x) + m - 1) // m) * m


class BatchMatcher:
    """Host orchestration: pack pair batches, run the device call, unpack.

    Two data paths: per-chunk host assembly (missions under 64 images) or
    a resident DescriptorStore with device-side gathers. The store it
    builds is int8, as the reference's (matcher.py:344); a caller may set
    ``store`` to a uint8 or float32 one (DescriptorStore.from_project's
    dtype). Everything runs on ``device``. RANSAC's samples are keyed by the pair
    (ransac.PairDraws, seeded from config.seed), so a pair's matches do
    not depend on the batch or the rank that matches it (the reference
    draws per batch)."""

    def __init__(self, proj, config: MatchConfig, use_store=None,
                 smart_state=None, device="cuda"):
        self.proj = proj
        self.config = config
        self.device = torch.device(device)
        self.K = proj.camera_model().K.to(self.device)
        w = int(proj.camera.get("width_px", 0)) or 4000
        h = int(proj.camera.get("height_px", 0)) or 3000
        # reference geometric-filter tolerance: w^0.25 px
        self.thresh = (config.filter_thresh if config.filter_thresh
                       else float(w) ** 0.25)
        self.draws = ransac.PairDraws(config.seed)
        if config.use_pallas is None:
            config.use_pallas = self.device.type == "cuda"
        self.smart = smart_state
        self.gated = (config.strategy == "smart" and smart_state is not None
                      and config.gate_radius_frac > 0)
        self.gate_radius = config.gate_radius_frac * float(np.hypot(w, h))
        self._poses = None
        if self.gated:
            poses = []
            for im in proj.image_list:
                ned, _, quat = im.get_camera_pose()
                poses.append(np.r_[np.asarray(ned), np.asarray(quat)])
            self._poses = np.asarray(poses, np.float32)
        self.store = None
        if use_store is None:
            use_store = len(proj.image_list) >= 64
        if use_store and proj.image_list:
            from .store import DescriptorStore
            counts = []
            for im in proj.image_list:
                if im.kp is None:
                    im.load_features()
                counts.append(len(im.kp) if im.kp is not None else 0)
            npad = max(_round_up(max(counts, default=1), 256), 256)
            if DescriptorStore.fits(len(proj.image_list), npad):
                self.store = DescriptorStore.from_project(
                    proj, device=self.device)

    def _tensor(self, x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _pair_gate_arrays(self, chunk, n):
        """(cam_a (n, 7), cam_b (n, 7), ground_z (n,)) numpy for a pair
        chunk: poses from the table, the surface prior per pair from the
        smart state as NED z = −elevation."""
        idx = np.zeros((n, 2), np.int64)
        idx[: len(chunk)] = chunk
        gz = np.zeros(n, np.float32)
        for bi, (i, j) in enumerate(chunk):
            i1, i2 = self.proj.image_list[i], self.proj.image_list[j]
            gz[bi] = -float(self.smart.get_surface(i1.name, i2.name))
        return self._poses[idx[:, 0]], self._poses[idx[:, 1]], gz

    def _prepare(self, image):
        if image.kp is None:
            image.load_features()
        image.load_descriptors()
        if image.uv_list is None:
            self.proj.undistort_image_keypoints(image)

    def _post_filter(self, i1, i2, rows, cols):
        """The host 5-point essential refilter of a pair's device
        survivors (transform "essential5"): K⁻¹-normalised points,
        threshold (thresh / f)², 128 hypotheses, the config's seed."""
        if self.config.transform != "essential5" or len(rows) < 8:
            return rows, cols
        for im in (i1, i2):
            if im.uv_list is None or im.kp is None:
                self._prepare(im)
        K = self.K.cpu().numpy().astype(np.float64)
        Kinv = np.linalg.inv(K)
        uv1 = i1.uv_list[rows]
        uv2 = i2.uv_list[cols]
        q1 = (np.c_[uv1, np.ones(len(uv1))] @ Kinv.T)[:, :2]
        q2 = (np.c_[uv2, np.ones(len(uv2))] @ Kinv.T)[:, :2]
        f = 0.5 * (K[0, 0] + K[1, 1])
        _, inl, _ = essential5.ransac_essential_5pt(
            q1, q2, thresh=(self.thresh / f) ** 2, n_hyp=128,
            seed=self.config.seed)
        return rows[inl], cols[inl]

    def _dispatch(self, desc_a, desc_b, uv_a, uv_b, n_a, n_b, bf16, keys,
                  gate=None):
        """Launch one padded pair batch (keys: each slot's pair key for
        its RANSAC draws); returns the device tensor of packed results
        (int16, or int32 at npad ≥ 32768). gate = (cam_a, cam_b,
        ground_z) numpy arrays → the gated smart path, which needs the
        packed-key kernel (npad ≤ 8192) on the kernel arm."""
        cfg = self.config
        npad = desc_a.shape[1]
        kw = dict(ratio=cfg.ratio, thresh=self.thresh,
                  transform=_device_transform(cfg.transform),
                  n_hyp=cfg.n_hyp, use_pallas=cfg.use_pallas, bf16=bf16)
        args = (desc_a, desc_b, uv_a, uv_b, n_a, n_b,
                self.draws.keyed(self._tensor(keys)))
        if gate is not None and (npad <= 8192 or not cfg.use_pallas):
            cam_a, cam_b, gz = (self._tensor(x) for x in gate)
            return match_pair_batch_gated(
                *args, self.K, cam_a, cam_b, gz,
                gate_radius=float(self.gate_radius), **kw)
        if npad < 32768:
            return match_pair_batch_packed(*args, K=self.K, **kw)
        best_j, ok = match_pair_batch(*args, K=self.K, **kw)
        return torch.where(ok, best_j, -1)

    def match_pairs(self, pairs, progress=True):
        """pairs: list of (i, j) image indices. Fills image.match_list in
        both directions. Gated (smart) matching retries the pairs that
        yielded nothing through the ungated path: a wrong surface or yaw
        prior can gate out the true correspondences."""
        n = self._match_pairs_impl(pairs, gated=self.gated)
        if self.gated:
            il = self.proj.image_list
            failed = [(i, j) for i, j in pairs
                      if len(il[i].match_list.get(il[j].name, ())) == 0]
            if failed:
                qlog(f"gated matching came up empty for {len(failed)} "
                     "pairs; retrying ungated")
                n += self._match_pairs_impl(failed, gated=False)
        return n

    def _match_pairs_impl(self, pairs, gated=False):
        if self.store is not None:
            return self._match_pairs_store(pairs, gated=gated)
        cfg = self.config
        images = self.proj.image_list
        npad = 256
        for im in images:
            if im.kp is None:
                im.load_features()
            if im.kp is not None and len(im.kp):
                npad = max(npad, _round_up(len(im.kp), 256))
        d = next((im.des.shape[1] for im in images
                  if im.des is not None and im.des.shape[0]), 128)
        B = cfg.batch_size
        n_matched = 0
        for start in range(0, len(pairs), B):
            chunk = pairs[start:start + B]
            desc_a = np.full((B, npad, d), knn.PAD_VALUE, np.float32)
            desc_b = np.full((B, npad, d), knn.PAD_VALUE, np.float32)
            uv_a = np.zeros((B, npad, 2), np.float32)
            uv_b = np.zeros((B, npad, 2), np.float32)
            n_a = np.zeros(B, np.int32)
            n_b = np.zeros(B, np.int32)
            for bi, (i, j) in enumerate(chunk):
                i1, i2 = images[i], images[j]
                self._prepare(i1)
                self._prepare(i2)
                na, nb = len(i1.kp), len(i2.kp)
                desc_a[bi, :na] = i1.des
                desc_b[bi, :nb] = i2.des
                uv_a[bi, :na] = i1.uv_list
                uv_b[bi, :nb] = i2.uv_list
                n_a[bi], n_b[bi] = na, nb
            gate = self._pair_gate_arrays(chunk, B) if gated else None
            keys = np.full(B, -1, np.int64)
            keys[: len(chunk)] = [i * len(images) + j for i, j in chunk]
            packed = self._dispatch(
                *(self._tensor(x) for x in (desc_a, desc_b, uv_a, uv_b, n_a,
                                            n_b)), cfg.bf16, keys, gate=gate)
            n_matched += _store_unpack(images, chunk, packed.cpu().numpy(),
                                       cfg.min_pairs, self._post_filter)
        return n_matched

    def _match_pairs_store(self, pairs, gated=False):
        """Store path: image indices go to the device; descriptors never
        leave it. The gate needs the packed-key kernel (npad ≤ 8192) on the
        kernel arm, as in _dispatch."""
        cfg = self.config
        gated_eff = gated and (self.store.npad <= 8192 or not cfg.use_pallas)
        return _store_match(
            self.store, self.proj.image_list, pairs, cfg, self.thresh,
            self.draws, K=self.K,
            gate_arrays=self._pair_gate_arrays if gated_eff else None,
            gate_radius=float(self.gate_radius),
            post_filter=self._post_filter)


def _device_transform(transform):
    """The transform the device runs: "essential5" filters on the host
    after the unpack, so its device call keeps every 2-NN survivor."""
    return "none" if transform == "essential5" else transform


def _store_match(store, images, pairs, config, thresh, generator, K=None,
                 gate_arrays=None, gate_radius=0.0, post_filter=None):
    """The store path's loop: groups of S = config.store_scan sub-batches of
    B = max(batch_size, 256) pairs, padded with (0, 0) pairs. Each group's
    results download while the next group computes (the device runs
    asynchronously; the download of group k waits only for group k).
    gate_arrays(chunk, n) → (cam_a, cam_b, ground_z) turns the gate on;
    post_filter(i1, i2, rows, cols) refilters each pair on the host. The
    2-NN runs in bf16 for an int8 or uint8 store and for a float32 one
    unless config.bf16 is off (the reference's rule, matcher.py:545).
    Fills images[i].match_list; returns the number of matches kept."""
    B = max(config.batch_size, 256)
    S = max(int(config.store_scan), 1)
    group = B * S
    npad = store.npad
    if npad >= 32768:
        raise ValueError(f"store npad {npad} does not fit the int16 packing")
    cap = group * 512 if (config.compact_downloads
                          and npad < (1 << _COMPACT_BITS)) else 0
    dev = store.desc.device
    bf16 = store.dtype in ("uint8", "int8") or config.bf16
    n_matched = 0
    pending = None
    for start in range(0, len(pairs), group):
        chunk = [tuple(p) for p in pairs[start:start + group]]
        idx = np.zeros((group, 2), np.int64)
        idx[: len(chunk)] = chunk
        gate = {}
        if gate_arrays is not None:
            cam_a, cam_b, gz = gate_arrays(chunk, group)
            gate = dict(
                cam_a=torch.from_numpy(cam_a.reshape(S, B, 7)).to(dev),
                cam_b=torch.from_numpy(cam_b.reshape(S, B, 7)).to(dev),
                ground_z=torch.from_numpy(gz.reshape(S, B)).to(dev),
                gate_radius=gate_radius, gated=True)
        packed = match_pair_batch_store_scan(
            store.desc, store.uv, store.counts,
            torch.from_numpy(idx[:, 0].reshape(S, B)),
            torch.from_numpy(idx[:, 1].reshape(S, B)), generator,
            ratio=config.ratio, thresh=thresh,
            transform=_device_transform(config.transform),
            n_hyp=config.n_hyp, K=K, use_pallas=config.use_pallas, bf16=bf16,
            uint8_cast=store.dtype == "uint8", **gate)
        comp = (_compact_packed(packed.reshape(group, npad), len(chunk), cap)
                if cap else None)
        if pending is not None:
            n_matched += _unpack_pending(images, pending, cap,
                                         config.min_pairs, post_filter)
        pending = (chunk, packed, comp)
    if pending is not None:
        n_matched += _unpack_pending(images, pending, cap, config.min_pairs,
                                     post_filter)
    return n_matched


def _unpack_pending(images, pending, cap, min_pairs, post_filter=None):
    chunk, packed, comp = pending
    if comp is not None:
        buf = comp.cpu().numpy()
        counts = buf[: len(buf) - cap][: len(chunk)]
        if int(counts.sum()) <= cap:
            return _store_unpack_compact(images, chunk, counts,
                                         buf[len(buf) - cap:], min_pairs,
                                         post_filter)
    packed = packed.cpu().numpy()
    return _store_unpack(images, chunk, packed.reshape(-1, packed.shape[-1]),
                         min_pairs, post_filter)


def match_pairs_store(store, pairs, config, thresh, K=None):
    """Match every (i, j) of pairs against the resident store, ungated
    (BatchMatcher's store path without a workspace). config.use_pallas
    None decides by the store's device. thresh is the RANSAC tolerance in
    px (the reference uses width^0.25); K (3, 3) the intrinsics, which the
    essential transform needs. "essential5" refilters with the workspace's
    keypoints, which this path has not: it raises. RANSAC draws as
    BatchMatcher does (ransac.PairDraws(config.seed), keyed by the pair).
    Returns {(i, j): (n, 2) int32 [row in i, col in j]} for every pair."""
    if config.transform == "essential5":
        raise ValueError("essential5 refilters on the host with a "
                         "workspace's keypoints: use BatchMatcher")
    if config.use_pallas is None:
        config.use_pallas = store.desc.device.type == "cuda"
    images = [types.SimpleNamespace(name=str(i), match_list={},
                                    matches_clean=True)
              for i in range(store.desc.shape[0])]
    _store_match(store, images, pairs, config, thresh,
                 ransac.PairDraws(config.seed), K=K)
    return {(i, j): images[i].match_list[str(j)] for i, j in pairs}


def _emit_pair(i1, i2, rows, cols, min_pairs, post_filter=None):
    """Record one pair's surviving matches in both directions as (n, 2)
    int32 arrays, after post_filter(i1, i2, rows, cols) when given; pairs
    under min_pairs record none."""
    if post_filter is not None:
        rows, cols = post_filter(i1, i2, rows, cols)
    if len(rows) < min_pairs:
        rows = rows[:0]
        cols = cols[:0]
    fwd = np.stack([np.asarray(rows), np.asarray(cols)],
                   axis=1).astype(np.int32, copy=False)
    i1.match_list[i2.name] = fwd
    i2.match_list[i1.name] = fwd[:, ::-1].copy()
    i1.matches_clean = False
    i2.matches_clean = False
    return len(fwd)


def _store_unpack(images, chunk, packed, min_pairs, post_filter=None):
    """Packed int (−1 = no match) (≥ len(chunk), npad) → match_list for
    each pair of chunk, by one whole-batch nonzero and a searchsorted
    split; rows past len(chunk) are padding."""
    n_matched = 0
    pk = packed[: len(chunk)]
    bi_all, rows_all = np.nonzero(pk >= 0)
    cols_all = pk[bi_all, rows_all].astype(np.int64)
    starts = np.searchsorted(bi_all, np.arange(len(chunk) + 1))
    for bi, (i, j) in enumerate(chunk):
        n_matched += _emit_pair(images[i], images[j],
                                rows_all[starts[bi]:starts[bi + 1]],
                                cols_all[starts[bi]:starts[bi + 1]],
                                min_pairs, post_filter)
    return n_matched


def _store_unpack_compact(images, chunk, counts, entries, min_pairs,
                          post_filter=None):
    """Unpack a device-compacted [counts | entries] result
    (_compact_packed): entries are (row << 13 | col) in pair-major order,
    split by counts."""
    mask = (1 << _COMPACT_BITS) - 1
    starts = np.zeros(len(chunk) + 1, np.int64)
    np.cumsum(counts[: len(chunk)], out=starts[1:])
    rows_all = (entries >> _COMPACT_BITS).astype(np.int64)
    cols_all = (entries & mask).astype(np.int64)
    n_matched = 0
    for bi, (i, j) in enumerate(chunk):
        n_matched += _emit_pair(images[i], images[j],
                                rows_all[starts[bi]:starts[bi + 1]],
                                cols_all[starts[bi]:starts[bi + 1]],
                                min_pairs, post_filter)
    return n_matched


def find_matches(proj, config: MatchConfig | None = None, use_distance=True,
                 sort=False, save_interval=300.0, smart_state=None,
                 device="cuda"):
    """Step 3a's matching stage: build the pair work list, match every pair
    on ``device``, save incrementally.

    Pairs already matched on disk are skipped (crash resume). With
    smart_state (match.smart.SmartState) and strategy "smart", each chunk
    of matched pairs updates the surface and yaw priors that gate the
    later chunks; bad-geometry pairs are discarded afterwards by
    smart.requalify_pairs. Across ranks each rank matches its contiguous
    slice of the pairs (process_shard) and writes a shard, and rank 0
    merges every rank's matches and smart evidence
    (_merge_multihost_matches) while the others wait."""
    config = config or MatchConfig()
    poses = [im.get_camera_pose()[0] for im in proj.image_list]
    work = worklist.build_work_list(np.asarray(poses),
                                    use_distance=use_distance, sort=sort)
    log(f"Work list: {len(work)} pairs over {len(proj.image_list)} images")

    todo = []
    for _, i, j in work:
        i1, i2 = proj.image_list[i], proj.image_list[j]
        if not i1.match_list:
            i1.load_matches()
        if not i2.match_list:
            i2.load_matches()
        if i2.name in i1.match_list and i1.name in i2.match_list \
           and len(i1.match_list[i2.name]) > 0:
            continue
        todo.append((i, j))
    if len(todo) < len(work):
        log(f"Resuming: {len(work) - len(todo)} pairs already matched")

    # across ranks: each matches its own contiguous slice of the pairs
    # (independent of each other) and rank 0 merges the shards
    n_proc = multihost.world()
    if n_proc > 1:
        mine = multihost.process_shard(todo)
        log(f"multi-host: rank {multihost.rank()} matching "
            f"{len(mine)}/{len(todo)} pairs")
        todo = mine

    matcher = BatchMatcher(proj, config, smart_state=smart_state,
                           device=device)
    t0 = time.time()
    last_save = t0
    B = config.batch_size * 8
    if matcher.store is not None:
        # the store's groups are 256 pairs wide or more: feed ≥ 8 of them
        # per outer chunk; smart-prior updates then run every ~2048 pairs
        B = max(B, 2048)
    total = 0
    for s in range(0, len(todo), B):
        chunk = todo[s:s + B]
        tc = time.time()
        total += matcher.match_pairs(chunk)
        qlog(f"chunk {s // B + 1}/{(len(todo) + B - 1) // B}: "
             f"{len(chunk)} pairs in {time.time() - tc:.1f}s")
        if smart_state is not None and config.strategy == "smart":
            # live surface/yaw evidence feeds the gate of LATER chunks
            from . import smart as smart_mod
            smart_mod.update_pairs_batched(
                proj, smart_state,
                [(proj.image_list[i], proj.image_list[j]) for i, j in chunk],
                device=device)
        if time.time() - last_save > save_interval:
            if n_proc > 1:
                _save_rank_shard(proj)
            else:
                _save_all_matches(proj)
            if smart_state is not None and multihost.is_rank0():
                smart_state.save()
            last_save = time.time()
    if n_proc > 1:
        _merge_multihost_matches(proj, smart_state=smart_state)
    else:
        _save_all_matches(proj)
        if smart_state is not None:
            smart_state.save()
    dt = time.time() - t0
    if todo:
        log(f"Matched {len(todo)} pairs in {dt:.1f}s "
            f"({len(todo) / max(dt, 1e-9):.2f} pairs/s), {total} matches")
    return total


def _save_all_matches(proj):
    for im in proj.image_list:
        if not im.matches_clean:
            im.save_matches()


def _shard_dir(proj):
    d = os.path.join(proj.analysis_dir, "match_shards")
    os.makedirs(d, exist_ok=True)
    return d


def _save_rank_shard(proj):
    """This rank's match lists as one pickle (atomically): each rank holds
    only its own pairs, so the per-image .match files cannot be written
    by every rank; rank 0 merges the shards at the end."""
    data = {im.name: im.match_list for im in proj.image_list
            if im.match_list}
    path = os.path.join(_shard_dir(proj), f"rank{multihost.rank()}.pkl")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(data, f)
    os.replace(tmp, path)


def _merge_multihost_matches(proj, smart_state=None):
    """Write this rank's shard, wait for every rank, then rank 0 unions the
    shards into the per-image .match files (the ranks' pairs are
    disjoint, so a key-wise union is exact) and the ranks' smart evidence
    into smart_state (SmartState.merge_shard_data), so that smart.json,
    which the yaw correction reads, holds every rank's pairs. Every rank
    waits until the merged files exist."""
    rank = multihost.rank()
    _save_rank_shard(proj)
    if smart_state is not None:
        smart_state.save_shard(os.path.join(_shard_dir(proj),
                                            f"smart_rank{rank}.json"))
    multihost.barrier("match_shards")
    if rank == 0:
        by_name = {im.name: im for im in proj.image_list}
        for path in sorted(glob.glob(os.path.join(_shard_dir(proj),
                                                  "rank*.pkl"))):
            with open(path, "rb") as f:
                data = pickle.load(f)
            for name, ml in data.items():
                im = by_name.get(name)
                if im is None:
                    continue
                for other, idx_pairs in ml.items():
                    if len(idx_pairs) or other not in im.match_list:
                        im.match_list[other] = idx_pairs
                im.matches_clean = False
        _save_all_matches(proj)
        for path in glob.glob(os.path.join(_shard_dir(proj), "rank*.pkl")):
            os.remove(path)
        if smart_state is not None:
            for path in sorted(glob.glob(os.path.join(
                    _shard_dir(proj), "smart_rank*.json"))):
                if not path.endswith("smart_rank0.json"):
                    # rank 0's evidence is smart_state's own
                    with open(path) as f:
                        smart_state.merge_shard_data(json.load(f))
                os.remove(path)
            smart_state.save()
    multihost.barrier("match_merged")

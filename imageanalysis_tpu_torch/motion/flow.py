"""Optical-flow camera-motion trackers.

Reference motion/motion.py:23-60: the SparseLK tracker (pyramidal LK on
Shi–Tomasi corners with periodic reseeding and a mask) estimating the
frame-to-frame homography, plus its decomposition into rotation/translation.
The flow itself is cv2 host-side (per-frame sequential); the homography
RANSAC is our batched device implementation.

Port of the JAX package's ``motion/flow.py``: the RANSAC runs through the
port's ``ops/ransac.ransac_homography`` on the tracker's device, with draws
from ``PairDraws(seed)`` keyed by the frame counter in place of a split
JAX key, so the CPU and the card draw alike.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import checked
from ..ops.ransac import PairDraws, ransac_homography


class SparseLK:
    """Frame-to-frame homography tracking via LK flow."""

    def __init__(self, max_corners=400, quality=0.01, min_dist=8,
                 reseed_every=10, seed=0, device="cuda"):
        self.max_corners = max_corners
        self.quality = quality
        self.min_dist = min_dist
        self.reseed_every = reseed_every
        self.prev = None
        self.p0 = None
        self.counter = 0
        self.device = checked(device, "SparseLK")
        self.draws = PairDraws(seed)

    def update(self, gray, mask=None):
        """Process the next frame; returns (H 3×3 or None, n_inliers)."""
        import cv2

        H = None
        n_inl = 0
        if self.prev is not None and self.p0 is not None and len(self.p0) >= 8:
            p1, st, _ = cv2.calcOpticalFlowPyrLK(self.prev, gray, self.p0,
                                                 None, winSize=(21, 21),
                                                 maxLevel=3)
            good = st.ravel() == 1
            a = self.p0[good].reshape(-1, 2)
            b = p1[good].reshape(-1, 2)
            if len(a) >= 8:
                npad = self.max_corners
                pa = np.zeros((npad, 2), np.float32)
                pb = np.zeros((npad, 2), np.float32)
                valid = np.zeros(npad, bool)
                n = min(len(a), npad)
                pa[:n], pb[:n], valid[:n] = a[:n], b[:n], True
                dev = self.device
                res = ransac_homography(
                    torch.as_tensor(pa, device=dev)[None],
                    torch.as_tensor(pb, device=dev)[None],
                    torch.as_tensor(valid, device=dev)[None], thresh=2.0,
                    n_hyp=128, generator=self.draws.keyed(
                        torch.tensor([self.counter])))
                if bool(res.ok[0]):
                    H = res.model[0].cpu().numpy().astype(np.float64)
                    n_inl = int(res.n_inliers[0])
            self.p0 = p1[good].reshape(-1, 1, 2)
        if (self.prev is None or self.counter % self.reseed_every == 0
                or self.p0 is None or len(self.p0) < self.max_corners // 4):
            self.p0 = cv2.goodFeaturesToTrack(gray, self.max_corners,
                                              self.quality, self.min_dist,
                                              mask=mask)
        self.prev = gray
        self.counter += 1
        return H, n_inl


def decompose_homography(H, K):
    """H → (R, t_dir, normal) candidates via cv2.decomposeHomographyMat
    equivalent selection: return the rotation part of the most fronto-
    parallel solution (reference motion.py uses cv2's decomposition)."""
    import cv2

    n, Rs, ts, normals = cv2.decomposeHomographyMat(H, np.asarray(K))
    best = 0
    best_score = -2.0
    for i in range(n):
        score = float(normals[i].ravel()[2])  # prefer plane facing camera
        if score > best_score:
            best_score, best = score, i
    return Rs[best], ts[best].ravel(), normals[best].ravel()

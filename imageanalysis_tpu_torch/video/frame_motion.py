"""Per-frame camera motion estimation — gyro rates from video.

Reference video/1a-est-gyro-rates.py:125-160 + video/5a variant using
motion.py optical-flow classes: track features between consecutive frames,
fit a 2-D similarity (affine), decompose to (rotation, tx, ty), and convert
to camera-frame rotation rates via the camera intrinsics. Output CSV matches
the reference's columns so correlate.sync_clocks can consume either:
``frame, time, rotation (deg), translation x (px), translation y (px)``.

Feature tracking here is pyramidal LK on Shi–Tomasi corners (the reference's
SparseLK tracker, motion/motion.py:23-60) via cv2 on the host; the
similarity fits for all frame pairs run as ONE batched device call at the
end (core.transforms.fit_similarity_2d takes leading batch dimensions),
replacing the per-frame cv2.estimateAffinePartial2D calls.

Port of the JAX package's ``video/frame_motion.py``: the tracking and the
CSV are copies; the fits run on ``device``.
"""

from __future__ import annotations

import csv
import os

import numpy as np
import torch

from ..core.device import checked
from ..core.transforms import decompose_affine_2d, fit_similarity_2d
from ..io.logger import log

MAX_TRACKS = 400


def track_video(video_path, max_frames=None, scale=1.0, reseed_every=10):
    """Yield (frame_idx, time_s, pts_prev (N,2), pts_cur (N,2)) tracks."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise FileNotFoundError(video_path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    prev = None
    p0 = None
    idx = 0
    while True:
        ret, frame = cap.read()
        if not ret or (max_frames and idx >= max_frames):
            break
        gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY) if frame.ndim == 3 else frame
        if scale != 1.0:
            gray = cv2.resize(gray, (0, 0), fx=scale, fy=scale)
        if prev is not None and p0 is not None and len(p0) >= 8:
            p1, st, _ = cv2.calcOpticalFlowPyrLK(prev, gray, p0, None,
                                                 winSize=(21, 21), maxLevel=3)
            good = st.ravel() == 1
            if good.sum() >= 8:
                yield idx, idx / fps, p0[good].reshape(-1, 2), \
                    p1[good].reshape(-1, 2)
            p0 = p1[good].reshape(-1, 1, 2)
        if prev is None or idx % reseed_every == 0 or p0 is None or len(p0) < 50:
            p0 = cv2.goodFeaturesToTrack(gray, MAX_TRACKS, 0.01, 8)
        prev = gray
        idx += 1
    cap.release()


def estimate_motion(video_path, max_frames=None, scale=1.0, device="cuda"):
    """All frame-to-frame similarity fits, batched on device.

    Returns records [(frame, time, rot_deg, tx_px, ty_px), ...] at full
    video resolution (tx/ty scaled back by 1/scale).
    """
    dev = checked(device, "estimate_motion")
    pairs = list(track_video(video_path, max_frames=max_frames, scale=scale))
    if not pairs:
        return []
    pa, pb, w = pad_tracks(pairs)
    rot, tx, ty = fit_pairs(pa, pb, w, dev)
    rot = np.degrees(rot)
    tx = tx / scale
    ty = ty / scale
    return [(f, t, float(rot[i]), float(tx[i]), float(ty[i]))
            for i, (f, t, _, _) in enumerate(pairs)]


def pad_tracks(pairs, npad=MAX_TRACKS):
    """track_video's pairs as (B, npad, 2) float32 point sets and (B, npad)
    weights, 1 on the first min(n, npad) tracks of each pair."""
    B = len(pairs)
    pa = np.zeros((B, npad, 2), np.float32)
    pb = np.zeros((B, npad, 2), np.float32)
    w = np.zeros((B, npad), np.float32)
    for i, (_, _, p0, p1) in enumerate(pairs):
        n = min(len(p0), npad)
        pa[i, :n] = p0[:n]
        pb[i, :n] = p1[:n]
        w[i, :n] = 1.0
    return pa, pb, w


def fit_pairs(pa, pb, w, device):
    """One batched fit_similarity_2d + decompose_affine_2d over every pair
    on device: (rotation rad, tx, ty) as float32 numpy, one a pair."""
    pa, pb, w = (torch.as_tensor(x, device=device) for x in (pa, pb, w))
    rot, tx, ty, _, _ = decompose_affine_2d(fit_similarity_2d(pa, pb, w))
    out = torch.stack([rot, tx, ty]).cpu().numpy()
    return out[0], out[1], out[2]


def write_motion_csv(records, out_path):
    """The reference's <video>.csv contract (1a-est-gyro-rates.py:523-527)."""
    with open(out_path, "w", newline="") as f:
        wcsv = csv.DictWriter(f, fieldnames=["frame", "time", "rotation (deg)",
                                             "translation x (px)",
                                             "translation y (px)"])
        wcsv.writeheader()
        for frame, time, rot, tx, ty in records:
            wcsv.writerow({"frame": frame, "time": "%.4f" % time,
                           "rotation (deg)": "%.2f" % rot,
                           "translation x (px)": "%.1f" % tx,
                           "translation y (px)": "%.1f" % ty})
    log("wrote motion csv:", out_path, f"({len(records)} rows)")


def rates_from_motion(records, K, fps):
    """Convert per-frame (rot, tx, ty) to camera rotation rates (rad/s):
    r (roll about optical axis) from the image rotation, p/q from the
    small-angle translation through the focal length (reference 1a:140-160)."""
    fx, fy = K[0, 0], K[1, 1]
    out = []
    for frame, time, rot, tx, ty in records:
        dt = 1.0 / fps
        rr = np.radians(rot) / dt
        qq = np.arctan2(ty, fy) / dt
        pp = np.arctan2(tx, fx) / dt
        out.append((time, pp, qq, rr))
    return np.asarray(out)

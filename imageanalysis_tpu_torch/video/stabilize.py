"""Video stabilization — the reference's 1c-motion-smoothing experiments.

Reference video/1c-motion-smoothing.py (752 LoC of variants): estimate the
frame-to-frame motion, low-pass the camera trajectory, and warp each frame
by the difference between its raw and smoothed pose, writing a stabilized
video (the reference's 1a script also writes a smoothed/stabilized output).

Pipeline: LK similarity track (video/frame_motion.py) → cumulative
trajectory (x, y, rotation) → Gaussian smoothing → per-frame correction
warp via cv2.warpAffine.

Port of the JAX package's ``video/stabilize.py``: a copy whose motion fits
run on ``device``, and whose writer raises when cv2 cannot open it (the
reference writes nothing and says nothing).
"""

from __future__ import annotations

import numpy as np

from ..io.logger import log
from .hud import open_writer


def smooth_trajectory(traj, sigma_frames=15.0):
    """Gaussian low-pass each column of (T, 3) [dx, dy, rot] cumulative
    trajectory, reflect-padded."""
    r = int(3 * sigma_frames)
    k = np.exp(-0.5 * (np.arange(-r, r + 1) / sigma_frames) ** 2)
    k /= k.sum()
    out = np.empty_like(traj)
    for c in range(traj.shape[1]):
        padded = np.pad(traj[:, c], r, mode="reflect")
        out[:, c] = np.convolve(padded, k, mode="valid")
    return out


def stabilize_video(video_path, out_path, sigma_frames=15.0, zoom=1.05,
                    max_frames=None, device="cuda"):
    """Write a stabilized copy of the video. Returns frames written."""
    import cv2

    from .frame_motion import estimate_motion

    records = estimate_motion(video_path, max_frames=max_frames,
                              device=device)
    if not records:
        raise ValueError("no trackable motion")
    # cumulative raw trajectory (per-frame motion integrated)
    idx_of = {f: i for i, (f, *_rest) in enumerate(records)}
    steps = np.array([[tx, ty, np.radians(rot)]
                      for _, _, rot, tx, ty in records])
    traj = np.cumsum(steps, axis=0)
    smooth = smooth_trajectory(traj, sigma_frames)
    corrections = smooth - traj   # what to ADD to each frame's motion

    cap = cv2.VideoCapture(video_path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    W = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    H = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    try:
        writer = open_writer(out_path, fps, (W, H))
    except OSError:
        cap.release()
        raise
    n = 0
    frame_idx = 0
    corr = np.zeros(3)
    while True:
        ret, frame = cap.read()
        if not ret or (max_frames and frame_idx >= max_frames):
            break
        if frame_idx in idx_of:
            corr = corrections[idx_of[frame_idx]]
        dx, dy, dth = corr
        c, s = np.cos(dth), np.sin(dth)
        # rotate about the image center, translate, slight zoom to hide edges
        M = cv2.getRotationMatrix2D((W / 2, H / 2), -np.degrees(dth), zoom)
        M[0, 2] += dx
        M[1, 2] += dy
        writer.write(cv2.warpAffine(frame, M, (W, H)))
        n += 1
        frame_idx += 1
    cap.release()
    writer.release()
    log(f"stabilized {n} frames → {out_path}")
    return n

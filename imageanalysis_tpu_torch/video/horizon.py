"""Horizon detection → camera roll/pitch estimate.

Reference video/horizon.py:17-120 + 5a-horizon-tracker.py: Canny on the
blue channel (sky is blue/white-dominant), optional Otsu sky mask from the
largest top-connected component, Hough line transform, dominant line →
roll = line angle, pitch from the line's offset from the image center
through the focal length.

Port of the JAX package's ``video/horizon.py``: a copy.
"""

from __future__ import annotations

import math

import numpy as np


def detect_horizon(frame_bgr, K, do_otsu=True):
    """Returns (roll_rad, pitch_rad, line) or None if no horizon found.

    line = (x1, y1, x2, y2) dominant Hough segment.
    """
    import cv2

    b = frame_bgr[..., 0] if frame_bgr.ndim == 3 else frame_bgr
    edges = cv2.Canny(b, 50 if do_otsu else 25, 150 if do_otsu else 75)

    if do_otsu:
        _, otsu = cv2.threshold(b, 0, 255, cv2.THRESH_BINARY + cv2.THRESH_OTSU)
        n, labels, stats, _ = cv2.connectedComponentsWithStats(otsu)
        best, best_metric = None, 0
        for i in range(1, n):
            area = stats[i, cv2.CC_STAT_AREA]
            top = stats[i, cv2.CC_STAT_TOP]
            metric = area / (top + 1.0)   # big and near the top = sky
            if metric > best_metric:
                best_metric, best = metric, i
        if best is not None:
            sky = (labels == best).astype(np.uint8)
            sky = cv2.dilate(sky, np.ones((5, 5), np.uint8))
            edges = edges * sky

    lines = cv2.HoughLinesP(edges, 1, np.pi / 180, threshold=60,
                            minLineLength=b.shape[1] // 4, maxLineGap=20)
    if lines is None or len(lines) == 0:
        return None
    # dominant = longest
    segs = lines.reshape(-1, 4)
    lens = [math.hypot(s[2] - s[0], s[3] - s[1]) for s in segs]
    x1, y1, x2, y2 = (int(v) for v in segs[int(np.argmax(lens))])

    roll = math.atan2(float(y1 - y2), float(x2 - x1))  # image y down
    cx, cy = K[0, 2], K[1, 2]
    fy = K[1, 1]
    # vertical offset of the line at the image center column
    if x2 != x1:
        yc = y1 + (y2 - y1) * (cx - x1) / (x2 - x1)
    else:
        yc = (y1 + y2) / 2.0
    pitch = math.atan2(cy - yc, fy)  # horizon above center ⇒ pitch down
    return roll, pitch, (int(x1), int(y1), int(x2), int(y2))

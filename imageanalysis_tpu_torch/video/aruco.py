"""ArUco marker tracking → twist rate / deflection CSV.

Reference video/1c-aruco-tracker.py:1-288: detect ArUco markers per frame,
estimate each marker's pose against the calibrated camera, log per-frame
marker rotation (twist) and position for control-surface deflection /
vibration analysis.

Port of the JAX package's ``video/aruco.py``: a copy, but a movie that cv2
cannot open raises FileNotFoundError.
"""

from __future__ import annotations

import csv

import numpy as np

from ..io.logger import log


def track_video(video_path, K, dist, marker_len_m=0.05,
                dictionary="DICT_4X4_50", max_frames=None):
    """Returns records [(frame, time, marker_id, rvec(3), tvec(3)), ...]."""
    import cv2

    aruco = cv2.aruco
    dic = aruco.getPredefinedDictionary(getattr(aruco, dictionary))
    try:
        detector = aruco.ArucoDetector(dic, aruco.DetectorParameters())
        detect = lambda g: detector.detectMarkers(g)
    except AttributeError:  # older cv2 API
        params = aruco.DetectorParameters_create()
        detect = lambda g: aruco.detectMarkers(g, dic, parameters=params)

    # marker corner object points (square, centered)
    h = marker_len_m / 2.0
    objp = np.array([[-h, h, 0], [h, h, 0], [h, -h, 0], [-h, -h, 0]],
                    np.float32)
    K = np.asarray(K, np.float64)
    dist = np.asarray(dist, np.float64)

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise FileNotFoundError(video_path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    records = []
    idx = 0
    while True:
        ret, frame = cap.read()
        if not ret or (max_frames and idx >= max_frames):
            break
        gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY) if frame.ndim == 3 else frame
        corners, ids, _ = detect(gray)
        if ids is not None:
            for c, mid in zip(corners, ids.ravel()):
                ok, rvec, tvec = cv2.solvePnP(objp, c.reshape(4, 2), K, dist)
                if ok:
                    records.append((idx, idx / fps, int(mid),
                                    rvec.ravel().copy(), tvec.ravel().copy()))
        idx += 1
    cap.release()
    log(f"aruco: {len(records)} detections over {idx} frames")
    return records


def write_csv(records, out_path):
    """Per-frame twist/deflection log (reference 1c-aruco-tracker.py CSV)."""
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["frame", "time", "marker_id",
                    "rx (rad)", "ry (rad)", "rz (rad)",
                    "tx (m)", "ty (m)", "tz (m)"])
        for frame, t, mid, rvec, tvec in records:
            w.writerow([frame, "%.4f" % t, mid] +
                       ["%.5f" % v for v in rvec] +
                       ["%.5f" % v for v in tvec])
    return out_path

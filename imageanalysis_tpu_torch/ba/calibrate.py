"""Global camera-calibration optimization (``--cam-calibration``).

Port of ``imageanalysis_tpu/ba/calibrate.py``: a thin wrapper over
``ba/bundle.py::solve_global_calib``. The 8 shared [f, cx, cy, k1, k2,
p1, p2, k3] join the camera-reduced Schur system as a dense border block,
solved jointly with poses and points, with a soft GPS position prior.

On near-planar aerial scenes the focal length trades against the flight
altitude almost exactly, so f is observable only as far as the GPS
altitudes pin it: the distortion recovers sharply, f partially, and the
reprojection error reaches the noise floor either way.
"""

from __future__ import annotations

import numpy as np

from ..io.logger import log
from . import bundle


def pack_calib(K, dist):
    """[f, cx, cy, k1, k2, p1, p2, k3] float32 of K (3, 3) and dist (5,),
    f the mean of fx and fy."""
    K = np.asarray(K)
    d = np.asarray(dist)
    return np.array([0.5 * (K[0, 0] + K[1, 1]), K[0, 2], K[1, 2],
                     d[0], d[1], d[2], d[3], d[4]], np.float32)


def solve_with_calibration(cams0, pts0, obs, K0, dist0,
                           config=bundle.BAConfig(), gps_sigma_m=2.0,
                           verbose=True, log_fn=log, device="cuda"):
    """Returns (BAResult, K (3, 3), dist (5,))."""
    return bundle.solve_global_calib(cams0, pts0, obs, K0, dist0,
                                     config=config, gps_sigma_m=gps_sigma_m,
                                     verbose=verbose, log_fn=log_fn,
                                     device=device)

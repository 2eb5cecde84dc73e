"""Camera-mount misalignment estimation from gyro correlation.

Reference video/5b-cam-mount-from-gyro(.1).py / 5b-cam-mount-from-horiz.py
(~900 LoC of iterative search): after time-synchronizing the video-derived
rotation rates against the flight-log gyro (correlate.sync_clocks), the
fixed camera-mount rotation is the R minimizing Σ‖R·ω_body − ω_cam‖².

That is Wahba's problem — solved in closed form by SVD of the
cross-covariance (orthogonal Procrustes) instead of the reference's
parameter sweep. Returns the mount ypr in degrees.

Port of the JAX package's ``video/mount.py``: a copy over the port's
``core/rotations.py``.
"""

from __future__ import annotations

import numpy as np

from ..core.rotations import matrix_to_quat, ypr_from_quat

R2D = 180.0 / np.pi


def estimate_mount(body_rates, cam_rates, weights=None):
    """body_rates/cam_rates: (N, 3) paired angular velocities (rad/s) after
    time sync. Returns (ypr_deg (3,), R (3,3), rms residual rad/s)."""
    A = np.asarray(body_rates, float)
    B = np.asarray(cam_rates, float)
    if weights is None:
        weights = np.ones(len(A))
    w = np.asarray(weights, float)[:, None]
    H = (B * w).T @ A                       # cross-covariance
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(U @ Vt))
    R = U @ np.diag([1.0, 1.0, d]) @ Vt     # B ≈ R A
    resid = B - A @ R.T
    rms = float(np.sqrt((resid**2).sum(1).mean()))
    q = matrix_to_quat(R)
    y, p, r = (float(v) * R2D for v in ypr_from_quat(np.asarray(q)))
    return np.array([y, p, r]), R, rms


def estimate_mount_from_logs(flight_times, flight_pqr, movie_times,
                             movie_pqr, time_shift):
    """Resample the synchronized logs onto a common grid and solve.

    flight_pqr/movie_pqr: (N, 3); movie_time + time_shift ≈ flight_time.
    """
    t0 = max(flight_times[0], movie_times[0] + time_shift)
    t1 = min(flight_times[-1], movie_times[-1] + time_shift)
    grid = np.linspace(t0, t1, max(int((t1 - t0) * 30), 10))
    fb = np.column_stack([np.interp(grid, flight_times, flight_pqr[:, i])
                          for i in range(3)])
    mc = np.column_stack([np.interp(grid - time_shift, movie_times,
                                    movie_pqr[:, i]) for i in range(3)])
    # weight by total rotation magnitude: quiescent samples carry no signal
    w = np.linalg.norm(fb, axis=1)
    return estimate_mount(fb, mc, weights=w)

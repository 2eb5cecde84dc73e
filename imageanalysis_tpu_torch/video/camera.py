"""VirtualCamera: intrinsics + mount for the video pipeline.

Reference video/camera.py:19-70: loads K/dist/mount from a camera config
json, scales K to the video resolution, and derives the projection
(rvec/tvec) for a given aircraft attitude — used by the HUD renderer and
the frame geotagger.

Port of the JAX package's ``video/camera.py``: a copy over the port's
``core/rotations.py``, whose quaternions are float32 tensors here as they
are float32 jnp arrays there.
"""

from __future__ import annotations

import json

import numpy as np

from ..core.camera import BODY2CAM
from ..core.rotations import quat_from_ypr, quat_multiply, quat_to_matrix

D2R = np.pi / 180.0


class VirtualCamera:
    def __init__(self, config: dict | None = None):
        self.K = np.eye(3)
        self.dist = np.zeros(5)
        self.mount_ypr = [0.0, 0.0, 0.0]
        self.width = 0
        self.height = 0
        if config:
            self.load_dict(config)

    def load_dict(self, d: dict):
        self.K = np.array(d.get("K", np.eye(3).ravel()), float).reshape(3, 3)
        self.dist = np.array(d.get("dist_coeffs", [0.0] * 5), float)
        m = d.get("mount", {})
        self.mount_ypr = [m.get("yaw_deg", 0.0), m.get("pitch_deg", 0.0),
                          m.get("roll_deg", 0.0)]
        self.width = int(d.get("width_px", 0))
        self.height = int(d.get("height_px", 0))
        return self

    @classmethod
    def load(cls, path: str):
        with open(path) as f:
            return cls(json.load(f))

    def scale_to(self, width, height):
        """Rescale K for a different (video) resolution (reference
        video/camera.py set_render_size)."""
        if self.width and self.height:
            sx = width / self.width
            sy = height / self.height
            K = self.K.copy()
            K[0] *= sx
            K[1] *= sy
            self.K = K
        self.width, self.height = int(width), int(height)
        return self

    def body2cam_quat(self):
        y, p, r = self.mount_ypr
        return np.asarray(quat_from_ypr(y * D2R, p * D2R, r * D2R))

    def proj_matrix(self, ned, aircraft_quat):
        """3×4 PROJ = K [R | t] for an aircraft at ``ned`` with NED→body
        attitude quat and this camera's mount (reference video/camera.py
        :19-70 PROJ derivation)."""
        q_cam = quat_multiply(np.asarray(aircraft_quat), self.body2cam_quat())
        B = np.asarray(quat_to_matrix(np.asarray(q_cam)))
        R = np.asarray(BODY2CAM) @ B.T
        t = -R @ np.asarray(ned, float)
        return self.K @ np.column_stack([R, t])

    def project_ned(self, points_ned, ned, aircraft_quat):
        """NED points → pixel uv (homogeneous divide; z<=0 → nan)."""
        P = self.proj_matrix(ned, aircraft_quat)
        pts = np.atleast_2d(np.asarray(points_ned, float))
        ph = np.c_[pts, np.ones(len(pts))] @ P.T
        z = ph[:, 2]
        uv = np.full((len(pts), 2), np.nan)
        ok = z > 1e-6
        uv[ok] = ph[ok, :2] / z[ok, None]
        return uv

"""Project workspace: the reference-compatible on-disk contract.

Port of ``ImageRecord`` and ``ProjectMgr`` of
``imageanalysis_tpu/io/project.py``, file for file and byte for byte, so a
workspace that one package writes loads in the other:

    <project_dir>/
      ImageAnalysis/
        config.json                     serialized /config tree
        messages-<host>                 run log
        meta/<image>.json               per-image pose metadata
        meta/<image>.match              pickle {other_name: (n, 2) int32}
        cache/<image>.feat              gzip pickle ("IAFEATv2", kp, meta)
                                        or the reference's keypoint tuples
        cache/<image>.desc              .npy (uint8) or gzip .npy
        state/STEPn                     stage gate markers
        smart.json                      /smart priors tree

Host-side Python and numpy; attitude math runs in float32 through
``core.rotations``, as the reference's does. ``detect_camera`` reads the
first image's EXIF through ``io/exif``.
"""

from __future__ import annotations

import fnmatch
import gzip
import os
import pickle

import numpy as np

from . import camera_db, logger, state
from .props import PropertyNode
from ..core.rotations import (quat_from_ypr, quat_multiply, quat_to_matrix,
                              ypr_from_quat)

D2R = np.pi / 180.0
R2D = 180.0 / np.pi


def _quat_ypr_deg(yaw_deg, pitch_deg, roll_deg):
    return quat_from_ypr(yaw_deg * D2R, pitch_deg * D2R,
                         roll_deg * D2R).numpy()


class ImageRecord:
    """Per-image state: poses, features, matches."""

    def __init__(self, analysis_dir: str, base: str):
        self.name = base
        self.analysis_dir = analysis_dir
        self.meta_file = os.path.join(analysis_dir, "meta", base + ".json")
        self.match_file = os.path.join(analysis_dir, "meta", base + ".match")
        self.features_file = os.path.join(analysis_dir, "cache",
                                          base + ".feat")
        self.desc_file = os.path.join(analysis_dir, "cache", base + ".desc")
        self.node = PropertyNode()
        self.kp = None          # (n, 2) float32 keypoint uv
        self.kp_meta = None     # (n, 4) size, angle, response, octave
        self.des = None         # (n, d) descriptors
        self.uv_list = None     # undistorted kp uv
        self.match_list = {}
        self.matches_clean = True
        if os.path.isfile(self.meta_file):
            self.node = PropertyNode.load_json(self.meta_file)

    # -- poses ------------------------------------------------------------
    def set_aircraft_pose(self, lat_deg, lon_deg, alt_m, yaw_deg, pitch_deg,
                          roll_deg, flight_time=-1.0):
        n = self.node.node("aircraft_pose")
        n.set("lat_deg", float(lat_deg))
        n.set("lon_deg", float(lon_deg))
        n.set("alt_m", float(alt_m))
        n.set("yaw_deg", float(yaw_deg))
        n.set("pitch_deg", float(pitch_deg))
        n.set("roll_deg", float(roll_deg))
        n.setlist("quat", _quat_ypr_deg(yaw_deg, pitch_deg, roll_deg))
        if flight_time > 0.0:
            self.node.set("flight_time", float(flight_time))

    def set_camera_pose(self, ned, yaw_deg, pitch_deg, roll_deg, opt=False,
                        quat=None):
        """Store a camera pose. Pass ``quat`` whenever you have one: the
        quat rebuilt from ypr is singular at pitch ±90°."""
        if quat is None:
            quat = _quat_ypr_deg(yaw_deg, pitch_deg, roll_deg)
        n = self.node.node("camera_pose_opt" if opt else "camera_pose")
        if opt:
            n.set("valid", True)
        n.setlist("ned", ned)
        n.set("yaw_deg", float(yaw_deg))
        n.set("pitch_deg", float(pitch_deg))
        n.set("roll_deg", float(roll_deg))
        n.setlist("quat", quat)

    def set_aircraft_yaw_error_estimate(self, yaw_error_deg, body2cam_quat):
        """Fold a smart yaw-error estimate into the aircraft AND camera pose
        quats."""
        n = self.node.node("aircraft_pose")
        n.set("yaw_error_deg", float(yaw_error_deg))
        yaw = n.get("yaw_deg", 0.0) + yaw_error_deg
        ned2body = quat_from_ypr(yaw * D2R, n.get("pitch_deg", 0.0) * D2R,
                                 n.get("roll_deg", 0.0) * D2R)
        n.setlist("quat", ned2body.numpy())
        ned2cam = quat_multiply(ned2body, body2cam_quat)
        y, p, r = (float(v) * R2D for v in ypr_from_quat(ned2cam))
        ned, _, _ = self.get_camera_pose()
        self.set_camera_pose(ned, y, p, r, quat=ned2cam.numpy())

    def get_aircraft_pose(self):
        n = self.node.node("aircraft_pose")
        lla = [n.get("lat_deg", 0.0), n.get("lon_deg", 0.0),
               n.get("alt_m", 0.0)]
        ypr = [n.get("yaw_deg", 0.0), n.get("pitch_deg", 0.0),
               n.get("roll_deg", 0.0)]
        return lla, ypr, n.getlist("quat")

    def get_camera_pose(self, opt=False):
        n = self.node.node("camera_pose_opt" if opt else "camera_pose")
        ned = n.getlist("ned") or [0.0, 0.0, 0.0]
        ypr = [n.get("yaw_deg", 0.0), n.get("pitch_deg", 0.0),
               n.get("roll_deg", 0.0)]
        quat = n.getlist("quat") or [1.0, 0.0, 0.0, 0.0]
        return ned, ypr, quat

    def has_opt_pose(self):
        n = self.node.node("camera_pose_opt", create=False)
        return bool(n and n.get("valid"))

    def get_body2ned(self, opt=False):
        _, _, quat = self.get_camera_pose(opt)
        return quat_to_matrix(np.asarray(quat, np.float64)).numpy()

    def get_size(self):
        return int(self.node.get("width", 0)), int(self.node.get("height", 0))

    def set_size(self, width, height):
        self.node.set("width", int(width))
        self.node.set("height", int(height))

    # -- persistence ------------------------------------------------------
    def save_meta(self):
        self.node.save_json(self.meta_file)

    def save_features(self):
        """.feat cache: a gzip pickle of ("IAFEATv2", kp (n, 2) f32, meta
        (n, 4) f32), or, with IMAGEANALYSIS_TPU_LEGACY_FEAT=1, the
        reference's list of (pt, size, angle, response, octave, class_id)
        tuples. load_features reads both."""
        if os.environ.get("IMAGEANALYSIS_TPU_LEGACY_FEAT"):
            pts = self.kp.astype(float).tolist()
            meta = self.kp_meta.astype(float).tolist()
            payload = [((p[0], p[1]), m[0], m[1], m[2], int(m[3]), -1)
                       for p, m in zip(pts, meta)]
        else:
            payload = ("IAFEATv2",
                       np.ascontiguousarray(self.kp, np.float32),
                       np.ascontiguousarray(self.kp_meta, np.float32))
        with gzip.open(self.features_file, "wb", compresslevel=1) as f:
            pickle.dump(payload, f)

    def load_features(self) -> bool:
        if not os.path.exists(self.features_file):
            return False
        with gzip.open(self.features_file, "rb") as f:
            feature_list = pickle.load(f)
        if isinstance(feature_list, tuple) and len(feature_list) == 3 \
                and feature_list[0] == "IAFEATv2":
            self.kp = np.asarray(feature_list[1], np.float32).reshape(-1, 2)
            self.kp_meta = np.asarray(feature_list[2],
                                      np.float32).reshape(-1, 4)
            return True
        n = len(feature_list)
        self.kp = np.array([p[0] for p in feature_list],
                           np.float32).reshape(n, 2)
        self.kp_meta = np.array([p[1:5] for p in feature_list],
                                np.float32).reshape(n, 4)
        return True

    def save_descriptors(self):
        """Integer-valued 0..255 descriptors (OpenCV's and both detectors')
        are stored as raw uint8 .npy; anything else as gzip .npy. load
        converts back to f32."""
        des = self.des
        if des is not None and des.dtype != np.uint8 and des.size:
            if des.min() >= 0 and des.max() <= 255 \
                    and np.array_equal(des, np.round(des)):
                des = des.astype(np.uint8)
        if des is not None and des.dtype == np.uint8:
            with open(self.desc_file, "wb") as f:
                np.save(f, des)
        else:
            with gzip.open(self.desc_file, "wb", compresslevel=6) as f:
                np.save(f, des)

    def load_descriptors(self) -> bool:
        if self.des is not None:
            return True
        if not os.path.exists(self.desc_file):
            return False
        with open(self.desc_file, "rb") as f:
            magic = f.read(2)
        if magic == b"\x1f\x8b":              # gzip envelope
            with gzip.open(self.desc_file, "rb") as f:
                self.des = np.load(f)
        else:                                  # raw .npy
            self.des = np.load(self.desc_file)
        if self.des is not None and self.des.dtype == np.uint8:
            self.des = self.des.astype(np.float32)
        return True

    def unload_descriptors(self):
        self.des = None

    def save_matches(self):
        with open(self.match_file, "wb") as f:
            pickle.dump(self.match_list, f)
        self.matches_clean = True

    def load_matches(self) -> bool:
        if not os.path.exists(self.match_file):
            return False
        with open(self.match_file, "rb") as f:
            self.match_list = pickle.load(f)
        self.matches_clean = True
        return True


class ProjectMgr:
    """Workspace lifecycle."""

    def __init__(self, project_dir: str, create: bool = False):
        self.project_dir = project_dir
        self.analysis_dir = os.path.join(project_dir, "ImageAnalysis")
        self.meta_dir = os.path.join(self.analysis_dir, "meta")
        self.cache_dir = os.path.join(self.analysis_dir, "cache")
        self.state_dir = os.path.join(self.analysis_dir, "state")
        self.models_dir = os.path.join(self.analysis_dir, "models")
        self.image_list: list[ImageRecord] = []
        if create:
            for d in (self.analysis_dir, self.meta_dir, self.cache_dir,
                      self.state_dir):
                os.makedirs(d, exist_ok=True)
        elif not os.path.isdir(self.analysis_dir):
            raise FileNotFoundError(
                f"analysis dir doesn't exist: {self.analysis_dir}")
        logger.init(self.analysis_dir)
        self.state = state.StateMgr(self.state_dir)
        self.config = PropertyNode()
        self.config_file = os.path.join(self.analysis_dir, "config.json")
        if os.path.isfile(self.config_file):
            self.config = PropertyNode.load_json(self.config_file)
        self.config.node("directories").set("project_dir", project_dir)

    # -- config -----------------------------------------------------------
    def save(self):
        self.config.save_json(self.config_file)

    @property
    def camera(self) -> PropertyNode:
        return self.config.node("camera")

    def detect_camera(self) -> str:
        """Camera DB key from the first image's EXIF ("" without images)."""
        from . import exif
        files = self.image_files()
        if not files:
            return ""
        key, _, _, _ = exif.get_camera_info(
            os.path.join(self.project_dir, files[0]))
        return key

    def set_camera_config(self, cfg: dict):
        self.camera.update(cfg)

    def camera_model(self, optimized=False):
        return camera_db.to_model(self.camera.as_dict(), optimized=optimized)

    def get_mount_params(self):
        m = self.camera.node("mount")
        return [m.get("yaw_deg", 0.0), m.get("pitch_deg", 0.0),
                m.get("roll_deg", 0.0)]

    def get_body2cam(self):
        return _quat_ypr_deg(*self.get_mount_params())

    # -- images -----------------------------------------------------------
    def image_files(self):
        return sorted(f for f in os.listdir(self.project_dir)
                      if any(fnmatch.fnmatch(f, p) for p in
                             ("*.jpg", "*.JPG", "*.jpeg", "*.png")))

    def load_images_info(self):
        """Populate image_list from meta/*.json."""
        self.image_list = []
        if not os.path.isdir(self.meta_dir):
            return
        for f in sorted(os.listdir(self.meta_dir)):
            if f.endswith(".json"):
                self.image_list.append(ImageRecord(self.analysis_dir, f[:-5]))

    def image_by_name(self, name: str) -> ImageRecord | None:
        for im in self.image_list:
            if im.name == name:
                return im
        return None

    def image_path(self, image: ImageRecord) -> str:
        for ext in (".jpg", ".JPG", ".jpeg", ".png"):
            p = os.path.join(self.project_dir, image.name + ext)
            if os.path.isfile(p):
                return p
        return os.path.join(self.project_dir, image.name + ".jpg")

    # -- reference frame --------------------------------------------------
    def compute_ned_reference_lla(self):
        """Average image lat/lon, alt 0."""
        lats, lons = [], []
        for im in self.image_list:
            n = im.node.node("aircraft_pose", create=False)
            if n and n.has("lat_deg"):
                lats.append(n.get("lat_deg"))
                lons.append(n.get("lon_deg"))
        ned_node = self.config.node("ned_reference")
        ned_node.set("lat_deg", float(np.mean(lats)))
        ned_node.set("lon_deg", float(np.mean(lons)))
        ned_node.set("alt_m", 0.0)

    def ned_reference_lla(self):
        n = self.config.node("ned_reference")
        return [n.get("lat_deg", 0.0), n.get("lon_deg", 0.0),
                n.get("alt_m", 0.0)]

    # -- matches (unified structure) --------------------------------------
    def save_matches_grouped(self, matches, name="matches_grouped"):
        with open(os.path.join(self.analysis_dir, name), "wb") as f:
            pickle.dump(matches, f, protocol=pickle.HIGHEST_PROTOCOL)

    def load_matches_grouped(self, name="matches_grouped"):
        with open(os.path.join(self.analysis_dir, name), "rb") as f:
            return pickle.load(f)

    # -- undistortion helpers --------------------------------------------
    def undistort_image_keypoints(self, image: ImageRecord, optimized=False):
        """image.uv_list ← undistorted kp coords (host numpy)."""
        if image.kp is None or len(image.kp) == 0:
            image.uv_list = np.zeros((0, 2), np.float32)
            return
        from ..core.camera import undistort_pixels_np

        model = self.camera_model(optimized)
        image.uv_list = undistort_pixels_np(image.kp, model.K.numpy(),
                                            model.dist.numpy())

    def undistort_all_keypoints(self, images=None, optimized=False):
        """uv_list for many images in one vectorised host pass. images=[]
        means nothing to do; only None means the whole project."""
        pool = self.image_list if images is None else images
        images = [im for im in pool if im.uv_list is None]
        for im in images:
            if im.kp is None:
                im.load_features()
        # images whose features failed to load keep uv_list None
        images = [im for im in images if im.kp is not None]
        if not images:
            return
        from ..core.camera import undistort_pixels_np

        counts = [len(im.kp) for im in images]
        model = self.camera_model(optimized)
        kp_all = np.concatenate(
            [im.kp if counts[i] else np.zeros((0, 2), np.float32)
             for i, im in enumerate(images)]).astype(np.float32)
        uv_all = undistort_pixels_np(kp_all, model.K.numpy(),
                                     model.dist.numpy())
        pos = 0
        for i, im in enumerate(images):
            im.uv_list = uv_all[pos:pos + counts[i]]
            pos += counts[i]

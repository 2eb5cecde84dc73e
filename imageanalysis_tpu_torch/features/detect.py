"""Feature detection front-end: the project's images → cached features.

Port of ``imageanalysis_tpu/features/detect.py``, both backends (the names
kept, so that config.json's detector node reads alike in both packages):

- ``tpu`` — decode and scale each frame (``load_scaled_gray``, on
  ``io/jpeg``), then CLAHE and SIFT over batches of frames on the device
  (``features/sift.py``);
- ``cv`` — the reference's default, OpenCV's SIFT or ORB on the host
  (``--detector SIFT|ORB``): frames decoded and scaled by the reference's
  host load (PIL's draft, cv2.resize) with cv2's CLAHE, on loader threads
  ahead of the detection, as the reference runs them. ORB's 256-bit
  descriptors are unpacked to 256 values of 0/1 (squared L2 on bits is the
  Hamming distance), which the 2-NN kernels take at 256 values a row.
  cv2 is imported inside this arm only; without it the arm raises
  ImportError and names ``--detector TPU``.

Either way keypoints are rescaled to full resolution and cached as
cache/<name>.feat and .desc; matching runs on the card. Across ranks
(parallel/multihost.py) each rank detects its slice of the images. Left
out: the TPU link's workarounds (the transport codec, the automatic
batch policy, the stall watchdog).
"""

from __future__ import annotations

import concurrent.futures as cf
from collections import deque

import numpy as np
import torch

from . import sift
from ..io import jpeg
from ..io.logger import log, qlog
from ..io.props import PropertyNode
from ..parallel import multihost


class DetectorConfig:
    def __init__(self, detector="SIFT", scale=0.4, max_features=0,
                 equalize=True, backend="cv", device_batch=0):
        self.detector = detector
        self.scale = scale
        self.max_features = int(max_features)
        self.equalize = equalize
        self.backend = backend
        # frames per device detect dispatch; 0 = the caller's batch size
        self.device_batch = int(device_batch)

    def to_dict(self):
        return dict(detector=self.detector, scale=self.scale,
                    max_features=self.max_features, equalize=self.equalize,
                    backend=self.backend, device_batch=self.device_batch)

    @classmethod
    def from_dict(cls, d):
        return cls(**{k: d[k] for k in
                      ("detector", "scale", "max_features", "equalize",
                       "backend", "device_batch")
                      if k in d})


def _cv2(detector):
    """cv2, for the host detectors; ImportError naming the device detector
    where it is missing."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"--detector {detector} runs OpenCV on the host and cv2 is not "
            "installed; use --detector TPU (SIFT on the device)") from e
    return cv2


def _load_scaled_gray_host(path, scale):
    """The reference's load_scaled_gray without CLAHE (detect.py:69-119):
    PIL draft at scale ≤ 0.5, else cv2.imread; cv2.resize to scale."""
    import cv2

    scaled = None
    full_size = None
    if scale <= 0.5:
        try:
            from PIL import Image as PILImage

            with PILImage.open(path) as im:
                full_size = (im.width, im.height)
                ratio = 2 if scale > 0.25 else (4 if scale > 0.125 else 8)
                im.draft("L", (im.width // ratio, im.height // ratio))
                gray = np.asarray(im.convert("L"))
            fx = scale * full_size[0] / gray.shape[1]
            fy = scale * full_size[1] / gray.shape[0]
            scaled = cv2.resize(gray, (0, 0), fx=fx, fy=fy) \
                if abs(fx - 1.0) > 1e-9 or abs(fy - 1.0) > 1e-9 else gray
        except (OSError, ValueError):
            scaled = None                 # not an image PIL reads: cv2 path
    if scaled is None:
        img = jpeg.decode_gray(path, "cpu").numpy()
        full_size = (img.shape[1], img.shape[0])
        scaled = cv2.resize(img, (0, 0), fx=scale, fy=scale) \
            if scale != 1.0 else img
    return torch.from_numpy(np.ascontiguousarray(scaled)), full_size


def _draft_ratio(w, h, ratio):
    """The reduction PIL's draft picks for a requested size of (w // ratio,
    h // ratio): the largest of 8, 4, 2, 1 not above the integer ratio of
    the sizes."""
    scale = min(w // max(w // ratio, 1), h // max(h // ratio, 1))
    return next(s for s in (8, 4, 2, 1) if scale >= s)


def load_scaled_gray(path, scale, device="cuda"):
    """Decode a frame to gray and scale it for detection → ((h, w) uint8
    tensor on device, (full_w, full_h)).

    CUDA: nvJPEG's luma at full size; at scale ≤ 0.5 a box mean by the
    ratio PIL's draft would decode at (2, 4 or 8), the counterpart of its
    DCT-domain reduction (libjpeg's reduced IDCT outputs the means of
    adjacent outputs of the full one); then resize_linear by fx = scale ·
    full_w / w to cv2's size round(w · fx). CPU: the reference's PIL and
    cv2 calls, byte for byte. CLAHE is left to the detect dispatch."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return _load_scaled_gray_host(path, scale)
    gray = jpeg.decode_gray(path, dev)
    full_h, full_w = gray.shape
    if scale <= 0.5:
        ratio = 2 if scale > 0.25 else (4 if scale > 0.125 else 8)
        gray = jpeg.box_reduce(gray, _draft_ratio(full_w, full_h, ratio))
    h, w = gray.shape
    fx = scale * full_w / w
    fy = scale * full_h / h
    if abs(fx - 1.0) > 1e-9 or abs(fy - 1.0) > 1e-9:
        gray = jpeg.resize_linear(gray, (int(np.rint(w * fx)),
                                         int(np.rint(h * fy))), (fx, fy))
    return gray, (full_w, full_h)


def detect(gray, config: DetectorConfig):
    """Detect on a scaled copy of a full-resolution (H, W) uint8 numpy
    frame (cv2.resize to config.scale); keypoints rescaled to full
    resolution. Returns detect_scaled's arrays."""
    scale = config.scale
    if scale != 1.0:
        gray = _cv2(config.detector).resize(gray, (0, 0), fx=scale, fy=scale)
    kp, kp_meta, des = detect_scaled(gray, config)
    return kp / scale, kp_meta, des


def detect_scaled(scaled, config: DetectorConfig):
    """OpenCV's SIFT (config.max_features, 0 = all) or ORB (max_features
    or 10000) on an already-scaled (H, W) uint8 numpy frame, on the host;
    keypoints in scaled pixels. Returns numpy (kp (n, 2), kp_meta (n, 4)
    [size, angle, response, octave], des (n, d) f32): d 128 for SIFT, 256
    for ORB (its bits as 0/1). The device detector (backend "tpu") runs
    batched: sift.detect_dispatch, as detect_project_features calls it."""
    if config.backend == "tpu":
        raise ValueError("detect_scaled runs the host detectors; the device "
                         "detector runs batched (sift.detect_dispatch)")
    cv2 = _cv2(config.detector)
    if config.detector == "SIFT":
        det = (cv2.SIFT_create(nfeatures=config.max_features)
               if config.max_features else cv2.SIFT_create())
    elif config.detector == "ORB":
        det = cv2.ORB_create(config.max_features or 10000)
    else:
        raise ValueError(f"unknown detector {config.detector}")
    kps, des = det.detectAndCompute(scaled, None)
    kp = np.array([k.pt for k in kps], np.float32).reshape(-1, 2)
    kp_meta = np.array([(k.size, k.angle, k.response, k.octave)
                        for k in kps], np.float32).reshape(-1, 4)
    if des is not None and config.detector == "ORB":
        # squared L2 on 0/1 values is the Hamming distance of the bits
        des = np.unpackbits(des, axis=1).astype(np.float32)
    if des is None:
        des = np.zeros((0, 128), np.float32)
        kp = np.zeros((0, 2), np.float32)
        kp_meta = np.zeros((0, 4), np.float32)
    return kp, kp_meta, np.ascontiguousarray(des, dtype=np.float32)


def _store(image, kp, kp_meta, des):
    image.kp, image.kp_meta, image.des = kp, kp_meta, des
    image.save_features()
    image.save_descriptors()
    image.save_meta()


def _detect_host(proj, config, todo, check_size, prefetch=4):
    """The cv backend over todo: loader threads decode, scale and
    equalize prefetch · 2 frames ahead; the calling thread detects; two
    writer threads cache the results."""
    _cv2(config.detector)

    def load(image):
        scaled, full_size = _load_scaled_gray_host(proj.image_path(image),
                                                   config.scale)
        scaled = scaled.numpy()
        if config.equalize:     # cv2's CLAHE, as the reference applies it
            scaled = _cv2(config.detector).createCLAHE(
                clipLimit=3.0, tileGridSize=(8, 8)).apply(scaled)
        return image, scaled, full_size

    with cf.ThreadPoolExecutor(max_workers=prefetch) as loaders, \
            cf.ThreadPoolExecutor(max_workers=2) as writers:
        window = deque(loaders.submit(load, im) for im in todo[:2 * prefetch])
        rest = iter(todo[2 * prefetch:])
        pending = []
        while window:
            image, scaled, (w, h) = window.popleft().result()
            nxt = next(rest, None)
            if nxt is not None:
                window.append(loaders.submit(load, nxt))
            qlog("Detecting features/descriptors for:", image.name)
            check_size(image, w, h)
            kp, kp_meta, des = detect_scaled(scaled, config)
            pending.append(writers.submit(_store, image, kp / config.scale,
                                          kp_meta, des))
        for p in pending:
            p.result()


def detect_project_features(proj, config: DetectorConfig, use_cache=True,
                            batch_size=16, device="cuda"):
    """Detect (or load cached) features for every image in the project.

    backend "tpu": frames go to the device in batches of
    config.device_batch (or batch_size when that is 0), each one CLAHE +
    SIFT dispatch (config.equalize: CLAHE on the device). backend "cv":
    OpenCV on the host (_detect_host). Keypoints are divided by
    config.scale and cached with the descriptors and the image's full
    size, which must match the camera config's.

    Across ranks each rank detects its contiguous slice of the image list
    (the cache files are per image, on the shared filesystem), then waits
    for the others, so that later stages can load any image's features.
    The slice comes from the full image list, never from the images left
    to detect, which ranks scanning the cache at different moments could
    see differently."""
    mine = proj.image_list
    if multihost.world() > 1:
        mine = multihost.process_shard(proj.image_list)
        log(f"multi-host: rank {multihost.rank()} detecting "
            f"{len(mine)}/{len(proj.image_list)} images")
    todo = [im for im in mine
            if not (use_cache and im.load_features()
                    and im.load_descriptors())]
    if todo:
        _detect_todo(proj, config, todo, batch_size, device)
    if multihost.world() > 1:
        multihost.barrier("detect")
        # the other ranks wrote their images' sizes into meta/: read them,
        # so that a later save_meta of such an image here keeps its size
        # (the reference's rank 0 drops them; ROADMAP.md queue 3)
        own = {im.name for im in mine}
        for im in proj.image_list:
            if im.name not in own:
                im.node = PropertyNode.load_json(im.meta_file)


def _detect_todo(proj, config, todo, batch_size, device):
    """detect_project_features's detection of the images in todo."""
    cam_w = int(proj.camera.get("width_px", 0))
    cam_h = int(proj.camera.get("height_px", 0))

    def check_size(image, w, h):
        image.set_size(w, h)
        if cam_w and (w != cam_w or h != cam_h):
            raise RuntimeError(
                f"image dimensions {w}x{h} do not match camera config "
                f"{cam_w}x{cam_h} — fix the camera config vs image size "
                f"issue (reference image.py:300-306)")

    if config.backend != "tpu":
        _detect_host(proj, config, todo, check_size)
        return
    dbatch = config.device_batch or batch_size
    for s in range(0, len(todo), dbatch):
        batch = todo[s:s + dbatch]
        grays = []
        for image in batch:
            gray, (w, h) = load_scaled_gray(proj.image_path(image),
                                            config.scale, device)
            qlog("Detecting features/descriptors for:", image.name)
            check_size(image, w, h)
            grays.append(gray)
        outs = sift.detect_dispatch(grays, config.max_features or 4096,
                                    equalize=config.equalize)
        for image, (kp, kp_meta, des) in zip(
                batch, sift.detect_finalize_batch(outs)):
            _store(image, kp / config.scale, kp_meta, des)

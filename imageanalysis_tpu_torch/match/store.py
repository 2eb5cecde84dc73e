"""Resident device descriptor store for mission-scale matching.

Port of ``imageanalysis_tpu/match/store.py``. A whole mission lives on the
device as ONE array (n_images, npad, d) of descriptors, beside the
keypoint uv (n_images, npad, 2) f32 and the per-image counts (n_images,)
int32. Pair batches are device-side gathers. Three modes, as the
reference's:

- ``int8`` (the default): SIFT's integral 0..255 values, rounded and
  clipped, as value − 128 (L2 distances are shift-invariant), so the 2-NN
  kernel runs on exact int8 products; pad rows hold 127;
- ``uint8``: the values rounded and clipped, gathered as bfloat16 (exact
  for 0..255), so the matcher runs the bf16 kernel; pad rows hold 255;
- ``float32``: the values as they are, unrounded; the matcher runs the bf16
  kernel unless its config turns bf16 off (then f32); pad rows hold
  10000.0, whose rows the counts drop (their squared norm, 1.28e10, is far
  beyond f32's exact integers).

Three constructors: ``from_project`` reads a project workspace (the
reference's constructor), ``from_numpy`` carries over the three arrays of
an existing store (for instance the JAX package's), and ``from_arrays``
builds one from per-image descriptor and uv arrays. ``fits`` counts
elements, not bytes, as the reference's: a budget of 6e9 values whatever
the mode.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.logger import log

DTYPES = {"int8": (torch.int8, np.int8, 127),
          "uint8": (torch.uint8, np.uint8, 255),
          "float32": (torch.float32, np.float32, 10000.0)}
_MODE = {v[0]: k for k, v in DTYPES.items()}


def _round_up(x, m):
    return ((int(x) + m - 1) // m) * m


def convert(dsc, dtype):
    """0..255 descriptors as a store of dtype holds them: int8 rounds,
    clips and shifts by −128; uint8 rounds and clips; float32 keeps the
    values as they are."""
    if dtype == "float32":
        return np.asarray(dsc, np.float32)
    u = np.clip(np.round(np.asarray(dsc, np.float32)), 0, 255)
    if dtype == "int8":
        return (u.astype(np.int16) - 128).astype(np.int8)
    return u.astype(np.uint8)


def _mode(dtype):
    if dtype not in DTYPES:
        raise ValueError(f"store dtype must be one of {sorted(DTYPES)}, "
                         f"got {dtype!r}")
    return DTYPES[dtype]


class DescriptorStore:
    def __init__(self, desc, uv, counts, names=None):
        """desc (n_images, npad, d) int8, uint8 or float32, uv (n_images,
        npad, 2) f32, counts (n_images,) int32 tensors, all on one device;
        names the image names, in order."""
        if desc.dtype not in _MODE or desc.dim() != 3:
            raise ValueError(f"store descriptors must be (n, npad, d) int8, "
                             f"uint8 or float32, got {tuple(desc.shape)} "
                             f"{desc.dtype}")
        self.dtype = _MODE[desc.dtype]
        self.desc = desc.contiguous()
        self.uv = uv.to(device=desc.device, dtype=torch.float32).contiguous()
        self.counts = counts.to(device=desc.device, dtype=torch.int32)
        self.npad = desc.shape[1]
        self.names = list(names) if names is not None else []
        self.index = {n: i for i, n in enumerate(self.names)}

    @classmethod
    def from_project(cls, proj, images=None, npad=None, device="cuda",
                     dtype="int8"):
        """The store of a project workspace: every image's undistorted
        keypoints and descriptors in the dtype's mode, staged on the device
        256 images at a time (peak host memory one chunk). npad rounds the
        largest count up to a multiple of 256 (at least 256). Host
        descriptor copies are unloaded as they are staged."""
        t_dtype, np_dtype, pad = _mode(dtype)
        images = images if images is not None else proj.image_list
        counts = []
        for im in images:
            if im.kp is None:
                im.load_features()
            counts.append(len(im.kp) if im.kp is not None else 0)
        if npad is None:
            npad = _round_up(max(max(counts, default=1), 256), 256)
        d = 128
        for im in images:
            im.load_descriptors()
            if im.des is not None and im.des.shape[0]:
                d = im.des.shape[1]
                break
        proj.undistort_all_keypoints(images)
        n_img = len(images)
        desc = torch.full((n_img, npad, d), pad, dtype=t_dtype,
                          device=device)
        uv = np.zeros((n_img, npad, 2), np.float32)
        n = np.zeros(n_img, np.int32)
        chunk = 256
        for s in range(0, n_img, chunk):
            e = min(s + chunk, n_img)
            desc_c = np.full((e - s, npad, d), pad, np_dtype)
            for i in range(s, e):
                im = images[i]
                im.load_descriptors()
                if im.uv_list is None:
                    proj.undistort_image_keypoints(im)
                k = min(counts[i], npad)
                if k:
                    desc_c[i - s, :k] = convert(im.des[:k], dtype)
                    uv[i, :k] = im.uv_list[:k]
                n[i] = k
                im.unload_descriptors()
            desc[s:e] = torch.from_numpy(desc_c).to(device)
        store = cls(desc, torch.from_numpy(uv).to(device),
                    torch.from_numpy(n).to(device),
                    names=[im.name for im in images])
        store._log(n_img, d)
        return store

    def _log(self, n_img, d):
        gb = self.desc.numel() * self.desc.element_size() / 1e9
        log(f"descriptor store: {n_img} images × {self.npad} × {d} "
            f"{self.dtype} ({gb:.3f} GB on {self.desc.device})")

    @staticmethod
    def fits(n_images, npad, d=128, budget_bytes=6_000_000_000):
        """Whether a store fits the budget, counted in elements whatever
        the mode, as the reference counts it."""
        return n_images * npad * d <= budget_bytes

    @classmethod
    def from_numpy(cls, desc, uv, counts, device="cuda", dtype="int8"):
        """A store from the arrays of an existing one: desc (n, npad, d) in
        the dtype's mode (int8 value − 128 with pad 127, uint8 with pad
        255, float32 with pad 10000.0), uv (n, npad, 2), counts (n,)."""
        _, np_dtype, _ = _mode(dtype)
        return cls(torch.as_tensor(np.asarray(desc, np_dtype), device=device),
                   torch.as_tensor(np.asarray(uv, np.float32), device=device),
                   torch.as_tensor(np.asarray(counts, np.int32),
                                   device=device))

    @classmethod
    def from_arrays(cls, des, uv, device="cuda", npad=None, dtype="int8"):
        """A store from per-image arrays: des[i] (n_i, d) 0..255 descriptors
        (uint8 or float), converted as the dtype's mode does, uv[i] (n_i,
        2). npad rounds the largest count up to a multiple of 256 (at least
        256)."""
        _, np_dtype, pad = _mode(dtype)
        counts = [len(d) for d in des]
        if npad is None:
            npad = _round_up(max(max(counts, default=1), 256), 256)
        d = next((x.shape[1] for x in des if len(x)), 128)
        n_img = len(des)
        desc = np.full((n_img, npad, d), pad, np_dtype)
        uvs = np.zeros((n_img, npad, 2), np.float32)
        n = np.zeros(n_img, np.int32)
        for i, (dsc, u) in enumerate(zip(des, uv)):
            k = min(counts[i], npad)
            if k:
                desc[i, :k] = convert(dsc[:k], dtype)
                uvs[i, :k] = u[:k]
            n[i] = k
        store = cls.from_numpy(desc, uvs, n, device=device, dtype=dtype)
        store._log(n_img, d)
        return store

    def gather(self, idx):
        """idx (B,) image indices → (desc (B, npad, d), uv (B, npad, 2),
        counts (B,)), all on the store's device. int8 and float32 rows pass
        through unchanged; uint8 rows are cast to bfloat16 (exact), which
        the matcher's bf16 kernel takes."""
        idx = torch.as_tensor(idx, device=self.desc.device).long()
        d = self.desc.index_select(0, idx)
        if self.dtype == "uint8":
            d = d.bfloat16()
        return (d, self.uv.index_select(0, idx),
                self.counts.index_select(0, idx))

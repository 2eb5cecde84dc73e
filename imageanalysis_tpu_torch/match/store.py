"""Resident device descriptor store for mission-scale matching.

Port of ``imageanalysis_tpu/match/store.py``. SIFT descriptors are
integral 0..255, so a whole mission lives on the device as ONE int8 array
(n_images, npad, 128) of value − 128 (L2 distances are shift-invariant,
and the 2-NN kernel then runs on exact int8 products), beside the
keypoint uv (n_images, npad, 2) f32 and the per-image counts (n_images,)
int32. Pad rows hold 127. Pair batches are device-side gathers.

Three constructors: ``from_project`` reads a project workspace (the
reference's constructor, int8 dtype), ``from_numpy`` carries over the
three arrays of an existing store (for instance the JAX package's), and
``from_arrays`` builds one from per-image descriptor and uv arrays. The
reference's uint8 and float32 store variants (comparison modes) are not
ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.logger import log


def _round_up(x, m):
    return ((int(x) + m - 1) // m) * m


def _to_int8(dsc):
    """0..255 descriptors (uint8 or float, rounded and clipped) → int8
    value − 128."""
    return (np.clip(np.round(np.asarray(dsc, np.float32)), 0, 255)
            .astype(np.int16) - 128).astype(np.int8)


class DescriptorStore:
    PAD = 127
    dtype = "int8"

    def __init__(self, desc, uv, counts, names=None):
        """desc (n_images, npad, d) int8, uv (n_images, npad, 2) f32,
        counts (n_images,) int32 tensors, all on one device; names the
        image names, in order."""
        if desc.dtype != torch.int8 or desc.dim() != 3:
            raise ValueError(f"store descriptors must be (n, npad, d) int8, "
                             f"got {tuple(desc.shape)} {desc.dtype}")
        self.desc = desc.contiguous()
        self.uv = uv.to(device=desc.device, dtype=torch.float32).contiguous()
        self.counts = counts.to(device=desc.device, dtype=torch.int32)
        self.npad = desc.shape[1]
        self.names = list(names) if names is not None else []
        self.index = {n: i for i, n in enumerate(self.names)}

    @classmethod
    def from_project(cls, proj, images=None, npad=None, device="cpu"):
        """The store of a project workspace: every image's undistorted
        keypoints and int8 descriptors, staged on the device 256 images at
        a time (peak host memory one chunk). npad rounds the largest count
        up to a multiple of 256 (at least 256). Host descriptor copies are
        unloaded as they are staged."""
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
        desc = torch.full((n_img, npad, d), cls.PAD, dtype=torch.int8,
                          device=device)
        uv = np.zeros((n_img, npad, 2), np.float32)
        n = np.zeros(n_img, np.int32)
        chunk = 256
        for s in range(0, n_img, chunk):
            e = min(s + chunk, n_img)
            desc_c = np.full((e - s, npad, d), cls.PAD, np.int8)
            for i in range(s, e):
                im = images[i]
                im.load_descriptors()
                if im.uv_list is None:
                    proj.undistort_image_keypoints(im)
                k = min(counts[i], npad)
                if k:
                    desc_c[i - s, :k] = _to_int8(im.des[:k])
                    uv[i, :k] = im.uv_list[:k]
                n[i] = k
                im.unload_descriptors()
            desc[s:e] = torch.from_numpy(desc_c).to(device)
        store = cls(desc, torch.from_numpy(uv).to(device),
                    torch.from_numpy(n).to(device),
                    names=[im.name for im in images])
        log(f"descriptor store: {n_img} images × {npad} × {d} int8 "
            f"({desc.numel() / 1e9:.2f} GB on {store.desc.device})")
        return store

    @staticmethod
    def fits(n_images, npad, d=128, budget_bytes=6_000_000_000):
        return n_images * npad * d <= budget_bytes

    @classmethod
    def from_numpy(cls, desc, uv, counts, device="cpu"):
        """A store from the arrays of an existing one: desc (n, npad, d)
        int8 (value − 128, pad 127), uv (n, npad, 2), counts (n,)."""
        return cls(torch.as_tensor(np.asarray(desc, np.int8), device=device),
                   torch.as_tensor(np.asarray(uv, np.float32), device=device),
                   torch.as_tensor(np.asarray(counts, np.int32),
                                   device=device))

    @classmethod
    def from_arrays(cls, des, uv, device="cpu", npad=None):
        """A store from per-image arrays: des[i] (n_i, d) 0..255 descriptors
        (uint8 or float, rounded and clipped), uv[i] (n_i, 2). npad rounds
        the largest count up to a multiple of 256 (at least 256)."""
        counts = [len(d) for d in des]
        if npad is None:
            npad = _round_up(max(max(counts, default=1), 256), 256)
        d = next((x.shape[1] for x in des if len(x)), 128)
        n_img = len(des)
        desc = np.full((n_img, npad, d), cls.PAD, np.int8)
        uvs = np.zeros((n_img, npad, 2), np.float32)
        n = np.zeros(n_img, np.int32)
        for i, (dsc, u) in enumerate(zip(des, uv)):
            k = min(counts[i], npad)
            if k:
                desc[i, :k] = _to_int8(dsc[:k])
                uvs[i, :k] = u[:k]
            n[i] = k
        store = cls.from_numpy(desc, uvs, n, device=device)
        log(f"descriptor store: {n_img} images × {npad} × {d} int8 "
            f"({desc.nbytes / 1e9:.3f} GB on {store.desc.device})")
        return store

    def gather(self, idx):
        """idx (B,) image indices → (desc (B, npad, d) int8, uv (B, npad,
        2), counts (B,)), all on the store's device."""
        idx = torch.as_tensor(idx, device=self.desc.device).long()
        return (self.desc.index_select(0, idx), self.uv.index_select(0, idx),
                self.counts.index_select(0, idx))

"""Resident device descriptor store for mission-scale matching.

Port of ``imageanalysis_tpu/match/store.py``. SIFT descriptors are
integral 0..255, so a whole mission lives on the device as ONE int8 array
(n_images, npad, 128) of value − 128 (L2 distances are shift-invariant,
and the 2-NN kernel then runs on exact int8 products), beside the
keypoint uv (n_images, npad, 2) f32 and the per-image counts (n_images,)
int32. Pad rows hold 127. Pair batches are device-side gathers.

Two constructors: ``from_numpy`` carries over the three arrays of an
existing store (for instance the JAX package's), and ``from_arrays``
builds one from per-image descriptor and uv arrays. The constructor from
a project workspace comes with the port of ``io/``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.logger import log


def _round_up(x, m):
    return ((int(x) + m - 1) // m) * m


class DescriptorStore:
    PAD = 127

    def __init__(self, desc, uv, counts):
        """desc (n_images, npad, d) int8, uv (n_images, npad, 2) f32,
        counts (n_images,) int32 tensors, all on one device."""
        if desc.dtype != torch.int8 or desc.dim() != 3:
            raise ValueError(f"store descriptors must be (n, npad, d) int8, "
                             f"got {tuple(desc.shape)} {desc.dtype}")
        self.desc = desc.contiguous()
        self.uv = uv.to(device=desc.device, dtype=torch.float32).contiguous()
        self.counts = counts.to(device=desc.device, dtype=torch.int32)
        self.npad = desc.shape[1]

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
                desc[i, :k] = (np.clip(np.round(np.asarray(dsc[:k], np.float32)),
                                       0, 255).astype(np.int16) - 128)
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

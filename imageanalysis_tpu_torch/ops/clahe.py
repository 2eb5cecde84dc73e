"""CLAHE (contrast-limited adaptive histogram equalization) on the device.

Port of ``imageanalysis_tpu/ops/clahe.py`` (cv2.createCLAHE(3.0, (8, 8))
semantics, reference image.py:99-135):

- integer tile histograms (one ``bincount`` over tile-offset values);
- cv2's clip-and-redistribute rule: limit = max(1, clip·area/256), the
  excess spread uniformly, the residual by cv2's stride rule;
- per-tile LUT = round(cdf · 255/area);
- bilinear blend of the four neighbouring tile LUTs per pixel, on cv2's
  tile-centre geometry (pixel y sits at grid coordinate (y+0.5)/th − 0.5).

The reference blends with one-hot matmuls because per-pixel table lookups
serialize on the TPU; here the four LUT entries of a pixel are gathered.
The blend weights and the order of its products follow the reference's
two einsums (rows first, then columns), in f32.
"""

from __future__ import annotations

import numpy as np
import torch


def _resize_weights(n_px, n_tiles, tile):
    """Per pixel: (lo, hi) tile indices and their f32 weights, as the
    reference's _resize_mat: pixel p sits at grid coordinate
    (p+0.5)/tile − 0.5, clamped to [0, n_tiles − 1]."""
    g = (np.arange(n_px) + 0.5) / tile - 0.5
    g = np.clip(g, 0.0, n_tiles - 1.0)
    if n_tiles > 1:
        lo = np.minimum(np.floor(g).astype(np.int64), n_tiles - 2)
        w = g - lo
        return lo, lo + 1, (1.0 - w).astype(np.float32), w.astype(np.float32)
    zero = np.zeros(n_px, np.int64)
    return zero, zero, np.ones(n_px, np.float32), np.zeros(n_px, np.float32)


def clahe(img, clip_limit=3.0, grid=(8, 8)):
    """CLAHE on (H, W) or (B, H, W) uint8 tensors → same shape uint8."""
    if img.dtype != torch.uint8:
        raise ValueError(f"clahe needs uint8 input, got {img.dtype}")
    squeeze = img.dim() == 2
    if squeeze:
        img = img[None]
    B, H, W = img.shape
    dev = img.device
    gh, gw = grid
    th, tw = -(-H // gh), -(-W // gw)          # cv2 ceil tile size
    v = img.long()
    # edge padding up to whole tiles
    rows = torch.arange(th * gh, device=dev).clamp(max=H - 1)
    cols = torch.arange(tw * gw, device=dev).clamp(max=W - 1)
    padded = v[:, rows][:, :, cols]
    area = th * tw
    tiles = padded.reshape(B, gh, th, gw, tw).permute(0, 1, 3, 2, 4) \
        .reshape(B * gh * gw, area)
    base = torch.arange(B * gh * gw, device=dev)[:, None] * 256
    hist = torch.bincount((tiles + base).reshape(-1),
                          minlength=B * gh * gw * 256).reshape(B, gh * gw, 256)

    limit = max(int(clip_limit * area / 256.0), 1)
    clipped = hist.clamp(max=limit)
    excess = (hist - clipped).sum(-1, keepdim=True)
    batch = excess // 256
    residual = excess - batch * 256
    clipped = clipped + batch
    # cv2 residual rule: +1 at bins 0, s, 2s, … for the first `residual`
    # strides, s = max(256 // residual, 1)
    k = torch.arange(256, device=dev)
    step = (256 // residual.clamp(min=1)).clamp(min=1)
    bump = ((k % step) == 0) & (k // step < residual)
    clipped = clipped + bump.long()

    scale = 255.0 / float(area)
    lut = torch.round(torch.cumsum(clipped, -1).float() * scale) \
        .clamp(0, 255).reshape(-1)               # (B·gh·gw·256,)

    ylo, yhi, wy0, wy1 = (torch.from_numpy(a).to(dev)
                          for a in _resize_weights(H, gh, th))
    xlo, xhi, wx0, wx1 = (torch.from_numpy(a).to(dev)
                          for a in _resize_weights(W, gw, tw))
    b0 = torch.arange(B, device=dev)[:, None, None] * (gh * gw)

    def at(ty, tx):
        return lut[((b0 + ty[None, :, None] * gw + tx[None, None, :]) * 256
                    + v)]

    wy0, wy1 = wy0[None, :, None], wy1[None, :, None]
    # rows first (Σ_i Ry[h, i]·lut[i, j]), then columns, as the reference
    r_lo = wy0 * at(ylo, xlo) + wy1 * at(yhi, xlo)
    r_hi = wy0 * at(ylo, xhi) + wy1 * at(yhi, xhi)
    out = wx0[None, None, :] * r_lo + wx1[None, None, :] * r_hi
    out = torch.round(out).clamp(0, 255).to(torch.uint8)
    return out[0] if squeeze else out

"""Lens distortion estimation from video motion.

Reference motion/6-estimate-lens-distortion.py (229 LoC): radial distortion
makes frame-to-frame motion deviate from a pure homography away from the
image center; search for the coefficients that make the tracked flow
homography-consistent.

TPU-native formulation: collect LK tracks over many frame pairs, then
minimize Σ‖H_i(undistort(p)) − undistort(q)‖² jointly over (k1, k2) and the
per-pair similarity transforms by gradient descent through the
differentiable undistortion (core.camera.undistort_normalized) — one
gradient-based optimization instead of the reference's grid search.

Port of the JAX package's ``motion/lens_distortion.py``: the loss is the
same pair residual, batched over pairs on ``device``; its gradient comes
from torch autograd and the optimiser is ``torch.optim.Adam``, whose
defaults (β 0.9/0.999, ε 1e-8 added to √v̂) are the reference's Adam's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.camera import pixels_to_normalized, undistort_normalized
from ..core.device import checked
from ..core.transforms import fit_similarity_2d


def estimate_k1_k2(track_pairs, K, iters=300, lr=3e-2, device="cuda"):
    """track_pairs: list of (pts_a (N,2), pts_b (N,2)) pixel tracks from
    frame pairs. Returns (k1, k2, history)."""
    dev = checked(device, "estimate_k1_k2")
    loss = pair_loss(track_pairs, K, dev)
    params = torch.zeros(2, device=dev, requires_grad=True)
    opt = torch.optim.Adam([params], lr=lr)
    history = []
    for _ in range(iters):
        opt.zero_grad()
        val = loss(params)
        val.backward()
        opt.step()
        history.append(float(val.detach()))
    k1, k2 = (float(v) for v in params.detach().cpu())
    return k1, k2, history


def pair_loss(track_pairs, K, device):
    """The loss of (k1, k2): the mean over pairs of each pair's similarity
    fit residual after undistortion, in px²."""
    npad = max(len(a) for a, _ in track_pairs)
    B = len(track_pairs)
    pa = np.zeros((B, npad, 2), np.float32)
    pb = np.zeros((B, npad, 2), np.float32)
    w = np.zeros((B, npad), np.float32)
    for i, (a, b) in enumerate(track_pairs):
        n = len(a)
        pa[i, :n], pb[i, :n], w[i, :n] = a, b, 1.0
    pa, pb, w = (torch.as_tensor(x, device=device) for x in (pa, pb, w))
    Kt = torch.as_tensor(np.asarray(K, np.float32), device=device)
    f = 0.5 * float(K[0, 0] + K[1, 1])

    na = pixels_to_normalized(pa, Kt)
    nb = pixels_to_normalized(pb, Kt)

    def loss(params):
        dist = torch.cat([params, params.new_zeros(3)])
        ua = undistort_normalized(na, dist, iters=6)
        ub = undistort_normalized(nb, dist, iters=6)
        A = fit_similarity_2d(ua, ub, w)
        pred = ua @ A[..., :2].transpose(-1, -2) + A[..., None, :, 2]
        r = (w * ((pred - ub) ** 2).sum(-1)).sum(-1) \
            / w.sum(-1).clamp_min(1.0)
        return r.mean() * f * f  # scale to px²

    return loss


def estimate_from_video(video_path, K, max_frames=120, scale=1.0,
                        device="cuda"):
    """End-to-end: track → optimize → (k1, k2)."""
    from ..video.frame_motion import track_video

    checked(device, "estimate_from_video")
    pairs = [(p0, p1) for _, _, p0, p1 in
             track_video(video_path, max_frames=max_frames, scale=scale)]
    if len(pairs) < 5:
        raise ValueError("not enough trackable frames")
    k1, k2, hist = estimate_k1_k2(pairs, K, device=device)
    return k1, k2, hist

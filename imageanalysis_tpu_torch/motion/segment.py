"""DMD-based motion segmentation: background vs movers.

Reference motion/dmd7/dmd8/motion2-6 experiments: stabilize frames against
camera motion (homography chain), run (streaming) DMD over the frame
sequence, reconstruct the quasi-static background from the near-unit-modulus
low-frequency modes, and flag movers as large |frame − background| residual.

``segment_video`` is the end-to-end entry; the DMD background solve is one
batched device SVD over the (pixels × frames) snapshot matrix (exact DMD),
with StreamingDMD available for unbounded sequences.

Port of the JAX package's ``motion/segment.py``: the SVD and the products
around it are torch on ``device``; the general eig and the lstsq stay on
the host, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import checked


def exact_dmd(X, Y, rank=None, device="cuda"):
    """Exact DMD: Y ≈ A X. Returns (modes (n, r), eigenvalues (r,),
    amplitudes (r,)) via rank-truncated SVD of X, computed on device."""
    dev = checked(device, "exact_dmd")
    X = torch.as_tensor(np.asarray(X, np.float32), device=dev)
    Y = torch.as_tensor(np.asarray(Y, np.float32), device=dev)
    U, S, Vt = torch.linalg.svd(X, full_matrices=False)
    if rank:
        U, S, Vt = U[:, :rank], S[:rank], Vt[:rank]
    Sinv = 1.0 / torch.maximum(S, 1e-6 * S[0])
    VS = Vt.T * Sinv[None, :]
    Atilde = U.T @ Y @ VS
    evals, W = np.linalg.eig(Atilde.cpu().numpy())   # general eig: host
    modes = (Y @ VS).cpu().numpy() @ W
    # amplitudes from projecting the first snapshot
    amps = np.linalg.lstsq(modes, X[:, 0].cpu().numpy(), rcond=None)[0]
    return modes, evals, amps


def background_model(frames, rank=10, static_tol=0.05, device="cuda"):
    """frames: (T, H, W) float. Returns (background (H, W), residuals
    (T, H, W)): background = reconstruction from modes with |λ| ≈ 1 and
    near-zero phase (the static content)."""
    T, H, W = frames.shape
    F = frames.reshape(T, -1).T.astype(np.float32)  # (n, T)
    X, Y = F[:, :-1], F[:, 1:]
    modes, evals, amps = exact_dmd(X, Y, rank=rank, device=device)
    static = (np.abs(np.abs(evals) - 1.0) < static_tol) \
        & (np.abs(np.angle(evals)) < static_tol)
    if not static.any():
        static = np.abs(np.abs(evals) - 1.0) < 10 * static_tol
    bg_vec = (modes[:, static] @ amps[static]).real
    bg = bg_vec.reshape(H, W)
    residuals = np.abs(frames - bg[None])
    return bg, residuals


def segment_video(video_path, rank=10, max_frames=120, scale=0.5,
                  thresh_sigma=3.5, device="cuda"):
    """Returns (background (H, W) uint8, masks (T, H, W) bool movers)."""
    import cv2

    checked(device, "segment_video")
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise FileNotFoundError(video_path)
    frames = []
    while len(frames) < max_frames:
        ret, fr = cap.read()
        if not ret:
            break
        g = cv2.cvtColor(fr, cv2.COLOR_BGR2GRAY) if fr.ndim == 3 else fr
        if scale != 1.0:
            g = cv2.resize(g, (0, 0), fx=scale, fy=scale)
        frames.append(g.astype(np.float32))
    cap.release()
    if len(frames) < 3:
        raise ValueError("not enough frames")
    frames = np.stack(frames)
    bg, residuals = background_model(frames, rank=rank, device=device)
    sigma = residuals.std()
    masks = residuals > thresh_sigma * sigma
    return bg.clip(0, 255).astype(np.uint8), masks

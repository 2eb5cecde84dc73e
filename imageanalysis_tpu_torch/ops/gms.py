"""GMS (Grid-based Motion Statistics) match filter, on tensors.

Port of ``imageanalysis_tpu/ops/gms.py`` (which replaces the reference's
cv2.xfeatures2d.matchGMS). True matches are supported by their
neighbours: both images are cut into G×G grids, each match votes for its
(cell in A, cell in B) pair, and a match survives where the votes of the
3×3 neighbourhoods of both cells exceed τ = α·√(their mean a supporting
cell). One scatter of the votes into the (G², G²) cell-pair matrix and a
3×3 sum along each of its four grid axes, on whatever device the matches
lie on.
"""

from __future__ import annotations

import torch

ALPHA = 6.0  # GMS paper's τ = α·√n factor (cv2 default)


def _conv3(x, axis):
    """x plus its neighbours ±1 along axis, zero beyond the edges."""
    n = x.shape[axis]
    idx = torch.arange(n, device=x.device)
    shape = [1] * x.dim()
    shape[axis] = -1
    lo = torch.roll(x, 1, dims=axis).masked_fill((idx == 0).view(shape), 0.0)
    hi = torch.roll(x, -1, dims=axis).masked_fill((idx == n - 1).view(shape),
                                                  0.0)
    return x + lo + hi


def _box3(x, g):
    """The 3×3 neighbourhood sums of a (g², g²) cell-pair matrix over both
    cells."""
    s = x.reshape(g, g, g, g)          # (ay, ax, by, bx)
    for ax in range(4):
        s = _conv3(s, ax)
    return s.reshape(g * g, g * g)


def gms_filter(uv_a, uv_b, valid, wh_a, wh_b, grid=20, alpha=ALPHA):
    """uv_a/uv_b (N, 2) matched keypoint coordinates, valid (N,) bool,
    wh_a/wh_b the images' (width, height). Returns (N,) bool: the GMS
    survivors among the valid matches."""
    g = grid
    dev = uv_a.device

    def cell_of(uv, wh):
        wh = torch.as_tensor(wh, dtype=torch.float32, device=dev)
        cx = (uv[:, 0] / wh[0] * g).to(torch.int64).clamp(0, g - 1)
        cy = (uv[:, 1] / wh[1] * g).to(torch.int64).clamp(0, g - 1)
        return cy * g + cx

    ca = cell_of(uv_a.float(), wh_a)
    cb = cell_of(uv_b.float(), wh_b)
    votes = torch.zeros((g * g, g * g), dtype=torch.float32, device=dev)
    votes.index_put_((ca, cb), valid.to(torch.float32), accumulate=True)
    support = _box3(votes, g)
    n_cells = _box3((votes > 0).to(torch.float32), g)
    tau = alpha * torch.sqrt((support / n_cells.clamp_min(1.0))
                             .clamp_min(0.0))
    return valid & (support > tau)[ca, cb]

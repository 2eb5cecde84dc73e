"""Pair work-list policy: which image pairs are worth matching.

The reference builds an O(n²) candidate list filtered by camera-pose distance
(max_dist = 4 × median adjacent interval) and always includes sequential
neighbors |i−j| ≤ 4, discretizing distance for cache-friendly ordering
(reference matcher.py:858-916). Note the distance window is disabled by an
``if False`` in the shipped code (matcher.py:896) — only neighbors are
matched; we implement the documented policy with both knobs.
"""

from __future__ import annotations

import numpy as np


def build_work_list(poses_ned, min_dist=0.0, max_dist=None, neighbor_window=4,
                    use_distance=True, sort=False):
    """poses_ned: (n, 3) camera NED positions. Returns list of (ddist, i, j),
    i < j."""
    poses = np.asarray(poses_ned, dtype=np.float64)
    n = len(poses)
    if n < 2:
        return []
    intervals = np.linalg.norm(np.diff(poses, axis=0), axis=1)
    median = float(np.median(intervals))
    average = float(np.mean(intervals))
    if median < average:
        median = average
    median_int = max(int(round(median)), 1)
    if max_dist is None:
        max_dist = median_int * 4
    interval = median_int * 1.3

    diff = poses[:, None, :] - poses[None, :, :]
    dist = np.linalg.norm(diff, axis=-1)
    iu, ju = np.triu_indices(n, k=1)
    d = dist[iu, ju]
    keep = np.zeros(len(d), bool)
    if use_distance:
        keep |= (d >= min_dist) & (d <= max_dist)
    keep |= (ju - iu) <= neighbor_window
    ddist = (np.round(d / interval) * interval).astype(np.float64)
    work = [(float(ddist[k]), int(iu[k]), int(ju[k]))
            for k in np.nonzero(keep)[0]]
    if sort:
        work.sort(key=lambda t: t[0])
    return work

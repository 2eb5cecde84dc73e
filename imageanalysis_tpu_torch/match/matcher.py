"""The match engine: batched pair matching on the device.

Port of the ungated store path of ``imageanalysis_tpu/match/matcher.py``:
for a batch of pairs, exact mutual 2-NN on packed int8 keys (kernel K1),
the Lowe ratio test, and homography RANSAC, all as batched tensor work
over a leading pair dimension; then the host unpack into per-pair match
arrays with the reference's ``min_pairs`` rule.

``match_pairs_store`` is ``BatchMatcher._match_pairs_store`` with the
project workspace lifted out: it takes a resident ``DescriptorStore`` and
a pair list and returns ``{(i, j): (rows, cols)}``. Gated (smart)
matching, the compacted download, the fundamental/essential transforms
and ``BatchMatcher`` itself are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import knn, ransac


class MatchConfig:
    """The knobs of the ported store path (the reference's MatchConfig
    without the gated, compact-download and backend options)."""

    def __init__(self, ratio=0.75, transform="homography", min_pairs=25,
                 batch_size=16, n_hyp=512, seed=42, store_scan=4):
        self.ratio = ratio
        self.transform = transform          # homography | none
        self.min_pairs = min_pairs          # reference matcher.py:131 (25)
        self.batch_size = batch_size
        self.n_hyp = n_hyp
        self.seed = seed
        # store path: S sub-batches of B pairs per group
        self.store_scan = store_scan


_TRANSFORMS = ("homography", "none")


def match_pair_batch(desc_a, desc_b, uv_a, uv_b, n_a, n_b, generator=None,
                     ratio=0.75, thresh=3.0, transform="homography",
                     n_hyp=512, pick=None):
    """Match a batch of image pairs end to end on the device.

    desc_a/desc_b (B, npad, 128) int8; uv_a/uv_b (B, npad, 2) undistorted
    keypoints; n_a/n_b (B,) real counts; generator draws the RANSAC minimal
    sets (pick (B, n_hyp, 4) replaces the draw). Returns (best_j (B, npad),
    ok (B, npad)) where ok marks ratio + mutual + RANSAC survivors."""
    if transform not in _TRANSFORMS:
        raise NotImplementedError(f"transform {transform!r} is not ported "
                                  f"yet (have {_TRANSFORMS})")
    best_j, ok, pb = knn.match_pair_dense(desc_a, desc_b, n_a, n_b,
                                          ratio=ratio, mutual=True, uv_b=uv_b)
    if transform == "homography":
        res = ransac.ransac_homography(uv_a, pb, ok, thresh=thresh,
                                       n_hyp=n_hyp, generator=generator,
                                       pick=pick)
        ok = ok & res.inliers & res.ok[:, None]
    return best_j, ok


def match_pair_batch_packed(desc_a, desc_b, uv_a, uv_b, n_a, n_b,
                            generator=None, ratio=0.75, thresh=3.0,
                            transform="homography", n_hyp=512):
    """match_pair_batch packed into one (B, npad) int16 tensor: the best B
    index of each survivor, −1 elsewhere. npad must stay below 32768."""
    npad = desc_a.shape[1]
    if npad >= 32768:
        raise ValueError(f"npad {npad} does not fit the int16 packing")
    best_j, ok = match_pair_batch(desc_a, desc_b, uv_a, uv_b, n_a, n_b,
                                  generator, ratio=ratio, thresh=thresh,
                                  transform=transform, n_hyp=n_hyp)
    return torch.where(ok, best_j, -1).to(torch.int16)


def match_pair_batch_store_scan(store_desc, store_uv, store_counts, idx_a,
                                idx_b, generator=None, ratio=0.75,
                                thresh=3.0, transform="homography",
                                n_hyp=512):
    """The store match step, gathers included, over S sub-batches.

    idx_a/idx_b (S, B) image indices into the resident store arrays.
    Returns (S, B, npad) packed int16. Padding slots (0, 0) match an image
    against itself and are dropped by the host unpack; a sub-batch of
    padding only is not computed (its row stays −1)."""
    S, B = idx_a.shape
    out = torch.full((S, B, store_desc.shape[1]), -1, dtype=torch.int16,
                     device=store_desc.device)
    for s in range(S):
        if not bool(((idx_a[s] != 0) | (idx_b[s] != 0)).any()):
            continue
        ia = idx_a[s].to(store_desc.device).long()
        ib = idx_b[s].to(store_desc.device).long()
        out[s] = match_pair_batch_packed(
            store_desc.index_select(0, ia), store_desc.index_select(0, ib),
            store_uv.index_select(0, ia), store_uv.index_select(0, ib),
            store_counts.index_select(0, ia),
            store_counts.index_select(0, ib), generator, ratio=ratio,
            thresh=thresh, transform=transform, n_hyp=n_hyp)
    return out


def _emit_pair(out, i, j, rows, cols, min_pairs):
    """Record one pair's surviving matches as an (n, 2) int32 array of
    (row in i, col in j); pairs under min_pairs record none (reference
    matcher.py:975-985)."""
    if len(rows) < min_pairs:
        rows = rows[:0]
        cols = cols[:0]
    out[(i, j)] = np.stack([np.asarray(rows), np.asarray(cols)],
                           axis=1).astype(np.int32, copy=False)
    return len(out[(i, j)])


def _store_unpack(out, chunk, packed, min_pairs):
    """Packed int (−1 = no match) (≥ len(chunk), npad) → out[(i, j)] for
    each pair of chunk; rows past len(chunk) are padding. Returns the
    number of matches kept."""
    n_matched = 0
    pk = packed[: len(chunk)]
    bi_all, rows_all = np.nonzero(pk >= 0)
    cols_all = pk[bi_all, rows_all].astype(np.int64)
    starts = np.searchsorted(bi_all, np.arange(len(chunk) + 1))
    for bi, (i, j) in enumerate(chunk):
        n_matched += _emit_pair(out, i, j,
                                rows_all[starts[bi]:starts[bi + 1]],
                                cols_all[starts[bi]:starts[bi + 1]],
                                min_pairs)
    return n_matched


def match_pairs_store(store, pairs, config, thresh):
    """Match every (i, j) of pairs against the resident store.

    Groups of S = config.store_scan sub-batches of B = max(batch_size, 256)
    pairs, padded with (0, 0) pairs; one torch.Generator on the store's
    device, seeded from config.seed, draws every RANSAC sample. thresh is
    the RANSAC tolerance in px (the reference uses width^0.25). Returns
    {(i, j): (n, 2) int32 [row in i, col in j]} for every pair."""
    B = max(config.batch_size, 256)
    S = max(int(config.store_scan), 1)
    group = B * S
    dev = store.desc.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(config.seed)
    out = {}
    for start in range(0, len(pairs), group):
        chunk = [tuple(p) for p in pairs[start:start + group]]
        idx = np.zeros((group, 2), np.int64)
        idx[: len(chunk)] = chunk
        packed = match_pair_batch_store_scan(
            store.desc, store.uv, store.counts,
            torch.from_numpy(idx[:, 0].reshape(S, B)),
            torch.from_numpy(idx[:, 1].reshape(S, B)), gen,
            ratio=config.ratio, thresh=thresh, transform=config.transform,
            n_hyp=config.n_hyp)
        _store_unpack(out, chunk, packed.reshape(group, -1).cpu().numpy(),
                      config.min_pairs)
    return out

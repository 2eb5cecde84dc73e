"""Connected-image grouping (Step 3d of ``apps/process.py``).

Port of ``imageanalysis_tpu/match/groups.py``, host numpy as there, the
same greedy algorithm: seed each group with the unplaced chain of the most
connections, then sweep all chains, adding any that touches the group (two
placed images, or the seed image) and still brings needed connections,
with per-image quotas max_wanted = max(8000/√n, 200) and the thresholds
min_connections = 25, min_group = 7. Sweeps run in CSR form and evaluate
each sweep against the previous one's counts (Jacobi), which reaches the
reference's fixed point. Chains are tagged with their group id in
match[1]; groups persist as groups.json (lists of image names), the same
file in both packages.
"""

from __future__ import annotations

import json
import os
from math import sqrt

import numpy as np

from ..io.logger import log

MIN_GROUP = 7
MIN_CONNECTIONS = 25


def compute(image_list, matches, min_chain_len=3, min_group=MIN_GROUP,
            min_connections=MIN_CONNECTIONS):
    """matches must be sorted longest-chain-first (cleanup.link_matches)."""
    log("Start of grouping algorithm...")
    use_single_pairs = min_chain_len == 2
    n_images = len(image_list)
    max_wanted = max(int(8000 / sqrt(max(n_images, 1))), 200)
    log("max features desired per image:", max_wanted)

    # pre-extract chain image lists into CSR form (built once): slot_img is
    # every chain's image ids concatenated, slot_chain maps each slot back
    # to its chain. A padded (n_chains, max_len) layout inflates with the
    # LONGEST chain (a deep chain can span hundreds of images at mission
    # scale); CSR keeps every sweep O(total observations).
    n_chains = len(matches)
    lengths = np.fromiter((len(m) - 2 for m in matches), np.int64, n_chains)
    slot_img = np.empty(int(lengths.sum()), np.int32)
    offs = np.zeros(n_chains + 1, np.int64)
    np.cumsum(lengths, out=offs[1:])
    for i, match in enumerate(matches):
        match[1] = -1
        slot_img[offs[i]:offs[i + 1]] = [m[0] for m in match[2:]]
    slot_chain = np.repeat(np.arange(n_chains, dtype=np.int64), lengths)
    # seed image per chain = second image (first for length-1 chains;
    # clipped for degenerate empty chains, which can never seed)
    second = np.minimum(offs[:-1] + 1, np.maximum(offs[1:] - 1, offs[:-1]))
    second = np.clip(second, 0, max(len(slot_img) - 1, 0))
    chain_second_img = slot_img[second] if len(slot_img) else \
        np.zeros(0, np.int32)
    group_of = np.full(n_chains, -1, np.int64)
    assigned = np.zeros(n_chains, bool)

    def chain_count(slot_mask):
        return np.bincount(slot_chain[slot_mask], minlength=n_chains)

    placed_images: set[int] = set()
    prev_placed = np.zeros(n_images, bool)
    groups = []

    while True:
        group_level = len(groups)
        placed_matches = np.zeros(n_images, np.int64)

        # seed: unaffiliated chain (touching no placed image) with the most
        # connections — vectorized over all chains
        has_placed = chain_count(prev_placed[slot_img]) > 0
        cand = (~assigned) & ~has_placed & (lengths > 2)
        if not cand.any():
            break
        seed_index = int(np.argmax(np.where(cand, lengths, 0)))
        seed_image = int(chain_second_img[seed_index])
        group_of[seed_index] = group_level
        assigned[seed_index] = True
        seed_slots = slot_img[offs[seed_index]:offs[seed_index + 1]]
        placed_matches += np.bincount(seed_slots, minlength=n_images)
        log("Seeding group with:", image_list[seed_image].name
            if hasattr(image_list[seed_image], "name") else seed_image)

        # vectorized expansion sweeps. The reference updates placed_matches
        # WITHIN a sweep (Gauss–Seidel); evaluating each sweep against the
        # previous sweep's counts (Jacobi) reaches the same fixed point in a
        # few more sweeps and turns the per-chain Python loop into flat
        # numpy over all chains — at 10⁵–10⁶ chains the difference is
        # minutes vs hours.
        eligible = (~assigned) & (use_single_pairs | (lengths > 2))
        slot_live = ~prev_placed[slot_img]
        seed_conn = chain_count(slot_live & (slot_img == seed_image)) > 0

        still_working = True
        while still_working:
            pm = placed_matches[slot_img]
            placed_count = chain_count(slot_live & (pm >= min_connections))
            placed_need = chain_count(slot_live & (pm > 0)
                                      & (pm < max_wanted))
            unplaced_count = chain_count(slot_live & (pm == 0))
            add = eligible & (
                (placed_count > 1)
                | (use_single_pairs & (placed_count > 0))
                | seed_conn) & ((placed_need > 0) | (unplaced_count > 0))
            if not add.any():
                still_working = False
                break
            group_of[add] = group_level
            assigned |= add
            placed_matches += np.bincount(slot_img[add[slot_chain]],
                                          minlength=n_images)
            eligible &= ~add

        group_images = set(int(i) for i in np.nonzero(
            placed_matches >= min_connections)[0])
        group_list = []
        for i in group_images:
            placed_images.add(i)
            prev_placed[i] = True
            group_list.append(image_list[i].name
                              if hasattr(image_list[i], "name") else str(i))
        if len(group_images) >= min_group:
            log("Group %d: %d images" % (group_level, len(group_list)))
            groups.append(sorted(group_list))
        if len(group_images) < 3:
            break
    # write group ids back into the match records once (a per-sweep python
    # loop over added chains was a visible slice of this stage's host time)
    for i, match in enumerate(matches):
        match[1] = int(group_of[i])
    return groups


def save(analysis_dir, groups):
    with open(os.path.join(analysis_dir, "groups.json"), "w") as f:
        json.dump(groups, f, indent=4, sort_keys=True)


def load(analysis_dir):
    path = os.path.join(analysis_dir, "groups.json")
    if not os.path.isfile(path):
        return []
    with open(path) as f:
        return json.load(f)

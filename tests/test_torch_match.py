"""Port parity: Step 3a's matching stage over a project workspace.

A 6-frame 320×240 synthetic mission, detected by the port, written as a
workspace (testing/synthetic.write_workspace); copies of it go through
both packages' ``find_matches(strategy="smart")`` and
``requalify_pairs``. Both run their CPU arms (the reference decides by
backend, the port by device). They draw different RANSAC samples
(jax.random against torch.Generator), so points on the inlier threshold
may flip: per pair the survivor sets agree on ≥ 98% (intersection over
union), and wherever both keep a row they pick the same B row.
smart.json's tri_surface_m agrees within 0.5 m and yaw_error within 0.5°.
The store path runs once more through ``BatchMatcher(use_store=True)``
with transform "none" (RANSAC is not the point there, and it saves the
reference a compile).

The repair: a store of npad 8448 (beyond K1's 13 index bits) matches
through ``match_pairs_store`` by K3, as the reference's knn_top2 does,
and returns what the reference's CPU arm returns for the same arrays.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageanalysis_tpu.io.project import ProjectMgr as JProject
from imageanalysis_tpu.match import matcher as jmatcher
from imageanalysis_tpu.match import smart as jsmart
from imageanalysis_tpu.ops import knn as jknn
from imageanalysis_tpu_torch.features import sift as tsift
from imageanalysis_tpu_torch.io.project import ProjectMgr as TProject
from imageanalysis_tpu_torch.match import matcher as tmatcher
from imageanalysis_tpu_torch.match import smart as tsmart
from imageanalysis_tpu_torch.match.store import DescriptorStore
from imageanalysis_tpu_torch.testing.synthetic import (make_mission,
                                                       write_workspace)
from torch_threads import one_torch_thread  # noqa: F401

SIZE = (320, 240)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """Workspaces of the mission to copy: all features, and at most 250
    an image."""
    m = make_mission(strips=3, per_strip=2, size=SIZE, strip_gap=1.5, seed=3,
                     device="cpu")
    dets = tsift.detect_finalize_batch(tsift.detect_dispatch(
        m.frames, max_features=512, equalize=True))
    base = tmp_path_factory.mktemp("ws")
    root = str(base / "template")
    write_workspace(root, m, dets)
    # the store-path case: at most 250 features an image (npad 256), which
    # keeps the reference's 256-pair store batches cheap on the CPU
    small = str(base / "small")
    write_workspace(small, m, [tuple(x[:250] for x in d) for d in dets])
    return root, small


def _copies(template, tmp_path):
    out = []
    for name, mgr in (("jax", JProject), ("torch", TProject)):
        dst = str(tmp_path / name)
        shutil.copytree(template, dst)
        proj = mgr(dst)
        proj.load_images_info()
        out.append(proj)
    return out


def _assert_same_matches(jp, tp, min_iou=0.98):
    n_kept = 0
    for ji, ti in zip(jp.image_list, tp.image_list):
        assert ji.name == ti.name
        assert set(ji.match_list) == set(ti.match_list)
        for other in ji.match_list:
            w = {int(r): int(c) for r, c in ji.match_list[other]}
            g = {int(r): int(c) for r, c in ti.match_list[other]}
            both, union = g.keys() & w.keys(), g.keys() | w.keys()
            if union:
                assert len(both) >= min_iou * len(union), \
                    (ji.name, other, len(both), len(union))
            assert all(g[r] == w[r] for r in both), (ji.name, other)
            n_kept += bool(w)
    return n_kept


def test_find_matches_smart_matches_reference(workspace, tmp_path,
                                             monkeypatch):
    """batch_size 1 makes find_matches's chunks 8 pairs wide, so the 15
    pairs take two chunks and the priors that chunk 1 triangulates gate
    chunk 2. Both states start from an SRTM ground 30 m above the true
    one: chunk 1 gates from it, chunk 2 from the triangulated surface."""
    template, _ = workspace
    jp, tp = _copies(template, tmp_path)
    config = dict(strategy="smart", batch_size=1, n_hyp=64)
    js, ts = (mod.SmartState(p.analysis_dir)
              for mod, p in ((jsmart, jp), (tsmart, tp)))
    for state in (js, ts):
        for im in tp.image_list:
            state.node(im.name)["srtm_surface_m"] = 30.0
    grounds = []       # the surface under each gated dispatch, in order
    gate_arrays = tmatcher.BatchMatcher._pair_gate_arrays

    def spy(self, chunk, n):
        out = gate_arrays(self, chunk, n)
        grounds.append(-out[2][: len(chunk)])
        return out

    monkeypatch.setattr(tmatcher.BatchMatcher, "_pair_gate_arrays", spy)
    n_j = jmatcher.find_matches(jp, jmatcher.MatchConfig(**config),
                                smart_state=js)
    n_t = tmatcher.find_matches(tp, tmatcher.MatchConfig(**config),
                                smart_state=ts, device="cpu")
    assert abs(n_t - n_j) <= 0.02 * n_j
    grounds = np.concatenate(grounds)
    assert len(grounds) == 15
    np.testing.assert_array_equal(grounds[:8], 30.0)
    # chunk 2: the surface chunk 1 triangulated, 30 m only for a pair
    # neither of whose images chunk 1 triangulated
    moved = np.abs(grounds[8:]) <= 1.0
    assert moved.sum() >= 5 and np.all(moved | (grounds[8:] == 30.0))
    jsmart.requalify_pairs(jp, js)
    tsmart.requalify_pairs(tp, ts, device="cpu")
    # the saved match files are what both packages compare
    for p, mgr in ((jp, JProject), (tp, TProject)):
        p.__init__(p.project_dir)
        p.load_images_info()
        for im in p.image_list:
            im.load_matches()
    assert _assert_same_matches(jp, tp) >= 14   # overlapping pairs, 2 ways
    again = tsmart.SmartState(tp.analysis_dir)
    assert again.data == ts.data                 # smart.json as saved
    for name, node in js.data.items():
        t = ts.data[name]
        assert abs(t["tri_surface_m"] - node["tri_surface_m"]) <= 0.5
        assert abs(t["tri_surface_m"]) <= 1.0     # the ground is at 0 m
        if "yaw_error" in node:
            assert abs(t["yaw_error"] - node["yaw_error"]) <= 0.5


def test_store_path_smart_matches_reference(workspace, tmp_path):
    """BatchMatcher's resident-store path, gated, with the ungated retry of
    the pairs that came up empty."""
    _, template = workspace
    jp, tp = _copies(template, tmp_path)
    pairs = [(i, j) for i in range(6) for j in range(i + 1, 6)]
    config = dict(strategy="smart", transform="none", store_scan=1)
    for mod, sm, p, kw in ((jmatcher, jsmart, jp, {}),
                           (tmatcher, tsmart, tp, {"device": "cpu"})):
        bm = mod.BatchMatcher(p, mod.MatchConfig(**config), use_store=True,
                              smart_state=sm.SmartState(p.analysis_dir),
                              **kw)
        assert bm.store is not None and bm.gated
        bm.match_pairs(pairs, progress=False) if mod is jmatcher \
            else bm.match_pairs(pairs)
    assert _assert_same_matches(jp, tp, min_iou=1.0) >= 14


def test_store_beyond_8192_rows_matches_reference(rng):
    """The repair: npad 8448 goes to K3 (int8 cast to bf16), where the
    port used to raise; it returns the reference CPU arm's matches."""
    counts = np.array([8400, 6000, 8300], np.int32)
    npad = 8448
    desc = np.full((3, npad, 128), 127, np.int8)
    base = rng.integers(0, 100, (3, npad, 128))
    for i in (1, 2):   # each image shares 2000 rows with the one before
        base[i, :2000] = np.clip(base[i - 1, :2000]
                                 + rng.integers(-3, 4, (2000, 128)), 0, 255)
    for i, n in enumerate(counts):
        desc[i, :n] = (base[i, :n] - 128).astype(np.int8)
    uv = rng.uniform(0, 4000, (3, npad, 2)).astype(np.float32)
    pairs = [(0, 1), (1, 2)]
    store = DescriptorStore.from_numpy(desc, uv, counts, device="cpu")
    got = tmatcher.match_pairs_store(
        store, pairs, tmatcher.MatchConfig(transform="none", use_pallas=True),
        thresh=7.9)

    # the reference's store step with transform "none" is, per pair, its
    # match_pair_dense on the CPU arm
    for i, j in pairs:
        bj, ok = _reference_match(desc[i], desc[j], counts[i], counts[j])
        want = np.stack([np.nonzero(ok)[0], bj[ok]], 1)
        np.testing.assert_array_equal(got[(i, j)], want)
        assert len(want) > 1900


_ref_top2 = jax.jit(jknn.knn_top2_ref)


def _reference_match(desc_a, desc_b, n_a, n_b, ratio=0.75):
    """The reference's match_pair_dense off the TPU with use_pallas=False,
    mutual=True and no uv_b, as (best_j, ok) numpy arrays: its jitted
    knn_top2_ref (imageanalysis_tpu/ops/knn.py:646-649), then the ratio
    test, the mutual check and the count masks of knn.py:651-657, 700-706
    written out in numpy. Jitted whole at npad 8448 the reference's
    function takes ~20 s a pair on the CPU, its 2-NN alone under 1 s;
    test_reference_match_copy_equals_reference holds this copy against
    the whole function at a small size."""
    row_d, row_i, _, col_i = (np.asarray(x) for x in _ref_top2(
        jnp.asarray(desc_a), jnp.asarray(desc_b)))
    bj = row_i[:, 0]
    ok = (np.maximum(row_d[:, 0], 0) < ratio ** 2
          * np.maximum(row_d[:, 1], 0))
    ok &= col_i[bj] == np.arange(len(desc_a))
    ok &= (np.arange(len(desc_a)) < n_a) & (bj < n_b)
    return bj, ok


def test_reference_match_copy_equals_reference(rng):
    """_reference_match equals the reference's match_pair_dense (CPU arm,
    mutual) at 384 × 512 rows, with planted matches and padding."""
    a = rng.integers(-128, 100, (384, 128)).astype(np.int8)
    b = rng.integers(-128, 100, (512, 128)).astype(np.int8)
    b[:200] = np.clip(a[:200].astype(np.int16)
                      + rng.integers(-3, 4, (200, 128)), -128, 127)
    n_a, n_b = 350, 480
    want = jax.jit(jknn.match_pair_dense, static_argnames=(
        "use_pallas", "mutual"))(jnp.asarray(a), jnp.asarray(b), n_a, n_b,
                                 use_pallas=False, mutual=True)
    got = _reference_match(a, b, n_a, n_b)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[1].sum() > 150


def test_compact_download_matches_reference(rng):
    """_compact_packed against the reference's, and the compacted unpack
    against the full one."""
    B, npad, cap = 6, 512, 900
    packed = np.where(rng.uniform(size=(B, npad)) < 0.3,
                      rng.integers(0, npad, (B, npad)), -1).astype(np.int16)
    want = np.asarray(jmatcher._compact_packed(jnp.asarray(packed), 4, cap))
    got = tmatcher._compact_packed(torch.from_numpy(packed), 4, cap).numpy()
    np.testing.assert_array_equal(got, want)
    chunk = [(0, 1), (1, 2), (2, 3), (0, 3)]

    def images():
        import types
        return [types.SimpleNamespace(name=str(i), match_list={},
                                      matches_clean=True) for i in range(4)]

    full, comp = images(), images()
    n1 = tmatcher._store_unpack(full, chunk, packed, 25)
    small = tmatcher._compact_packed(torch.from_numpy(packed), 4, 2048)
    n2 = tmatcher._store_unpack_compact(comp, chunk, small[:B].numpy(),
                                        small[B:].numpy(), 25)
    assert n1 == n2 > 0
    for a, b in zip(full, comp):
        assert a.match_list.keys() == b.match_list.keys()
        for k in a.match_list:
            np.testing.assert_array_equal(a.match_list[k], b.match_list[k])


def test_match_config_decides_the_arm_by_device(workspace, tmp_path):
    """use_pallas=None takes the CPU arm on the CPU (as the reference on a
    non-TPU backend); compact downloads leave the store path's result
    unchanged."""
    _, template = workspace
    _, tp = _copies(template, tmp_path)
    cfg = tmatcher.MatchConfig(transform="none", compact_downloads=True,
                               store_scan=1)
    bm = tmatcher.BatchMatcher(tp, cfg, use_store=True, device="cpu")
    assert cfg.use_pallas is False and not bm.gated
    pairs = [(0, 1), (2, 3), (4, 5), (0, 2)]
    bm.match_pairs(pairs)
    got = {p: tp.image_list[p[0]].match_list[tp.image_list[p[1]].name]
           for p in pairs}
    want = tmatcher.match_pairs_store(
        bm.store, pairs, tmatcher.MatchConfig(transform="none",
                                              use_pallas=False), 1.0)
    for p in pairs:
        np.testing.assert_array_equal(got[p], want[p])
    # with RANSAC both draw by pair from the config's seed: the same
    # survivors
    cfg_h = tmatcher.MatchConfig(transform="homography", n_hyp=64,
                                 store_scan=1, filter_thresh=3.0)
    bm_h = tmatcher.BatchMatcher(tp, cfg_h, use_store=True, device="cpu")
    bm_h.match_pairs(pairs)
    want_h = tmatcher.match_pairs_store(
        bm_h.store, pairs, tmatcher.MatchConfig(transform="homography",
                                                n_hyp=64,
                                                use_pallas=False), 3.0)
    for p in pairs:
        np.testing.assert_array_equal(
            tp.image_list[p[0]].match_list[tp.image_list[p[1]].name],
            want_h[p])
    # the fundamental filter keeps a subset of the unfiltered survivors;
    # an unknown transform raises, and so does essential5, whose host
    # refilter needs a workspace
    fund = tmatcher.match_pairs_store(
        bm.store, pairs, tmatcher.MatchConfig(transform="fundamental",
                                              use_pallas=False), 1.0)
    for p in pairs:
        assert set(map(tuple, fund[p])) <= set(map(tuple, want[p]))
    with pytest.raises(ValueError, match="unknown transform"):
        tmatcher.match_pairs_store(
            bm.store, pairs, tmatcher.MatchConfig(transform="affine"), 1.0)
    with pytest.raises(ValueError, match="essential5"):
        tmatcher.match_pairs_store(
            bm.store, pairs, tmatcher.MatchConfig(transform="essential5"),
            1.0)

"""Port parity: Step 3a's device path as a whole.

decoded frames → CLAHE + SIFT detect → int8 resident store → work list →
2-NN + ratio + mutual + homography RANSAC → per-pair match arrays.

The parity case runs the JAX package's detect, then its store match step
(Pallas K1 in interpret mode, as tests/test_ops_knn.py runs it on the
CPU) on store arrays that the port's ``DescriptorStore.from_numpy``
carries across, so both packages match from one resident state. The two
draw different RANSAC samples (jax.random against torch.Generator), so
points on the inlier threshold may flip: per pair the survivor sets agree
on ≥ 98% (intersection over union), and wherever both keep a row they
pick the same B row.
"""

import os
import re
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageanalysis_tpu.features import sift_tpu as jsift
from imageanalysis_tpu.match import matcher as jmatcher
from imageanalysis_tpu_torch import _build
from imageanalysis_tpu_torch.features import sift as tsift
from imageanalysis_tpu_torch.match import matcher as tmatcher
from imageanalysis_tpu_torch.match import worklist
from imageanalysis_tpu_torch.match.store import DescriptorStore
from imageanalysis_tpu_torch.ops import knn as tknn
from imageanalysis_tpu_torch.testing.synthetic import make_mission
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "imageanalysis_tpu_torch")
SIZE = (320, 240)                   # (W, H)
MAX_FEATURES = 512
THRESH = float(SIZE[0]) ** 0.25     # the matcher's w^0.25 px tolerance
N_HYP = 64
B = 4


@pytest.fixture(scope="module")
def mission():
    """6 frames, 3 strips of 2, with their planted homographies."""
    m = make_mission(strips=3, per_strip=2, size=SIZE, strip_gap=1.5, seed=3,
                     device="cpu")
    pairs = [(i, j) for _, i, j in
             worklist.build_work_list(m.ned, use_distance=True)]
    return m.frames, pairs, m.H_ij


def _store_arrays(dets):
    """The JAX store's int8 layout (store.py): value − 128, pad rows 127,
    npad the largest count rounded up to 256."""
    counts = np.array([len(d[0]) for d in dets], np.int32)
    npad = max(-(-int(counts.max()) // 256) * 256, 256)
    desc = np.full((len(dets), npad, 128), 127, np.int8)
    uv = np.zeros((len(dets), npad, 2), np.float32)
    for i, (kp, _, d) in enumerate(dets):
        desc[i, :len(d)] = (np.clip(np.round(d), 0, 255).astype(np.int16)
                            - 128).astype(np.int8)
        uv[i, :len(kp)] = kp
    return desc, uv, counts


def _jax_match(desc, uv, counts, pairs):
    """The reference's store step (S = 1 sub-batch of B pairs per call)
    and its own host unpack into per-pair match arrays."""
    images = [types.SimpleNamespace(name=str(i), match_list={})
              for i in range(len(desc))]
    args = [jnp.asarray(x) for x in (desc, uv, counts)]
    key = jax.random.PRNGKey(42)
    for s in range(0, len(pairs), B):
        chunk = pairs[s:s + B]
        idx = np.zeros((B, 2), np.int32)
        idx[:len(chunk)] = chunk
        key, sub = jax.random.split(key)
        packed = jmatcher.match_pair_batch_store_scan(
            *args, jnp.asarray(idx[None, :, 0]), jnp.asarray(idx[None, :, 1]),
            jax.random.split(sub, B)[None], jnp.eye(3), ratio=0.75,
            thresh=THRESH, transform="homography", n_hyp=N_HYP,
            use_pallas=True)
        jmatcher._store_unpack(images, chunk, np.asarray(packed)[0], 25)
    return {(i, j): images[i].match_list[str(j)] for i, j in pairs}


def _config():
    """The kernel arm (use_pallas=True), as the reference's side runs."""
    return tmatcher.MatchConfig(batch_size=B, store_scan=1, n_hyp=N_HYP,
                                ratio=0.75, min_pairs=25, use_pallas=True)


def test_slice_matches_reference_from_one_store(mission):
    frames, pairs, _ = mission
    dets = jsift.detect_finalize_batch(jsift.detect_dispatch(
        frames.numpy(), max_features=MAX_FEATURES, equalize=True))
    desc, uv, counts = _store_arrays(dets)
    want = _jax_match(desc, uv, counts, pairs)

    store = DescriptorStore.from_numpy(desc, uv, counts, device="cpu")
    # the per-image constructor builds the same resident state
    again = DescriptorStore.from_arrays([d[2] for d in dets],
                                        [d[0] for d in dets], device="cpu")
    assert torch.equal(again.desc, store.desc)
    assert torch.equal(again.uv, store.uv)
    assert torch.equal(again.counts, store.counts)
    d, u, n = store.gather([2, 0])
    assert torch.equal(d, store.desc[[2, 0]])
    assert torch.equal(u, store.uv[[2, 0]])
    assert torch.equal(n, store.counts[[2, 0]])

    got = tmatcher.match_pairs_store(store, pairs, _config(), THRESH)
    assert set(got) == set(pairs)
    n_kept = 0
    for p in pairs:
        g = {int(r): int(c) for r, c in got[p]}
        w = {int(r): int(c) for r, c in want[p]}
        both = g.keys() & w.keys()
        union = g.keys() | w.keys()
        if union:
            assert len(both) >= 0.98 * len(union), (p, len(both), len(union))
        assert all(g[r] == w[r] for r in both), p
        n_kept += bool(w)
    assert n_kept >= len(pairs) // 2       # most pairs overlap and match


def test_slice_recovers_planted_homographies(mission):
    """The port's own detect and match: every along-track neighbour keeps
    matches, and ≥ 95% of all matches land within 2·thresh px of where
    the planted homography puts them."""
    frames, pairs, H_ij = mission
    dets = tsift.detect_finalize_batch(tsift.detect_dispatch(
        frames, max_features=MAX_FEATURES, equalize=True))
    for kp, meta, desc in dets:
        assert len(kp) > 200
        assert np.isfinite(kp).all() and np.isfinite(meta).all()
        assert desc.dtype == np.float32 and desc.shape == (len(kp), 128)
    store = DescriptorStore.from_arrays([d[2] for d in dets],
                                        [d[0] for d in dets], device="cpu")
    result = tmatcher.match_pairs_store(store, pairs, _config(), THRESH)
    n_in = n_all = 0
    for (i, j), m in result.items():
        assert m.dtype == np.int32 and m.ndim == 2 and m.shape[1] == 2
        if not len(m):
            continue
        assert len(m) >= 25                 # the min_pairs rule
        pa = dets[i][0][m[:, 0]].astype(np.float64)
        q = np.c_[pa, np.ones(len(pa))] @ H_ij(i, j).T
        err = np.linalg.norm(q[:, :2] / q[:, 2:] - dets[j][0][m[:, 1]],
                             axis=1)
        n_in += int((err < 2 * THRESH).sum())
        n_all += len(m)
    for i in (0, 2, 4):                     # along-track neighbours
        assert len(result[(i, i + 1)]) >= 50, (i, len(result[(i, i + 1)]))
    assert n_in >= 0.95 * n_all, (n_in, n_all)


def test_port_imports_no_jax():
    code = ("import sys, imageanalysis_tpu_torch.features.sift, "
            "imageanalysis_tpu_torch.match.matcher, "
            "imageanalysis_tpu_torch.match.worklist, "
            "imageanalysis_tpu_torch.match.smart, "
            "imageanalysis_tpu_torch.io.project, "
            "imageanalysis_tpu_torch.core.camera, "
            "imageanalysis_tpu_torch.testing.synthetic, "
            "imageanalysis_tpu_torch.io.jpeg, "
            "imageanalysis_tpu_torch.io.pose, "
            "imageanalysis_tpu_torch.surface.srtm, "
            "imageanalysis_tpu_torch.features.detect, "
            "imageanalysis_tpu_torch.render.build_map, "
            "imageanalysis_tpu_torch.render.ac3d, "
            "imageanalysis_tpu_torch.render.geotiff, "
            "imageanalysis_tpu_torch.render.histogram, "
            "imageanalysis_tpu_torch.render.texture, "
            "imageanalysis_tpu_torch.io.exif, "
            "imageanalysis_tpu_torch.io.camera_db, "
            "imageanalysis_tpu_torch.ops.essential5, "
            "imageanalysis_tpu_torch.ba.calibrate, "
            "imageanalysis_tpu_torch.apps.process; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'cv2' not in sys.modules and 'PIL' not in sys.modules; "
            "assert 'imageanalysis_tpu' not in sys.modules")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    pattern = re.compile(r"^\s*(import|from)\s+(jax|imageanalysis_tpu)\b",
                         re.M)
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    assert not pattern.search(fh.read()), f


def test_kernel_wrappers_raise_on_other_devices():
    """No silent fallback: a tensor that is neither on the CPU nor on a
    CUDA card reaches neither the kernel nor the plain version."""
    d = torch.empty((1, 64, 128), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="meta"):
        tknn.knn_packed_raw(d, d)
    f = torch.empty((1, 64, 128), dtype=torch.bfloat16, device="meta")
    n = torch.empty((1, 64), device="meta")
    with pytest.raises(ValueError, match="meta"):
        tknn.knn_packed_raw(f, f, n, n)
    with pytest.raises(ValueError, match="meta"):
        tknn.knn_wide_raw(f, f, n, n)
    img = torch.empty((1, 64, 64), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        tsift._blur(img, 1.6)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "CUDA_DEFAULT", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load()

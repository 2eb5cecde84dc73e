"""Port parity: the reference's mission generator, testing/synthetic.py.

The same seeds go through the JAX package's generator
(``imageanalysis_tpu/testing/synthetic.py``: OpenCV on the host) and the
port's (``cv_ground_texture``, ``cv_tiled_texture``, ``WorldTexture``,
``SyntheticMission`` in torch, here on the CPU):

- the textures within one gray level on every texel and equal on
  ≥ 99.99% of them (OpenCV's optimized INTER_CUBIC resize sums in an
  order of its own: a few texels in a million truncate the other way);
  the Gaussian blur bit for bit with cv2.GaussianBlur;
- WorldTexture's tile seeds (negative indices too), its first-in
  first-out cache and its patches (S equal, the texture within the
  textures' tolerance), and the reference's own
  test_world_texture_consistency assertions held on the port;
- SyntheticMission in single-texture mode (tests/test_torch_process.py's
  fixture: 8 frames of 320×240) and in world tiles
  (tests/test_e2e_pipeline.py::test_world_tiles_mission_end_to_end's 4
  frames of 640×480): pix4d.csv and camera_config() equal,
  world_to_image_H and true_camera_ned within 1e-12 relative,
  skip_existing rebuilding the same records without touching a frame,
  and the decoded JPEGs equal on ≥ 99.9% of pixels and within
  JPEG_LEVELS gray levels elsewhere (measured: the single-texture frames
  come out byte-equal, the world-tiles ones 2 levels apart at most);
- the slice as a whole: the port's process.main on the CPU over the
  port's world-tiles mission keeps its cameras within the reference
  test's 0.3 m mean of the truth.
"""

import filecmp
import os
import shutil

import cv2
import numpy as np
import pytest
import torch

from imageanalysis_tpu.testing import synthetic as jsynthetic
from imageanalysis_tpu_torch.apps import process as tprocess
from imageanalysis_tpu_torch.io import camera_db as tcamera_db
from imageanalysis_tpu_torch.io.project import ProjectMgr
from imageanalysis_tpu_torch.testing import synthetic as tsynthetic
from torch_threads import one_torch_thread  # noqa: F401

TEXEL_SHARE = 0.9999      # texels equal to the reference's
PIXEL_SHARE = 0.999       # decoded JPEG pixels equal
JPEG_LEVELS = 2           # gray levels apart elsewhere (measured: 2)

MISSIONS = {
    # tests/test_torch_process.py's fixture
    "texture": dict(n_images=8, img_size=(320, 240), altitude=100.0,
                    spacing=6.0, fx=280.0, seed=11, rows=2),
    # test_e2e_pipeline.py::test_world_tiles_mission_end_to_end
    "world_tiles": dict(n_images=4, img_size=(640, 480), altitude=90.0,
                        spacing=12.0, seed=3, texture_res=0.15,
                        world_tiles=True),
}


def _close(got, want, share=TEXEL_SHARE, levels=1):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max() <= levels, d.max()
    assert (d == 0).mean() >= share, (d == 0).mean()


# --- the textures -------------------------------------------------------

@pytest.mark.parametrize("kind, seed, size, period", [
    ("ground", 5, 448, None), ("ground", 1, 1707, None),
    ("tiled", 5, 448, 140), ("tiled", 3, 1000, 97)])
def test_textures_match_reference(kind, seed, size, period):
    """cv_ground_texture / cv_tiled_texture against make_ground_texture /
    make_tiled_texture from the same seed: one level at most, ≥ 99.99%
    equal; the generator's rng ends in the same state."""
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    if kind == "ground":
        want = jsynthetic.make_ground_texture(rj, size=size)
        got = tsynthetic.cv_ground_texture(rt, size, device="cpu")
    else:
        want = jsynthetic.make_tiled_texture(rj, size=size, period=period)
        got = tsynthetic.cv_tiled_texture(rt, size, period, device="cpu")
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    _close(got.numpy(), want)
    assert rj.integers(1 << 30) == rt.integers(1 << 30)


@pytest.mark.parametrize("sigma", [2.0, 1.5])
def test_blur_and_resize_follow_opencv(sigma):
    """cv_gaussian_blur is cv2.GaussianBlur(img, (0, 0), σ) bit for bit
    (cv2.getGaussianKernel's taps equal too); cv_resize_cubic is within
    2e-4 of cv2.resize INTER_CUBIC on 0..255 (summation order only)."""
    rng = np.random.default_rng(9)
    img = rng.uniform(0, 255, (203, 317)).astype(np.float32)
    taps = tsynthetic.cv_gaussian_taps(sigma)
    np.testing.assert_array_equal(
        taps, cv2.getGaussianKernel(len(taps), sigma, ktype=cv2.CV_32F)
        .ravel())
    np.testing.assert_array_equal(
        tsynthetic.cv_gaussian_blur(torch.from_numpy(img), sigma).numpy(),
        cv2.GaussianBlur(img, (0, 0), sigma))
    small = img[:23, :37].copy()
    want = cv2.resize(small, (317, 203), interpolation=cv2.INTER_CUBIC)
    got = tsynthetic.cv_resize_cubic(torch.from_numpy(small), (203, 317))
    assert np.abs(got.numpy() - want).max() <= 2e-4


# --- WorldTexture -----------------------------------------------------------

def test_world_texture_seeds_and_cache_follow_reference():
    """Tile seeds in Python integers equal the reference's numpy int64
    expression at negative and positive indices; after more tiles than the
    cache holds, both caches keep the same tiles in the same order."""
    seed = np.random.default_rng(42).integers(1 << 30)
    w = tsynthetic.WorldTexture(seed, res=4.0, tile_m=128.0, device="cpu")
    for ti in range(-40, 41, 7):
        for tj in range(-3000, 3001, 571):
            want = (seed * 1_000_003 + ti * 7919 + tj * 104729) & 0x7FFFFFFF
            assert w.tile_seed(ti, tj) == int(want)
    j = jsynthetic.WorldTexture(seed, res=4.0, tile_m=128.0)
    for ti in range(-3, 3):
        for tj in range(-2, 4):
            w.patch(ti * 128.0, tj * 128.0, ti * 128.0 + 1, tj * 128.0 + 1)
            j.patch(ti * 128.0, tj * 128.0, ti * 128.0 + 1, tj * 128.0 + 1)
    assert list(w._cache) == j._order and len(w._cache) == 32
    _close(np.stack([w._cache[key].numpy() for key in j._order]),
           np.stack([j._cache[key] for key in j._order]))


@pytest.mark.parametrize("rect", [(-10, -10, 100, 100), (-150, 30, -20, 220),
                                  (30, 30, 160, 160)])
def test_world_texture_patch_matches_reference(rect):
    """patch returns the reference's S exactly and its texture within the
    textures' tolerance."""
    w = tsynthetic.WorldTexture(seed=123, res=0.5, tile_m=64.0,
                                device="cpu")
    j = jsynthetic.WorldTexture(seed=123, res=0.5, tile_m=64.0)
    tex, S = w.patch(*rect)
    tex_j, S_j = j.patch(*rect)
    np.testing.assert_array_equal(S, S_j)
    assert tuple(tex.shape) == tex_j.shape
    _close(tex.numpy(), tex_j)


def test_world_texture_consistency_on_the_port():
    """tests/test_e2e_pipeline.py::test_world_texture_consistency's
    assertions, on the port's WorldTexture."""
    def world(seed):
        return tsynthetic.WorldTexture(seed=seed, res=0.5, tile_m=64.0,
                                       device="cpu")

    w1, w2 = world(123), world(123)
    t1, S1 = w1.patch(-10, -10, 100, 100)
    t2, S2 = w2.patch(-10, -10, 100, 100)
    assert torch.equal(t1, t2)
    t3, S3 = w1.patch(30, 30, 160, 160)

    def px_of(S, n, e):
        return (int(round((n - S[0, 2]) / S[0, 1])),
                int(round((e - S[1, 2]) / S[1, 0])))

    y1, x1 = px_of(S1, 64.0, 64.0)
    y3, x3 = px_of(S3, 64.0, 64.0)
    assert torch.equal(t1[y1:y1 + 50, x1:x1 + 50], t3[y3:y3 + 50, x3:x3 + 50])
    t4, _ = world(124).patch(-10, -10, 100, 100)
    assert (t4 != t1).float().mean() > 0.5


# --- SyntheticMission -------------------------------------------------------

@pytest.fixture(scope="module")
def missions(tmp_path_factory):
    """Each mode's mission written by both generators: {mode: (reference
    mission, port mission, reference dir, port dir)}."""
    root = tmp_path_factory.mktemp("missions")
    out = {}
    for mode, kw in MISSIONS.items():
        j_dir, t_dir = str(root / f"{mode}_j"), str(root / f"{mode}_t")
        jm = jsynthetic.SyntheticMission(j_dir, **kw)
        jm.generate()
        tm = tsynthetic.SyntheticMission(t_dir, device="cpu", **kw)
        tm.generate()
        out[mode] = (jm, tm, j_dir, t_dir)
    return out


@pytest.mark.parametrize("mode", list(MISSIONS))
def test_mission_records_match_reference(missions, mode):
    """pix4d.csv and camera_config() equal; every frame's
    world_to_image_H and the cameras' true_camera_ned in another NED
    reference within 1e-12 relative (they come out equal)."""
    jm, tm, j_dir, t_dir = missions[mode]
    assert filecmp.cmp(os.path.join(j_dir, "pix4d.csv"),
                       os.path.join(t_dir, "pix4d.csv"), shallow=False)
    assert tm.camera_config() == jm.camera_config()
    for (name, ned, ypr), (name_j, ned_j, ypr_j) in zip(tm.poses, jm.poses):
        assert name == name_j and ypr == ypr_j
        np.testing.assert_array_equal(ned, ned_j)
        np.testing.assert_array_equal(tm.camera_quat(ypr),
                                      jm.camera_quat(ypr_j))
        np.testing.assert_allclose(tm.world_to_image_H(ned, ypr),
                                   jm.world_to_image_H(ned_j, ypr_j),
                                   rtol=1e-12, atol=0)
    ref = (44.98, -93.25, 12.0)
    np.testing.assert_allclose(tm.true_camera_ned(ref),
                               jm.true_camera_ned(ref), rtol=1e-12, atol=0)
    np.testing.assert_array_equal(tm.true_camera_ned(), jm.true_camera_ned())


@pytest.mark.parametrize("mode", list(MISSIONS))
def test_mission_frames_match_reference(missions, mode):
    """Each decoded JPEG equals the reference's on ≥ 99.9% of its pixels
    and within JPEG_LEVELS elsewhere; 3-channel, B = G = R."""
    jm, tm, j_dir, t_dir = missions[mode]
    for name, _, _ in tm.poses:
        got = cv2.imread(os.path.join(t_dir, name), cv2.IMREAD_UNCHANGED)
        want = cv2.imread(os.path.join(j_dir, name), cv2.IMREAD_UNCHANGED)
        assert got.shape == want.shape == (tm.h, tm.w, 3)
        _close(got, want, PIXEL_SHARE, JPEG_LEVELS)


@pytest.mark.parametrize("mode", list(MISSIONS))
def test_skip_existing_rebuilds_the_same_records(missions, mode, tmp_path):
    """generate(skip_existing=True) over the written folder makes the same
    draws: the same records and pix4d.csv, every frame left as it was."""
    _, tm, _, t_dir = missions[mode]
    d = str(tmp_path / "again")
    shutil.copytree(t_dir, d)
    os.remove(os.path.join(d, "pix4d.csv"))
    stamps = {f: os.stat(os.path.join(d, f)).st_mtime_ns
              for f in os.listdir(d)}
    again = tsynthetic.SyntheticMission(d, device="cpu", **MISSIONS[mode])
    records = again.generate(skip_existing=True)
    assert [(n, list(ned), ypr) for n, ned, ypr in records] == \
        [(n, list(ned), ypr) for n, ned, ypr in tm.poses]
    assert filecmp.cmp(os.path.join(d, "pix4d.csv"),
                       os.path.join(t_dir, "pix4d.csv"), shallow=False)
    assert {f: os.stat(os.path.join(d, f)).st_mtime_ns
            for f in stamps} == stamps


def test_port_pipeline_on_world_tiles_mission(missions, tmp_path):
    """The slice: the port's process.main on the CPU, with
    test_world_tiles_mission_end_to_end's arguments, over the port's
    world-tiles mission keeps the cameras within 0.3 m mean of the
    truth."""
    _, tm, _, t_dir = missions["world_tiles"]
    proj_dir = str(tmp_path / "m")
    shutil.copytree(t_dir, proj_dir)
    db = str(tmp_path / "cams")
    tcamera_db.save("Synthetic_TestCam_none", tm.camera_config(), db)
    rc = tprocess.main([proj_dir, "--camera", "Synthetic_TestCam_none",
                        "--camera-db", db, "--scale", "1.0", "--ground",
                        "0.0", "--batch-size", "2", "--min-chain-len", "2"],
                       device="cpu")
    assert rc == 0
    proj = ProjectMgr(proj_dir)
    proj.load_images_info()
    true_ned = tm.true_camera_ned(proj.ned_reference_lla())
    errs = [np.linalg.norm(np.array(im.get_camera_pose(
        opt=im.has_opt_pose())[0]) - true_ned[i])
        for i, im in enumerate(proj.image_list)]
    assert np.mean(errs) < 0.3, errs

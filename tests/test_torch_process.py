"""Port parity: ``apps/process.py``'s Steps 1→5 from a folder of JPEGs.

The same inputs go through both packages on the CPU:

- Step 2 (pose files in both orders, the NED reference, camera poses,
  the SRTM terrain from .hgt tiles written here, or flat without them,
  and the smart state's srtm_surface_m): config.json, meta/*.json and
  smart.json equal within 1e-9 relative (they come out equal), less the
  float32 attitude, which each package computes with its own sin, cos
  and atan2 (``F32_ATTITUDE``);
- the detection load: ``load_scaled_gray`` bit-exact with the
  reference's at scales 1.0, 0.4 and 0.2 (the CPU path is PIL and cv2);
- the card's resize math (``io/jpeg.resize_linear``, ``resize_area``) on
  CPU tensors within ±1 gray level of cv2.resize at the slice's ratios;
- Step 5 (``render/build_map.build`` on one post-Step-4 workspace):
  surface.bin equal, egg vertices within 1e-3 m and uvs within 1e-5 (the
  grids before printing) with the same polygons, the same textures'
  names and sizes, the .ac files' words equal and their numbers within
  2e-3 (1e-3 m plus one printed unit);
- the pipeline as a whole (the reference's ``process.main --detector
  TPU``, the port's on the CPU) on one small JPEG mission rendered by the
  reference's SyntheticMission: Steps 1–2's outputs equal, groups equal,
  BA mre within 10%, camera positions within 0.5 m of each other and
  within tests/test_e2e_pipeline.py's 3 m of the truth; a second run of
  the port skips every stage;
- Step 5's ``--geotiff --histogram`` on that workspace in both packages:
  the mosaics' size, extent and TIFF tags equal, their pixels within one
  gray level on ≥ 99% of the covered pixels (mean |Δ| ≤ 0.25: the decode
  is the same cv2 on the CPU, the warp and feathering bit-exact with
  cv2's, so what differs is the f32 pose math under them), the
  histograms within the ±1 level of cv2.resize against the port's
  resize_linear, the templates likewise, and TextureManager.load_base
  through the same tables within two levels (CLAHE on V and HSV → BGR,
  tests/test_torch_render_extras.py; through each package's own tables
  the ±1 of a histogram moves the lookup table by more where the
  template is flat);
- the whole command from EXIF: the pipeline's frames tagged by the
  port's writer, no --camera and no pose file, reach STEP5 with the
  cameras within 3 m of the truth;
- the default detector (the host SIFT) runs Step 3a on the colour
  fixture; a run across hosts and BA over a mesh of cards raise
  NotImplementedError, and the card is never swapped for the CPU.
"""

import json
import os
import pickle
import re
import shutil

import cv2
import numpy as np
import pytest
import torch

from imageanalysis_tpu.apps import process as jprocess
from imageanalysis_tpu.features import detect as jdetect
from imageanalysis_tpu.io import camera_db as jcamera_db
from imageanalysis_tpu.io import pose as jpose
from imageanalysis_tpu.io import project as jproject
from imageanalysis_tpu.match import smart as jsmart
from imageanalysis_tpu.render import build_map as jbuild_map
from imageanalysis_tpu.render import histogram as jhistogram
from imageanalysis_tpu.render import texture as jtexture
from imageanalysis_tpu.surface import srtm as jsrtm
from imageanalysis_tpu.testing.synthetic import SyntheticMission
from imageanalysis_tpu_torch.apps import process as tprocess
from imageanalysis_tpu_torch.apps import stages as tstages
from imageanalysis_tpu_torch.features import detect as tdetect
from imageanalysis_tpu_torch.io import jpeg
from imageanalysis_tpu_torch.io import pose as tpose
from imageanalysis_tpu_torch.io import project as tproject
from imageanalysis_tpu_torch.match import smart as tsmart
from imageanalysis_tpu_torch.render import build_map as tbuild_map
from imageanalysis_tpu_torch.render import texture as ttexture
from imageanalysis_tpu_torch.surface import srtm as tsrtm
from imageanalysis_tpu_torch.testing import synthetic as tsynthetic

JPEG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "jpeg")
CAMERA = "Synthetic_TestCam_none"
SIZE = (320, 240)
N_IMAGES = 8          # two rows of four: one group needs 7 (groups.py)


# The attitude is float32 in both packages, through each one's own sin,
# cos and atan2 (quat_from_ypr, ypr_from_quat): quats within 2 float32
# ulp, and the camera's yaw, pitch and roll (read back from a quat 90°
# from level, where atan2 is ill-conditioned) within 2e-4 degrees
F32_ATTITUDE = {r"/quat\[\d\]$": 1.2e-7,
                r"/camera_pose/(yaw|pitch|roll)_deg$": 2e-4}


def _close_tree(a, b, rel=1e-9, path=""):
    """JSON trees equal, numbers within rel relative (1e-12 absolute),
    the float32 attitude within F32_ATTITUDE's absolute tolerances."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, a, b)
        for k in a:
            _close_tree(a[k], b[k], rel, f"{path}/{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _close_tree(x, y, rel, f"{path}[{i}]")
    elif isinstance(a, (int, float)) and not isinstance(a, bool):
        tol = rel * max(abs(a), abs(b)) + 1e-12
        for pattern, atol in F32_ATTITUDE.items():
            if re.search(pattern, path):
                tol = atol
        assert abs(a - b) <= tol, (path, a, b)
    else:
        assert a == b, (path, a, b)


def _json(path):
    with open(path) as f:
        return json.load(f)


# --- Step 2 ---------------------------------------------------------------

_REF = (44.995, -93.26)     # near a tile edge: the grid needs two tiles


def _write_tiles(cache):
    """N44W094 and N45W094 as SRTM3 .hgt from seeded numpy: smooth hills
    and a void (−32768), which the grid fills with the fallback."""
    rng = np.random.default_rng(3)
    y, x = np.mgrid[0:1201, 0:1201] / 1200.0
    for k, name in enumerate(("N44W094", "N45W094")):
        a, b = rng.uniform(2, 8, 2)
        elev = 250 + 40 * np.sin(a * x + k) * np.cos(b * y) + 5 * x * y
        elev = np.round(elev).astype(">i2")
        elev[1190:1201, 500:520] = -32768
        elev.tofile(os.path.join(cache, name + ".hgt"))


def _pose_project(root, order):
    """A folder of 8 (empty) JPEG names and a pose file in the given
    order: two rows, one image over max_angle, one row naming no file."""
    os.makedirs(root)
    rng = np.random.default_rng(11)
    rows = []
    for i in range(N_IMAGES):
        open(os.path.join(root, f"IMG_{i:04d}.jpg"), "wb").close()
        lat = _REF[0] + 0.0004 * (i % 4) + rng.normal(0, 1e-5)
        lon = _REF[1] + 0.0006 * (i // 4) + rng.normal(0, 1e-5)
        ypr = (rng.uniform(-180, 180), rng.normal(0, 3), rng.normal(0, 3))
        if i == 5:
            ypr = (ypr[0], 31.0, ypr[2])            # extreme attitude
        rows.append((f"IMG_{i:04d}.jpg", lat, lon, 300 + rng.normal(0, 2),
                     ypr))
    rows.append(("IMG_0099.jpg", _REF[0], _REF[1], 300.0, (0.0, 0.0, 0.0)))
    if order == "rpy":
        path = os.path.join(root, "pix4d.csv")
        lines = ["File Name,Lat,Lon,Alt,Roll,Pitch,Yaw"] + [
            f"{n},{la:.10f},{lo:.10f},{al:.2f},{r:.2f},{p:.2f},{y:.2f}"
            for n, la, lo, al, (y, p, r) in rows]
    else:
        path = os.path.join(root, "image-metadata.txt")
        lines = ["# File, lat, lon, alt, yaw, pitch, roll, time"] + [
            f"{n},{la:.10f},{lo:.10f},{al:.2f},{y:.2f},{p:.2f},{r:.2f},"
            f"{1000.0 + k}" for k, (n, la, lo, al, (y, p, r))
            in enumerate(rows)]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def _step2(pkg, proj_dir, posefile, order):
    """Step 2 as apps/process.py runs it, with pkg = (project, pose,
    srtm, smart) modules of one package."""
    project, pose, srtm, smart = pkg
    proj = project.ProjectMgr(proj_dir, create=True)
    proj.set_camera_config({
        "make": "Synthetic", "model": "TestCam", "K": [280.0, 0, 160, 0,
                                                       280.0, 120, 0, 0, 1],
        "dist_coeffs": [0.0] * 5, "width_px": 320, "height_px": 240,
        "mount": {"yaw_deg": 0.0, "pitch_deg": -90.0, "roll_deg": 0.0}})
    n = pose.set_aircraft_poses(proj, posefile, order=order)
    proj.load_images_info()
    proj.compute_ned_reference_lla()
    pose.compute_camera_poses(proj)
    kw = {} if srtm is jsrtm else {"device": "cpu"}
    terrain = srtm.project_terrain(proj, **kw)
    state = smart.SmartState(proj.analysis_dir)
    state.update_srtm_elevations(proj, terrain)
    state.save()
    proj.save()
    return n, terrain


@pytest.mark.parametrize("tiles", [True, False], ids=["srtm", "flat"])
@pytest.mark.parametrize("order", ["rpy", "ypr"])
def test_step2_matches_reference(tmp_path, monkeypatch, order, tiles):
    cache = tmp_path / "srtm"
    cache.mkdir()
    monkeypatch.setenv("SRTM_CACHE", str(cache))
    monkeypatch.setenv("HOME", str(tmp_path))     # no user tile cache
    if tiles:
        _write_tiles(str(cache))
    root = str(tmp_path / "j")
    posefile = _pose_project(root, order)
    shutil.copytree(root, str(tmp_path / "t"))
    posefile_t = posefile.replace(root, str(tmp_path / "t"))
    nj, tj = _step2((jproject, jpose, jsrtm, jsmart), root, posefile, order)
    nt, tt = _step2((tproject, tpose, tsrtm, tsmart), str(tmp_path / "t"),
                    posefile_t, order)
    assert nj == nt == N_IMAGES - 1
    assert tj.flat == tt.flat == (not tiles)
    np.testing.assert_array_equal(tt.grid, tj.grid)
    ia_j = os.path.join(root, "ImageAnalysis")
    ia_t = os.path.join(str(tmp_path / "t"), "ImageAnalysis")
    metas = sorted(os.listdir(os.path.join(ia_j, "meta")))
    assert metas == sorted(os.listdir(os.path.join(ia_t, "meta")))
    assert len(metas) == N_IMAGES - 1
    for f in metas + ["../config.json", "../smart.json"]:
        want = _json(os.path.join(ia_j, "meta", f))
        got = _json(os.path.join(ia_t, "meta", f))
        if f == "../config.json":
            for d in (want, got):
                d.pop("directories")
        _close_tree(got, want)
    # the device grid and its ray walk against the reference's
    ned = np.array([[10.0, -20.0, -300.0]])
    vec = np.array([[0.1, -0.2, 0.97], [0.0, 0.0, -1.0]])
    vec[0] /= np.linalg.norm(vec[0])
    want = np.asarray(tj.intersect_vectors(ned[0], vec))
    got = tt.intersect_vectors(ned[0], vec).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


# --- the detection load and the card's resize math ------------------------

@pytest.mark.parametrize("scale", [1.0, 0.4, 0.2])
@pytest.mark.parametrize("name", ["colour", "gray"])
def test_load_scaled_gray_bit_exact(name, scale):
    path = os.path.join(JPEG_DIR, f"{name}.jpg")
    want, want_size = jdetect.load_scaled_gray(path, scale, equalize=False)
    got, size = tdetect.load_scaled_gray(path, scale, "cpu")
    assert size == want_size
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


# (input W, H) → (output W, H): the detection load at 0.4 after the 1/2
# draft, the texture from a 1/2 decode and from a small frame (both axes
# grow), dummy.jpg from a full frame
_RATIOS = [((1088, 720), (870, 576)), ((1088, 720), (512, 512)),
           ((320, 240), (512, 512)), ((2176, 1440), (64, 64))]


@pytest.mark.parametrize("src,dst", _RATIOS,
                         ids=[f"{s[0]}to{d[0]}" for s, d in _RATIOS])
def test_resizes_within_one_level_of_cv2(src, dst):
    rng = np.random.default_rng(5)
    img = cv2.GaussianBlur(rng.integers(0, 256, (src[1], src[0], 3),
                                        dtype=np.uint8), (0, 0), 1.2)
    t = torch.from_numpy(img)
    area = jpeg.resize_area(t, dst).numpy()
    want = cv2.resize(img, dst, interpolation=cv2.INTER_AREA)
    assert area.shape == want.shape
    assert np.abs(area.astype(int) - want).max() <= 1
    fx, fy = dst[0] / src[0], dst[1] / src[1]
    lin = jpeg.resize_linear(t[..., 0], dst, (fx, fy)).numpy()
    want = cv2.resize(img[..., 0], (0, 0), fx=fx, fy=fy)
    assert lin.shape == want.shape
    assert np.abs(lin.astype(int) - want).max() <= 1


# --- the pipeline from JPEGs ------------------------------------------------

def _argv(proj_dir, db):
    return [proj_dir, "--camera", CAMERA, "--camera-db", db, "--scale",
            "1.0", "--ground", "0.0", "--batch-size", "8",
            "--min-chain-len", "2", "--detector", "TPU",
            "--max-features", "512"]


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    """One JPEG mission through both packages' process.main; returns the
    mission, both project dirs and the port's post-Step-4 snapshot."""
    root = tmp_path_factory.mktemp("pipeline")
    j_dir, t_dir = str(root / "j"), str(root / "t")
    m = SyntheticMission(j_dir, n_images=N_IMAGES, img_size=SIZE,
                         altitude=100.0, spacing=6.0, fx=280.0, seed=11,
                         rows=2)
    m.generate()
    db = str(root / "db")
    jcamera_db.save(CAMERA, m.camera_config(), db)
    shutil.copytree(j_dir, t_dir)
    assert jprocess.main(_argv(j_dir, db)) == 0
    assert tprocess.main(_argv(t_dir, db), device="cpu") == 0
    return m, j_dir, t_dir, db


def _ia(d):
    return os.path.join(d, "ImageAnalysis")


def test_pipeline_matches_reference(pipelines):
    m, j_dir, t_dir, _ = pipelines
    # Steps 1-2: config, poses and the terrain prior
    cj, ct = _json(os.path.join(_ia(j_dir), "config.json")), \
        _json(os.path.join(_ia(t_dir), "config.json"))
    for key in ("camera", "ned_reference", "detector", "matcher"):
        _close_tree(ct[key], cj[key])
    sj, st = _json(os.path.join(_ia(j_dir), "smart.json")), \
        _json(os.path.join(_ia(t_dir), "smart.json"))
    assert set(sj) == set(st)
    for name in sj:
        assert st[name]["srtm_surface_m"] == sj[name]["srtm_surface_m"]
    for f in sorted(os.listdir(os.path.join(_ia(j_dir), "meta"))):
        if not f.endswith(".json"):
            continue
        want = _json(os.path.join(_ia(j_dir), "meta", f))
        got = _json(os.path.join(_ia(t_dir), "meta", f))
        for key in ("aircraft_pose", "camera_pose", "width", "height"):
            _close_tree(got[key], want[key])
    # Steps 3-4: groups, BA, the recovered cameras
    gj, gt = _json(os.path.join(_ia(j_dir), "groups.json")), \
        _json(os.path.join(_ia(t_dir), "groups.json"))
    assert gt == gj and gj and len(gj[0]) >= 7

    def ba_mre(d):
        text = "".join(open(os.path.join(_ia(d), f)).read()
                       for f in os.listdir(_ia(d))
                       if f.startswith("messages-"))
        return float(re.findall(r"BA finished: mre=([\d.]+)px", text)[-1])

    mj, mt = ba_mre(j_dir), ba_mre(t_dir)
    assert abs(mt - mj) <= 0.1 * mj, (mt, mj)
    pj = jproject.ProjectMgr(j_dir)
    pj.load_images_info()
    pt = tproject.ProjectMgr(t_dir)
    pt.load_images_info()
    truth = m.true_camera_ned(ref_lla=pt.ned_reference_lla())
    for i, (a, b) in enumerate(zip(pj.image_list, pt.image_list)):
        assert a.name == b.name and b.has_opt_pose()
        na = np.asarray(a.get_camera_pose(opt=True)[0])
        nb = np.asarray(b.get_camera_pose(opt=True)[0])
        assert np.linalg.norm(nb - na) < 0.5, (a.name, na, nb)
        assert np.linalg.norm(nb - truth[i]) < 3.0, (a.name, nb, truth[i])
    # Step 5: the same kinds of files
    for ext in (".egg", ".JPG"):
        names = [sorted(f for f in os.listdir(os.path.join(_ia(d), "models"))
                        if f.endswith(ext)) for d in (j_dir, t_dir)]
        assert names[0] == names[1] and names[0]
    for f in ("surface.bin", "dummy.jpg", "surface-global.ac", "direct.ac"):
        assert os.path.isfile(os.path.join(_ia(t_dir), "models", f))


def test_resume_is_noop(pipelines, capsys, tmp_path):
    _, _, t_dir, db = pipelines
    capsys.readouterr()
    trace = str(tmp_path / "trace")
    assert tprocess.main(_argv(t_dir, db) + ["--trace", trace],
                         device="cpu") == 0
    out = capsys.readouterr().out
    assert "Step " not in out and "Pipeline complete" in out
    assert os.path.getsize(os.path.join(trace, "trace.json")) > 0


# --- Step 5 on one workspace ------------------------------------------------

def _polygons(path):
    return re.findall(r"<VertexRef> \{ (\d+) (\d+) (\d+) (\d+)",
                      open(path).read())


def _ac(path):
    """An .ac file's words, the numbers split out: (words, numbers)."""
    words, nums = [], []
    for w in open(path).read().split():
        try:
            nums.append(float(w))
        except ValueError:
            words.append(w)
    return words, np.array(nums)


def test_build_map_matches_reference(pipelines, tmp_path, monkeypatch):
    _, j_dir, _, _ = pipelines
    grids = {"j": {}, "t": {}}
    for side, mod in (("j", jbuild_map), ("t", tbuild_map)):
        def write_egg(path, grid_xyz, dist_uv, *a, _w=mod.write_egg,
                      _g=grids[side]):
            _g[os.path.basename(path)] = (np.array(grid_xyz, float),
                                          np.array(dist_uv, float), a[:2])
            return _w(path, grid_xyz, dist_uv, *a)
        monkeypatch.setattr(mod, "write_egg", write_egg)
    dirs = {}
    for side in ("j", "t"):
        d = str(tmp_path / side)
        shutil.copytree(j_dir, d)
        shutil.rmtree(os.path.join(_ia(d), "models"))
        dirs[side] = d
    results = {}
    for side, project, build_map in (("j", jproject, jbuild_map),
                                     ("t", tproject, tbuild_map)):
        proj = project.ProjectMgr(dirs[side])
        proj.load_images_info()
        grps = _json(os.path.join(_ia(dirs[side]), "groups.json"))
        kw = {"device": "cpu"} if side == "t" else {}
        results[side] = build_map.build(proj, proj.load_matches_grouped(),
                                        grps, **kw)
    assert results["t"] == results["j"] and results["j"]
    mj, mt = (os.path.join(_ia(dirs[s]), "models") for s in ("j", "t"))
    with open(os.path.join(mj, "surface.bin"), "rb") as f:
        want = pickle.load(f)
    with open(os.path.join(mt, "surface.bin"), "rb") as f:
        assert pickle.load(f) == want
    assert sorted(os.listdir(mt)) == sorted(os.listdir(mj))
    # the eggs: the same polygons; the grids before printing, vertices
    # within 1e-3 m and texture uv within 1e-5 px / size
    assert sorted(grids["t"]) == sorted(grids["j"]) and grids["j"]
    for name, (xyz, uv, wh) in grids["j"].items():
        xyz_t, uv_t, wh_t = grids["t"][name]
        assert wh_t == wh
        np.testing.assert_array_equal(np.isnan(xyz_t), np.isnan(xyz))
        np.testing.assert_allclose(xyz_t, xyz, rtol=0, atol=1e-3)
        np.testing.assert_allclose(uv_t / wh, uv / wh, rtol=0, atol=1e-5)
        assert _polygons(os.path.join(mt, name)) == \
            _polygons(os.path.join(mj, name))
    for name in os.listdir(mj):
        if name.lower().endswith(".jpg"):
            a = cv2.imread(os.path.join(mj, name))
            b = cv2.imread(os.path.join(mt, name))
            assert a.shape == b.shape, name
        elif name.endswith(".ac"):
            # the same words; the numbers (printed to 1e-3 m and 1e-5 uv)
            # within the grids' 1e-3 m plus one printed unit
            (wj, nj), (wt, nt) = (_ac(os.path.join(d, name))
                                  for d in (mj, mt))
            assert wt == wj and nt.shape == nj.shape
            np.testing.assert_allclose(nt, nj, rtol=0, atol=2e-3)


# --- Step 5's --geotiff and --histogram -------------------------------------

def _tiff(path):
    """(tags: the bytes before the pixel strip, (H, W, 3) BGR pixels)."""
    data = open(path, "rb").read()
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    return data[:len(data) - img.size], img


def _cdf_within_one_level(got, want):
    """A histogram of an image within ±1 level of another's: each level's
    cumulative share lies between the other's one level below and above."""
    g = np.cumsum(got) / np.sum(got)
    w = np.cumsum(want) / np.sum(want)
    lo = np.r_[0.0, w[:-1]] - 1e-9
    hi = np.r_[w[1:], 1.0] + 1e-9
    return bool(((g >= lo) & (g <= hi)).all())


def test_step5_geotiff_histogram_match_reference(pipelines, tmp_path):
    """--refresh STEP5 --geotiff --geotiff-res 0.5 --histogram in both
    packages, each on a copy of the reference's finished workspace."""
    _, j_dir, _, db = pipelines
    dirs = {}
    for side, main, kw in (("j", jprocess.main, {}),
                           ("t", tprocess.main, {"device": "cpu"})):
        d = str(tmp_path / side)
        shutil.copytree(j_dir, d)
        assert main(_argv(d, db) + ["--refresh", "STEP5", "--geotiff",
                                    "--geotiff-res", "0.5", "--histogram"],
                    **kw) == 0
        dirs[side] = d
    (tags_j, mj), (tags_t, mt) = (
        _tiff(os.path.join(_ia(dirs[s]), "models", "mosaic.tif"))
        for s in ("j", "t"))
    assert mt.shape == mj.shape and tags_t == tags_j
    assert os.path.isfile(os.path.join(_ia(dirs["t"]), "models",
                                       "gdalscript.sh"))
    covered = (mj > 0).any(-1) | (mt > 0).any(-1)
    diff = np.abs(mt.astype(int) - mj)[covered]
    assert covered.mean() > 0.3
    assert (diff.max(-1) <= 1).mean() >= 0.99 and diff.mean() <= 0.25
    hj, tj = jhistogram.load(_ia(dirs["j"]))
    ht, tt = jhistogram.load(_ia(dirs["t"]))
    assert sorted(ht) == sorted(hj) == sorted(tt) == sorted(tj)
    for name in hj:
        for c in range(3):
            assert ht[name][c].dtype == np.float32
            assert ht[name][c].sum() == hj[name][c].sum()
            assert _cdf_within_one_level(ht[name][c], hj[name][c])
            q = np.r_[0.0, tj[name][c]]
            assert ((tt[name][c] >= q[:-1] - 1e-6)
                    & (tt[name][c] <= np.r_[q[2:], 1.0] + 1e-6)).all()
    # a texture through the same tables (the reference's pickle in both)
    shutil.copy(os.path.join(_ia(dirs["j"]), "histogram.pickle"),
                os.path.join(_ia(dirs["t"]), "histogram.pickle"))
    name = sorted(hj)[0]
    want = jtexture.TextureManager(
        jproject.ProjectMgr(dirs["j"])).load_base(name)
    got = ttexture.TextureManager(tproject.ProjectMgr(dirs["t"]),
                                  device="cpu").load_base(name)
    assert got.shape == want.shape
    assert np.abs(got.numpy().astype(int) - want).max() <= 2


def test_pipeline_from_exif(pipelines, tmp_path):
    """The pipeline's frames, tagged by the port's writer from its
    pix4d.csv (GPS, DateTime, the camera's Make/Model/Lens and focal
    length, the attitude as DJI XMP), without the pose file and without
    --camera: Step 1 finds Synthetic_TestCam_none by EXIF, Step 2 writes
    pix4d.csv (its rows equal the original within its own rounding), and
    the run reaches STEP5 with every camera within 3 m of the truth."""
    m, j_dir, _, db = pipelines
    d = str(tmp_path / "exif")
    os.makedirs(d)
    rows = [ln.split(",") for ln in
            open(os.path.join(j_dir, "pix4d.csv")).read().splitlines()[1:]]
    for i, row in enumerate(rows):
        path = os.path.join(d, row[0])
        shutil.copy(os.path.join(j_dir, row[0]), path)
        lat, lon, alt, roll, pitch, yaw = (float(v) for v in row[1:])
        tsynthetic.tag_frame(path, (lat, lon, alt), (yaw, pitch, roll),
                             m.fx, 1.6e9 + i)
    argv = _argv(d, db)
    argv.remove("--camera")
    argv.remove(CAMERA)
    assert tprocess.main(argv, device="cpu") == 0
    got = [ln.split(",") for ln in
           open(os.path.join(d, "pix4d.csv")).read().splitlines()[1:]]
    for a, b in zip(got, rows):
        assert a[0] == b[0]
        assert np.allclose([float(v) for v in a[1:3]],
                           [float(v) for v in b[1:3]], atol=3e-8)
        assert a[3:6] == b[3:6]
        assert (float(a[6]) - float(b[6])) % 360.0 == 0.0
    proj = tproject.ProjectMgr(d)
    assert proj.camera.get("model") == "TestCam" and proj.state.check("STEP5")
    proj.load_images_info()
    truth = m.true_camera_ned(ref_lla=proj.ned_reference_lla())
    for i, im in enumerate(proj.image_list):
        ned = np.asarray(im.get_camera_pose(opt=True)[0])
        assert np.linalg.norm(ned - truth[i]) < 3.0, (im.name, ned)


# --- what the port does not run -------------------------------------------

@pytest.fixture
def tiny_project(tmp_path):
    """Two copies of the colour fixture and a camera DB entry."""
    d = tmp_path / "p"
    d.mkdir()
    for i in range(2):
        shutil.copy(os.path.join(JPEG_DIR, "colour.jpg"),
                    d / f"IMG_{i:04d}.jpg")
    db = str(tmp_path / "db")
    jcamera_db.save(CAMERA, {"K": [300.0, 0, 201, 0, 300.0, 149, 0, 0, 1],
                             "width_px": 402, "height_px": 298}, db)
    return str(d), db


def test_unported_paths_raise(tiny_project, monkeypatch):
    """The default detector (the reference's host SIFT) now runs: Step 3a
    caches 128-value SIFT descriptors and a match list. A run across
    hosts still raises, and so does the stage script's BA over a mesh of
    two cards."""
    d, db = tiny_project
    with open(os.path.join(d, "pix4d.csv"), "w") as f:
        f.write("File Name,Lat,Lon,Alt,Roll,Pitch,Yaw\n" + "".join(
            f"IMG_{i:04d}.jpg,44.97,{-93.26 + 1e-4 * i},100,0,0,0\n"
            for i in range(2)))
    tprocess.main([d, "--camera", CAMERA, "--camera-db", db, "--ground", "0",
                   "--scale", "1.0"], device="cpu")      # the cv backend
    proj = tproject.ProjectMgr(d)
    proj.load_images_info()
    assert proj.state.check("STEP3a")
    assert proj.config.node("detector").get("backend") == "cv"
    for im in proj.image_list:
        assert im.load_features() and im.load_descriptors()
        assert len(im.kp) > 100 and im.des.shape == (len(im.kp), 128)
        assert im.load_matches() and len(im.match_list) == 1
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="across hosts"):
        tprocess.main([d, "--detector", "TPU"], device="cpu")
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.raises(NotImplementedError, match="queue 1 item 2"):
        tstages.main(["optimize", d, "--mesh", "2"], device="cpu")


def test_main_needs_the_card_unless_the_cpu_is_asked(tiny_project,
                                                     monkeypatch):
    d, _ = tiny_project
    monkeypatch.delenv("IMGTPU_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="IMGTPU_PLATFORM=cpu"):
        tprocess.main([d])
    monkeypatch.setenv("IMGTPU_PLATFORM", "cpu")
    with pytest.raises(NotImplementedError):        # reached the CPU run
        tprocess.main([d])

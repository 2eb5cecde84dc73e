"""Port parity: the OpenCV detectors, the stage scripts, the culls, smart's
per-pair estimators and the GMS filter.

The same inputs go through both packages on the CPU, on one small JPEG
mission rendered by the reference's SyntheticMission (8 frames of
320×240, two rows):

- the cv backend (``--detector SIFT|ORB``): each package's
  detect_project_features caches the same keypoints and descriptors, bit
  for bit, under the same cv2 (SIFT at the reference's scale 0.4 through
  PIL's draft, ORB at 1.0 through cv2.imread; ORB's bits unpacked to 256
  values of 0/1);
- process.main with no --detector flag (the reference's default, SIFT on
  the host) in both packages: groups equal, BA mre within 10%, cameras
  within 0.5 m of each other and 3 m of the truth (the pipeline
  tolerances of tests/test_torch_process.py); the port's ORB run reaches
  STEP5 with 256-value descriptors and its cameras within 3 m;
- the stage scripts (create-project … render, the host SIFT) in both
  packages: the same tolerances against each other and against the
  port's process.main, and process.main resumes after them with nothing
  to do;
- the culls on the staged workspace: compute_errors within 1e-3 px, and
  every subcommand's resulting matches_grouped equal to the reference's;
- smart's per-pair estimators on the staged workspace's pairs, and
  gms_filter on tests/test_smart_gms_cull.py's case.
"""

import os
import re
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageanalysis_tpu.apps import cull as jcull
from imageanalysis_tpu.apps import process as jprocess
from imageanalysis_tpu.apps import stages as jstages
from imageanalysis_tpu.features import detect as jdetect
from imageanalysis_tpu.io import camera_db as jcamera_db
from imageanalysis_tpu.io import project as jproject
from imageanalysis_tpu.match import smart as jsmart
from imageanalysis_tpu.ops import gms as jgms
from imageanalysis_tpu.testing.synthetic import SyntheticMission
from imageanalysis_tpu_torch.apps import cull as tcull
from imageanalysis_tpu_torch.apps import process as tprocess
from imageanalysis_tpu_torch.apps import stages as tstages
from imageanalysis_tpu_torch.features import detect as tdetect
from imageanalysis_tpu_torch.io import project as tproject
from imageanalysis_tpu_torch.match import smart as tsmart
from imageanalysis_tpu_torch.ops import gms as tgms

CAMERA = "Synthetic_TestCam_none"


@pytest.fixture(scope="module")
def mission(tmp_path_factory):
    """The mission's JPEGs and pix4d.csv, and a camera DB."""
    root = tmp_path_factory.mktemp("stages")
    src = str(root / "src")
    m = SyntheticMission(src, n_images=8, img_size=(320, 240),
                         altitude=100.0, spacing=6.0, fx=280.0, seed=11,
                         rows=2)
    m.generate()
    db = str(root / "db")
    jcamera_db.save(CAMERA, m.camera_config(), db)
    return m, src, db, root


def _copy(mission, name):
    _, src, _, root = mission
    d = str(root / name)
    shutil.copytree(src, d, ignore=shutil.ignore_patterns("ImageAnalysis"))
    return d


def _process_argv(d, db, *extra):
    return [d, "--camera", CAMERA, "--camera-db", db, "--scale", "1.0",
            "--ground", "0.0", "--batch-size", "8", "--min-chain-len", "2",
            *extra]


def _stage_argvs(d, db):
    return [["create-project", d],
            ["set-camera", d, "--camera", CAMERA, "--camera-db", db],
            ["set-poses", d],
            ["matching", d, "--scale", "1.0", "--batch-size", "8",
             "--max-features", "512"],
            ["clean", d],
            ["triangulate", d, "--method", "ground", "--ground", "0"],
            ["groups", d, "--min-chain-len", "2"],
            ["optimize", d],
            ["render", d]]


@pytest.fixture(scope="module")
def runs(mission):
    """process.main with the default detector and the stage scripts, each
    in both packages: {name: project dir}."""
    _, _, db, _ = mission
    out = {k: _copy(mission, k) for k in ("j_proc", "t_proc", "j_st",
                                          "t_st")}
    feats = ("--max-features", "512")
    assert jprocess.main(_process_argv(out["j_proc"], db, *feats)) == 0
    assert tprocess.main(_process_argv(out["t_proc"], db, *feats),
                         device="cpu") == 0
    for argv in _stage_argvs(out["j_st"], db):
        assert jstages.main(argv) == 0, argv
    for argv in _stage_argvs(out["t_st"], db):
        assert tstages.main(argv, device="cpu") == 0, argv
    return out


def _projects(d):
    pj, pt = jproject.ProjectMgr(d), tproject.ProjectMgr(d)
    pj.load_images_info()
    pt.load_images_info()
    return pj, pt


def _ba_mre(d):
    text = "".join(open(os.path.join(d, "ImageAnalysis", f)).read()
                   for f in os.listdir(os.path.join(d, "ImageAnalysis"))
                   if f.startswith("messages-"))
    return float(re.findall(r"BA finished: mre=([\d.]+)px", text)[-1])


def _cameras(d):
    proj = tproject.ProjectMgr(d)
    proj.load_images_info()
    return proj, np.array([im.get_camera_pose(opt=True)[0]
                           for im in proj.image_list])


def _same_outcome(m, got, want):
    """The pipeline tolerances: groups equal, BA mre within 10%, cameras
    within 0.5 m of each other and 3 m of the truth."""
    with open(os.path.join(got, "ImageAnalysis", "groups.json")) as f:
        g = f.read()
    with open(os.path.join(want, "ImageAnalysis", "groups.json")) as f:
        assert g == f.read()
    mg, mw = _ba_mre(got), _ba_mre(want)
    assert abs(mg - mw) <= 0.1 * mw, (mg, mw)
    proj, cg = _cameras(got)
    _, cw = _cameras(want)
    assert np.linalg.norm(cg - cw, axis=1).max() < 0.5
    truth = m.true_camera_ned(ref_lla=proj.ned_reference_lla())
    assert np.linalg.norm(cg - truth, axis=1).max() < 3.0
    assert proj.state.check("STEP5")


@pytest.mark.parametrize("detector,scale", [("SIFT", 0.4), ("ORB", 1.0)])
def test_cv_features_match_reference(mission, detector, scale):
    """Both packages' cv backend over one workspace's frames: every
    image's keypoints, their size/angle/response/octave and descriptors
    bit for bit; and detect() on one frame."""
    _, _, db, _ = mission
    dj = _copy(mission, f"feat_j_{detector}")
    for argv in _stage_argvs(dj, db)[:3]:
        assert tstages.main(argv, device="cpu") == 0
    dt = _copy(mission, f"feat_t_{detector}")
    shutil.copytree(os.path.join(dj, "ImageAnalysis"),
                    os.path.join(dt, "ImageAnalysis"))
    pj, _ = _projects(dj)
    _, pt = _projects(dt)
    jdetect.detect_project_features(
        pj, jdetect.DetectorConfig(detector=detector, scale=scale),
        progress=False)
    tdetect.detect_project_features(
        pt, tdetect.DetectorConfig(detector=detector, scale=scale),
        device="cpu")
    width = 128 if detector == "SIFT" else 256
    pj, _ = _projects(dj)
    _, pt = _projects(dt)
    for a, b in zip(pj.image_list, pt.image_list):
        assert a.load_features() and a.load_descriptors()
        assert b.load_features() and b.load_descriptors()
        assert len(b.kp) > 20 and b.des.shape == (len(b.kp), width)
        np.testing.assert_array_equal(b.kp, a.kp)
        np.testing.assert_array_equal(b.kp_meta, a.kp_meta)
        np.testing.assert_array_equal(b.des, a.des)
    if detector == "ORB":
        assert set(np.unique(b.des)) <= {0.0, 1.0}
    # detect() on one full-resolution frame: the same arrays
    gray = jdetect.load_gray(os.path.join(dj, pt.image_list[0].name + ".jpg"))
    cfg = dict(detector=detector, scale=0.5)
    for g, w in zip(tdetect.detect(gray, tdetect.DetectorConfig(**cfg)),
                    jdetect.detect(gray, jdetect.DetectorConfig(**cfg))):
        np.testing.assert_array_equal(g, w)


def test_process_default_detector_matches_reference(mission, runs):
    """process.main with no --detector flag runs the reference's host SIFT
    in both packages, Steps 1 → 5, with the same outcome."""
    m = mission[0]
    _same_outcome(m, runs["t_proc"], runs["j_proc"])
    proj = tproject.ProjectMgr(runs["t_proc"])
    assert proj.config.node("detector").get("backend") == "cv"
    assert proj.config.node("detector").get("detector") == "SIFT"


def test_process_orb_reaches_step5(mission):
    """--detector ORB: 256-value descriptors through the matcher's float
    path (K1's plain version at 256), Steps 1 → 5, cameras within 3 m of
    the truth."""
    m, _, db, _ = mission
    d = _copy(mission, "orb")
    assert tprocess.main(_process_argv(d, db, "--detector", "ORB",
                                       "--max-features", "1000"),
                         device="cpu") == 0
    proj, cams = _cameras(d)
    assert proj.state.check("STEP5")
    proj.image_list[0].load_descriptors()
    assert proj.image_list[0].des.shape[1] == 256
    truth = m.true_camera_ned(ref_lla=proj.ned_reference_lla())
    assert np.linalg.norm(cams - truth, axis=1).max() < 3.0
    assert _ba_mre(d) <= 1.0


def test_stages_match_reference_and_process(mission, runs, capsys):
    """The stage scripts: the port's equal the reference's and the port's
    process.main within the pipeline tolerances; process.main resumes
    after them with every stage done."""
    m = mission[0]
    _same_outcome(m, runs["t_st"], runs["j_st"])
    _same_outcome(m, runs["t_st"], runs["t_proc"])
    models = os.path.join(runs["t_st"], "ImageAnalysis", "models")
    for f in ("surface.bin", "surface-global.ac", "direct.ac"):
        assert os.path.isfile(os.path.join(models, f))
    capsys.readouterr()
    assert tprocess.main(_process_argv(runs["t_st"], mission[2]),
                         device="cpu") == 0
    assert "Step " not in capsys.readouterr().out


def test_stages_and_cull_help_exit_zero(capsys):
    for main in (tstages.main, tcull.main):
        with pytest.raises(SystemExit) as e:
            main(["--help"], device="cpu")
        assert e.value.code == 0
    assert "create-project" in capsys.readouterr().out


def test_compute_errors_match_reference(runs):
    """compute_errors on the staged workspace: the same observations,
    errors within 1e-3 px, the same per-image report."""
    pj, pt = _projects(runs["t_st"])
    matches = pt.load_matches_grouped()
    ej, ij = jcull.compute_errors(pj, pj.load_matches_grouped())
    et, it = tcull.compute_errors(pt, matches, device="cpu")
    assert it == ij and len(it) > 1000
    np.testing.assert_allclose(et, ej, atol=1e-3)
    rows_j = jcull.report_by_image(pj, ej, ij, matches)
    rows_t = tcull.report_by_image(pt, et, it, matches)
    assert [r[0] for r in rows_t] == [r[0] for r in rows_j]
    np.testing.assert_allclose([r[1:] for r in rows_t],
                               [r[1:] for r in rows_j], atol=1e-3)


# every subcommand, at thresholds that mark something on the clean
# synthetic workspace
CULLS = {
    "mre": ["mre", "--stddev", "2"],
    "mre-robust-strong": ["mre", "--stddev", "3", "--robust", "--strong"],
    "colocated": ["colocated", "--min-angle", "6"],
    "remove-image": ["remove-image", "IMG_0003"],
    "depth": ["depth", "--stddev", "1"],
    "movers": ["movers", "--angle", "6"],
    "colocated-cams": ["colocated-cams", "--avg", "5"],
    "surface": ["surface", "--stddev", "2"],
}


@pytest.mark.parametrize("name", list(CULLS))
def test_cull_matches_reference(runs, mission, name):
    """Each cull subcommand on a copy of the staged workspace in each
    package: the same chains removed (matches_grouped equal) and STEP4
    cleared."""
    out = {}
    for pkg, main in (("j", jcull.main),
                      ("t", lambda a: tcull.main(a, device="cpu"))):
        d = str(mission[3] / f"cull_{name}_{pkg}")
        shutil.copytree(runs["t_st"], d)
        assert main([d, *CULLS[name]]) == 0
        proj = tproject.ProjectMgr(d)
        out[pkg] = proj.load_matches_grouped()
        assert not proj.state.check("STEP4")
    assert out["t"] == out["j"]
    assert out["t"] != tproject.ProjectMgr(runs["t_st"]).load_matches_grouped()


def test_smart_estimators_match_reference(runs):
    """triangulate_pair, estimate_surface_elevation, estimate_yaw_error
    and update_pair on the staged workspace's matched pairs: points within
    1e-3 m, elevations and yaw within 1e-3, smart.json's records within
    their rounding step."""
    pj, pt = _projects(runs["t_st"])
    for p in (pj, pt):
        for im in p.image_list:
            im.load_features()
            im.load_matches()
    sj = jsmart.SmartState(str(runs["t_st"]) + "/j_smart")
    st = tsmart.SmartState(str(runs["t_st"]) + "/t_smart")
    n = 0
    for (a1, b1) in zip(pj.image_list, pt.image_list):
        for (a2, b2) in zip(pj.image_list, pt.image_list):
            if a1.name >= a2.name or not len(a1.match_list.get(a2.name,
                                                            ())):
                continue
            n += 1
            pw = jsmart.triangulate_pair(pj, a1, a2)
            pg = tsmart.triangulate_pair(pt, b1, b2, device="cpu")
            np.testing.assert_allclose(pg, pw, atol=1e-3)
            ew = jsmart.estimate_surface_elevation(pj, a1, a2)
            eg = tsmart.estimate_surface_elevation(pt, b1, b2, device="cpu")
            np.testing.assert_allclose(eg, ew, atol=1e-3)
            yw = jsmart.estimate_yaw_error(pj, a1, a2)
            yg = tsmart.estimate_yaw_error(pt, b1, b2, device="cpu")
            np.testing.assert_allclose(yg, yw, rtol=1e-4, atol=1e-3)
            jsmart.update_pair(pj, sj, a1, a2)
            tsmart.update_pair(pt, st, b1, b2, device="cpu")
    assert n >= 10
    # smart.json rounds to 0.1: the f32 fits, summed in another order, may
    # round a value on the boundary to the next step
    assert st.data.keys() == sj.data.keys()
    for name in sj.data:
        for key in ("tri_surface_pairs", "yaw_pairs"):
            got, want = st.data[name].get(key, {}), sj.data[name].get(key, {})
            assert got.keys() == want.keys()
            for other in want:
                for field, w in want[other].items():
                    assert abs(got[other][field] - w) <= 0.1 + 1e-9, (
                        name, key, other, field)
        for key in ("tri_surface_m", "yaw_error"):
            assert abs(st.data[name].get(key, 0.0)
                       - sj.data[name].get(key, 0.0)) <= 0.1 + 1e-9


def test_gms_filter_matches_reference(rng):
    """tests/test_smart_gms_cull.py's case: a coherent cluster and
    scattered false matches; the port's survivors equal the reference's,
    and GMS keeps the cluster and drops the scatter."""
    n_good, n_bad, npad = 600, 120, 1024
    uv_a = np.zeros((npad, 2), np.float32)
    uv_b = np.zeros((npad, 2), np.float32)
    valid = np.zeros(npad, bool)
    uv_a[:n_good] = rng.uniform([0, 0], [2000, 1500], (n_good, 2))
    uv_b[:n_good] = uv_a[:n_good] + np.array([120.0, -60.0]) \
        + rng.normal(0, 2, (n_good, 2))
    uv_a[n_good:n_good + n_bad] = rng.uniform([0, 0], [2000, 1500],
                                              (n_bad, 2))
    uv_b[n_good:n_good + n_bad] = rng.uniform([0, 0], [2000, 1500],
                                              (n_bad, 2))
    valid[:n_good + n_bad] = True
    wh = [2000.0, 1500.0]
    want = np.asarray(jgms.gms_filter(jnp.asarray(uv_a), jnp.asarray(uv_b),
                                      jnp.asarray(valid), jnp.asarray(wh),
                                      jnp.asarray(wh)))
    got = tgms.gms_filter(torch.from_numpy(uv_a), torch.from_numpy(uv_b),
                          torch.from_numpy(valid), wh, wh).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[:n_good].mean() > 0.85
    assert got[n_good:n_good + n_bad].mean() < 0.25
    assert not got[n_good + n_bad:].any()

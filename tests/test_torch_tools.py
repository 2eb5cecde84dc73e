"""Port parity: the tools that come after a run.

``apps/utils.py``, ``apps/inspect.py``, ``apps/zooniverse.py``,
``apps/explorer.py``, ``render/annotations.py`` and
``surface/coverage.py`` of both packages on copies of one processed
mission: the reference's SyntheticMission (3 frames at 640×480) through
the reference's ``process.main`` with ``--histogram``, as
tests/test_utils_inspect.py's ``util_mission``. Each test copies it twice
and runs the reference on one copy and the port (``device="cpu"``) on
the other. Tolerances:

- coverage and annotations equal, the json, csv and kml byte-equal;
- the inspect PNGs byte-equal and the printed logs equal (the copies'
  paths replaced);
- ``ReviewSession``: the items in the same order (by-image errors within
  1e-3 px), the .match files equal after ``apply`` by pairs; by image
  the port diverges on purpose (it keeps the dropped image's partners'
  other pairs, which the reference's ``apply`` empties), and the case
  states both results;
- ``preview-crops``: the crops and index.html equal;
- ``est-cam-transform``: every printed number within 0.01;
- ``histogram``: the tables within the ±1 level of tests/
  test_torch_process.py (cv2.resize against the port's resize_linear);
- ``vignette``, ``zip``, ``merge``, ``calibrate``, the renumber tools,
  ``capture-dates``, ``wx-report``, ``import-info``, ``new-camera`` and
  ``trim-far``: outputs equal;
- ``chop``: the manifest and the tiles byte-equal; ``paste``: the markers
  within 1e-3 m;
- the explorer: ``select_top`` equal, ``get_elevation`` within 1e-6,
  ``_warp_full`` (the same textures: the reference's tables, no display
  filter) ≤ 0.1% of pixels differing with the extent equal, and
  ``render_to``'s drawn count equal.

One case holds a reference quirk that the port copies: ``utils
vignette`` writes ``ImageAnalysis/vignette.png`` while ``TextureManager``
reads ``vignette-mask.jpg``, so the explorer never applies the mask.
"""

import csv
import json
import os
import pickle
import re
import shutil
import zipfile

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from imageanalysis_tpu.apps import explorer as jexplorer  # noqa: E402
from imageanalysis_tpu.apps import inspect as jinspect  # noqa: E402
from imageanalysis_tpu.apps import utils as jutils  # noqa: E402
from imageanalysis_tpu.apps import zooniverse as jzoo  # noqa: E402
from imageanalysis_tpu.io.project import ProjectMgr as JProject  # noqa: E402
from imageanalysis_tpu.render import histogram as jhistogram  # noqa: E402
from imageanalysis_tpu.render import texture as jtexture  # noqa: E402
from imageanalysis_tpu.render.annotations import (  # noqa: E402
    Annotations as JAnnotations)
from imageanalysis_tpu.surface import coverage as jcoverage  # noqa: E402
from imageanalysis_tpu_torch.apps import explorer as texplorer  # noqa: E402
from imageanalysis_tpu_torch.apps import inspect as tinspect  # noqa: E402
from imageanalysis_tpu_torch.apps import utils as tutils  # noqa: E402
from imageanalysis_tpu_torch.apps import zooniverse as tzoo  # noqa: E402
from imageanalysis_tpu_torch.core import geodesy  # noqa: E402
from imageanalysis_tpu_torch.io.project import (  # noqa: E402
    ProjectMgr as TProject)
from imageanalysis_tpu_torch.render import texture as ttexture  # noqa: E402
from imageanalysis_tpu_torch.render.annotations import (  # noqa: E402
    Annotations as TAnnotations)
from imageanalysis_tpu_torch.surface import coverage as tcoverage  # noqa: E402
from imageanalysis_tpu_torch.testing.synthetic import tag_frame  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

CPU = {"device": "cpu"}


@pytest.fixture(scope="module")
def mission(tmp_path_factory):
    """The reference's processed 3-frame mission, with its histogram
    tables."""
    from imageanalysis_tpu.apps import process
    from imageanalysis_tpu.io import camera_db
    from imageanalysis_tpu.testing.synthetic import SyntheticMission

    proj_dir = str(tmp_path_factory.mktemp("tools") / "m")
    m = SyntheticMission(proj_dir, n_images=3, img_size=(640, 480),
                         altitude=90.0, spacing=12.0, seed=6)
    m.generate()
    db = str(tmp_path_factory.mktemp("cams"))
    camera_db.save("Synthetic_TestCam_none", m.camera_config(), db)
    rc = process.main([proj_dir, "--camera", "Synthetic_TestCam_none",
                       "--camera-db", db, "--scale", "1.0", "--ground", "0.0",
                       "--batch-size", "2", "--min-chain-len", "2",
                       "--histogram"])
    assert rc == 0
    return proj_dir


def _copies(mission, tmp_path):
    """(reference's copy, port's copy) of the mission."""
    out = []
    for side in ("jax", "torch"):
        dst = str(tmp_path / side)
        shutil.copytree(mission, dst)
        out.append(dst)
    return out


def _run(capsys, j_call, t_call, jd, td):
    """Run both sides; their printed output with each copy's path
    replaced, and their return values."""
    capsys.readouterr()
    rj = j_call()
    out_j = capsys.readouterr().out.replace(jd, "<P>")
    rt = t_call()
    out_t = capsys.readouterr().out.replace(td, "<P>")
    return (rj, out_j), (rt, out_t)


def _ia(d):
    return os.path.join(d, "ImageAnalysis")


def _match_files(d):
    """{file: its match dict} of a workspace's .match files."""
    out = {}
    meta = os.path.join(_ia(d), "meta")
    for f in sorted(os.listdir(meta)):
        if f.endswith(".match"):
            with open(os.path.join(meta, f), "rb") as fh:
                out[f] = {k: np.asarray(v).tolist()
                          for k, v in pickle.load(fh).items()}
    return out


# --- coverage and annotations ----------------------------------------------

def test_coverage_equals_reference(mission):
    """Coverage rects from the models' grids, their union, the images
    covering the mission's centre and the rects' lla: equal."""
    ex = jexplorer.Explorer(mission)
    names = ex._model_names()
    rects = {}
    for mod, side in ((jcoverage, "j"), (tcoverage, "t")):
        rects[side] = {n: mod.image_coverage(ex._grid(n)[0]) for n in names}
    assert rects["t"] == rects["j"] and len(names) == 3
    union = tcoverage.coverage_union(list(rects["t"].values()))
    assert union == jcoverage.coverage_union(list(rects["j"].values()))
    e, n = 0.5 * (union[0] + union[2]), 0.5 * (union[1] + union[3])
    hits = tcoverage.images_covering_point(rects["t"], e, n)
    assert hits and hits == jcoverage.images_covering_point(rects["j"], e, n)
    ref = JProject(mission).ned_reference_lla()
    for name in names:
        assert (tcoverage.coverage_lla(rects["t"][name], ref)
                == jcoverage.coverage_lla(rects["j"][name], ref))


def test_annotations_files_byte_equal(mission, tmp_path):
    """Markers by lla and by NED, one deleted, saved with the cameras'
    hull: annotations.json, .csv and .kml byte-equal; loaded back equal."""
    jd, td = _copies(mission, tmp_path)
    proj = JProject(mission)
    proj.load_images_info()
    ref = proj.ned_reference_lla()
    cams = np.asarray([im.get_camera_pose()[0] for im in proj.image_list]
                      + [[30.0, -20.0, -90.0]])
    out = {}
    for cls, d in ((JAnnotations, jd), (TAnnotations, td)):
        a = cls(_ia(d), ref, id_prefix="pt")
        a.add_marker_lla(ref[0] + 1e-4, ref[1] - 2e-4, 3.25, "a & <b>")
        a.add_marker_ned([12.5, -7.25, 0.5], "second")
        a.add_marker_ned([-3.0, 4.0, -1.0], "third", id=9)
        a.delete_marker(1)
        a.save(cams, mission_name="tools & co")
        out[d] = [open(a.path(ext), "rb").read()
                  for ext in ("json", "csv", "kml")]
        again = cls(_ia(d), ref).load()
        out[d].append([(m["id"], m["comment"], m["ned"])
                       for m in again.markers])
    assert out[td] == out[jd]
    assert b"<LineString>" in out[td][2]


# --- inspect ----------------------------------------------------------------

def test_inspect_outputs_equal_reference(mission, tmp_path, capsys):
    """features and pair: the PNGs byte-equal; groups and matches: the
    logs and return codes equal (this mission's groups.json is empty, so
    groups returns 1 in both)."""
    jd, td = _copies(mission, tmp_path)
    for cmd, extra in (("features", ["IMG_0000"]),
                       ("pair", ["IMG_0000", "IMG_0001"])):
        outs = [str(tmp_path / f"{cmd}_{s}.png") for s in ("j", "t")]
        (rj, lj), (rt, lt) = _run(
            capsys,
            lambda: jinspect.main([cmd, jd] + extra + ["--out", outs[0]]),
            lambda: tinspect.main([cmd, td] + extra + ["--out", outs[1]],
                                  **CPU), jd, td)
        assert rj == rt == 0
        assert lt.replace(outs[1], "<O>") == lj.replace(outs[0], "<O>")
        assert open(outs[1], "rb").read() == open(outs[0], "rb").read()
        assert os.path.getsize(outs[1]) > 1000
    for cmd in ("groups", "matches"):
        (rj, lj), (rt, lt) = _run(capsys, lambda: jinspect.main([cmd, jd]),
                                  lambda: tinspect.main([cmd, td], **CPU),
                                  jd, td)
        assert rt == rj and lt == lj and lt


@pytest.mark.parametrize("mode,keys", [("pairs", "dkd"), ("images", "kd")])
def test_review_session_equals_reference(mission, tmp_path, mode, keys):
    """The triage's items in the same order (by-image errors from
    apps/cull.compute_errors on the device), the same decisions, and the
    .match files equal after apply."""
    jd, td = _copies(mission, tmp_path)
    sessions = []
    for d, mgr, make in (
            (jd, JProject, lambda p: jinspect.ReviewSession(p, mode)),
            (td, TProject, lambda p: tinspect.ReviewSession(p, mode,
                                                            **CPU))):
        proj = mgr(d)
        proj.load_images_info()
        sessions.append(make(proj))
    js, ts = sessions
    if mode == "pairs":
        assert [(a.name, b.name) for a, b in ts.items] == \
            [(a.name, b.name) for a, b in js.items]
    else:
        assert [im.name for im, _ in ts.items] == \
            [im.name for im, _ in js.items]
        np.testing.assert_allclose([e for _, e in ts.items],
                                   [e for _, e in js.items], atol=1e-3)
    assert len(ts.items) >= 2
    for k in keys:
        assert ts.handle_key(k) == js.handle_key(k)
    before = _match_files(td)
    assert ts.apply() == js.apply() > 0
    after, want = _match_files(td), _match_files(jd)
    assert len(after) == 3 and after != before
    if mode == "pairs":
        assert after == want
        return
    # by image, the port diverges on purpose: the reference empties the
    # dropped image's partners' other pairs too (it saves their lists
    # unloaded); the port empties only the entries toward the dropped
    # image
    (dropped, _), = js.dropped
    mine = dropped.name + ".match"
    assert after[mine] == want[mine] and all(not v for v in
                                             after[mine].values())
    for f, ml in after.items():
        if f != mine:
            assert ml == {k: ([] if k == dropped.name else v)
                          for k, v in before[f].items()}, f
            assert want[f] == {dropped.name: []}, f


# --- utils ------------------------------------------------------------------

def test_preview_crops_equal_reference(mission, tmp_path, capsys):
    """import-annotations of a CSV of three ground points, then
    preview-crops: the annotations.json, the crops and index.html equal."""
    jd, td = _copies(mission, tmp_path)
    proj = JProject(mission)
    proj.load_images_info()
    lat, lon, _ = proj.ned_reference_lla()
    path = tmp_path / "ann.csv"
    path.write_text("OBJECTID,Latitude,Longitude,Altitude\n" + "".join(
        f"{k},{lat + dn:.8f},{lon + de:.8f},0.0\n"
        for k, (dn, de) in enumerate([(0, 0), (5e-5, 1e-4), (-6e-5, 3e-5)],
                                     start=7)))
    for main, d, kw in ((jutils.main, jd, {}), (tutils.main, td, CPU)):
        assert main(["import-annotations", d, str(path)], **kw) == 0
        assert main(["preview-crops", d, "--size", "64"], **kw) == 0
    pj, pt = (os.path.join(_ia(d), "annotations-preview") for d in (jd, td))
    files = sorted(os.listdir(pj))
    assert sorted(os.listdir(pt)) == files and len(files) == 4
    for f in files + ["../annotations.json"]:
        assert open(os.path.join(pt, f), "rb").read() == \
            open(os.path.join(pj, f), "rb").read(), f


def test_est_cam_transform_within_reference(mission, tmp_path, capsys):
    """The average transform and every image's row: each printed number
    within 0.01 (float32 quaternions on both sides)."""
    jd, td = _copies(mission, tmp_path)
    (rj, lj), (rt, lt) = _run(
        capsys, lambda: jutils.main(["est-cam-transform", jd]),
        lambda: tutils.main(["est-cam-transform", td], **CPU), jd, td)
    assert rj == rt == 0
    num = r"-?\d+\.\d+(?:e[-+]\d+)?"
    assert re.sub(num, "#", lt) == re.sub(num, "#", lj)
    got = np.array(re.findall(num, lt), float)
    want = np.array(re.findall(num, lj), float)
    assert len(got) >= 3 + 6 * 3
    np.testing.assert_allclose(got, want, atol=0.01)


def _cdf_within_one_level(got, want):
    """A histogram within ±1 level of another's (tests/
    test_torch_process.py): each level's cumulative share lies between
    the other's one level below and above."""
    g = np.cumsum(got) / np.sum(got)
    w = np.cumsum(want) / np.sum(want)
    lo = np.r_[0.0, w[:-1]] - 1e-9
    hi = np.r_[w[1:], 1.0] + 1e-9
    return bool(((g >= lo) & (g <= hi)).all())


def test_histogram_tables_within_reference(mission, tmp_path, capsys):
    """utils histogram rebuilds the tables: the histograms and templates
    within ±1 level of the reference's."""
    jd, td = _copies(mission, tmp_path)
    (rj, lj), (rt, lt) = _run(
        capsys, lambda: jutils.main(["histogram", jd, "--dist", "60"]),
        lambda: tutils.main(["histogram", td, "--dist", "60"], **CPU),
        jd, td)
    assert rj == rt == 0 and lt == lj
    hj, tj = jhistogram.load(_ia(jd))
    ht, tt = jhistogram.load(_ia(td))
    assert sorted(ht) == sorted(hj) == sorted(tt) == sorted(tj)
    for name in hj:
        for c in range(3):
            assert ht[name][c].sum() == hj[name][c].sum()
            assert _cdf_within_one_level(ht[name][c], hj[name][c])
            q = np.r_[0.0, tj[name][c]]
            assert ((tt[name][c] >= q[:-1] - 1e-6)
                    & (tt[name][c] <= np.r_[q[2:], 1.0] + 1e-6)).all()


def _host_tree(d):
    """{relative path: bytes} of the files under d."""
    out = {}
    for root, _, files in os.walk(d):
        for f in files:
            p = os.path.join(root, f)
            out[os.path.relpath(p, d)] = open(p, "rb").read()
    return out


def test_vignette_and_zip_equal_reference(mission, tmp_path, monkeypatch):
    """vignette writes the same mask; zip archives the same files."""
    jd, td = _copies(mission, tmp_path)
    for main, d, kw in ((jutils.main, jd, {}), (tutils.main, td, CPU)):
        assert main(["vignette", d, "--max-images", "2"], **kw) == 0
        monkeypatch.chdir(tmp_path)
        assert main(["zip", d, "--out", d + ".zip"], **kw) == 0
    vig = [open(os.path.join(_ia(d), "vignette.png"), "rb").read()
           for d in (jd, td)]
    assert vig[0] == vig[1]
    names = [sorted(zipfile.ZipFile(d + ".zip").namelist()) for d in (jd, td)]
    assert names[0] == names[1] and names[0]


def test_vignette_never_reaches_the_explorer(mission, tmp_path):
    """The reference quirk the port copies: utils vignette writes
    vignette.png, TextureManager reads vignette-mask.jpg, so the explorer
    applies no vignette mask after it."""
    jd, td = _copies(mission, tmp_path)
    for main, d, kw in ((jutils.main, jd, {}), (tutils.main, td, CPU)):
        assert main(["vignette", d], **kw) == 0
        assert os.path.isfile(os.path.join(_ia(d), "vignette.png"))
    jt = jtexture.TextureManager(JProject(jd))
    tt = ttexture.TextureManager(TProject(td), **CPU)
    assert jt.vignette_full is None and tt.vignette_full is None


def test_merge_and_renumber_tools_equal_reference(tmp_path, rng):
    """merge, add-to-name (dry run, then --write), copy-and-add and
    import-info: the same files, links and pose rows."""
    header = ("File Name,Lat (decimal degrees),Lon (decimal degrees),"
              "Alt (meters MSL),Roll (decimal degrees),"
              "Pitch (decimal degrees),Yaw (decimal degrees)")
    src = tmp_path / "src"
    for pi in range(2):
        d = src / f"p{pi}"
        d.mkdir(parents=True)
        rows = []
        for i in range(3):
            name = f"P{pi}_{i:04d}.jpg"
            cv2.imwrite(str(d / name), rng.integers(0, 255, (40, 60),
                                                    np.uint8))
            rows.append(f"{name},44.97,-93.26,300,0,0,0")
        (d / "pix4d.csv").write_text(header + "\n" + "\n".join(rows) + "\n")
        (d / f"P{pi}_0007.info").write_text(json.dumps(
            {"aircraft-pose": {"lla": [44.9 + pi, -93.2, 310.5],
                               "ypr": [-45.0 * pi, 1.5, -2.25]}}))
    results = {}
    for side, main, kw in (("j", jutils.main, {}), ("t", tutils.main, CPU)):
        root = tmp_path / side
        shutil.copytree(src, root / "in")
        assert main(["merge", str(root / "merged"), str(root / "in" / "p0"),
                     str(root / "in" / "p1")], **kw) == 0
        f0 = str(root / "in" / "p0" / "P0_0000.jpg")
        assert main(["add-to-name", "--add", "100", f0], **kw) == 0
        assert os.path.isfile(f0)
        assert main(["add-to-name", "--add", "100", "--write", f0],
                    **kw) == 0
        assert main(["copy-and-add", "--src", str(root / "in" / "p1"),
                     "--dest", str(root / "copied"), "--add", "1000"],
                    **kw) == 0
        assert main(["import-info", str(root / "in" / "p1"), "--out",
                     str(root / "info.csv")], **kw) == 0
        merged = root / "merged"
        results[side] = (
            sorted((f, os.path.relpath(os.path.realpath(merged / f), root))
                   for f in os.listdir(merged)),
            _host_tree(root / "in"), _host_tree(root / "copied"),
            (root / "info.csv").read_bytes())
    assert results["t"] == results["j"]
    assert len(results["t"][0]) == 7 and results["t"][3].count(b"\n") == 2


def test_calibrate_equals_reference(tmp_path):
    """Chessboard calibration of 8 seeded views at 640×480: the same
    camera config in the DB, its numbers equal. cv2.calibrateCamera's
    threaded sums move them by up to ~3e-6 relative from one run to the
    next (k1 of the distortion, in either package), so both packages run
    with OpenCV on one thread, where repeated runs are bit-identical."""
    K_true = np.array([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]])
    board = np.kron((np.add.outer(np.arange(7), np.arange(10)) % 2 == 0)
                    .astype(np.uint8) * 255, np.ones((60, 60), np.uint8))
    img_dir = tmp_path / "cal"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    sq = 25.0
    for i in range(8):
        rvec = rng.normal(0, 0.25, 3)
        tvec = np.array([rng.normal(-20, 10), rng.normal(-20, 10),
                         rng.uniform(500, 800)])
        R, _ = cv2.Rodrigues(rvec)
        Hb = K_true @ np.column_stack([
            R[:, 0] * (sq / 60), R[:, 1] * (sq / 60),
            R @ np.array([-120 * sq / 60, -90 * sq / 60, 0]) + tvec])
        cv2.imwrite(str(img_dir / f"cal_{i:02d}.png"),
                    cv2.warpPerspective(board, Hb / Hb[2, 2], (640, 480),
                                        borderValue=128))
    argv = ["calibrate", "--images", str(img_dir), "--pattern", "9x6",
            "--square-mm", "25", "--make", "Acme", "--model", "Cal 1"]
    threads = cv2.getNumThreads()
    cv2.setNumThreads(1)
    try:
        assert jutils.main(argv + ["--db", str(tmp_path / "dj")]) == 0
        assert tutils.main(argv + ["--db", str(tmp_path / "dt")],
                           **CPU) == 0
    finally:
        cv2.setNumThreads(threads)
    got, want = (json.loads((tmp_path / d / "Acme_Cal_1.json").read_text())
                 for d in ("dt", "dj"))
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], list):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k
    assert abs(got["K"][0] / 600.0 - 1.0) < 0.01


def test_exif_tools_equal_reference(mission, tmp_path, capsys, monkeypatch):
    """On the frames tagged with EXIF: capture-dates, wx-report (no
    ~/.forecastio key: no weather lookup), new-camera and trim-far print
    and write the same."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    jd, td = _copies(mission, tmp_path)
    proj = JProject(mission)
    proj.load_images_info()
    for d in (jd, td):
        for k, im in enumerate(proj.image_list):
            lla, ypr, _ = im.get_aircraft_pose()
            tag_frame(os.path.join(d, im.name + ".jpg"), lla, ypr, 700.0,
                      1_700_000_000 + 7 * k)
    for argv in (["capture-dates"], ["wx-report"], ["trim-far"]):
        (rj, lj), (rt, lt) = _run(
            capsys, lambda: jutils.main(argv[:1] + [jd] + argv[1:]),
            lambda: tutils.main(argv[:1] + [td] + argv[1:], **CPU), jd, td)
        assert rj == rt == 0 and lt == lj, argv
        assert "IMG_0002" in lt or "Mission location" in lt, lt
    outs = []
    for main, d, kw in ((jutils.main, jd, {}), (tutils.main, td, CPU)):
        db = os.path.join(d, "newdb")
        assert main(["new-camera", os.path.join(d, "IMG_0001.jpg"), "--db",
                     db], **kw) == 0
        outs.append(_host_tree(db))
    assert outs[1] == outs[0] and len(outs[0]) == 1


def test_plot_matches_draws_the_same(mission, tmp_path):
    """plot-matches: the same figure, pixel for pixel."""
    jd, td = _copies(mission, tmp_path)
    outs = [str(tmp_path / f"g{s}.png") for s in "jt"]
    assert jutils.main(["plot-matches", jd, "--out", outs[0]]) == 0
    assert tutils.main(["plot-matches", td, "--out", outs[1]], **CPU) == 0
    a, b = (cv2.imread(o) for o in outs)
    assert a.shape == b.shape and np.array_equal(a, b)


# --- zooniverse -------------------------------------------------------------

def test_zooniverse_chop_and_paste_match_reference(mission, tmp_path):
    """chop at 256 / 32: the manifest and every tile byte-equal; paste of
    marks in three tiles (one unknown tile, skipped): the markers within
    1e-3 m of the reference's, comments and ids equal."""
    jd, td = _copies(mission, tmp_path)
    tiles = {}
    for mod, d, kw in ((jzoo, jd, {}), (tzoo, td, CPU)):
        out = os.path.join(d, "tiles")
        manifest = mod.chop(d, out, tile=256, overlap=32)
        tiles[d] = (manifest, _host_tree(out))
    assert tiles[td] == tiles[jd] and len(tiles[td][0]) == 3 * 6
    names = [row[0] for row in tiles[td][0]]
    marks = tmp_path / "marks.csv"
    with open(marks, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["tile", "u", "v", "comment"])
        w.writerow([names[0], 10.5, 20.25, "first"])
        w.writerow([names[7], 128.0, 64.0, "second"])
        w.writerow(["missing.jpg", 1, 1, "skipped"])
        w.writerow([names[-1], 200.75, 3.5, "third"])
    got = {}
    for mod, d, kw in ((jzoo, jd, {}), (tzoo, td, CPU)):
        n = mod.paste(d, str(marks), os.path.join(d, "tiles", "tiles.csv"),
                      ground=1.5, **kw)
        with open(os.path.join(_ia(d), "annotations.json")) as f:
            got[d] = (n, json.load(f))
    (nj, aj), (nt, at) = got[jd], got[td]
    assert nt == nj == 3
    ref = JProject(jd).ned_reference_lla()
    for mt, mj in zip(at["markers"], aj["markers"]):
        assert (mt["id"], mt["comment"]) == (mj["id"], mj["comment"])
        a = geodesy.lla2ned(mt["lat_deg"], mt["lon_deg"], mt["alt_m"], *ref)
        b = geodesy.lla2ned(mj["lat_deg"], mj["lon_deg"], mj["alt_m"], *ref)
        assert np.abs(np.subtract(a, b)).max() < 1e-3


# --- explorer ---------------------------------------------------------------

def test_explorer_equals_reference(mission, tmp_path):
    """select_top and get_elevation across the mission, _warp_full of the
    top model at 512² through the same textures (the reference's tables in
    both copies, no display filter), and render_to's drawn count."""
    jd, td = _copies(mission, tmp_path)
    shutil.copy(os.path.join(_ia(jd), "histogram.pickle"),
                os.path.join(_ia(td), "histogram.pickle"))
    je = jexplorer.Explorer(jd, filter_mode="none")
    te = texplorer.Explorer(td, filter_mode="none", **CPU)
    names = te._model_names()
    assert names == je._model_names() and len(names) == 3
    v = np.concatenate([te._grid(n)[0] for n in names])
    v = v[~np.all(v[:, :2] == 0, axis=1)]
    lo, hi = v.min(0), v.max(0)
    for fx, fy in ((0.5, 0.5), (0.2, 0.7), (0.9, 0.1), (-1.0, 0.5)):
        c = (lo[0] + fx * (hi[0] - lo[0]), lo[1] + fy * (hi[1] - lo[1]))
        assert te.select_top(names, c) == je.select_top(names, c)
        assert abs(te.get_elevation(*c) - je.get_elevation(*c)) <= 1e-6
    top = te.select_top(names, (0.5 * (lo[0] + hi[0]),
                                0.5 * (lo[1] + hi[1])))
    want, ext_j = je._warp_full(top, res=512)
    got, ext_t = te._warp_full(top, res=512)
    assert ext_t == ext_j and got.shape == want.shape == (512, 512, 4)
    differ = (got != want).any(-1).mean()
    assert differ <= 1e-3, differ
    assert (want[..., 3] > 0).mean() > 0.3
    # the drawn count does not depend on the top image, warped above
    drawn = [e.render_to(str(tmp_path / f"{s}.png"), dpi=60,
                         full_res_top=False)
             for s, e in (("j", je), ("t", te))]
    assert drawn[1] == drawn[0] == 3
    assert os.path.getsize(tmp_path / "t.png") > 5_000


# --- entry points ----------------------------------------------------------

def test_mains_help_and_usage(capsys):
    """utils, inspect and zooniverse print their parsers' help; the
    explorer without arguments prints its usage and returns 1."""
    for main, word in ((tutils.main, "preview-crops"),
                       (tinspect.main, "review"),
                       (tzoo.main, "paste")):
        with pytest.raises(SystemExit) as e:
            main(["--help"], **CPU)
        assert e.value.code == 0 and word in capsys.readouterr().out
    assert texplorer.main([], **CPU) == 1
    assert "imageanalysis_tpu_torch.apps.explorer" in capsys.readouterr().out


@pytest.mark.parametrize("tool", ["utils", "inspect", "zooniverse",
                                  "explorer"])
def test_mains_follow_imgtpu_platform(mission, tmp_path, monkeypatch, tool):
    """Each main runs on the card by default: without one it raises, and
    never swaps the card for the CPU; IMGTPU_PLATFORM=cpu runs it on the
    CPU."""
    main, argv = {
        "utils": (tutils.main, ["capture-dates", mission]),
        "inspect": (tinspect.main, ["matches", mission]),
        "zooniverse": (tzoo.main, ["chop", mission, str(tmp_path / "t"),
                                   "--tile", "400", "--overlap", "0"]),
        "explorer": (texplorer.main, [mission, "--screenshot",
                                      str(tmp_path / "e.png")]),
    }[tool]
    monkeypatch.delenv("IMGTPU_PLATFORM", raising=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            main(argv)
    monkeypatch.setenv("IMGTPU_PLATFORM", "cpu")
    if tool == "explorer":     # its render is test_explorer_equals_reference's
        seen = []
        monkeypatch.setattr(texplorer.Explorer, "render_to",
                            lambda self, out: seen.append(self.device))
        assert main(argv) == 0 and seen == [torch.device("cpu")]
        return
    assert main(argv) == 0

"""Port parity: the project workspace and the state carried across it.

One workspace, two packages: whatever imageanalysis_tpu writes,
imageanalysis_tpu_torch loads to the same values and writes back to the
same bytes, and the other way round (config.json, meta/*.json,
meta/*.match, cache/*.feat, cache/*.desc, smart.json). On top of it: the
resident store built from the workspace, the smart gate's ground-projected
prior (against the reference and against the planted homographies) and
the smart estimators (against the reference: surface mean/std to 1e-3 m,
similarity to 1e-4).

The workspace comes from the port's synthetic mission with matches
planted from its homographies (no detector), so every quantity has a
known truth.
"""

import gzip
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageanalysis_tpu.io import project as jproject
from imageanalysis_tpu.match import matcher as jmatcher
from imageanalysis_tpu.match import smart as jsmart
from imageanalysis_tpu.match.store import DescriptorStore as JStore
from imageanalysis_tpu_torch.io import project as tproject
from imageanalysis_tpu_torch.match import matcher as tmatcher
from imageanalysis_tpu_torch.match import smart as tsmart
from imageanalysis_tpu_torch.match.store import DescriptorStore as TStore
from imageanalysis_tpu_torch.testing import synthetic
from torch_threads import one_torch_thread  # noqa: F401

SIZE = (320, 240)
PAIRS = [(0, 1), (1, 2), (2, 3), (0, 2), (1, 3)]


@pytest.fixture(scope="module")
def mission():
    """4 frames, 2 strips of 2, with features and matches planted from the
    homographies (0.3 px noise): dets[i] = (kp, meta, desc), matches
    {(i, j): (n, 2) int32}."""
    m = synthetic.make_mission(strips=2, per_strip=2, size=SIZE,
                               strip_gap=1.0, seed=5, device="cpu")
    rng = np.random.default_rng(7)
    kps = [list(rng.uniform(0, SIZE, (40, 2))) for _ in range(4)]
    matches = {}
    for i, j in PAIRS:
        p = rng.uniform(0, SIZE, (600, 2))
        q = np.c_[p, np.ones(len(p))] @ m.H_ij(i, j).T
        q = q[:, :2] / q[:, 2:]
        keep = np.nonzero(((q >= 0) & (q < SIZE)).all(1))[0][:120]
        ri = np.arange(len(kps[i]), len(kps[i]) + len(keep))
        rj = np.arange(len(kps[j]), len(kps[j]) + len(keep))
        kps[i] += list(p[keep])
        kps[j] += list(q[keep] + rng.normal(0, 0.3, q[keep].shape))
        matches[(i, j)] = np.stack([ri, rj], 1).astype(np.int32)
    dets = []
    for k in kps:
        kp = np.asarray(k, np.float32)
        meta = np.c_[rng.uniform(2, 9, (len(kp), 3)),
                     rng.integers(0, 4, len(kp))].astype(np.float32)
        dets.append((kp, meta, rng.integers(0, 256, (len(kp), 128))
                     .astype(np.float32)))
    return m, dets, matches


def _write_with(project_mod, root, m, dets, matches):
    """The same workspace through either package's API."""
    proj = project_mod.ProjectMgr(root, create=True)
    K = m.K
    proj.set_camera_config({
        "make": "Synthetic", "model": "Cam", "lens_model": "none",
        "K": K.ravel().tolist(), "dist_coeffs": [0.01, -0.002, 0, 0, 0],
        "width_px": SIZE[0], "height_px": SIZE[1],
        "mount": {"yaw_deg": 0.0, "pitch_deg": -90.0, "roll_deg": 0.0}})
    ref = proj.config.node("ned_reference")
    for key, v in zip(("lat_deg", "lon_deg", "alt_m"), synthetic.REF_LLA):
        ref.set(key, float(v))
    proj.save()
    from imageanalysis_tpu_torch.core import geodesy
    lla = geodesy.ned2lla(m.ned, *synthetic.REF_LLA)
    for i, (kp, meta, desc) in enumerate(dets):
        im = project_mod.ImageRecord(proj.analysis_dir,
                                     synthetic.image_name(i))
        im.set_aircraft_pose(*lla[i], *m.aircraft_ypr[i])
        im.set_camera_pose(m.ned[i], -90.0, -89.0, 1.0, quat=m.cam_quat[i])
        im.set_size(*SIZE)
        im.save_meta()
        im.kp, im.kp_meta, im.des = kp, meta, desc
        im.save_features()
        im.save_descriptors()
        for (a, b), mm in matches.items():
            if a == i:
                im.match_list[synthetic.image_name(b)] = mm
            elif b == i:
                im.match_list[synthetic.image_name(a)] = mm[:, ::-1].copy()
        im.save_matches()
    proj.load_images_info()
    return proj


def _files(root):
    out = {}
    for d, _, fs in os.walk(os.path.join(root, "ImageAnalysis")):
        for f in fs:
            if not f.startswith("messages-"):
                path = os.path.join(d, f)
                out[os.path.relpath(path, root)] = path
    return out


def _content(path):
    """File bytes; .feat caches decompressed (gzip stores a timestamp)."""
    opener = gzip.open if path.endswith(".feat") else open
    with opener(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("writer,reader", [(jproject, tproject),
                                           (tproject, jproject)],
                         ids=["jax_to_torch", "torch_to_jax"])
def test_workspace_round_trip(tmp_path, mission, writer, reader):
    """One package writes, the other loads the same values and writes
    every file back byte for byte."""
    m, dets, matches = mission
    root = str(tmp_path / "ws")
    _write_with(writer, root, m, dets, matches)
    before = {k: _content(p) for k, p in _files(root).items()}
    proj = reader.ProjectMgr(root)
    proj.load_images_info()
    assert [im.name for im in proj.image_list] == [
        synthetic.image_name(i) for i in range(len(dets))]
    np.testing.assert_array_equal(np.asarray(proj.camera_model().K), m.K
                                  .astype(np.float32))
    for i, im in enumerate(proj.image_list):
        assert im.load_features() and im.load_descriptors()
        assert im.load_matches()
        kp, meta, desc = dets[i]
        np.testing.assert_array_equal(im.kp, kp)
        np.testing.assert_array_equal(im.kp_meta, meta)
        np.testing.assert_array_equal(im.des, desc)
        ned, _, quat = im.get_camera_pose()
        np.testing.assert_array_equal(ned, m.ned[i])
        np.testing.assert_array_equal(quat, m.cam_quat[i])
        for (a, b), mm in matches.items():
            if a == i:
                np.testing.assert_array_equal(
                    im.match_list[synthetic.image_name(b)], mm)
        im.save_meta()
        im.save_features()
        im.save_descriptors()
        im.save_matches()
    proj.save()
    after = {k: _content(p) for k, p in _files(root).items()}
    assert after.keys() == before.keys()
    for k in before:
        assert after[k] == before[k], k


def test_both_packages_write_the_same_workspace(tmp_path, mission):
    """From the same inputs the two writers produce the same files; the
    one float32 value computed on the way (the aircraft quat from ypr)
    agrees to 1e-6."""
    m, dets, matches = mission
    roots = [str(tmp_path / n) for n in ("j", "t")]
    for mod, root in zip((jproject, tproject), roots):
        _write_with(mod, root, m, dets, matches)
    fj, ft = _files(roots[0]), _files(roots[1])
    assert fj.keys() == ft.keys()
    import json
    for k in fj:
        if k.endswith(".json") and "meta" in k:
            with open(fj[k]) as a, open(ft[k]) as b:
                ja, jb = json.load(a), json.load(b)
            qa = ja["aircraft_pose"].pop("quat")
            qb = jb["aircraft_pose"].pop("quat")
            np.testing.assert_allclose(qa, qb, atol=1e-6)
            assert ja == jb, k
        elif not k.endswith("config.json"):
            assert _content(fj[k]) == _content(ft[k]), k


def test_smart_state_round_trip(tmp_path):
    """smart.json written by either package loads in the other and is
    written back unchanged."""
    for src, dst in ((jsmart, tsmart), (tsmart, jsmart)):
        d = str(tmp_path / src.__name__.split(".")[0])
        os.makedirs(d)
        st = src.SmartState(d)
        st.update_surface_pair("a", "b", 12.34, 3.21, 20.5)
        st.update_surface_pair("a", "c", 10.0, 30.0, 25.0)
        st.update_yaw_pair("a", "b", 2.26, 20.5, 91.4, 3.3)
        st.node("c")["srtm_surface_m"] = 7.5
        st.save()
        with open(st.path(), "rb") as f:
            raw = f.read()
        other = dst.SmartState(d)
        assert other.data == st.data
        assert other.get_surface("a", "c") == st.get_surface("a", "c")
        assert other.get_surface("c") == 7.5
        assert other.get_yaw_error("a") == st.get_yaw_error("a")
        other.save()
        with open(other.path(), "rb") as f:
            assert f.read() == raw


def test_store_from_project_matches_reference(tmp_path, mission):
    """DescriptorStore.from_project builds the reference constructor's
    int8 arrays, undistorted uv and counts."""
    m, dets, matches = mission
    root = str(tmp_path / "ws")
    _write_with(tproject, root, m, dets, matches)
    jp = jproject.ProjectMgr(root)
    jp.load_images_info()
    want = JStore(jp)
    tp = tproject.ProjectMgr(root)
    tp.load_images_info()
    got = TStore.from_project(tp, device="cpu")
    assert got.npad == want.npad and got.names == want.names
    np.testing.assert_array_equal(got.desc.numpy(), np.asarray(want.desc))
    np.testing.assert_array_equal(got.uv.numpy(), np.asarray(want.uv))
    np.testing.assert_array_equal(got.counts.numpy(),
                                  np.asarray(want.counts))
    assert all(im.des is None for im in tp.image_list)   # unloaded
    assert TStore.fits(2812, 8192) and not TStore.fits(8000, 8192)


def test_predict_uv_matches_reference_and_planted_homography(mission):
    """The smart gate's prior: rays from camera B through its keypoints,
    down to the flat ground (down = 0), into camera A. It reproduces the
    planted frame-to-frame homography to < 0.5 px, and the reference's
    per-pair function to 1e-2 px."""
    m, _, _ = mission
    rng = np.random.default_rng(3)
    poses = np.c_[m.ned, m.cam_quat].astype(np.float32)
    K = m.K.astype(np.float32)
    pairs = [(0, 1), (1, 0), (0, 2), (3, 1)]
    uv_b = rng.uniform(0, SIZE, (len(pairs), 50, 2)).astype(np.float32)
    cam_a = poses[[a for a, _ in pairs]]
    cam_b = poses[[b for _, b in pairs]]
    gz = np.zeros(len(pairs), np.float32)
    got = tmatcher._predict_uv_in_a(
        *(torch.from_numpy(x) for x in (uv_b, cam_a, cam_b, gz, K))).numpy()
    for k, (a, b) in enumerate(pairs):
        want = np.asarray(jmatcher._predict_uv_in_a(
            jnp.asarray(uv_b[k]), jnp.asarray(cam_a[k]),
            jnp.asarray(cam_b[k]), jnp.float32(0.0), jnp.asarray(K)))
        np.testing.assert_allclose(got[k], want, atol=1e-2)
        q = np.c_[uv_b[k], np.ones(50)] @ m.H_ij(b, a).T
        err = np.linalg.norm(q[:, :2] / q[:, 2:] - got[k], axis=1)
        assert err.max() < 0.5, (a, b, err.max())
    # rays that never reach the ground (camera B turned to look up) are
    # gated out
    from imageanalysis_tpu_torch.core.rotations import quat_multiply
    flip = quat_multiply(torch.tensor([0.0, 1.0, 0.0, 0.0]),
                         torch.from_numpy(cam_b[:1, 3:]))
    up = torch.cat([torch.from_numpy(cam_b[:1, :3]), flip], 1)
    bad = tmatcher._predict_uv_in_a(
        torch.from_numpy(uv_b[:1]), torch.from_numpy(cam_a[:1]), up,
        torch.zeros(1), torch.from_numpy(K))
    assert (bad == -1e7).all()


def test_smart_estimators_match_reference(tmp_path, mission):
    """pair_surface_stats_batched (triangulated surface mean/std to 1e-3
    m, the uv2→uv1 similarity to 1e-4), then update_pairs_batched and
    requalify_pairs leave the same smart.json in both packages."""
    m, dets, matches = mission
    roots = {}
    for name, mod in (("j", jproject), ("t", tproject)):
        roots[name] = str(tmp_path / name)
        _write_with(mod, roots[name], m, dets, matches)
    jp = jproject.ProjectMgr(roots["j"])
    jp.load_images_info()
    tp = tproject.ProjectMgr(roots["t"])
    tp.load_images_info()
    for p in (jp, tp):
        for im in p.image_list:
            im.load_matches()
    pj = [(jp.image_list[i], jp.image_list[j]) for i, j in PAIRS]
    pt = [(tp.image_list[i], tp.image_list[j]) for i, j in PAIRS]
    sj, aj = jsmart.pair_surface_stats_batched(jp, pj)
    st, at = tsmart.pair_surface_stats_batched(tp, pt, device="cpu")
    for (mj, dj, bj), (mt, dt, bt) in zip(sj, st):
        assert abs(mj - mt) < 1e-3 and abs(dj - dt) < 1e-3
        assert bj == pytest.approx(bt, rel=1e-6)
        assert abs(mt) < 0.5                  # the ground is at 0 m
    np.testing.assert_allclose(np.stack(at), np.stack(aj), rtol=1e-4,
                               atol=1e-4)
    for k, (i1, i2) in enumerate(pt):
        yt = tsmart._yaw_from_affine(tp, i1, i2, at[k])
        yj = jsmart._yaw_from_affine(jp, *pj[k], aj[k])
        np.testing.assert_allclose(yt, yj, rtol=1e-4, atol=1e-3)
    state_j = jsmart.SmartState(jp.analysis_dir)
    state_t = tsmart.SmartState(tp.analysis_dir)
    jsmart.update_pairs_batched(jp, state_j, pj)
    tsmart.update_pairs_batched(tp, state_t, pt, device="cpu")
    assert jsmart.requalify_pairs(jp, state_j) == \
        tsmart.requalify_pairs(tp, state_t, device="cpu")
    assert state_t.data.keys() == state_j.data.keys()
    for name in state_j.data:
        for key in ("tri_surface_m", "yaw_error"):
            assert (key in state_t.data[name]) == (key in state_j.data[name])
            assert abs(state_t.data[name].get(key, 0.0)
                       - state_j.data[name].get(key, 0.0)) <= 0.1 + 1e-9
    assert tsmart.pair_surface_stats_batched(None, []) == ([], [])


def test_project_helpers_match_reference(tmp_path, mission):
    """The rest of ImageRecord's and ProjectMgr's helpers agree with the
    reference on one workspace: image files and paths, lookups, the body
    frame, the NED reference, the yaw-error fold into the poses, and the
    matches_grouped file written by either package."""
    m, dets, matches = mission
    root = str(tmp_path / "ws")
    _write_with(jproject, root, m, dets, matches)
    for name in ("IMG_0001.JPG", "IMG_0000.jpg", "notes.txt"):
        open(os.path.join(root, name), "wb").close()
    jp, tp = jproject.ProjectMgr(root), tproject.ProjectMgr(root)
    for p in (jp, tp):
        p.load_images_info()
    assert tp.image_files() == jp.image_files() == ["IMG_0000.jpg",
                                                    "IMG_0001.JPG"]
    for ji, ti in zip(jp.image_list, tp.image_list):
        assert tp.image_path(ti) == jp.image_path(ji)
        assert tp.image_by_name(ti.name).name == ti.name
        assert ti.get_size() == ji.get_size() == SIZE
        assert ti.has_opt_pose() is ji.has_opt_pose() is False
        np.testing.assert_allclose(ti.get_body2ned(), ji.get_body2ned(),
                                   atol=1e-6)
    assert tp.image_by_name("IMG_9999") is None
    assert tp.ned_reference_lla() == jp.ned_reference_lla()
    for p in (jp, tp):
        p.compute_ned_reference_lla()
    np.testing.assert_allclose(tp.ned_reference_lla(),
                               jp.ned_reference_lla(), rtol=1e-12)
    b2c = tp.get_body2cam()
    np.testing.assert_allclose(b2c, np.asarray(jp.get_body2cam()), atol=1e-7)
    ji, ti = jp.image_list[1], tp.image_list[1]
    ji.set_aircraft_yaw_error_estimate(2.5, jp.get_body2cam())
    ti.set_aircraft_yaw_error_estimate(2.5, b2c)
    # quats to f32 rounding; the camera's ypr in degrees to 1e-3, since
    # yaw and roll are ill-conditioned at the nadir camera's pitch ≈ −90°
    for get in ("get_aircraft_pose", "get_camera_pose"):
        for g, w, tol in zip(getattr(ti, get)(), getattr(ji, get)(),
                             (1e-9, 1e-3, 1e-6)):
            np.testing.assert_allclose(np.asarray(g, np.float64),
                                       np.asarray(w, np.float64), atol=tol)
    grouped = [[np.float64(1.5), [0, 3], [2, 7]], [[1.0, 2.0, 3.0], [1, 4]]]
    for src, dst, name in ((jp, tp, "from_jax"), (tp, jp, "from_torch")):
        src.save_matches_grouped(grouped, name)
        assert dst.load_matches_grouped(name) == grouped

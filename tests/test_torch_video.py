"""Port parity: the video tools (``video/`` and ``apps/video.py``).

The same seeded inputs go through the reference and the port (on the
CPU): a 320×320, 30-frame mp4v movie of a rotating, drifting textured
ground (``testing/video.write_flight_movie``), which both packages read,
its flight log, a DJI flight record and caption file. Tolerances:

- ``estimate_motion``: frames and times exactly; rotation within 1e-3°
  and tx/ty within 1e-2 px (both fit in float32, in another order);
  ``write_motion_csv`` byte-equal on the same records;
- ``sync_clocks``: the shift exactly, ``ycorr`` within 1e-4 of its
  maximum (a float32 FFT on both sides);
- ``VirtualCamera``: projections within 1e-4 px (the rotations are
  float32 on both sides);
- one HUD frame of each style and ``overlay_video`` at ``max_frames=3``:
  at most 0.1% of the pixels differ (float32 rotations that differ in
  ulps move a line end by a pixel);
- ``djilog``: the table and the names equal, the frames' GPS equal after
  reading, their pixels equal ``cv2.imwrite``'s (the port's geotag
  rewrites only the Exif APP1);
- ``flight_data``, ``ephemeris``, ``ils``, ``mount``, ``horizon`` and
  ``aruco`` (host copies): equal to float tolerance;
- every ``apps/video`` subcommand writes the reference's artifacts.

The port's writers raise where cv2 cannot open them (the deliberate
divergence: the reference writes nothing and says nothing).
"""

import csv
import datetime
import filecmp
import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from imageanalysis_tpu.apps import video as jvideo_app  # noqa: E402
from imageanalysis_tpu.core import rotations as jrot  # noqa: E402
from imageanalysis_tpu.io import exif as jexif  # noqa: E402
from imageanalysis_tpu.video import (  # noqa: E402
    camera as jcam, correlate as jcorrelate, djilog as jdjilog,
    frame_motion as jframe_motion, hud as jhud)
from imageanalysis_tpu_torch.apps import video as tvideo_app  # noqa: E402
from imageanalysis_tpu_torch.core import rotations as trot  # noqa: E402
from imageanalysis_tpu_torch.io import exif as texif  # noqa: E402
from imageanalysis_tpu_torch.testing import video as synth  # noqa: E402
from imageanalysis_tpu_torch.video import (  # noqa: E402
    camera as tcam, correlate as tcorrelate, djilog as tdjilog,
    frame_motion as tframe_motion, hud as thud, stabilize as tstabilize)
from torch_threads import one_torch_thread  # noqa: E402,F401

SIZE, FRAMES, SHIFT = (320, 320), 30, 2.5
START = datetime.datetime(2023, 6, 1, 10, 0, 0)
CAM = {"K": [260.0, 0, 160, 0, 260.0, 160, 0, 0, 1],
       "dist_coeffs": [0] * 5, "width_px": 320, "height_px": 320,
       "mount": {"yaw_deg": 2.0, "pitch_deg": -10.0, "roll_deg": 1.0}}


@pytest.fixture(scope="module")
def footage(tmp_path_factory):
    d = tmp_path_factory.mktemp("footage")
    movie = synth.write_flight_movie(str(d / "flight.mp4"), seed=7,
                                     size=SIZE, n_frames=FRAMES)
    synth.write_flight_log(str(d / "flight.csv"), movie, SHIFT)
    dji = str(d / "DJIFlightRecord_2023-06-01_[10-00-00].csv")
    rows = synth.write_dji_csv(dji, START, 8)
    synth.write_srt(str(d / "flight.srt"), START + datetime.timedelta(
        seconds=1), 3)
    return dict(dir=d, movie=movie, log=str(d / "flight.csv"), dji=dji,
                dji_rows=rows, srt=str(d / "flight.srt"))


@pytest.fixture(scope="module")
def motion(footage):
    """Both packages' estimate_motion on the movie."""
    path = footage["movie"].path
    return (jframe_motion.estimate_motion(path),
            tframe_motion.estimate_motion(path, device="cpu"))


def test_estimate_motion_matches_reference(motion, footage, tmp_path):
    want, got = motion
    assert len(got) == len(want) == FRAMES - 1
    assert [r[:2] for r in got] == [r[:2] for r in want]
    g, w = np.array([r[2:] for r in got]), np.array([r[2:] for r in want])
    np.testing.assert_allclose(g[:, 0], w[:, 0], atol=1e-3)
    np.testing.assert_allclose(g[:, 1:], w[:, 1:], atol=1e-2)
    # and the planted rotation, the bar of the reference's own test
    planted = np.diff(footage["movie"].angle_deg)
    np.testing.assert_allclose(g[:, 0], planted, atol=0.1)
    # the CSV writer: byte-equal on the same records
    paths = [str(tmp_path / f"{k}.csv") for k in ("j", "t")]
    jframe_motion.write_motion_csv(want, paths[0])
    tframe_motion.write_motion_csv(want, paths[1])
    assert filecmp.cmp(*paths, shallow=False)


def test_sync_clocks_matches_reference(motion, footage, tmp_path):
    """The clock sync of hud-overlay --movie-csv (the same shapes as the
    subcommand's, whose FFTs the reference then reuses compiled)."""
    from imageanalysis_tpu.video import flight_data as jfd
    from imageanalysis_tpu_torch.video import flight_data as tfd

    movie_csv = str(tmp_path / "motion.csv")
    jframe_motion.write_motion_csv(motion[0], movie_csv)
    want = jvideo_app._auto_time_shift(jfd.FlightLog(footage["log"]),
                                       movie_csv)
    got = tvideo_app._auto_time_shift(tfd.FlightLog(footage["log"]),
                                      movie_csv, "cpu")
    assert got == want
    rng = np.random.default_rng(3)
    a, b = rng.normal(size=300), rng.normal(size=120)
    wy = jcorrelate.cross_correlate_full(a, b)
    gy = tcorrelate.cross_correlate_full(a, b, device="cpu")
    assert gy.shape == wy.shape == (419,)
    assert np.abs(gy - wy).max() <= 1e-4 * np.abs(wy).max()
    np.testing.assert_allclose(gy, np.correlate(a, b, mode="full"),
                               atol=1e-4)


def test_virtual_camera_projects_as_reference():
    rng = np.random.default_rng(5)
    cams = [m.VirtualCamera(dict(CAM)).scale_to(640, 480)
            for m in (jcam, tcam)]
    pts = rng.uniform([200, -300, -50], [900, 300, 50], (64, 3))
    for _ in range(2):
        ypr = rng.uniform(-0.3, 0.3, 3)
        ned = rng.uniform(-50, 50, 3) + [0, 0, -120]
        qj = np.asarray(jrot.quat_from_ypr(*ypr))
        qt = np.asarray(trot.quat_from_ypr(*ypr))
        np.testing.assert_allclose(qt, qj, atol=1e-7)
        uv_j = cams[0].project_ned(pts, ned, qj)
        uv_t = cams[1].project_ned(pts, ned, qt)
        assert (np.isnan(uv_j) == np.isnan(uv_t)).all()
        ok = ~np.isnan(uv_j)
        np.testing.assert_allclose(uv_t[ok], uv_j[ok], atol=1e-4)
    np.testing.assert_allclose(cams[1].K, cams[0].K)


def _full_hud(mod, cam_mod, rot, style):
    """A HUD of every symbol group of the reference's full-draw test, one
    state; less the grid, which takes the reference 4 s a frame."""
    h = mod.HUD(cam_mod.VirtualCamera(dict(CAM)).scale_to(480, 360),
                style=style)
    t = datetime.datetime(2023, 6, 21, 18, 0,
                          tzinfo=datetime.timezone.utc).timestamp()
    q = np.asarray(rot.quat_from_ypr(0.3, 0.05, np.radians(12.0)))
    h.update_state(ned=[10.0, 5.0, -120.0], quat=q,
                   ypr_deg=(np.degrees(0.3), np.degrees(0.05), 12.0),
                   vel_ned=[20.0, 4.0, -1.0])
    h.update_lla([45.0, -93.0, 300.0])
    h.update_time(10.0, unixtime=t)
    h.set_ned_ref(45.0, -93.0, 0.0)
    h.update_ap("auto", ap_roll=5.0, ap_pitch=3.0, ap_hdg=15.0)
    h.update_act(0.1, 0.1, 0.5, 0.0)
    h.update_pilot(0.3, -0.2, 0.7, 0.1)
    h.update_airdata(alpha_rad=0.03, beta_rad=0.01)
    h.update_features([[300.0, e * 20.0, 0.0] for e in range(-3, 4)])
    for k in range(10):
        h.update_ned_history(float(k), [100.0 + 30.0 * k, 0.0, -110.0])
    h.show_compass = True
    return h.draw(np.zeros((360, 480, 3), np.uint8))


def _share_differing(a, b):
    assert a.shape == b.shape
    return float((a != b).any(axis=-1).mean())


@pytest.mark.parametrize("style", ["classic", "glass"])
def test_hud_frame_matches_reference(style):
    want = _full_hud(jhud, jcam, jrot, style)
    got = _full_hud(thud, tcam, trot, style)
    assert (want.sum(-1) > 30).sum() > 1000
    assert _share_differing(got, want) <= 1e-3


def _read_all(path):
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, fr = cap.read()
        if not ok:
            break
        frames.append(fr)
    cap.release()
    return frames


def test_overlay_video_matches_reference(footage, tmp_path):
    from imageanalysis_tpu.video import flight_data as jfd
    from imageanalysis_tpu_torch.video import flight_data as tfd

    outs = []
    for name, hud_mod, cam_mod, fd in (("j", jhud, jcam, jfd),
                                       ("t", thud, tcam, tfd)):
        out = str(tmp_path / f"{name}.mp4")
        state_fn = fd.FlightLog(footage["log"]).state_fn(time_shift=SHIFT)
        n = hud_mod.overlay_video(footage["movie"].path, out,
                                  cam_mod.VirtualCamera(dict(CAM)), state_fn,
                                  max_frames=3, alpha=0.8)
        assert n == 3
        outs.append(_read_all(out))
    assert len(outs[0]) == len(outs[1]) == 3
    for w, g in zip(*outs):
        assert _share_differing(g, w) <= 1e-3


@pytest.mark.parametrize("tool", ["overlay_video", "stabilize_video"])
def test_writer_that_does_not_open_raises(footage, tmp_path, tool):
    """The deliberate divergence: where cv2.VideoWriter does not open, the
    reference writes nothing and says nothing; the port raises."""
    out = str(tmp_path / "no_such_dir" / "out.mp4")
    path = footage["movie"].path
    with pytest.raises(OSError, match="VideoWriter"):
        if tool == "overlay_video":
            thud.overlay_video(path, out, tcam.VirtualCamera(dict(CAM)),
                               lambda t: dict(ned=[0, 0, -100.0],
                                              quat=[1.0, 0, 0, 0],
                                              ypr_deg=(0, 0, 0)),
                               max_frames=2)
        else:
            tstabilize.stabilize_video(path, out, max_frames=12,
                                       device="cpu")
    assert not os.path.exists(out)


def test_dji_log_and_extracted_frames_match_reference(footage, tmp_path):
    logs = [m.DjiCsv().load(footage["dji"]) for m in (jdjilog, tdjilog)]
    assert logs[1].records == logs[0].records
    assert [r["unix_sec"] for r in logs[1].records] == \
        [r[0] for r in footage["dji_rows"]]
    for t in (0.0, 1.5, 3.25):
        u = logs[0].records[0]["unix_sec"] + t
        assert logs[1].query(u) == logs[0].query(u)
    assert tdjilog.parse_srt(footage["srt"]) == \
        jdjilog.parse_srt(footage["srt"])
    dirs = [str(tmp_path / k) for k in ("j", "t")]
    names = [m.extract_frames(footage["movie"].path, log, d, interval=0.3)
             for m, log, d in zip((jdjilog, tdjilog), logs, dirs)]
    assert names[1] == names[0] and len(names[0]) == 4
    assert filecmp.cmp(*(os.path.join(d, "pix4d.csv") for d in dirs),
                       shallow=False)
    frames = _read_all(footage["movie"].path)
    for i, name in enumerate(names[1]):
        paths = [os.path.join(d, name) for d in dirs]
        assert texif.get_pose(paths[1]) == jexif.get_pose(paths[0]) \
            == texif.get_pose(paths[0])
        # the frame as cv2.imwrite wrote it, Exif aside
        enc = cv2.imencode(".jpg", frames[_grab(i)],
                           [cv2.IMWRITE_JPEG_QUALITY, 95])[1]
        np.testing.assert_array_equal(
            cv2.imread(paths[1]), cv2.imdecode(enc, cv2.IMREAD_COLOR))


def _grab(i, interval=0.3, fps=synth.FPS):
    """The frame index extract_frames takes for its i-th frame."""
    k, nxt = 0, 0.0
    taken = []
    while len(taken) <= i:
        if k / fps + 1e-9 >= nxt:
            taken.append(k)
            nxt += interval
        k += 1
    return taken[i]


def _flight_data(fd, d):
    t = np.arange(0, 20, 0.1)
    with open(d / "horiz.csv", "w") as f:
        f.write("flight time (sec),ekf roll error (rad),"
                "ekf pitch error (rad)\n")
        for i, ti in enumerate(t):
            roll = 0.5 if i == 50 else 0.02 * np.sin(ti)
            f.write(f"{ti:.2f},{roll:.6f},{0.01 * np.cos(ti):.6f}\n")
    (d / "old.txt").write_text("0.0 0.1 0.2 0.3 1.0 2.0 3.0\n"
                               "10.0 0.1 0.2 0.3 1.0 2.0 3.0\n")
    with open(d / "feat.csv", "w") as f:
        f.write("video time,p (rad/sec),q (rad/sec),r (rad/sec),"
                "hp (rad/sec),hq (rad/sec),hr (rad/sec)\n")
        for ti in t:
            f.write(f"{ti:.2f},{0.1 * np.sin(ti):.6f},0.0,0.0,"
                    f"{0.1 * np.sin(ti):.6f},0.0,0.0\n")
    with open(d / "hor.csv", "w") as f:
        f.write("video time,camera roll (deg),camera pitch (deg)\n")
        for ti in t:
            f.write(f"{ti:.2f},{10 * np.sin(ti):.4f},{2 * ti:.4f}\n")
    corr = fd.AttitudeCorrection().load_horiz(str(d / "horiz.csv"))
    corr2 = fd.AttitudeCorrection().load_old(str(d / "old.txt"))
    fr = fd.FeatureRates().load(str(d / "feat.csv")).smooth(2.0) \
        .make_interp()
    hl = fd.HorizonLog().load(str(d / "hor.csv")).make_rates()
    r_i, p_i = hl.interp_attitude()
    out = [list(corr.query(x).values()) + list(corr2.query(x).values())
           + list(fr.query_rates(x)) + [r_i(x), p_i(x)]
           for x in (1.0, 5.0, 5.05, 12.3)]
    out.append(list(hl.q))
    return out


def _flight_state(fd, log):
    fn = fd.FlightLog(log).state_fn(time_shift=SHIFT)
    out = []
    for t in (0.0, 0.4, 0.9):
        s = fn(t)
        out.append(np.concatenate([s["ned"], s["quat"], s["ypr_deg"],
                                   s["vel_ned"], [s["airspeed"],
                                                  s["altitude"]]]))
    return out


def _ephemeris(eph, ils, with_ils):
    out = []
    for y, mo, d, h in ((2000, 3, 20, 12), (2015, 7, 2, 2), (2023, 6, 21,
                                                              17)):
        t = datetime.datetime(y, mo, d, h, 7,
                              tzinfo=datetime.timezone.utc).timestamp()
        jd = eph._julian_day(t)
        out.append([*eph.sun_radec(jd), *eph.moon_radec(jd),
                    *eph.radec_to_azalt(*eph.sun_radec(jd), 51.48, 0.0, jd)])
        out.append(np.concatenate(eph.sun_moon_ned(-93.0, 45.0, 300.0, t)))
        if with_ils:
            out.append([ils.sun_angle_deg(45.0, -93.0, 300.0, ypr, t)
                        for ypr in ((0, 0, 0), (10, 5, 40), (200, -8, -20))])
    if with_ils:
        rows = [("a.jpg", 45.0, -93.0, 300.0, 0.0, 0.0, 0.0, 1000.0),
                ("b.jpg", 45.0, -93.0, 300.0, 0.0, 0.0, 40.0, 700.0)]
        out.append([r[1:] for r in ils.correction_factors(rows, t)])
    return out


def _mount(mount, rot):
    rng = np.random.default_rng(9)
    R_map = np.asarray(rot.quat_to_matrix(rot.quat_from_ypr(0.1, -1.5,
                                                            0.05))).T
    body = rng.normal(0, 0.5, (300, 3))
    cam = body @ R_map.T + rng.normal(0, 0.01, (300, 3))
    ypr, R, rms = mount.estimate_mount(body, cam)
    t_f = np.arange(0, 30, 1 / 50)
    body2 = rng.normal(0, 1, (len(t_f), 3))
    t_m = np.arange(0, 20, 1 / 30)
    cam2 = np.column_stack([np.interp(t_m + 4.2, t_f, (body2 @ R_map.T)[:, i])
                            for i in range(3)])
    ypr2, R2, rms2 = mount.estimate_mount_from_logs(t_f, body2, t_m, cam2,
                                                    4.2)
    return [ypr, R.ravel(), [rms], ypr2, R2.ravel(), [rms2]]


def _horizon(horizon):
    K = np.array([[700.0, 0, 320], [0, 700.0, 240], [0, 0, 1]])
    out = []
    yy, xx = np.mgrid[0:480, 0:640]
    for roll_deg in (0.0, 10.0, -15.0):
        img = np.zeros((480, 640, 3), np.uint8)
        sky = (yy - 250) < -np.tan(np.radians(roll_deg)) * (xx - 320)
        img[sky] = (230, 160, 120)
        img[~sky] = (40, 90, 60)
        for otsu in (True, False):
            r, p, line = horizon.detect_horizon(img, K, do_otsu=otsu)
            out.append([r, p, *line])
    return out


def _aruco(aruco_mod, path):
    K = np.array([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]])
    recs = aruco_mod.track_video(path, K, np.zeros(5), marker_len_m=0.1)
    assert len(recs) >= 4
    return [np.concatenate([r[:3], np.ravel(r[3]), np.ravel(r[4])])
            for r in recs]


@pytest.fixture(scope="module")
def aruco_movie(tmp_path_factory):
    aruco = cv2.aruco
    marker = aruco.generateImageMarker(
        aruco.getPredefinedDictionary(aruco.DICT_4X4_50), 7, 120)
    path = str(tmp_path_factory.mktemp("aruco") / "ar.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30, (640, 480))
    for i in range(6):
        frame = np.full((480, 640), 180, np.uint8)
        frame[180:300, 100 + i * 8:220 + i * 8] = marker
        w.write(cv2.cvtColor(frame, cv2.COLOR_GRAY2BGR))
    w.release()
    return path


@pytest.mark.parametrize("module", ["flight_data", "ephemeris", "ils",
                                    "mount", "horizon", "aruco"])
def test_host_module_matches_reference(module, footage, aruco_movie,
                                       tmp_path):
    """The host copies on the reference tests' inputs: equal to float
    tolerance (float64 numpy on both sides; the rotations float32)."""
    import importlib

    def mods(name):
        return [importlib.import_module(f"{p}.video.{name}")
                for p in ("imageanalysis_tpu", "imageanalysis_tpu_torch")]

    if module == "flight_data":
        want, got = (_flight_data(m, tmp_path / k)
                     for m, k in zip(mods(module), ("j", "t"))
                     if not (tmp_path / k).mkdir())
        want2, got2 = (_flight_state(m, footage["log"])
                       for m in mods(module))
        want, got = want + want2, got + got2
    elif module in ("ephemeris", "ils"):
        want, got = (_ephemeris(e, i, module == "ils")
                     for e, i in zip(mods("ephemeris"), mods("ils")))
    elif module == "mount":
        want, got = (_mount(m, r) for m, r in zip(mods("mount"),
                                                   (jrot, trot)))
    elif module == "horizon":
        want, got = (_horizon(m) for m in mods(module))
    else:
        want, got = (_aruco(m, aruco_movie) for m in mods(module))
    assert len(got) == len(want)
    tol = 1e-5 if module in ("ils", "mount") else 1e-9   # float32 rotations
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g, float), np.asarray(w, float),
                                   rtol=tol, atol=tol)


def _artifacts(app, d, footage, cmd):
    """Run one subcommand of app into d; returns what it wrote."""
    path = footage["movie"].path
    if cmd == "est-gyro-rates":
        out = str(d / "motion.csv")
        argv = [cmd, path, "--out", out, "--max-frames", "20"]
    elif cmd == "stabilize":
        out = str(d / "stab.mp4")
        argv = [cmd, path, "--out", out, "--max-frames", "15"]
    elif cmd == "hud-overlay":
        motion = str(d / "motion.csv")
        assert run_app(app, ["est-gyro-rates", path, "--out", motion]) == 0
        out = str(d / "hud.mp4")
        argv = [cmd, path, "--flight", footage["log"], "--movie-csv",
                motion, "--style", "glass", "--max-frames", "1", "--out",
                out]
    else:
        out = str(d / "frames")
        argv = [cmd, path, "--log", footage["dji"], "--out-dir", out,
                "--interval", "0.5", "--srt", footage["srt"]]
    assert run_app(app, argv) == 0
    return out


def run_app(app, argv):
    if app is tvideo_app:
        return app.main(argv, device="cpu")
    return app.main(argv)


@pytest.mark.parametrize("cmd", ["est-gyro-rates", "stabilize",
                                 "hud-overlay", "extract-dji"])
def test_video_app_writes_reference_artifacts(footage, tmp_path, cmd):
    outs = []
    for app, k in ((jvideo_app, "j"), (tvideo_app, "t")):
        (tmp_path / k).mkdir()
        outs.append(_artifacts(app, tmp_path / k, footage, cmd))
    want, got = outs
    if cmd == "est-gyro-rates":
        rows = [list(csv.reader(open(p))) for p in (want, got)]
        assert rows[1][0] == rows[0][0] and len(rows[1]) == len(rows[0]) == 20
        for g, w in zip(rows[1][1:], rows[0][1:]):
            assert g[:2] == w[:2]
            np.testing.assert_allclose(np.float64(g[2:]), np.float64(w[2:]),
                                       atol=0.011)   # one unit of rounding
    elif cmd == "extract-dji":
        assert sorted(os.listdir(got)) == sorted(os.listdir(want))
        assert filecmp.cmp(os.path.join(got, "pix4d.csv"),
                           os.path.join(want, "pix4d.csv"), shallow=False)
    else:
        fw, fg = _read_all(want), _read_all(got)
        assert len(fg) == len(fw) == (15 if cmd == "stabilize" else 1)
        for g, w in zip(fg, fw):
            if cmd == "stabilize":   # sub-pixel warps of float32 fits
                assert np.abs(g.astype(int) - w).mean() < 1.0
            else:
                assert _share_differing(g, w) <= 1e-3

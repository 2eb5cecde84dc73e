"""Port parity: EXIF and XMP (``io/exif.py``) and Steps 1–2 from EXIF.

The port's host parser against the reference's PIL reader on the same
files, and the port's writer read back through the reference's reader:

- the reader: ``get_pose`` and ``get_camera_info`` equal on a JPEG
  tagged by the reference's PIL ``write_geotag`` (little-endian ``II``),
  on a big-endian ``MM`` Exif block built here, on DJI-XMP files and on a
  file with no EXIF;
- the writer: its output reads back equal through the reference's
  reader; the entropy-coded bytes stay as they were (the deliberate
  divergence: the reference re-encodes through PIL); a negative altitude
  reads back positive (GPSAltitudeRef ignored, the reference's quirk);
- ``unixtime`` is a naive local-time timestamp, and the Mavic Mini 2
  (FC7303) reads flight yaw (both quirks of the reference);
- Steps 1–2: ``make_pix4d`` (with XMP yaw, from the ground track, the
  Phantom 4 raise and an existing file), ``estimate_from_exif`` and
  ``detect_camera`` equal the reference's on the same files; the frames
  that ``write_mission(exif=True)`` tags give back the mission's aircraft
  attitude through the reference's ``make_pix4d``.

Every comparison is exact: both sides compute the same float64 values
from the same integers.
"""

import datetime
import os
import shutil
import struct
import time

import numpy as np
import pytest

from imageanalysis_tpu.io import camera_db as jcamera_db
from imageanalysis_tpu.io import exif as jexif
from imageanalysis_tpu.io import pose as jpose
from imageanalysis_tpu.io import project as jproject
from imageanalysis_tpu_torch.io import camera_db as tcamera_db
from imageanalysis_tpu_torch.io import exif as texif
from imageanalysis_tpu_torch.io import pose as tpose
from imageanalysis_tpu_torch.io import project as tproject
from imageanalysis_tpu_torch.testing import synthetic

COLOUR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "jpeg", "colour.jpg")


def _copy(tmp_path, name):
    path = str(tmp_path / name)
    shutil.copy(COLOUR, path)
    return path


def _insert(path, segment):
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[:2] + segment + data[2:])


def _xmp(attrs):
    body = " ".join(f'{k}="{v}"' for k, v in attrs.items())
    xmp = (f'<x:xmpmeta xmlns:x="adobe:ns:meta/"><rdf:Description {body}/>'
           f'<Camera:Roll>1.25</Camera:Roll></x:xmpmeta>').encode()
    payload = b"http://ns.adobe.com/xap/1.0/\x00" + xmp
    return b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload


def _mm_exif():
    """A big-endian Exif APP1 built by hand: IFD0 (Make, Model, DateTime,
    the two pointers), the Exif IFD (FocalLength, LensModel) and the GPS
    IFD (S, W, altitude below sea level), values inline and out of line."""
    def ifd(entries, start):
        data_at = start + 2 + 12 * len(entries) + 4
        head, tail = struct.pack(">H", len(entries)), b""
        for tag, typ, count, raw in entries:
            if len(raw) <= 4:
                head += struct.pack(">HHI", tag, typ, count) + raw.ljust(4,
                                                                      b"\0")
            else:
                head += struct.pack(">HHII", tag, typ, count,
                                    data_at + len(tail))
                tail += raw
        return head + struct.pack(">I", 0) + tail

    def rat(*pairs):
        return b"".join(struct.pack(">II", n, d) for n, d in pairs)

    exif_e = [(0x920A, 5, 1, rat((4500, 1000))),
              (0xA434, 2, 9, b"Wide Len\0")]
    gps_e = [(1, 2, 2, b"S\0"), (2, 5, 3, rat((33, 1), (51, 1), (123456,
                                                                  10000))),
             (3, 2, 2, b"W\0"), (4, 5, 3, rat((70, 1), (30, 1), (1, 4))),
             (5, 1, 1, b"\x01"), (6, 5, 1, rat((1234, 100)))]
    ifd0_e = [(0x010F, 2, 4, b"DJI\0"), (0x0110, 2, 7, b"FC6310\0"),
              (0x0132, 2, 20, b"2021:06:30 14:05:09\0"),
              (0x8769, 4, 1, b""), (0x8825, 4, 1, b"")]
    size0 = len(ifd(ifd0_e, 8))
    exif_at = 8 + size0
    exif_blob = ifd(exif_e, exif_at)
    gps_at = exif_at + len(exif_blob)
    ifd0_e[3] = (0x8769, 4, 1, struct.pack(">I", exif_at))
    ifd0_e[4] = (0x8825, 4, 1, struct.pack(">I", gps_at))
    tiff = (b"MM\0*" + struct.pack(">I", 8) + ifd(ifd0_e, 8) + exif_blob
            + ifd(gps_e, gps_at))
    payload = b"Exif\0\0" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload


def _kinds(tmp_path):
    """{kind: path} of the files both readers are held to."""
    files = {"none": _copy(tmp_path, "none.jpg")}
    files["pil_ii"] = _copy(tmp_path, "pil.jpg")
    jexif.write_geotag(files["pil_ii"], 44.9712345, -93.2612345, 287.456,
                       unixtime=1_600_000_000.0)
    files["mm"] = _copy(tmp_path, "mm.jpg")
    _insert(files["mm"], _mm_exif())
    files["dji"] = _copy(tmp_path, "dji.jpg")
    _insert(files["dji"], _xmp({
        "drone-dji:GpsLatitude": "+45.123456789",
        "drone-dji:GpsLongitude": "-93.5",
        "drone-dji:AbsoluteAltitude": "-12.5",
        "drone-dji:GimbalYawDegree": "-45.3",
        "drone-dji:GimbalPitchDegree": "-89.9",
        "drone-dji:GimbalRollDegree": "0.1", "tiff:Model": "FC6310"}))
    files["mavic"] = _copy(tmp_path, "mavic.jpg")
    jexif.write_geotag(files["mavic"], -1.5, 2.5, 10.0)
    _insert(files["mavic"], _xmp({
        "drone-dji:GimbalYawDegree": "12.0",
        "drone-dji:FlightYawDegree": "-170.5", "tiff:Model": "FC7303"}))
    return files


@pytest.mark.parametrize("kind", ["none", "pil_ii", "mm", "dji", "mavic"])
def test_reader_matches_reference(tmp_path, kind):
    path = _kinds(tmp_path)[kind]
    assert texif.get_pose(path) == jexif.get_pose(path)
    assert texif.get_camera_info(path) == jexif.get_camera_info(path)


def test_reader_quirks_of_the_reference(tmp_path, monkeypatch):
    files = _kinds(tmp_path)
    # the Mavic Mini 2 reads flight yaw (−170.5 → 189.5), not gimbal yaw
    assert texif.get_pose(files["mavic"])[4] == 189.5
    # GPSAltitudeRef 1 (below sea level) is ignored: 12.34 m reads positive
    assert texif.get_pose(files["mm"])[2] == 12.34
    # DateTime is a naive local time: the timestamp moves with TZ
    stamps = []
    try:
        with monkeypatch.context() as mp:
            for tz in ("UTC", "America/Chicago"):
                mp.setenv("TZ", tz)
                time.tzset()
                stamps.append(texif.get_pose(files["mm"])[3])
                assert stamps[-1] == datetime.datetime(2021, 6, 30, 14, 5,
                                                       9).timestamp()
    finally:
        time.tzset()
    assert stamps[1] - stamps[0] == 5 * 3600


def test_writer_reads_back_through_reference(tmp_path):
    """The port's write_geotag on the MM file: the reference reads the
    GPS and DateTime written and the camera tags kept; the bytes after the
    Exif segment (the scan) are unchanged, where PIL re-encodes."""
    files = _kinds(tmp_path)
    src = files["mm"]
    with open(src, "rb") as f:
        before = f.read()
    out = str(tmp_path / "out.jpg")
    texif.write_geotag(src, 44.5, -93.25, -20.25, unixtime=1_650_000_000.0,
                       out_file=out)
    lon, lat, alt, t, *_ = jexif.get_pose(out)
    assert (lat, lon) == pytest.approx((44.5, -93.25), abs=1e-9)
    assert alt == 20.25                  # the negative altitude: positive
    assert t == 1_650_000_000.0
    assert jexif.get_camera_info(out) == jexif.get_camera_info(src)
    assert texif.get_pose(out) == jexif.get_pose(out)
    with open(out, "rb") as f:
        after = f.read()
    sos = before.index(b"\xff\xda")
    assert after.endswith(before[sos:])
    # the reference's writer re-encodes the scan
    ref = str(tmp_path / "ref.jpg")
    jexif.write_geotag(files["none"], 44.5, -93.25, 20.25, out_file=ref)
    with open(files["none"], "rb") as f:
        orig = f.read()
    with open(ref, "rb") as f:
        assert not f.read().endswith(orig[orig.index(b"\xff\xda"):])
    # a file without EXIF gains one; the same values as PIL writes
    mine = str(tmp_path / "mine.jpg")
    texif.write_geotag(files["none"], 44.5, -93.25, 20.25, out_file=mine)
    assert jexif.get_pose(mine) == jexif.get_pose(ref)


def _tagged_folder(tmp_path, yaw=True):
    """Three colour frames along a track, tagged by the port's writer;
    with yaw, a DJI XMP attitude each."""
    d = tmp_path / "imgs"
    d.mkdir()
    for i in range(3):
        p = str(d / f"IMG_{i:04d}.jpg")
        shutil.copy(COLOUR, p)
        if yaw:
            _insert(p, synthetic.xmp_segment(10.0 * i - 5.0, -88.5 + i,
                                             0.25 * i))
        texif.write_geotag(p, 44.97 + 1e-4 * i, -93.26 + 2e-4 * i * i,
                           120.0 + i, unixtime=1.6e9 + i)
    return str(d)


@pytest.mark.parametrize("groundtrack", [False, True],
                         ids=["xmp_yaw", "groundtrack"])
def test_make_pix4d_matches_reference(tmp_path, groundtrack):
    src = _tagged_folder(tmp_path, yaw=not groundtrack)
    dst = str(tmp_path / "t")
    shutil.copytree(src, dst)
    kw = dict(camera_make="DJI", camera_model="FC7303")
    want = jpose.make_pix4d(src, **kw)
    got = tpose.make_pix4d(dst, **kw)
    with open(want) as a, open(got) as b:
        assert b.read() == a.read()
    with pytest.raises(FileExistsError):
        tpose.make_pix4d(dst)


def test_make_pix4d_phantom4_raises(tmp_path):
    with pytest.raises(RuntimeError, match="Phantom 4"):
        tpose.make_pix4d(str(tmp_path), camera_make="DJI",
                         camera_model="FC6310")


def test_estimate_from_exif_and_detect_camera_match_reference(tmp_path):
    files = _kinds(tmp_path)
    for kind in ("mm", "pil_ii", "none"):
        assert tcamera_db.estimate_from_exif(files[kind]) == \
            jcamera_db.estimate_from_exif(files[kind])
    d = tmp_path / "proj"
    d.mkdir()
    shutil.copy(files["mm"], d / "IMG_0001.jpg")
    shutil.copy(files["none"], d / "IMG_0002.jpg")
    key = tproject.ProjectMgr(str(d), create=True).detect_camera()
    assert key == jproject.ProjectMgr(str(d), create=True).detect_camera()
    assert key == "DJI_FC6310_Wide_Len"


def test_write_mission_exif_gives_back_the_attitude(tmp_path):
    """write_mission(exif=True)'s frames through the reference's
    make_pix4d: the mission's aircraft attitude (yaw mod 360) and
    positions, within the CSV's rounding and DMS's 1e-4 arcsecond."""
    m = synthetic.make_mission(strips=1, per_strip=3, size=(96, 64),
                               seed=2, device="cpu")
    d = str(tmp_path / "m")
    synthetic.write_mission(d, m, str(tmp_path / "db"), exif=True)
    assert not os.path.exists(os.path.join(d, "pix4d.csv"))
    rows = [ln.split(",") for ln in
            open(jpose.make_pix4d(d)).read().splitlines()[1:]]
    lla = synthetic.geodesy.ned2lla(m.ned, *synthetic.REF_LLA)
    for row, (lat, lon, alt), (y, p, r) in zip(rows, lla, m.aircraft_ypr):
        got = [float(v) for v in row[1:]]
        assert got[0:2] == pytest.approx([lat, lon], abs=1e-4 / 3600 + 1e-9)
        assert abs(got[2] - alt) <= 0.01
        assert abs(got[3] - r) <= 0.005 and abs(got[4] - p) <= 0.005
        assert abs((got[5] - y + 180.0) % 360.0 - 180.0) <= 0.005
    key = tproject.ProjectMgr(d, create=True).detect_camera()
    assert key == synthetic.CAMERA_KEY
    cfg = tcamera_db.estimate_from_exif(os.path.join(d, "IMG_0000.jpg"))
    assert cfg["K"][0] == pytest.approx(m.K[0, 0], rel=1e-6)
    np.testing.assert_array_equal(cfg["K"], jcamera_db.estimate_from_exif(
        os.path.join(d, "IMG_0000.jpg"))["K"])

"""Synthetic flight footage and logs for the video and motion tools.

The inputs of ``apps/video.py`` made from a seed, as the reference's video
tests make theirs (a textured plane warped by cv2 and written as mp4v):

- ``write_flight_movie``: a textured ground seen by a camera that rotates
  about its optical axis at a planted, band-limited rate while the view
  drifts at a planted speed; each frame is one ``cv2.warpAffine`` of a
  seeded texture, so the frame-to-frame similarity is known exactly;
- ``write_mover_movie``: the same ground from a still camera, with a
  bright block crossing it (the segmenter's input: its DMD background
  assumes a camera that does not move);
- ``write_flight_log``: a flight-log CSV of ``video/flight_data.FlightLog``
  whose yaw rate is the movie's planted rate, ``shift`` seconds later
  (movie time + shift = flight time, ``correlate.sync_clocks``'s sign);
- ``write_dji_csv`` and ``write_srt``: a DJI flight record and its caption
  file, in the formats that ``video/djilog.py`` parses.

Host numpy and cv2, like the tools they feed.
"""

from __future__ import annotations

import csv
import datetime
from typing import NamedTuple

import numpy as np

FPS = 30.0


class FlightMovie(NamedTuple):
    path: str
    size: tuple          # (W, H)
    fps: float
    times: np.ndarray    # (T,) frame times, s
    angle_deg: np.ndarray   # (T,) planted image rotation of each frame
    drift: np.ndarray    # (T, 2) planted view offset, px
    rate_t: np.ndarray   # the planted rate's time grid, s (covers the log)
    rate_deg_s: np.ndarray  # the planted rate on rate_t


def planted_rate(seed, t0, t1, hz=100.0, mean_deg_s=8.0, amp_deg_s=10.0,
                 cutoff_hz=1.0):
    """(t, rate deg/s) on [t0, t1] at hz: mean plus zero-mean noise cut at
    cutoff_hz and scaled to amp_deg_s standard deviation."""
    rng = np.random.default_rng(seed)
    t = np.arange(t0, t1, 1.0 / hz)
    spec = np.fft.rfft(rng.normal(size=len(t)))
    spec[np.fft.rfftfreq(len(t), 1.0 / hz) > cutoff_hz] = 0.0
    wave = np.fft.irfft(spec, len(t))
    return t, mean_deg_s + amp_deg_s * wave / wave.std()


def ground_texture(seed, size):
    """(size, size) uint8 seeded texture: blurred noise, full range."""
    import cv2

    rng = np.random.default_rng(seed)
    base = cv2.GaussianBlur(rng.uniform(0, 255, (size, size))
                            .astype(np.float32), (0, 0), 2)
    return cv2.normalize(base, None, 0, 255, cv2.NORM_MINMAX) \
        .astype(np.uint8)


def view_matrix(canvas, size, angle_deg, offset):
    """The 2×3 affine taking canvas pixels to the frame of (W, H) size: a
    rotation by angle_deg about the canvas point center + offset, which
    lands on the frame's center."""
    import cv2

    c = (canvas / 2.0 + offset[0], canvas / 2.0 + offset[1])
    M = cv2.getRotationMatrix2D(c, float(angle_deg), 1.0)
    M[0, 2] += size[0] / 2.0 - c[0]
    M[1, 2] += size[1] / 2.0 - c[1]
    return M


def _writer(path, fps, size):
    import cv2

    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, size)
    if not w.isOpened():
        raise OSError(f"cv2.VideoWriter cannot open {path}")
    return w


def write_flight_movie(path, seed=0, size=(1920, 1080), n_frames=300,
                       fps=FPS, drift_px_s=(12.0, -6.0), mean_deg_s=8.0,
                       amp_deg_s=10.0, log_pad_s=6.0):
    """A gray, 3-channel mp4v movie of the rotating, drifting camera, whose
    image turns by angle_deg (the sign of frame_motion's rotation).
    Returns its FlightMovie (the planted rate covers log_pad_s beyond the
    movie on either side, for a flight log that outlasts it)."""
    import cv2

    W, H = size
    dur = n_frames / fps
    rate_t, rate = planted_rate(seed + 1, -log_pad_s, dur + log_pad_s,
                                mean_deg_s=mean_deg_s, amp_deg_s=amp_deg_s)
    times = np.arange(n_frames) / fps
    cum = np.concatenate([[0.0], np.cumsum(rate[:-1] * np.diff(rate_t))])
    angle = np.interp(times, rate_t, cum) - np.interp(0.0, rate_t, cum)
    drift = times[:, None] * np.asarray(drift_px_s, float)[None]
    reach = np.abs(drift).max()
    canvas = int(np.ceil(np.hypot(W, H) + 2 * reach)) + 16
    tex = ground_texture(seed, canvas)
    w = _writer(path, fps, (W, H))
    try:
        for i in range(n_frames):
            fr = cv2.warpAffine(tex, view_matrix(canvas, (W, H), -angle[i],
                                                 drift[i]), (W, H))
            w.write(cv2.cvtColor(fr, cv2.COLOR_GRAY2BGR))
    finally:
        w.release()
    return FlightMovie(path, (W, H), fps, times, angle, drift, rate_t, rate)


def block_box(i, size, block, speed_px):
    """(x0, y0, x1, y1) of the mover in frame i: block (w, h) px crossing
    the frame left to right at speed_px a frame, centred vertically."""
    W, H = size
    bw, bh = block
    x0 = int(round(W * 0.1 + speed_px * i))
    y0 = (H - bh) // 2
    return x0, y0, x0 + bw, y0 + bh


def write_mover_movie(path, seed=0, size=(1920, 1080), n_frames=120,
                      fps=FPS, block=None, speed_px=None):
    """A still camera over the seeded ground with a white block crossing
    it, by default W/16 px square at W/160 px a frame (120 px at 12 px a
    frame in 1080p). Returns the block's boxes, one a frame (block_box)."""
    import cv2

    W, H = size
    block = block or (W // 16, W // 16)
    speed_px = speed_px or W / 160.0
    tex = ground_texture(seed, max(W, H))[:H, :W]
    boxes = []
    w = _writer(path, fps, (W, H))
    try:
        for i in range(n_frames):
            fr = tex.copy()
            x0, y0, x1, y1 = block_box(i, size, block, speed_px)
            fr[y0:y1, x0:x1] = 255
            boxes.append((x0, y0, x1, y1))
            w.write(cv2.cvtColor(fr, cv2.COLOR_GRAY2BGR))
    finally:
        w.release()
    return boxes


def write_flight_log(path, movie: FlightMovie, shift, hz=50.0,
                     ref_lla=(44.97, -93.26, 300.0), speed_m_s=20.0):
    """A FlightLog CSV (time, lat, lon, alt, roll, pitch, yaw, vn, ve, vd,
    airspeed) whose yaw rate at flight time t is the movie's planted rate
    at movie time t − shift; flight time starts at 0, so the movie starts
    at flight time shift. Level flight north at speed_m_s."""
    t_f = np.arange(0.0, movie.times[-1] + shift + 2.0, 1.0 / hz)
    cum = np.concatenate([[0.0], np.cumsum(movie.rate_deg_s[:-1]
                                           * np.diff(movie.rate_t))])
    yaw = np.interp(t_f - shift, movie.rate_t, cum)
    yaw = (yaw - yaw[0] + 30.0) % 360.0
    lat0, lon0, alt0 = ref_lla
    north = speed_m_s * t_f
    lat = lat0 + np.degrees(north / 6378137.0)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["time", "lat", "lon", "alt", "roll", "pitch", "yaw",
                    "vn", "ve", "vd", "airspeed"])
        for i in range(len(t_f)):
            w.writerow(["%.4f" % t_f[i], "%.9f" % lat[i], "%.9f" % lon0,
                        "%.2f" % alt0, "2.0", "1.0", "%.5f" % yaw[i],
                        "%.2f" % speed_m_s, "0.0", "0.0",
                        "%.2f" % (speed_m_s + 1.0)])


def _dji_time(start, i):
    """The DJI CSV's local clock ('H:MM:SS AM') i seconds after start, a
    naive datetime."""
    return (start + datetime.timedelta(seconds=i)).strftime("%I:%M:%S %p") \
        .lstrip("0")


def write_dji_csv(path, start, n, lat0=44.97, lon0=-93.26, alt0_ft=300.0):
    """A DJI flight record of n one-second rows from start (naive local
    datetime): lat/lon stepping 1e-4 deg a second, altitude 1 ft a second,
    gimbal pitch −90, yaw 2 deg a second. The file name must hold the date
    (DJIFlightRecord_YYYY-MM-DD_...), from which the loader takes it.
    Returns the rows as (unix_sec, lat, lon, alt_ft)."""
    rows = []
    lines = ["CUSTOM.updateTime [local], OSD.latitude, OSD.longitude,"
             " OSD.altitude [ft], GIMBAL.pitch, GIMBAL.roll, GIMBAL.yaw"]
    for i in range(n):
        lat, lon, alt = lat0 + 1e-4 * i, lon0 + 1e-4 * i, alt0_ft + i
        lines.append(f"{_dji_time(start, i)},{lat:.4f},{lon:.4f},{alt:.1f},"
                     f"-90.0,0.0,{2 * i}")
        rows.append(((start + datetime.timedelta(seconds=i)).timestamp(),
                     lat, lon, alt))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return rows


def write_srt(path, start, n_s, lat0=44.97, lon0=-93.26):
    """A DJI caption file: one block a second for n_s seconds, each with
    the wall-clock datetime from start and GPS fields."""
    blocks = []
    for i in range(n_s):
        t = start + datetime.timedelta(seconds=i)
        blocks.append(
            f"{i + 1}\n00:00:{i:02d},000 --> 00:00:{i + 1:02d},000\n"
            f"{t.strftime('%Y-%m-%d %H:%M:%S')}\n"
            f"GPS: {lon0 + 1e-4 * i:.4f}, latitude: {lat0 + 1e-4 * i:.4f}\n")
    with open(path, "w") as f:
        f.write("\n".join(blocks))

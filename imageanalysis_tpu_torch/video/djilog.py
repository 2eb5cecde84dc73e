"""DJI flight-log ingestion + video frame extraction/geotagging.

Reference video/djilog.py:17-90 (phantomhelp "verbose" CSV export: local
timestamps, OSD lat/lon/alt, GIMBAL ypr) and video/4-extract-dji-frames.py
(SRT subtitle sync + frame grabs + geotag, feeding the stills pipeline).

EXIF geotag writing (the reference uses pyexiv2, absent here) is replaced by
generating the ``pix4d.csv`` pose file directly — the stills pipeline's
preferred input (io/pose.py) — so extracted frames process unchanged.

Port of the JAX package's ``video/djilog.py``: a copy; the geotag goes
through the port's ``io/exif.write_geotag``, which rewrites only the Exif
APP1.
"""

from __future__ import annotations

import csv
import datetime
import os
import re

import numpy as np

from ..io.logger import log

FT2M = 0.3048


class DjiCsv:
    """Parsed DJI flight log with time interpolation."""

    def __init__(self):
        self.records = []
        self._cols = {}

    def load(self, file_name):
        m = re.search(r"DJIFlightRecord_(\d{4})-(\d{2})-(\d{2})", file_name)
        year, month, day = m.groups() if m else ("1970", "01", "01")
        with open(file_name, encoding="ISO-8859-1") as f:
            reader = csv.DictReader(f)
            for row in reader:
                time_str = row.get("CUSTOM.updateTime [local]") or \
                    row.get("CUSTOM.updateTime")
                unix_sec = _parse_local_time(time_str, year, month, day)
                self.records.append({
                    "unix_sec": unix_sec,
                    "lat": float(row[" OSD.latitude"]),
                    "lon": float(row[" OSD.longitude"]),
                    "baro_alt": float(row[" OSD.altitude [ft]"]) * FT2M,
                    "pitch": float(row[" GIMBAL.pitch"]),
                    "roll": float(row[" GIMBAL.roll"]),
                    "yaw": float(row[" GIMBAL.yaw"]),
                })
        self.records.sort(key=lambda r: r["unix_sec"])
        keys = [k for k in self.records[0] if k != "unix_sec"]
        t = np.array([r["unix_sec"] for r in self.records])
        self._t = t
        self._cols = {k: np.array([r[k] for r in self.records]) for k in keys}
        log(f"dji log: {len(self.records)} records, "
            f"{t[-1] - t[0]:.1f} s span")
        return self

    def query(self, unix_sec):
        return {k: float(np.interp(unix_sec, self._t, v))
                for k, v in self._cols.items()}


def parse_srt(path):
    """DJI caption .srt → [(t_start_s, fields dict)]; extracts the embedded
    ISO timestamp and any 'key: value' telemetry pairs."""
    entries = []
    with open(path, encoding="utf-8", errors="replace") as f:
        blocks = f.read().split("\n\n")
    for block in blocks:
        lines = [ln.strip() for ln in block.strip().splitlines()]
        if len(lines) < 2 or "-->" not in lines[1]:
            continue
        t0 = _parse_srt_time(lines[1].split("-->")[0].strip())
        fields = {}
        for ln in lines[2:]:
            m = re.search(r"(\d{4}-\d{2}-\d{2} \d{2}:\d{2}:\d{2})", ln)
            if m:
                dt = datetime.datetime.strptime(m.group(1), "%Y-%m-%d %H:%M:%S")
                fields["datetime"] = dt.timestamp()
            for key, val in re.findall(r"([A-Za-z_.]+)\s*[:=]\s*(-?[\d.]+)", ln):
                try:
                    fields[key] = float(val)
                except ValueError:
                    pass
        entries.append((t0, fields))
    return entries


def extract_frames(video_path, flight_log: DjiCsv, out_dir, interval=1.0,
                   video_start_unix=None, ref_alt=None, geotag_exif=True):
    """Grab frames every ``interval`` s, save as jpgs, write pix4d.csv from
    the interpolated flight log, and (by default) write the GPS pose back
    into each frame's EXIF like the reference's
    3-extract-and-geotag-frames.py (it uses piexif; io/exif.write_geotag
    rewrites the Exif APP1 with the GPS IFD).

    video_start_unix: unix time of video start; defaults to the log start.
    Returns list of written frame names.
    """
    import cv2

    from ..io import exif as exif_mod

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise FileNotFoundError(video_path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    os.makedirs(out_dir, exist_ok=True)
    if video_start_unix is None:
        video_start_unix = flight_log.records[0]["unix_sec"]

    rows = []
    names = []
    frame_idx = 0
    next_t = 0.0
    base = os.path.splitext(os.path.basename(video_path))[0]
    while True:
        ret, frame = cap.read()
        if not ret:
            break
        t = frame_idx / fps
        if t + 1e-9 >= next_t:
            state = flight_log.query(video_start_unix + t)
            name = f"{base}_{len(names):04d}.jpg"
            cv2.imwrite(os.path.join(out_dir, name), frame,
                        [cv2.IMWRITE_JPEG_QUALITY, 95])
            alt = state["baro_alt"] if ref_alt is None else ref_alt + state["baro_alt"]
            if geotag_exif:
                exif_mod.write_geotag(os.path.join(out_dir, name),
                                      state["lat"], state["lon"], alt,
                                      unixtime=video_start_unix + t)
            rows.append([name, state["lat"], state["lon"], alt,
                         state["roll"], state["pitch"], state["yaw"]])
            names.append(name)
            next_t += interval
        frame_idx += 1
    cap.release()

    pix4d = os.path.join(out_dir, "pix4d.csv")
    with open(pix4d, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["File Name", "Lat (decimal degrees)",
                    "Lon (decimal degrees)", "Alt (meters MSL)",
                    "Roll (decimal degrees)", "Pitch (decimal degrees)",
                    "Yaw (decimal degrees)"])
        for name, lat, lon, alt, roll, pitch, yaw in rows:
            w.writerow([name, "%.10f" % lat, "%.10f" % lon, "%.2f" % alt,
                        "%.2f" % roll, "%.2f" % pitch, "%.2f" % yaw])
    log(f"extracted {len(names)} frames + pix4d.csv to {out_dir}")
    return names


def _parse_local_time(time_str, year, month, day):
    t, ampm = time_str.split(" ")
    parts = t.split(":")
    hour = int(parts[0])
    if ampm.upper() == "PM" and hour != 12:
        hour += 12
    sec = float(parts[2])
    dt = datetime.datetime(int(year), int(month), int(day), hour,
                           int(parts[1]), int(sec))
    return dt.timestamp() + (sec - int(sec))


def _parse_srt_time(s):
    h, m, rest = s.split(":")
    sec = float(rest.replace(",", "."))
    return int(h) * 3600 + int(m) * 60 + sec

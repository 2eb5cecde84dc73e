"""Flight/video log tables for the HUD-overlay pipeline.

Numpy/scipy replacements for the reference's pandas log helpers:

- ``AttitudeCorrection`` — per-time attitude(+position) error tables that
  correct the flight log before HUD projection (reference
  video/correction.py:20-111: horiz CSV with ekf roll/pitch errors —
  sanitized at |err| > 0.08 rad, 1 Hz butterworth-filtered — or the
  legacy whitespace table with ypr + ned errors);
- ``FeatureRates`` — per-frame camera rotation rates from the feature
  tracker CSV, smoothed + interpolated (reference video/feat_data.py);
- ``HorizonLog`` — per-frame camera roll/pitch from the horizon tracker
  CSV, with finite-difference p/q rate estimation (reference
  video/horiz_data.py make_rates);
- ``load_feature_ned`` — triangulated feature points re-expressed in an
  external NED reference for HUD draw_features (reference
  video/features.py).

Port of the JAX package's ``video/flight_data.py``: a copy over the port's
``core/geodesy.py`` (float64 numpy) and ``core/rotations.py`` (float32, as
the reference's jnp).
"""

from __future__ import annotations

import csv
import re

import numpy as np

D2R = np.pi / 180.0


def _interp1(x, y):
    x = np.asarray(x, float)
    y = np.asarray(y, float)

    def f(t):
        return np.interp(t, x, y, left=0.0, right=0.0)

    return f


def _butter_filtfilt(y, cutoff_hz, fs, order=2):
    import scipy.signal as signal

    if fs <= 2 * cutoff_hz:
        return np.asarray(y, float)
    b, a = signal.butter(order, cutoff_hz, fs=fs)
    return signal.filtfilt(b, a, y)


def _read_csv_columns(path):
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    cols = {}
    for k in rows[0].keys():
        cols[k] = np.array([float(r[k]) for r in rows])
    return cols


class AttitudeCorrection:
    """Time-indexed attitude/position corrections (correction.py)."""

    def __init__(self):
        z = lambda t: np.zeros_like(np.asarray(t, float))
        self.yaw = self.pitch = self.roll = z
        self.north = self.east = self.down = z

    def load_horiz(self, path, err_limit=0.08, cutoff_hz=1.0):
        """CSV with 'flight time (sec)', 'ekf roll error (rad)',
        'ekf pitch error (rad)' (correction.py:20-78)."""
        cols = _read_csv_columns(path)
        t = cols["flight time (sec)"]
        hz = max(int(round(len(t) / max(t.max() - t.min(), 1e-9))), 1)
        roll = cols["ekf roll error (rad)"].copy()
        pitch = cols["ekf pitch error (rad)"].copy()
        roll[np.abs(roll) > err_limit] = 0.0
        pitch[np.abs(pitch) > err_limit] = 0.0
        self.roll = _interp1(t, _butter_filtfilt(roll, cutoff_hz, hz))
        self.pitch = _interp1(t, _butter_filtfilt(pitch, cutoff_hz, hz))
        return self

    def load_old(self, path):
        """Legacy whitespace/comma table: time yaw pitch roll n e d errors
        (correction.py:81-111)."""
        table = []
        with open(path) as f:
            for line in f:
                tok = re.split(r"[,\s]+", line.strip())
                if len(tok) >= 7:
                    table.append([float(v) for v in tok[:7]])
        a = np.asarray(table)
        t = a[:, 0]
        for i, name in enumerate(("yaw", "pitch", "roll", "north", "east",
                                  "down")):
            setattr(self, name, _interp1(t, a[:, i + 1]))
        return self

    def query(self, t):
        return {
            "yaw_rad": float(self.yaw(t)), "pitch_rad": float(self.pitch(t)),
            "roll_rad": float(self.roll(t)), "north_m": float(self.north(t)),
            "east_m": float(self.east(t)), "down_m": float(self.down(t)),
        }


class FeatureRates:
    """Feature-tracker rotation-rate log (feat_data.py): columns
    'video time', '(h)p/q/r (rad/sec)'."""

    def __init__(self):
        self.t = None
        self.cols = {}
        self.hz = None
        self.interp = {}

    def load(self, path):
        cols = _read_csv_columns(path)
        self.t = cols["video time"]
        self.cols = cols
        span = max(self.t.max() - self.t.min(), 1e-9)
        self.hz = max(int(round(len(self.t) / span)), 1)
        return self

    def smooth(self, cutoff_hz):
        for k in list(self.cols):
            if "(rad/sec)" in k:
                self.cols[k] = _butter_filtfilt(self.cols[k], cutoff_hz,
                                                self.hz)
        return self

    def make_interp(self, prefix="h"):
        for axis in "pqr":
            key = f"{prefix}{axis} (rad/sec)"
            if key not in self.cols:
                key = f"{axis} (rad/sec)"
            self.interp[axis] = _interp1(self.t, self.cols[key])
        return self

    def query_rates(self, t):
        return tuple(float(self.interp[a](t)) for a in "pqr")


class HorizonLog:
    """Horizon-tracker roll/pitch log (horiz_data.py): columns
    'video time', 'camera roll (deg)', 'camera pitch (deg)'."""

    def __init__(self):
        self.t = None
        self.roll_deg = None
        self.pitch_deg = None
        self.p = None
        self.q = None

    def load(self, path):
        cols = _read_csv_columns(path)
        self.t = cols["video time"]
        self.roll_deg = cols["camera roll (deg)"]
        self.pitch_deg = cols["camera pitch (deg)"]
        return self

    def make_rates(self):
        """Finite-difference roll/pitch rates (horiz_data.py:24-54)."""
        dt = np.diff(self.t, prepend=self.t[0] - 1.0)
        dt[dt <= 0] = 1.0
        self.p = np.diff(self.roll_deg, prepend=self.roll_deg[0]) * D2R / dt
        self.q = np.diff(self.pitch_deg, prepend=self.pitch_deg[0]) * D2R / dt
        self.p[0] = self.q[0] = 0.0
        return self

    def interp_attitude(self):
        r = _interp1(self.t, self.roll_deg)
        p = _interp1(self.t, self.pitch_deg)
        return r, p


def load_feature_ned(matches_path, proj_ref_lla, extern_ref_lla):
    """Triangulated feature points re-expressed in an external NED frame
    for HUD draw_features (reference video/features.py)."""
    import pickle

    from ..core import geodesy

    with open(matches_path, "rb") as f:
        matches = pickle.load(f)
    pts = np.array([m[0] for m in matches if m[0] is not None], float)
    if not len(pts):
        return pts
    lla = geodesy.ned2lla(pts, *proj_ref_lla)
    return np.asarray(geodesy.lla2ned(lla[:, 0], lla[:, 1], lla[:, 2],
                                      *extern_ref_lla)).T \
        if np.asarray(lla).ndim == 2 else pts


class FlightLog:
    """Generic time-indexed flight log → per-frame HUD state.

    The reference's HUD program loads aura flight logs through the external
    aurauas_flightdata package and builds per-frame interpolators
    (video/2-gen-hud-overlay.py:86-187). This covers the same role for CSV
    exports: columns are sniffed case-insensitively — time/t/timestamp,
    lat/latitude, lon/longitude, alt (m MSL), roll/pitch/yaw (deg), and
    optionally vn/ve/vd (m/s) and airspeed. pix4d.csv-style headers
    ("Lat (decimal degrees)", …) are accepted too. Velocities fall back to
    finite differences of the NED track.
    """

    _ALIASES = {
        "time": ("time", "t", "timestamp", "unix_sec", "time (s)"),
        "lat": ("lat", "latitude", "lat (decimal degrees)"),
        "lon": ("lon", "longitude", "lon (decimal degrees)"),
        "alt": ("alt", "altitude", "alt_m", "alt (meters msl)",
                "altitude [m]"),
        "roll": ("roll", "roll (decimal degrees)", "roll_deg"),
        "pitch": ("pitch", "pitch (decimal degrees)", "pitch_deg"),
        "yaw": ("yaw", "yaw (decimal degrees)", "yaw_deg", "heading"),
        "vn": ("vn", "vel_n", "vn (m/s)"),
        "ve": ("ve", "vel_e", "ve (m/s)"),
        "vd": ("vd", "vel_d", "vd (m/s)"),
        "airspeed": ("airspeed", "airspeed (m/s)", "ias"),
    }

    def __init__(self, path=None):
        self.cols = {}
        if path:
            self.load(path)

    def load(self, path):
        raw = _read_csv_columns(path)
        lower = {k.strip().lower(): v for k, v in raw.items()}
        for canon, names in self._ALIASES.items():
            for nm in names:
                if nm in lower:
                    self.cols[canon] = lower[nm]
                    break
        missing = [k for k in ("time", "lat", "lon", "alt", "roll", "pitch",
                               "yaw") if k not in self.cols]
        if missing:
            raise ValueError(f"flight log {path} missing columns: {missing}")
        order = np.argsort(self.cols["time"])
        self.cols = {k: v[order] for k, v in self.cols.items()}
        return self

    @property
    def t(self):
        return self.cols["time"]

    def ref_lla(self):
        return (float(self.cols["lat"][0]), float(self.cols["lon"][0]), 0.0)

    def state_fn(self, ref_lla=None, time_shift=0.0):
        """fn(movie_time_s) → HUD state dict; flight time = movie time +
        time_shift (the correlate.sync_clocks convention)."""
        from ..core import geodesy
        from ..core.rotations import quat_from_ypr

        ref = ref_lla or self.ref_lla()
        ned = np.asarray(geodesy.lla2ned(self.cols["lat"], self.cols["lon"],
                                         self.cols["alt"], *ref), float)
        if ned.shape[0] == 3 and ned.shape[0] != len(self.t):
            ned = ned.T
        t = self.t - self.t[0]
        if all(k in self.cols for k in ("vn", "ve", "vd")):
            vel = np.c_[self.cols["vn"], self.cols["ve"], self.cols["vd"]]
        else:
            dt = np.gradient(t)
            dt[dt <= 0] = 1.0
            vel = np.gradient(ned, axis=0) / dt[:, None]
        airspeed = self.cols.get("airspeed",
                                 np.linalg.norm(vel[:, :2], axis=1))
        # yaw interpolates through wrap via unwrapped radians
        yaw_u = np.unwrap(np.radians(self.cols["yaw"]))

        def fn(movie_t):
            ft = movie_t + time_shift
            p = np.array([np.interp(ft, t, ned[:, k]) for k in range(3)])
            v = np.array([np.interp(ft, t, vel[:, k]) for k in range(3)])
            ypr = (np.degrees(np.interp(ft, t, yaw_u)) % 360.0,
                   np.interp(ft, t, self.cols["pitch"]),
                   np.interp(ft, t, self.cols["roll"]))
            q = np.asarray(quat_from_ypr(np.radians(ypr[0]),
                                         np.radians(ypr[1]),
                                         np.radians(ypr[2])))
            return dict(ned=p, quat=q, ypr_deg=ypr, vel_ned=v,
                        airspeed=float(np.interp(ft, t, airspeed)),
                        altitude=float(np.interp(ft, t, self.cols["alt"])))

        return fn

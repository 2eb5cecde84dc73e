"""AR HUD overlay rendering on flight video.

Reference video/hud.py:27-1034 (+ hud_glass.py variant): all symbology is
drawn by projecting NED-space geometry through K·[R|t] for the current
aircraft state (hud.py:214-222), split into conformal symbols (stick to
the world: horizon, compass points, sun/moon, airports, flight track,
feature points, pitch ladder, velocity vector — hud.py:987-1002) and
fixed symbols (tapes, sticks, time — hud.py:1003-1023), plus autopilot
symbology (nose when manual; flight-director vbars, heading bug, bird and
course when auto — hud.py:1025-1032).

Sun/moon come from video/ephemeris.py (Meeus formulas — the reference
uses pyephem, hud.py:189-213); airports from video/airports.py.

Port of the JAX package's ``video/hud.py``: a copy, but for its writer,
which raises when cv2 cannot open it (the reference writes nothing and
says nothing).
"""

from __future__ import annotations

import math

import numpy as np

from ..core import geodesy
from .camera import VirtualCamera

D2R = math.pi / 180.0
R2D = 180.0 / math.pi

GREEN = (20, 220, 20)
WHITE = (240, 240, 240)
# glass palette + units (reference hud_glass.py:23-32,17-20)
GREEN2 = (0, 238, 0)
RED = (0, 0, 238)
YELLOW = (50, 255, 255)
ORCHID = (211, 85, 186)
ROYALBLUE = (225, 105, 65)
M2FT = 1.0 / 0.3048
KT2MPS = 1.0 / 1.94384


class HUD:
    def __init__(self, cam: VirtualCamera, color=GREEN, line_width=2,
                 style="classic"):
        """style: 'classic' (reference hud.py) or 'glass' (hud_glass.py) —
        glass draws filled translucent tapes/boxes and a sky-pointer roll
        indicator instead of bare line symbology."""
        self.cam = cam
        self.color = color
        self.lw = line_width
        self.style = style
        # current state
        self.ned = np.zeros(3)
        self.quat = np.array([1.0, 0, 0, 0])
        self.ypr = (0.0, 0.0, 0.0)
        self.vel_ned = np.zeros(3)
        self.airspeed = 0.0
        self.altitude = 0.0
        # optional state for the extended symbology (each symbol only
        # draws when its data has been supplied, like the reference)
        self.lla = None                 # [lat, lon, alt]
        self.ref_lla = None             # ned reference [lat, lon, alt]
        self.unixtime = None
        self.time = None
        self.ned_history = []           # [(t, ned)] for draw_track
        self.history_seconds = 60.0
        self.features = []              # ned points for draw_features
        self.airports = []              # [ident, lat, lon, alt]
        self.flight_mode = None         # 'manual' | 'auto'
        self.ap_roll = 0.0
        self.ap_pitch = 0.0
        self.ap_hdg = 0.0
        self.ap_speed = 0.0
        self.ap_alt = 0.0
        self.pilot_stick = None         # (ail, ele, thr, rud)
        self.act_stick = None
        self.alpha_beta = None          # (alpha_rad, beta_rad)
        self.ground_m = 0.0
        self.airspeed_units = "kt"
        self.altitude_units = "ft"
        self.wind_deg = 0.0
        self.wind_kt = 0.0
        self._gc_rad = 0.0              # persisted ground course
        self.nose_uv = None             # set by draw_nose, anchors the dg
        self.show_compass = False
        self.show_grid = False
        self._grid_pts = []
        self._vel_filt = np.zeros(3)

    def update_state(self, ned, quat, ypr_deg, vel_ned=None, airspeed=None,
                     altitude=None):
        self.ned = np.asarray(ned, float)
        self.quat = np.asarray(quat, float)
        self.ypr = tuple(ypr_deg)
        if vel_ned is not None:
            self.vel_ned = np.asarray(vel_ned, float)
        self.airspeed = airspeed if airspeed is not None else \
            float(np.linalg.norm(self.vel_ned))
        self.altitude = altitude if altitude is not None else -self.ned[2]

    # -- extended-state updaters (reference hud.py:104-188) ----------------
    def set_ned_ref(self, lat_deg, lon_deg, alt_m=0.0):
        self.ref_lla = [float(lat_deg), float(lon_deg), float(alt_m)]

    def update_lla(self, lla):
        self.lla = [float(v) for v in lla]

    def update_time(self, time_s, unixtime=None):
        self.time = float(time_s)
        if unixtime is not None:
            self.unixtime = float(unixtime)

    def update_ned_history(self, t, ned):
        """Keep the last history_seconds of positions (hud.py:130-139)."""
        self.ned_history.append((float(t), np.asarray(ned, float)))
        cutoff = float(t) - self.history_seconds
        while self.ned_history and self.ned_history[0][0] < cutoff:
            self.ned_history.pop(0)

    def update_features(self, feature_list):
        self.features = [np.asarray(f, float) for f in feature_list]

    def load_airports(self, path, range_m=30000.0):
        from . import airports as apt_mod

        if self.ref_lla is None:
            raise ValueError("set_ned_ref before load_airports")
        self.airports = apt_mod.load(path, self.ref_lla, range_m)

    def update_ap(self, flight_mode, ap_roll=0.0, ap_pitch=0.0, ap_hdg=0.0,
                  ap_speed=0.0, ap_alt=0.0):
        self.flight_mode = flight_mode
        self.ap_roll = ap_roll
        self.ap_pitch = ap_pitch
        self.ap_hdg = ap_hdg
        self.ap_speed = ap_speed
        self.ap_alt = ap_alt

    def update_pilot(self, aileron, elevator, throttle, rudder):
        self.pilot_stick = (aileron, elevator, throttle, rudder)

    def update_act(self, aileron, elevator, throttle, rudder):
        self.act_stick = (aileron, elevator, throttle, rudder)

    def update_airdata(self, airspeed=None, altitude=None, alpha_rad=None,
                       beta_rad=None, wind_deg=None, wind_kt=None):
        if airspeed is not None:
            self.airspeed = airspeed
        if altitude is not None:
            self.altitude = altitude
        if alpha_rad is not None or beta_rad is not None:
            self.alpha_beta = (alpha_rad or 0.0, beta_rad or 0.0)
        if wind_deg is not None:
            self.wind_deg = wind_deg
        if wind_kt is not None:
            self.wind_kt = wind_kt

    # -- projection helpers (reference hud.py:214-222) --------------------
    def project(self, points_ned):
        return self.cam.project_ned(points_ned, self.ned, self.quat)

    def _pt(self, ned, frame):
        """Project one NED point → integer (u, v) or None (hud.py:214-222).
        Culls points far outside the frame like the reference render-window
        checks."""
        uv = self.project(np.asarray(ned, float)[None])
        if np.isnan(uv).any():
            return None
        h, w = frame.shape[:2]
        u, v = float(uv[0, 0]), float(uv[0, 1])
        if u < -w * 0.25 or u > w * 1.25 or v < -h * 0.25 or v > h * 1.25:
            return None
        return (int(round(u)), int(round(v)))

    def _ladder_uv(self, frame, yaw_rad, pitch_deg, dyaw_deg):
        """Point 1000 m out at pitch/horizontal offset angles from the
        given azimuth (reference ar_helper, hud_glass.py:348-357: the
        offsets compose as intrinsic z-then-y rotations of the north
        axis, so rungs droop slightly by cos(dyaw) at their ends)."""
        p = pitch_deg * D2R
        dy = dyaw_deg * D2R
        ca, sa = math.cos(yaw_rad), math.sin(yaw_rad)
        vn = math.cos(p) * math.cos(dy)
        ve = math.sin(dy)
        vd = -math.sin(p) * math.cos(dy)
        d = 1000.0
        ned = self.ned + [d * (ca * vn - sa * ve),
                          d * (sa * vn + ca * ve),
                          d * vd]
        return self._pt(ned, frame)

    def _cam_uv(self, a0_deg, a1_deg):
        """Boresight-relative angle-space point in IMAGE coordinates
        (reference cam_helper, hud_glass.py:359-373 with zero mount
        offsets): a0 up, a1 right, degrees. Pure pinhole math — these
        symbols ride the image, not the world. Returns None behind the
        camera (the reference's project_xyz culls at z <= 0.2,
        camera.py:152)."""
        a0 = a0_deg * D2R
        a1 = a1_deg * D2R
        K = self.cam.K
        if math.cos(a0) * math.cos(a1) <= 0.2:
            return None
        u = K[0, 2] + K[0, 0] * math.tan(a1) / math.cos(a0)
        v = K[1, 2] - K[1, 1] * math.tan(a0)
        return (int(round(u)), int(round(v)))

    @staticmethod
    def _rotate_pt(p, center, angle_rad):
        """Rotate an image point about a center (hud.py:369-374)."""
        ca, sa = math.cos(angle_rad), math.sin(angle_rad)
        x = p[0] - center[0]
        y = p[1] - center[1]
        return (int(round(center[0] + ca * x - sa * y)),
                int(round(center[1] + sa * x + ca * y)))

    def draw_label(self, frame, cv2, label, uv, scale=0.5, horiz="center",
                   vert="center", color=None):
        size = cv2.getTextSize(label, cv2.FONT_HERSHEY_SIMPLEX, scale,
                               self.lw)
        u = uv[0] - (size[0][0] // 2 if horiz == "center" else 0)
        v = uv[1] + (size[0][1] if vert == "below"
                     else size[0][1] // 2 if vert == "center" else 0)
        cv2.putText(frame, label, (int(u), int(v)), cv2.FONT_HERSHEY_SIMPLEX,
                    scale, color or self.color, self.lw, cv2.LINE_AA)

    def draw_ned_point(self, frame, cv2, ned, label=None, scale=1.0,
                       vert="above"):
        """Labeled world point (hud.py:521-532)."""
        uv = self._pt(ned, frame)
        if uv is not None:
            cv2.circle(frame, uv, 4 + self.lw, self.color, self.lw,
                       cv2.LINE_AA)
        if label:
            off = -0.02 if vert == "above" else 0.02
            uv2 = self._pt([ned[0], ned[1], ned[2] + off], frame)
            if uv2 is not None:
                self.draw_label(frame, cv2, label, uv2, scale, vert=vert)

    def draw_lla_point(self, frame, cv2, lla, label):
        """Labeled geographic point with distance callout when within
        10 sm (hud.py:534-557)."""
        if self.ref_lla is None:
            return
        pt = geodesy.lla2ned(lla[0], lla[1], lla[2], *self.ref_lla)
        rel = np.asarray(pt, float) - self.ned
        hdist = math.hypot(rel[0], rel[1])
        dist = float(np.linalg.norm(rel))
        hdist_sm = hdist * 0.000621371
        if hdist_sm > 10.0 or dist < 1e-6:
            return
        scale = 0.7 - (hdist_sm / 10.0) * 0.4
        if hdist_sm <= 7.5:
            label += " (%.1f)" % hdist_sm
        rel /= dist
        self.draw_ned_point(frame, cv2, self.ned + rel, label, scale=scale,
                            vert="below")

    # -- drawing ----------------------------------------------------------
    def draw(self, frame):
        import cv2

        # ground-velocity low-pass runs once per frame at the top of the
        # draw loop (reference hud_glass.py:1612-1614), so the course and
        # dg arrows are current even in manual mode
        tf = 0.2
        self._vel_filt = (1.0 - tf) * self._vel_filt + tf * self.vel_ned
        # conformal symbols (hud.py:987-1002)
        self.draw_horizon(frame, cv2)
        if self.show_compass:
            self.draw_compass_points(frame, cv2)
        if self.unixtime is not None and self.lla is not None:
            self.draw_astro(frame, cv2)
        if self.airports:
            self.draw_airports(frame, cv2)
        if self.ned_history:
            self.draw_track(frame, cv2)
        if self.features:
            self.draw_features(frame, cv2)
        if self.show_grid:
            self.draw_grid(frame, cv2)
        self.draw_pitch_ladder(frame, cv2)
        if self.alpha_beta is not None:
            self.draw_alpha_beta_marker(frame, cv2)
        self.draw_heading(frame, cv2)
        # fixed symbols (hud.py:1003-1023)
        if self.style == "glass":
            self.draw_tapes_glass(frame, cv2)
            self.draw_roll_indicator(frame, cv2)
            self.draw_dg(frame, cv2)
        else:
            self.draw_tapes(frame, cv2)
        if self.pilot_stick is not None or self.act_stick is not None:
            self.draw_sticks(frame, cv2)
        if self.time is not None:
            self.draw_time(frame, cv2)
        # autopilot symbology (hud.py:1025-1032)
        if self.flight_mode == "manual":
            self.draw_nose(frame, cv2)
        elif self.flight_mode == "auto":
            self.draw_vbars(frame, cv2)
            self.draw_heading_bug(frame, cv2)
            self.draw_bird(frame, cv2)
            self.draw_course(frame, cv2)
        self.draw_flight_path_marker(frame, cv2)
        return frame

    # -- conformal extras ---------------------------------------------------
    def draw_astro(self, frame, cv2):
        """Sun, shadow and moon markers (hud.py:594-618 draw_astro)."""
        from . import ephemeris

        sun, moon = ephemeris.sun_moon_ned(self.lla[1], self.lla[0],
                                           self.lla[2], self.unixtime)
        self.draw_ned_point(frame, cv2, self.ned + sun, "Sun")
        if sun[2] < 0.0:   # shadow point opposite an above-horizon sun
            self.draw_ned_point(frame, cv2, self.ned - np.asarray(sun),
                                "shadow", scale=0.7)
        self.draw_ned_point(frame, cv2, self.ned + moon, "Moon")

    def draw_airports(self, frame, cv2):
        for apt in self.airports:
            self.draw_lla_point(frame, cv2, [apt[1], apt[2], apt[3]], apt[0])

    def draw_compass_points(self, frame, cv2):
        """Unit-distance compass ticks + N/S/E/W labels (hud.py:559-592)."""
        for i in range(12):
            a = i * 30.0 * D2R
            n, e = math.cos(a), math.sin(a)
            uv1 = self._pt(self.ned + [n, e, 0.0], frame)
            uv2 = self._pt(self.ned + [n, e, -0.02], frame)
            if uv1 and uv2:
                cv2.line(frame, uv1, uv2, self.color, self.lw, cv2.LINE_AA)
        for label, n, e in (("N", 1, 0), ("S", -1, 0), ("E", 0, 1),
                            ("W", 0, -1)):
            uv = self._pt(self.ned + [n, e, -0.03], frame)
            if uv:
                self.draw_label(frame, cv2, label, uv, 1.0, vert="above")

    def draw_track(self, frame, cv2):
        """Flight-track breadcrumbs, sized by distance (hud.py:897-941)."""
        prev = None
        for _, ned in self.ned_history:
            dist = float(np.linalg.norm(self.ned - ned))
            uv = self._pt(ned, frame) if dist > 5.0 else None
            if uv is not None:
                size = max(int(round(200.0 / max(dist, 1e-6))), 2)
                cv2.circle(frame, uv, size, WHITE, self.lw, cv2.LINE_AA)
                if prev is not None:
                    cv2.line(frame, prev, uv, WHITE, 1, cv2.LINE_AA)
            prev = uv

    def draw_features(self, frame, cv2):
        """Externally supplied feature points (hud.py:942-956)."""
        for ned in self.features:
            uv = self._pt(ned, frame)
            if uv is not None:
                cv2.circle(frame, uv, 2, WHITE, self.lw, cv2.LINE_AA)

    def draw_grid(self, frame, cv2):
        """3-D reference grid in space (hud.py:958-985)."""
        if not self._grid_pts:
            h, v = 100, 75
            for n in range(-500, 501, h):
                for e in range(-500, 501, h):
                    for d in range(int(-self.ground_m) - 4 * v,
                                   int(-self.ground_m) + 1, v):
                        self._grid_pts.append(np.array([n, e, d], float))
        for ned in self._grid_pts:
            dist = float(np.linalg.norm(self.ned - ned))
            uv = self._pt(ned, frame)
            if uv is not None:
                size = max(int(round(1000.0 / max(dist, 1e-6))), 1)
                cv2.circle(frame, uv, size, WHITE, 1, cv2.LINE_AA)

    def draw_alpha_beta_marker(self, frame, cv2):
        """Alpha/beta dot relative to the boresight (hud.py:339-367)."""
        alpha, beta = self.alpha_beta
        yaw = self.ypr[0] * D2R
        pitch = self.ypr[1]
        center = self._ladder_uv(frame, yaw, pitch, 0.0)
        alpha_uv = self._ladder_uv(frame, yaw, pitch - alpha * R2D,
                                   beta * R2D)
        if center is None or alpha_uv is None:
            return
        cv2.circle(frame, alpha_uv, 4, self.color, self.lw, cv2.LINE_AA)
        cv2.line(frame, center, alpha_uv, self.color, 1, cv2.LINE_AA)

    # -- fixed extras -------------------------------------------------------
    def draw_sticks(self, frame, cv2):
        """Pilot/actuator stick boxes, auto selects the active source.
        glass geometry at 0.29w/0.85h in white (hud_glass.py draw_sticks);
        classic at 0.1h/0.8h in the HUD color (hud.py:835-874)."""
        stick = (self.act_stick if self.flight_mode == "auto"
                 else self.pilot_stick) or (0.0, 0.0, 0.0, 0.0)
        ail, ele, thr, rud = stick
        h, w = frame.shape[:2]
        if self.style == "glass":
            lx, ly = int(w * 0.29), int(h * 0.85)
            rx, ry = w - int(w * 0.29), int(h * 0.85)
            white = (255, 255, 255)
        else:
            lx, ly = int(h * 0.1), int(h * 0.8)
            rx, ry = w - int(h * 0.1), int(h * 0.8)
            white = self.color
        r1 = max(int(round(h * 0.09)), 10)
        r2 = max(int(round(h * 0.01)), 2)
        for cx, cy in ((lx, ly), (rx, ry)):
            cv2.circle(frame, (cx, cy), r1, white, self.lw, cv2.LINE_AA)
            cv2.line(frame, (cx, cy - r1), (cx, cy + r1), white, 1,
                     cv2.LINE_AA)
            cv2.line(frame, (cx - r1, cy), (cx + r1, cy), white, 1,
                     cv2.LINE_AA)
        cv2.circle(frame, (lx + int(round(rud * r1)),
                           ly + r1 - int(round(2 * thr * r1))), r2,
                   white, self.lw, cv2.LINE_AA)
        cv2.circle(frame, (rx + int(round(ail * r1)),
                           ry - int(round(ele * r1))), r2,
                   white, self.lw, cv2.LINE_AA)

    def draw_time(self, frame, cv2):
        """Elapsed-time stamp, lower left (hud.py:876-882)."""
        h = frame.shape[0]
        cv2.putText(frame, "%.1f" % self.time, (2, h - 8),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.7, self.color, self.lw,
                    cv2.LINE_AA)

    # -- autopilot symbology -------------------------------------------------
    def draw_nose(self, frame, cv2):
        """Double circle on the body x-axis (hud.py:623-634)."""
        yaw = self.ypr[0] * D2R
        uv = self._ladder_uv(frame, yaw, self.ypr[1], 0.0)
        self.nose_uv = uv                 # anchors the glass dg rose
        if uv is None:
            return
        h = frame.shape[0]
        cv2.circle(frame, uv, max(h // 80, 2), self.color, self.lw,
                   cv2.LINE_AA)
        cv2.circle(frame, uv, max(h // 40, 4), self.color, self.lw,
                   cv2.LINE_AA)

    def draw_vbars(self, frame, cv2):
        """Flight-director command bars. glass: filled orchid wedges at
        the AP pitch target, rolled to the AP roll target about the
        boresight (hud_glass.py:533-583; 12-deg span at 20-deg sweep).
        classic: world-conformal line vbars (hud.py:376-425)."""
        if self.style != "glass":
            return self._draw_vbars_classic(frame, cv2)
        scale = 12.0
        ang = 20.0 * D2R
        a1 = scale * math.cos(ang)
        a3 = scale * math.sin(ang)
        a2 = a3 * 0.4
        a0 = -self.ypr[1] + self.ap_pitch   # boresight-relative pitch cmd
        nose = self._cam_uv(0.0, 0.0)
        c0 = self._cam_uv(a0, 0.0)
        if nose is None or c0 is None:
            return
        rot = -self.ypr[2] * D2R + self.ap_roll * D2R
        center = self._rotate_pt(c0, nose, rot)
        half_width = max(int(self.lw * 0.5), 1)
        dark_orchid = (139, 56, 123)
        for sgn in (1, -1):
            tmp = [self._cam_uv(a0 - a3, sgn * a1),
                   self._cam_uv(a0 - a3, sgn * (a1 + a2)),
                   self._cam_uv(a0 - (a3 - a2), sgn * (a1 + a2))]
            if any(p is None for p in tmp):
                continue
            uv = [self._rotate_pt(p, nose, rot) for p in tmp]
            pts = np.array([[center, uv[0], uv[1], uv[2]]])
            cv2.fillPoly(frame, pts, ORCHID)
            cv2.line(frame, uv[0], uv[2], dark_orchid, half_width,
                     cv2.LINE_AA)
            cv2.polylines(frame, pts, True, (0, 0, 0), half_width,
                          cv2.LINE_AA)

    def _draw_vbars_classic(self, frame, cv2):
        """Line flight-director vbars, world-conformal at the AP pitch,
        rotated about the nose by the AP roll (reference hud.py:376-425:
        a1=10, a2=1.5, a3=3 deg, medium orchid)."""
        color = ORCHID
        a1, a2, a3 = 10.0, 1.5, 3.0
        yaw = self.ypr[0] * D2R
        a0 = self.ap_pitch
        rot_pt = self._ladder_uv(frame, yaw, self.ypr[1], 0.0)  # nose
        tmp0 = self._ladder_uv(frame, yaw, a0, 0.0)
        if rot_pt is None or tmp0 is None:
            return
        roll = self.ap_roll * D2R
        center = self._rotate_pt(tmp0, rot_pt, roll)
        for sgn in (1, -1):
            tmp = [self._ladder_uv(frame, yaw, a0 - a3, sgn * a1),
                   self._ladder_uv(frame, yaw, a0 - a3, sgn * (a1 + a3)),
                   self._ladder_uv(frame, yaw, a0 - a2, sgn * (a1 + a3))]
            if any(p is None for p in tmp):
                continue
            uv1, uv2, uv3 = (self._rotate_pt(p, rot_pt, roll) for p in tmp)
            for p, q in ((center, uv1), (center, uv3), (uv1, uv2),
                         (uv1, uv3), (uv2, uv3)):
                cv2.line(frame, p, q, color, self.lw, cv2.LINE_AA)

    def draw_heading_bug(self, frame, cv2):
        """AP heading bug on the horizon (hud.py:427-451)."""
        color = (211, 85, 186)
        hdg = self.ap_hdg * D2R
        pts = [self._ladder_uv(frame, hdg, 0.0, 2.0),
               self._ladder_uv(frame, hdg, 0.0, -2.0),
               self._ladder_uv(frame, hdg, 1.5, -2.0),
               self._ladder_uv(frame, hdg, 1.5, -1.0),
               self._ladder_uv(frame, hdg, 0.0, 0.0),
               self._ladder_uv(frame, hdg, 1.5, 1.0),
               self._ladder_uv(frame, hdg, 1.5, 2.0)]
        if any(p is None for p in pts):
            return
        for i in range(len(pts)):
            cv2.line(frame, pts[i], pts[(i + 1) % len(pts)], color, self.lw,
                     cv2.LINE_AA)

    def draw_bird(self, frame, cv2):
        """Attitude 'bird'. glass: image-fixed filled yellow/dark-yellow
        wing wedges about the boresight plus wing-line horizon markers
        (hud_glass.py:739-811, wing-marker mode). classic: line bird,
        world-conformal at the current pitch, rolled about the ladder
        center (hud.py:453-487)."""
        if self.style != "glass":
            return self._draw_bird_classic(frame, cv2)
        yellow = YELLOW
        dark_yellow = (33, 170, 170)
        scale = 12.0
        ang = 20.0 * D2R
        a1 = scale * math.cos(ang)
        a3 = scale * math.sin(ang)
        a2 = a3 * 0.5
        a4 = scale * 1.15
        a5 = scale * 0.036
        nose = self._cam_uv(0.0, 0.0)
        if nose is None:
            return
        self.nose_uv = nose
        hw = max(int(self.lw * 0.5), 1)
        for sgn in (1, -1):
            uv = [self._cam_uv(-a3, sgn * a1),
                  self._cam_uv(-a3, sgn * (a1 - a2)),
                  self._cam_uv(-a3, sgn * (a1 - a3))]
            if any(p is None for p in uv):
                continue
            pts1 = np.array([[nose, uv[0], uv[2]]])
            pts2 = np.array([[nose, uv[1], uv[2]]])
            cv2.fillPoly(frame, pts1, yellow)
            cv2.fillPoly(frame, pts2, dark_yellow)
            cv2.polylines(frame, pts1, True, (0, 0, 0), hw, cv2.LINE_AA)
        # wing-line horizon markers at +/-a4
        for sgn in (1, -1):
            uv = [self._cam_uv(0.0, sgn * a4),
                  self._cam_uv(-a5, sgn * (a4 + a5)),
                  self._cam_uv(-a5, sgn * (a4 + a3)),
                  self._cam_uv(a5, sgn * (a4 + a3)),
                  self._cam_uv(a5, sgn * (a4 + a5)),
                  self._cam_uv(0.0, sgn * (a4 + a3))]
            if any(p is None for p in uv):
                continue
            pts1 = np.array([[uv[0], uv[1], uv[2], uv[3], uv[4]]])
            pts2 = np.array([[uv[0], uv[5], uv[3], uv[4]]])
            cv2.fillPoly(frame, pts1, dark_yellow)
            cv2.fillPoly(frame, pts2, yellow)
            cv2.polylines(frame, pts1, True, (0, 0, 0), hw, cv2.LINE_AA)

    def _draw_bird_classic(self, frame, cv2):
        """Line attitude bird at the current pitch, wings rolled about the
        center (reference hud.py:453-487: a1=10, a2=3 deg, yellow)."""
        a1, a2 = 10.0, 3.0
        yaw = self.ypr[0] * D2R
        a0 = self.ypr[1]
        roll = self.ypr[2] * D2R
        center = self._ladder_uv(frame, yaw, a0, 0.0)
        if center is None:
            return
        self.nose_uv = center
        for sgn in (1, -1):
            tmp = [self._ladder_uv(frame, yaw, a0 - a2, sgn * a1),
                   self._ladder_uv(frame, yaw, a0 - a2, sgn * (a1 - a2))]
            if any(p is None for p in tmp):
                continue
            uv1 = self._rotate_pt(tmp[0], center, roll)
            uv2 = self._rotate_pt(tmp[1], center, roll)
            for p, q in ((center, uv1), (center, uv2), (uv1, uv2)):
                cv2.line(frame, p, q, YELLOW, self.lw, cv2.LINE_AA)

    def draw_course(self, frame, cv2):
        """Ground-course caret on the horizon from filtered velocity
        (hud.py:488-502; the filter itself updates in draw())."""
        color = (0, 220, 220)
        if np.linalg.norm(self._vel_filt[:2]) < 0.1:
            return
        a = math.atan2(self._vel_filt[1], self._vel_filt[0])
        uv1 = self._ladder_uv(frame, a, 0.0, 0.0)
        uv2 = self._ladder_uv(frame, a, 1.5, 1.0)
        uv3 = self._ladder_uv(frame, a, 1.5, -1.0)
        if uv1 and uv2 and uv3:
            cv2.line(frame, uv1, uv2, color, self.lw, cv2.LINE_AA)
            cv2.line(frame, uv1, uv3, color, self.lw, cv2.LINE_AA)

    def _glass_font_size(self, frame):
        """Reference sizes the glass font from the frame diagonal
        (7a-explore.py / hud CLI: size = sqrt(w^2+h^2)/1400)."""
        h, w = frame.shape[:2]
        return max(0.4, math.hypot(w, h) / 1400.0)

    def draw_tapes_glass(self, frame, cv2):
        """Glass-cockpit speed/altitude tapes, reference geometry
        (hud_glass.py:1188-1266 draw_speed_tape and :1268-1375
        draw_altitude_tape): tape axis at 0.2w / 0.8w spanning
        0.2h..0.8h, 1-unit tic rows with 5-unit labeled majors, a
        pointer-pentagon value box at mid-height, an AP bug heptagon,
        and (altitude only) ground / max-altitude limit bars."""
        spd = self.airspeed if self.airspeed_units == "kt" \
            else self.airspeed * KT2MPS
        alt_disp = self.altitude * M2FT if self.altitude_units == "ft" \
            else self.altitude
        ground = self.ground_m * M2FT if self.altitude_units == "ft" \
            else self.ground_m
        ceiling = ground + (400.0 if self.altitude_units == "ft"
                            else 121.92)
        # AP bugs convert with their tapes (hud_glass.py:1562-1575:
        # ap_speed*kt2mps for mps, ap_altitude_ft*ft2m for meters)
        spd_bug = self.ap_speed if self.airspeed_units == "kt" \
            else self.ap_speed * KT2MPS
        alt_bug = self.ap_alt if self.altitude_units == "ft" \
            else self.ap_alt * 0.3048
        self._draw_tape(frame, cv2, side=-1, value=spd,
                        bug=spd_bug, units=self.airspeed_units,
                        tick_unit=1.0, label_fmt="%d",
                        lo=0, hi=65, green_band=(20, 40))
        self._draw_tape(frame, cv2, side=+1, value=alt_disp,
                        bug=alt_bug, units=self.altitude_units,
                        tick_unit=10.0, label_fmt="%d",
                        lo=int(alt_disp / 100) * 100 - 300,
                        hi=int(alt_disp / 100) * 100 + 300,
                        ground=ground, ceiling=ceiling)

    def _draw_tape(self, frame, cv2, side, value, bug, units, tick_unit,
                   label_fmt, lo, hi, green_band=None, ground=None,
                   ceiling=None):
        """One vertical tape. side=-1: left (speed, box points right);
        side=+1: right (altitude, box points left). Geometry per
        hud_glass.py:1188-1375."""
        h, w = frame.shape[:2]
        font = cv2.FONT_HERSHEY_SIMPLEX
        fs = self._glass_font_size(frame)
        lw = self.lw
        pad = 5 + lw * 2
        cy = int(h * 0.5)
        cx = int(w * 0.2) if side < 0 else int(w * 0.8)
        miny = int(h * 0.2)
        maxy = h - miny
        if side > 0:
            box_label = "%.0f" % (round(value / 10.0) * 10)
        else:
            box_label = "%.0f" % value
        tsz = cv2.getTextSize(box_label, font, fs, lw)
        xsize = tsz[0][0] + pad
        ysize = tsz[0][1] + pad
        # px per tick row: speed rows are half a text height apart, the
        # coarser altitude rows a full one (hud_glass.py:1204,1289)
        spacing = int(round(tsz[0][1] * 0.5)) if side < 0 else tsz[0][1]

        def row_y(v):
            return cy - int((v - value) / tick_unit * spacing)

        # AP bug: heptagon notched on the tape side (orchid)
        by = row_y(bug)
        if self.flight_mode == "auto" and miny <= by <= maxy:
            e = side * int(ysize * 0.7)
            pts = np.array([[(cx, by), (cx + e, by - int(ysize / 2)),
                             (cx + e, by - ysize), (cx, by - ysize),
                             (cx, by + ysize), (cx + e, by + ysize),
                             (cx + e, by + int(ysize / 2))]])
            cv2.fillPoly(frame, pts, ORCHID)

        if ground is not None:
            gy = row_y(ground)
            if miny <= gy <= maxy:
                cv2.line(frame, (cx + 2, gy),
                         (cx + 2, min(gy + 5 * spacing, maxy)), RED,
                         lw * 4, cv2.LINE_AA)
        if ceiling is not None:
            my = row_y(ceiling)
            if miny <= my <= maxy:
                cv2.line(frame, (cx + 2, my),
                         (cx + 2, max(my - 5 * spacing, miny)), YELLOW,
                         lw * 4, cv2.LINE_AA)
        if green_band is not None:
            y0 = min(max(row_y(green_band[0]), miny), maxy)
            y1 = min(max(row_y(green_band[1]), miny), maxy)
            cv2.line(frame, (cx, y0), (cx, y1), GREEN2, lw, cv2.LINE_AA)

        # tic rows: minor every tick_unit, labeled major every 5
        n_lo, n_hi = int(lo / tick_unit), int(hi / tick_unit)
        for i in range(n_lo, n_hi):
            y = row_y(i * tick_unit)
            if not (miny <= y <= maxy):
                continue
            ln = 6 if i % 5 == 0 else 4
            cv2.line(frame, (cx, y), (cx + side * ln, y), WHITE, lw,
                     cv2.LINE_AA)
        for i in range(n_lo, n_hi, 5):
            y = row_y(i * tick_unit)
            if not (miny <= y <= maxy):
                continue
            label = label_fmt % int(i * tick_unit)
            lsz = cv2.getTextSize(label, font, fs, lw)
            if side < 0:
                ux = cx - 8 - lsz[0][0]
            else:
                ux = cx + 8
            cv2.putText(frame, label, (ux, y + int(lsz[0][1] / 2)), font,
                        fs, WHITE, lw, cv2.LINE_AA)

        # value box: pointer pentagon, black fill, white outline
        e = side * int(ysize * 0.7)
        pts = np.array([[(cx, cy), (cx + e, cy - int(ysize / 2)),
                         (cx + e + side * xsize, cy - int(ysize / 2)),
                         (cx + e + side * xsize, cy + int(ysize / 2) + 1),
                         (cx + e, cy + int(ysize / 2) + 1)]])
        cv2.fillPoly(frame, pts, (0, 0, 0))
        cv2.polylines(frame, pts, True, WHITE, lw, cv2.LINE_AA)
        if side < 0:
            ux = int(cx - ysize * 0.7 - tsz[0][0])
        else:
            ux = int(cx + ysize * 0.7)
        cv2.putText(frame, box_label, (ux, cy + int(tsz[0][1] / 2)), font,
                    fs, WHITE, lw, cv2.LINE_AA)

        # units label under the tape
        lsz = cv2.getTextSize(units, font, fs, lw)
        ux = cx + side * int((ysize + xsize) * 0.5) - int(lsz[0][1] * 0.5)
        cv2.putText(frame, units, (ux, maxy + lsz[0][1] + lw * 2), font,
                    fs, WHITE, lw, cv2.LINE_AA)

    def draw_dg(self, frame, cv2):
        """Glass directional gyro (hud_glass.py:584-712). The reference
        composites a pre-rendered PNG rose (hdg_hud.png, alpha art in an
        annulus: 5-deg tics 0.88R..0.99R, 10-deg tics from 0.828R, 30-deg
        labels N/3/6/E/... centered near 0.67R), sized 0.25*frame_w,
        rotated to heading, cropped to its top 70% and bottom-anchored at
        the nose column. Here the same rose is drawn programmatically at
        the same annulus geometry, plus the white center marker, the AP
        heading bug arc and the ground-course arrow."""
        h, w = frame.shape[:2]
        rows = int(round(w * 0.25))       # rose bitmap size = 0.25w
        radius = rows // 2
        hdg_rows = int(rows * 0.7)        # cropped to the top 70%
        cx = self.nose_uv[0] if self.nose_uv else w // 2
        row_start = h - hdg_rows - 1
        cy = row_start + int(round(rows * 0.5))
        top = (cx, row_start)
        size1 = int(round(hdg_rows * 0.04))
        size2 = int(round(hdg_rows * 0.09))
        psi = self.ypr[0] * D2R
        y_crop = row_start + hdg_rows     # nothing below survives the crop

        def rim(theta, r_frac):
            """Point at screen angle theta (rad, clockwise from 12
            o'clock) and radius fraction r_frac of the rose."""
            return (int(round(cx + r_frac * radius * math.sin(theta))),
                    int(round(cy - r_frac * radius * math.cos(theta))))

        for hdg in range(0, 360, 5):
            a = hdg * D2R - psi
            r_in = 0.88 if hdg % 10 else 0.828
            p0, p1 = rim(a, r_in), rim(a, 0.99)
            if max(p0[1], p1[1]) > y_crop:
                continue
            cv2.line(frame, p0, p1, WHITE, self.lw, cv2.LINE_AA)
            if hdg % 30 == 0:
                lbl = {0: "N", 90: "E", 180: "S", 270: "W"}.get(
                    hdg, str(hdg // 10))
                fs = 0.11 * radius / 22.0  # text height ~0.11R
                lsz = cv2.getTextSize(lbl, cv2.FONT_HERSHEY_SIMPLEX, fs,
                                      self.lw)
                pl = rim(a, 0.665)
                if pl[1] + lsz[0][1] // 2 <= y_crop:
                    cv2.putText(frame, lbl,
                                (pl[0] - lsz[0][0] // 2,
                                 pl[1] + lsz[0][1] // 2),
                                cv2.FONT_HERSHEY_SIMPLEX, fs, WHITE,
                                self.lw, cv2.LINE_AA)

        def rot_all(pts, a):
            return [self._rotate_pt(p, (cx, cy), a) for p in pts]

        # AP heading bug: rim arc spanning +/-10 deg, depth size2 (orchid,
        # hud_glass.py:619-636)
        if self.flight_mode is not None and self.flight_mode != "manual":
            rot = self.ap_hdg * D2R - psi
            rot = (rot + math.pi) % (2 * math.pi) - math.pi
            ref1, ref2 = top, (cx, row_start + size2)
            arc = [rot_all([ref1, ref2], rot + d * D2R)
                   for d in (-10, -5, 0, 5, 10)]
            pts = np.array([[arc[0][0], arc[1][0], arc[2][0], arc[3][0],
                             arc[4][0], arc[4][1], arc[3][1], arc[2][0],
                             arc[1][1], arc[0][1]]])
            cv2.fillPoly(frame, pts, ORCHID)

        # white center marker above the rose top (hud_glass.py:656-660)
        cv2.fillPoly(frame, np.array([[top,
                                       (cx - size1, top[1] - size2),
                                       (cx + size1, top[1] - size2)]]),
                     (255, 255, 255))

        # ground-course arrow: shaft from just inside the rim to the rose
        # center plus a filled head, rotated to the persisted course
        # (hud_glass.py:662-683 — gc_rad only updates when moving)
        gs = math.hypot(self._vel_filt[0], self._vel_filt[1])
        if gs > 0.5:
            self._gc_rad = math.atan2(self._vel_filt[1], self._vel_filt[0])
        gc_rot = self._gc_rad - psi
        gc_rot = (gc_rot + math.pi) % (2 * math.pi) - math.pi
        nose = (cx, row_start + 1)
        uv = rot_all([nose, (cx - size1, nose[1] + size2),
                      (cx + size1, nose[1] + size2),
                      (cx, row_start + size1), (cx, cy)], gc_rot)
        cv2.polylines(frame, np.array([[uv[3], uv[4]]]), False, YELLOW,
                      int(round(self.lw * 1.5)), cv2.LINE_AA)
        cv2.fillPoly(frame, np.array([[uv[0], uv[1], uv[2]]]), YELLOW)

        # wind indicator: center-out arrow scaled by wind speed (royal
        # blue, hud_glass.py:685-712)
        if self.wind_deg != 0 or self.wind_kt != 0:
            max_wind = self.ap_speed if self.ap_speed > 0.1 else 30.0
            wind_kt = min(self.wind_kt, max_wind)
            wc_rot = self.wind_deg * D2R - psi
            wc_rot = (wc_rot + math.pi) % (2 * math.pi) - math.pi
            s1 = int(round(hdg_rows * 0.05))
            s2 = int(round(hdg_rows * 0.1))
            s3 = max(int(round(radius * (wind_kt / max_wind))), s1 + s2)
            uv = rot_all([(cx, cy), (cx - s1, cy - s2), (cx + s1, cy - s2),
                          (cx, cy - s1), (cx, cy - s3)], wc_rot)
            cv2.polylines(frame, np.array([[uv[3], uv[4]]]), False,
                          ROYALBLUE, int(round(self.lw * 1.5)), cv2.LINE_AA)
            cv2.fillPoly(frame, np.array([[uv[0], uv[1], uv[2]]]),
                         ROYALBLUE)

    def draw_roll_indicator(self, frame, cv2):
        """Bank-angle arc: 12-deg angular radius about the boresight, arc
        and tics counter-rotate with roll (sky pointer), white triangles
        for the zero marker (rolls) and the roll pointer (image-fixed)
        (hud_glass.py:812-871)."""
        scale = 12.0
        a1 = scale
        a2 = scale * 0.1
        a3 = scale * 0.06
        nose = self._cam_uv(0.0, 0.0)
        if nose is None:
            return
        rot = -self.ypr[2] * D2R

        def arc_pt(ang_deg, r):
            return self._cam_uv(math.cos(ang_deg * D2R) * r,
                                math.sin(ang_deg * D2R) * r)

        arc = [arc_pt(a, a1) for a in range(-60, 61, 5)]
        if any(p is None for p in arc):
            return
        arc = [self._rotate_pt(p, nose, rot) for p in arc]
        cv2.polylines(frame, np.array([arc]), False, (255, 255, 255),
                      self.lw, cv2.LINE_AA)
        for ang, ln in ((-60, a2), (-30, a2), (30, a2), (60, a2),
                        (-45, a3), (45, a3), (-20, a3), (20, a3),
                        (-10, a3), (10, a3)):
            t0, t1 = arc_pt(ang, a1), arc_pt(ang, a1 + ln)
            if t0 is None or t1 is None:
                continue
            tic = [self._rotate_pt(t0, nose, rot),
                   self._rotate_pt(t1, nose, rot)]
            cv2.polylines(frame, np.array([tic]), False, (255, 255, 255),
                          self.lw, cv2.LINE_AA)
        # zero marker (counter-rotates) and roll pointer (image-fixed)
        tri = [self._cam_uv(a1, 0.0), self._cam_uv(a1 + a2, 0.66),
               self._cam_uv(a1 + a2, -0.65)]
        if all(p is not None for p in tri):
            cv2.fillPoly(frame, np.array([[self._rotate_pt(p, nose, rot)
                                           for p in tri]]), (255, 255, 255))
        tri = [self._cam_uv(a1, 0.0), self._cam_uv(a1 - a2, 0.66),
               self._cam_uv(a1 - a2, -0.65)]
        if all(p is not None for p in tri):
            cv2.fillPoly(frame, np.array([tri]), (255, 255, 255))

    def draw_horizon(self, frame, cv2):
        """True horizon: points at zero elevation angle, far away
        (reference hud.py:223-254)."""
        yaw = self.ypr[0] * D2R
        pts = []
        for dyaw in np.linspace(-60, 60, 9) * D2R:
            d = 5000.0
            pts.append(self.ned + [d * math.cos(yaw + dyaw),
                                   d * math.sin(yaw + dyaw), 0.0])
        uv = self.project(np.asarray(pts))
        self._polyline(frame, cv2, uv)

    def draw_pitch_ladder(self, frame, cv2, beta_rad=0.0):
        """Pitch ladder: solid rungs above the horizon, 3-dash slanted
        rungs below, 0.5-deg end ticks, degree labels at a 1.25x rung
        extension; rungs span 2..8 deg either side of the heading
        (hud_glass.py:398-481)."""
        a1, a2 = 2.0, 8.0
        yaw = self.ypr[0] * D2R
        fs = self._glass_font_size(frame)

        def lad(p, dy):
            return self._ladder_uv(frame, yaw, p, dy)

        def label(uv1, uv2, a0):
            du, dv = uv2[0] - uv1[0], uv2[1] - uv1[1]
            self.draw_label(frame, cv2, "%d" % a0,
                            (uv1[0] + int(1.25 * du), uv1[1] + int(1.25 * dv)),
                            fs)

        for a0 in range(5, 35, 5):
            for sgn in (1, -1):
                # above horizon: solid rung + end tick + label
                uv1, uv2 = lad(a0, sgn * a1), lad(a0, sgn * a2)
                if uv1 is not None and uv2 is not None:
                    cv2.line(frame, uv1, uv2, self.color, self.lw,
                             cv2.LINE_AA)
                    label(uv1, uv2, a0)
                t1, t2 = lad(a0 - 0.5, sgn * a1), lad(a0, sgn * a1)
                if t1 is not None and t2 is not None:
                    cv2.line(frame, t1, t2, self.color, self.lw,
                             cv2.LINE_AA)
                # below horizon: three slanted dashes + end tick + label
                uv1, uv2 = lad(-a0, sgn * a1), lad(-a0 - 0.5, sgn * a2)
                if uv1 is not None and uv2 is not None:
                    du, dv = uv2[0] - uv1[0], uv2[1] - uv1[1]
                    for i in range(3):
                        d1 = (uv1[0] + int(0.375 * i * du),
                              uv1[1] + int(0.375 * i * dv))
                        d2 = (d1[0] + int(0.25 * du), d1[1] + int(0.25 * dv))
                        cv2.line(frame, d1, d2, self.color, self.lw,
                                 cv2.LINE_AA)
                    label(uv1, uv2, a0)
                t1, t2 = lad(-a0 + 0.5, sgn * a1), lad(-a0, sgn * a1)
                if t1 is not None and t2 is not None:
                    cv2.line(frame, t1, t2, self.color, self.lw,
                             cv2.LINE_AA)

    def draw_heading(self, frame, cv2):
        """Compass ribbon along the top (reference hud.py:648-700)."""
        w = frame.shape[1]
        yaw = self.ypr[0] % 360
        cx = w // 2
        span = 60.0  # degrees visible
        for hdg in range(0, 360, 5):
            diff = (hdg - yaw + 180) % 360 - 180
            if abs(diff) > span / 2:
                continue
            x = int(cx + diff / (span / 2) * (w * 0.25))
            major = hdg % 10 == 0
            cv2.line(frame, (x, 18), (x, 30 if major else 24), self.color, 1)
            if hdg % 30 == 0:
                label = str(hdg // 10)
                cv2.putText(frame, label, (x - 8, 14),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.45, self.color, 1)
        cv2.putText(frame, "%03d" % round(yaw), (cx - 18, 48),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.6, WHITE, 2)

    def draw_tapes(self, frame, cv2):
        """Airspeed (left) and altitude (right) tapes (hud.py:648-834)."""
        h, w = frame.shape[:2]
        cy = h // 2
        for side, value, label in ((0, self.airspeed, "m/s"),
                                   (1, self.altitude, "m")):
            x = 30 if side == 0 else w - 90
            for dv in range(-25, 30, 5):
                v = (round(value / 5) * 5) + dv
                if v < 0:
                    continue
                y = int(cy - (v - value) * 4)
                if 40 < y < h - 40:
                    cv2.line(frame, (x + 45, y), (x + 52, y), self.color, 1)
                    cv2.putText(frame, "%d" % v, (x, y + 4),
                                cv2.FONT_HERSHEY_SIMPLEX, 0.45, self.color, 1)
            cv2.rectangle(frame, (x - 5, cy - 14), (x + 60, cy + 12),
                          (0, 0, 0), -1)
            cv2.putText(frame, "%.0f %s" % (value, label), (x, cy + 6),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.55, WHITE, 2)

    def draw_flight_path_marker(self, frame, cv2):
        """Where the aircraft is actually going (hud.py velocity vector)."""
        if np.linalg.norm(self.vel_ned) < 0.5:
            return
        tgt = self.ned + self.vel_ned / np.linalg.norm(self.vel_ned) * 1000.0
        uv = self.project(tgt[None])
        if np.isnan(uv).any():
            return
        c = tuple(uv[0].astype(int))
        cv2.circle(frame, c, 8, self.color, self.lw)
        cv2.line(frame, (c[0] - 16, c[1]), (c[0] - 8, c[1]), self.color, self.lw)
        cv2.line(frame, (c[0] + 8, c[1]), (c[0] + 16, c[1]), self.color, self.lw)
        cv2.line(frame, (c[0], c[1] - 12), (c[0], c[1] - 6), self.color, self.lw)

    def _polyline(self, frame, cv2, uv):
        good = ~np.isnan(uv).any(axis=1)
        pts = uv[good].astype(int)
        for i in range(len(pts) - 1):
            cv2.line(frame, tuple(pts[i]), tuple(pts[i + 1]), self.color,
                     self.lw)


def open_writer(out_path, fps, size):
    """An mp4v cv2.VideoWriter of size (W, H) at fps; raises when cv2 cannot
    open it, rather than drop every frame or take another codec."""
    import cv2

    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             size)
    if not writer.isOpened():
        raise OSError(f"cv2.VideoWriter cannot open {out_path} (mp4v, "
                      f"{size[0]}x{size[1]} at {fps} fps)")
    return writer


def overlay_video(video_path, out_path, cam: VirtualCamera, state_fn,
                  max_frames=None, alpha=1.0, style="classic"):
    """Render the HUD over a flight video (reference 2-gen-hud-overlay.py).

    state_fn(time_s) → dict(ned, quat, ypr_deg[, vel_ned, airspeed,
    altitude]) interpolated from the correlated flight log.
    """
    import cv2

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise FileNotFoundError(video_path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    W = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    H = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    cam.scale_to(W, H)
    try:
        writer = open_writer(out_path, fps, (W, H))
    except OSError:
        cap.release()
        raise
    hud = HUD(cam, style=style)
    idx = 0
    while True:
        ret, frame = cap.read()
        if not ret or (max_frames and idx >= max_frames):
            break
        state = state_fn(idx / fps)
        hud.update_state(**state)
        overlay = frame.copy()
        hud.draw(overlay)
        if alpha < 1.0:
            frame = cv2.addWeighted(overlay, alpha, frame, 1 - alpha, 0)
        else:
            frame = overlay
        writer.write(frame)
        idx += 1
    cap.release()
    writer.release()
    return idx

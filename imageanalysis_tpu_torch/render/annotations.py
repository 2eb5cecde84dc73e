"""Map annotations: markers with lat/lon/alt/comment, multi-format export.

Reference scripts/explore/annotations.py:74-174: ``annotations.json``
({id_prefix, markers: [{lat_deg, lon_deg, alt_m, comment, id}]}),
``annotations.csv``, and ``annotations.kml`` (markers + mission-outline
convex hull). KML here is written directly (simplekml isn't in this
environment — it's a trivial XML schema).

Port of ``imageanalysis_tpu/render/annotations.py``: the same code over
the port's core/geodesy (float64 numpy), so the three files are byte for
byte the reference's for the same markers.
"""

from __future__ import annotations

import csv
import json
import os

import numpy as np

from ..core import geodesy


class Annotations:
    def __init__(self, analysis_dir: str, ned_ref, id_prefix="mk"):
        self.analysis_dir = analysis_dir
        self.ned_ref = list(ned_ref)
        self.id_prefix = id_prefix
        self.markers: list[dict] = []
        self.next_id = 0

    # -- marker management ------------------------------------------------
    def add_marker_lla(self, lat_deg, lon_deg, alt_m, comment="", id=None):
        mid = id if id is not None else self.next_id
        self.next_id = max(self.next_id, mid + 1)
        ned = geodesy.lla2ned(lat_deg, lon_deg, alt_m, *self.ned_ref)
        m = {"lat_deg": float(lat_deg), "lon_deg": float(lon_deg),
             "alt_m": float(alt_m), "comment": comment, "id": int(mid),
             "ned": np.asarray(ned).tolist()}
        self.markers.append(m)
        return m

    def add_marker_ned(self, ned, comment="", id=None):
        lla = geodesy.ned2lla(np.asarray(ned, float), *self.ned_ref)
        return self.add_marker_lla(lla[0], lla[1], lla[2], comment, id)

    def delete_marker(self, mid):
        self.markers = [m for m in self.markers if m["id"] != mid]

    # -- persistence (reference annotations.py:74-174) --------------------
    def path(self, ext):
        return os.path.join(self.analysis_dir, "annotations." + ext)

    def load(self):
        if not os.path.isfile(self.path("json")):
            return self
        with open(self.path("json")) as f:
            root = json.load(f)
        markers = root.get("markers", root) if isinstance(root, dict) else root
        if isinstance(root, dict) and "id_prefix" in root:
            self.id_prefix = root["id_prefix"]
        self.markers = []
        for m in markers:
            if isinstance(m, dict):
                self.add_marker_lla(m["lat_deg"], m["lon_deg"],
                                    m.get("alt_m", 0.0),
                                    m.get("comment", ""), m.get("id"))
            else:  # legacy [lat, lon, alt(, comment)]
                self.add_marker_lla(m[0], m[1], m[2],
                                    m[3] if len(m) > 3 else "")
        return self

    def save(self, camera_positions_ned=None, mission_name="mission"):
        lla_list = [{"lat_deg": m["lat_deg"], "lon_deg": m["lon_deg"],
                     "alt_m": round(m["alt_m"], 2), "comment": m["comment"],
                     "id": m["id"]} for m in self.markers]
        with open(self.path("json"), "w") as f:
            json.dump({"id_prefix": self.id_prefix, "markers": lla_list}, f,
                      indent=4)
        with open(self.path("csv"), "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["id", "lat_deg", "lon_deg",
                                              "alt_m", "comment"])
            w.writeheader()
            for jm in lla_list:
                row = dict(jm)
                row["id"] = "%s%03d" % (self.id_prefix, jm["id"])
                w.writerow(row)
        self.save_kml(camera_positions_ned, mission_name)

    def save_kml(self, camera_positions_ned=None, mission_name="mission"):
        lines = ['<?xml version="1.0" encoding="UTF-8"?>',
                 '<kml xmlns="http://www.opengis.net/kml/2.2">', "<Document>"]
        for m in self.markers:
            name = "%s%03d" % (self.id_prefix, m["id"])
            lines += ["<Placemark>",
                      f"  <name>{name}</name>",
                      f"  <description>{_esc(m['comment'])}</description>",
                      "  <Point><coordinates>"
                      f"{m['lon_deg']:.8f},{m['lat_deg']:.8f},{m['alt_m']:.2f}"
                      "</coordinates></Point>",
                      "</Placemark>"]
        if camera_positions_ned is not None and len(camera_positions_ned) >= 3:
            import scipy.spatial

            pts = np.asarray(camera_positions_ned)[:, :2]
            hull = scipy.spatial.ConvexHull(pts)
            loop = list(hull.vertices) + [hull.vertices[0]]
            coords = []
            for vi in loop:
                ned = [pts[vi][0], pts[vi][1], 0.0]
                lla = geodesy.ned2lla(ned, *self.ned_ref)
                coords.append(f"{lla[1]:.8f},{lla[0]:.8f},0")
            lines += ["<Placemark>",
                      f"  <name>{_esc(mission_name)}</name>",
                      "  <LineString><coordinates>",
                      "  " + " ".join(coords),
                      "  </coordinates></LineString>",
                      "</Placemark>"]
        lines += ["</Document>", "</kml>"]
        with open(self.path("kml"), "w") as f:
            f.write("\n".join(lines) + "\n")


def _esc(s):
    return (str(s).replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;"))

"""Project utilities — the reference's 99-* script family.

Subcommands:

- ``new-camera``    — estimate a camera config from an image's EXIF and add
                      it to a camera DB dir (reference 99-new-camera.py:1-122)
- ``vignette``      — build the average-image vignette mask from a mission's
                      images (reference 99-vignette.py): median-downsampled
                      mean image, radially fit, saved as vignette.png for
                      the explorer's texture correction
- ``merge``         — merge several project folders into a group project
                      (reference 99-create-group-project.py): union of image
                      metadata and caches via symlinks + merged pose files
- ``zip``           — archive the ImageAnalysis meta (without caches) for
                      sharing (reference 99-zip-project.py)
- ``calibrate``     — chessboard camera calibration from images or a movie
                      (reference 3rd_party/ltseez-opencv/calibrate*.py)
- ``histogram``     — neighborhood histogram-matching tables for the
                      explorer (reference lib/histogram.py)
- ``preview-crops`` — cropped previews around each annotation + a leaflet
                      HTML map (reference 99-gen-preview-crops.py)
- ``import-annotations`` — CSV (lat/lon/alt/objectid columns) →
                      annotations.json (reference 99-import-annotations.py)
- ``est-cam-transform`` — average quaternion transform between initial and
                      optimized camera attitudes + per-image error report
                      (reference 99-est-cam-transform.py)
- ``capture-dates`` — per-image EXIF DateTime listing (reference
                      99-show-capture-date.py)
- ``add-to-name``   — renumber files by adding a constant to the numeric
                      part of the name (reference 99-add-to-name.py)
- ``copy-and-add``  — copy images renumbering by a constant (reference
                      99-copy-and-add.py)
- ``trim-far``      — list/delete images beyond a distance from the mission
                      center (reference 99-trim-far.py)
- ``plot-matches``  — headless match-graph figure (reference
                      99-plot-matches.py)
- ``wx-report``     — mission weather report: capture window, location and
                      SRTM elevation; the forecast.io fetch degrades
                      gracefully offline (reference 99-wx-report.py)

Port of ``imageanalysis_tpu/apps/utils.py``, the same 16 subcommands and
parser. ``preview-crops`` projects every annotation into its nearest
camera in one float32 call on the device (core/camera.project_ned_quat),
``histogram`` builds its tables on the device (render/texture), and
``wx-report`` samples its terrain there; ``est-cam-transform`` is host
work in float32, as the reference's jnp quaternions (core/rotations on
CPU tensors). The rest is host numpy and cv2, the same code. Usage:
``python -m imageanalysis_tpu_torch.apps.utils <subcommand> ...``; it runs
on the CUDA card, ``IMGTPU_PLATFORM=cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import zipfile

import numpy as np
import torch

from ..io.logger import log
from .process import main_device


def cmd_new_camera(args):
    from ..io import camera_db

    cfg = camera_db.estimate_from_exif(args.image, ccd_width_mm=args.ccd_width)
    key = f"{cfg['make']}_{cfg['model']}_{cfg['lens_model']}".replace(" ", "_")
    camera_db.save(key, cfg, args.db)
    log("wrote camera config:", os.path.join(args.db, key + ".json"))
    print(json.dumps(cfg, indent=2))
    return 0


def cmd_vignette(args):
    import cv2

    files = sorted(f for f in os.listdir(args.project)
                   if f.lower().endswith((".jpg", ".jpeg")))
    if not files:
        log("no images found")
        return 1
    acc = None
    count = 0
    for fname in files[: args.max_images]:
        img = cv2.imread(os.path.join(args.project, fname))
        g = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY).astype(np.float64)
        acc = g if acc is None else acc + g
        count += 1
    mean = acc / count
    mean = cv2.GaussianBlur(mean, (0, 0), mean.shape[1] / 32.0)
    # radial fit: average by radius, normalized to center
    h, w = mean.shape
    yy, xx = np.mgrid[0:h, 0:w]
    r = np.hypot(yy - h / 2, xx - w / 2)
    r_norm = r / r.max()
    nbins = 64
    idx = np.minimum((r_norm * nbins).astype(int), nbins - 1)
    prof = np.bincount(idx.ravel(), mean.ravel(), nbins) / \
        np.maximum(np.bincount(idx.ravel(), minlength=nbins), 1)
    prof = prof / prof[0]
    vig = prof[idx]
    out = os.path.join(args.project, "ImageAnalysis", "vignette.png")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    cv2.imwrite(out, (np.clip(vig, 0.2, 1.0) * 255).astype(np.uint8))
    log(f"vignette mask from {count} images → {out} "
        f"(corner falloff {prof[-1]:.2f})")
    return 0


def cmd_merge(args):
    """Union several missions into one group project via symlinked images
    and concatenated pix4d files."""
    os.makedirs(args.out, exist_ok=True)
    rows = []
    header = None
    for src in args.projects:
        pix4d = os.path.join(src, "pix4d.csv")
        with open(pix4d) as f:
            lines = f.read().splitlines()
        if header is None:
            header = lines[0]
        for ln in lines[1:]:
            if not ln.strip():
                continue
            name = ln.split(",")[0]
            link = os.path.join(args.out, name)
            target = os.path.abspath(os.path.join(src, name))
            if not os.path.exists(link):
                os.symlink(target, link)
            rows.append(ln)
    with open(os.path.join(args.out, "pix4d.csv"), "w") as f:
        f.write(header + "\n" + "\n".join(rows) + "\n")
    log(f"merged {len(args.projects)} projects, {len(rows)} images → {args.out}")
    return 0


def cmd_zip(args):
    ia = os.path.join(args.project, "ImageAnalysis")
    out = args.out or (os.path.basename(os.path.abspath(args.project))
                       + "-analysis.zip")
    n = 0
    with zipfile.ZipFile(out, "w", zipfile.ZIP_DEFLATED) as z:
        for root, dirs, files in os.walk(ia):
            if os.path.basename(root) == "cache" and not args.include_cache:
                dirs[:] = []
                continue
            for fname in files:
                p = os.path.join(root, fname)
                z.write(p, os.path.relpath(p, args.project))
                n += 1
    log(f"zipped {n} files → {out}")
    return 0


def cmd_calibrate(args):
    """Chessboard calibration (reference 3rd_party/ltseez-opencv)."""
    import cv2

    pattern = tuple(int(v) for v in args.pattern.split("x"))
    objp = np.zeros((pattern[0] * pattern[1], 3), np.float32)
    objp[:, :2] = np.mgrid[0:pattern[0], 0:pattern[1]].T.reshape(-1, 2) \
        * args.square_mm
    objpoints, imgpoints = [], []
    shape = None

    def feed(gray):
        nonlocal shape
        shape = gray.shape[::-1]
        found, corners = cv2.findChessboardCorners(gray, pattern)
        if found:
            corners = cv2.cornerSubPix(
                gray, corners, (5, 5), (-1, -1),
                (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 30, 0.01))
            objpoints.append(objp)
            imgpoints.append(corners)

    if args.movie:
        cap = cv2.VideoCapture(args.movie)
        idx = 0
        while True:
            ret, fr = cap.read()
            if not ret:
                break
            if idx % args.frame_step == 0:
                feed(cv2.cvtColor(fr, cv2.COLOR_BGR2GRAY))
            idx += 1
        cap.release()
    else:
        for f in sorted(os.listdir(args.images)):
            if f.lower().endswith((".jpg", ".jpeg", ".png")):
                img = cv2.imread(os.path.join(args.images, f),
                                 cv2.IMREAD_GRAYSCALE)
                feed(img)
    if len(objpoints) < 5:
        log(f"only {len(objpoints)} usable chessboard views; need ≥5")
        return 1
    rms, K, dist, _, _ = cv2.calibrateCamera(objpoints, imgpoints, shape,
                                             None, None)
    log(f"calibration rms: {rms:.3f}px over {len(objpoints)} views")
    cfg = {
        "make": args.make, "model": args.model, "lens_model": "unknown",
        "K": K.ravel().tolist(), "dist_coeffs": dist.ravel()[:5].tolist(),
        "width_px": shape[0], "height_px": shape[1],
        "focal_len_mm": 0.0, "ccd_width_mm": 0.0, "ccd_height_mm": 0.0,
    }
    if args.db:
        from ..io import camera_db
        key = f"{args.make}_{args.model}".replace(" ", "_")
        camera_db.save(key, cfg, args.db)
        log("saved to camera DB:", key)
    print(json.dumps(cfg, indent=2))
    return 0


def _load_annotations(project):
    path = os.path.join(project, "ImageAnalysis", "annotations.json")
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    with open(path) as f:
        root = json.load(f)
    if isinstance(root, dict):
        return root.get("id_prefix", "Marker "), root.get("markers", [])
    return "Marker ", root


def cmd_preview_crops(args, device="cuda"):
    """512² crops around each annotation from the nearest optimized camera
    + a leaflet HTML index (reference 99-gen-preview-crops.py:36-220).
    Every annotation is projected into its camera in one device call."""
    import cv2

    from ..core import geodesy
    from ..io.project import ProjectMgr

    id_prefix, markers = _load_annotations(args.project)
    proj = ProjectMgr(args.project)
    proj.load_images_info()
    ref = proj.ned_reference_lla()
    model = proj.camera_model(optimized=True)
    preview_dir = os.path.join(proj.analysis_dir, "annotations-preview")
    os.makedirs(preview_dir, exist_ok=True)
    for f in os.listdir(preview_dir):
        if f.endswith(".jpg"):
            os.remove(os.path.join(preview_dir, f))

    poses = []
    for im in proj.image_list:
        ned, _, quat = im.get_camera_pose(opt=im.has_opt_pose())
        poses.append((np.asarray(ned), np.asarray(quat)))

    size = args.size
    entries = []
    bounds = None
    feats, llas, nearest = [], [], []
    for m in markers:
        if "ned" in m:
            feat = np.asarray(m["ned"], float)
            lla = geodesy.ned2lla(feat[None], *ref)[0]
            lat, lon = float(lla[0]), float(lla[1])
        else:
            lat, lon = m["lat_deg"], m["lon_deg"]
            feat = np.asarray(geodesy.lla2ned(
                lat, lon, m.get("alt_m") or 0.0, *ref), float)
        dists = [np.linalg.norm(feat - p[0]) for p, _ in
                 zip(poses, proj.image_list)]
        feats.append(feat)
        llas.append((lat, lon))
        nearest.append(int(np.argmin(dists)))
    uvs = project_markers(feats, [poses[bi] for bi in nearest], model,
                          device) if markers else []
    for m, (lat, lon), bi, (u, v) in zip(markers, llas, nearest, uvs):
        bounds = ([min(bounds[0][0], lat), min(bounds[0][1], lon)],
                  [max(bounds[1][0], lat), max(bounds[1][1], lon)]) \
            if bounds else ([lat, lon], [lat, lon])
        image = proj.image_list[bi]
        rgb = cv2.imread(proj.image_path(image))
        if rgb is None:
            continue
        h, w = rgb.shape[:2]
        cx = int(np.clip(round(u), size, max(w - size, size)))
        cy = int(np.clip(round(v), size, max(h - size, size)))
        crop = rgb[max(cy - size, 0):cy + size, max(cx - size, 0):cx + size]
        label = "%s%03d" % (id_prefix, m.get("id", 0))
        out = os.path.join(preview_dir, label + ".jpg")
        cv2.imwrite(out, crop)
        entries.append((lat, lon, label + ".jpg"))
        log("preview:", out, f"from {image.name} at ({cx},{cy})")

    # leaflet map (reference 99-gen-preview-crops.py:64-220)
    html = [
        "<!DOCTYPE html><html><head><meta charset='utf-8'/>",
        "<link rel='stylesheet' "
        "href='https://unpkg.com/leaflet@1.6.0/dist/leaflet.css'/>",
        "<script src='https://unpkg.com/leaflet@1.6.0/dist/leaflet.js'>"
        "</script></head><body>",
        "<div id='mapid' style='width:100%;height:800px;'></div><script>",
        "var mymap = L.map('mapid');",
        "new L.TileLayer('http://{s}.tile.openstreetmap.org/{z}/{x}/{y}.png',"
        "{maxZoom:18}).addTo(mymap);",
    ]
    for lat, lon, img_file in entries:
        html.append(
            'L.marker([%.10f, %.10f]).addTo(mymap).bindPopup('
            '"<img width=\\"%d\\" height=\\"%d\\" src=\\"%s\\"/>",'
            ' { maxWidth: %d} );' % (lat, lon, 2 * size, 2 * size,
                                     img_file, 2 * size))
    if bounds:
        html.append("mymap.fitBounds([[%.10f,%.10f],[%.10f,%.10f]]);"
                    % (bounds[0][0], bounds[0][1], bounds[1][0],
                       bounds[1][1]))
    html.append("</script></body></html>")
    with open(os.path.join(preview_dir, "index.html"), "w") as f:
        f.write("\n".join(html))
    log(f"wrote {len(entries)} previews + index.html to {preview_dir}")
    return 0


def cmd_import_annotations(args):
    """CSV with latitude/longitude/altitude/objectid-ish columns →
    annotations.json (reference 99-import-annotations.py)."""
    import csv

    markers = []
    with open(args.csv_file) as f:
        for row in csv.DictReader(f):
            pt = {"id": None, "comment": "", "lat_deg": None,
                  "lon_deg": None, "alt_m": None}
            for key, val in row.items():
                k = key.lower()
                if "latitude" in k:
                    pt["lat_deg"] = float(val)
                elif "longitude" in k:
                    pt["lon_deg"] = float(val)
                elif "altitude" in k:
                    pt["alt_m"] = float(val)
                elif "objectid" in k:
                    pt["id"] = int(val)
            markers.append(pt)
    out = os.path.join(args.project, "ImageAnalysis", "annotations.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump({"id_prefix": os.path.basename(args.csv_file),
                   "markers": markers}, f, indent=4)
    log(f"imported {len(markers)} annotations → {out}")
    return 0


def project_markers(feats, poses, model, device="cuda"):
    """Pixels (N, 2) numpy of N NED points feats, each in its own camera
    poses[i] = (ned, quat), projected in one float32 call on device through
    the camera model's K and distortion."""
    from ..core.camera import project_ned_quat

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    uv, _ = project_ned_quat(t(feats), t([p[0] for p in poses]),
                             t([p[1] for p in poses]),
                             model.K.to(device), model.dist.to(device))
    return uv.cpu().numpy()


def _average_quaternions(Q):
    """Eigenvector quaternion average (reference 99-est-cam-transform.py:
    57-80, the standard Markley method)."""
    A = np.zeros((4, 4))
    for q in Q:
        A += np.outer(q, q)
    A /= len(Q)
    w, v = np.linalg.eigh(A)
    return np.real(v[:, -1])


def _ypr(rot, q):
    """(yaw, pitch, roll) radians of a quaternion, float32 numpy."""
    return torch.stack(rot.ypr_from_quat(rot.as_tensor(q))).numpy()


def cmd_est_cam_transform(args):
    """Average initial→optimized camera attitude transform + per-image
    pose-error rows (reference 99-est-cam-transform.py)."""
    from ..core import rotations as rot
    from ..io.project import ProjectMgr
    from ..match import groups as groups_mod

    proj = ProjectMgr(args.project)
    proj.load_images_info()
    grps = groups_mod.load(proj.analysis_dir)
    group = set(grps[0]) if grps else {im.name for im in proj.image_list}

    quats = []
    rows = []
    for im in proj.image_list:
        if im.name not in group or not im.has_opt_pose():
            continue
        ned0, _, q0 = im.get_camera_pose(opt=False)
        ned1, _, q1 = im.get_camera_pose(opt=True)
        # float32, as the reference's jnp quaternions
        rx = rot.quat_multiply(np.asarray(q1),
                               rot.quat_conjugate(np.asarray(q0))).numpy()
        rx = np.asarray(rx) / np.linalg.norm(rx)
        if quats and np.dot(rx, quats[0]) < 0:
            rx = -rx
        quats.append(rx)
        rows.append((im, np.asarray(ned0), np.asarray(ned1),
                     np.asarray(q0), np.asarray(q1)))
    if not quats:
        log("no optimized poses to estimate a transform from")
        return 1
    q_avg = _average_quaternions(np.asarray(quats))
    q_avg /= np.linalg.norm(q_avg)
    ypr = np.degrees(_ypr(rot, q_avg))
    log("average attitude transform (quat wxyz):",
        np.array2string(q_avg, precision=6))
    log("average transform euler ypr (deg): %.3f %.3f %.3f" % tuple(ypr))

    q_inv = rot.quat_conjugate(q_avg)
    log("%-24s %8s %8s %8s %8s %8s %8s"
        % ("image", "yaw_err", "pit_err", "rol_err", "n_err", "e_err",
           "d_err"))
    for im, ned0, ned1, q0, q1 in rows:
        q_corr = rot.quat_multiply(np.asarray(q1), q_inv)
        e0 = np.degrees(_ypr(rot, np.asarray(q0)))
        e1 = np.degrees(_ypr(rot, q_corr))
        derr = (e1 - e0 + 180.0) % 360.0 - 180.0
        nerr = ned1 - ned0
        log("%-24s %8.2f %8.2f %8.2f %8.2f %8.2f %8.2f"
            % (im.name, derr[0], derr[1], derr[2],
               nerr[0], nerr[1], nerr[2]))
    return 0


def cmd_capture_dates(args):
    """EXIF DateTime per image (reference 99-show-capture-date.py)."""
    import datetime

    from ..io import exif as exif_mod

    for f in sorted(os.listdir(args.project)):
        if f.lower().endswith((".jpg", ".jpeg", ".png")):
            try:
                _, _, _, unixtime, *_ = exif_mod.get_pose(
                    os.path.join(args.project, f))
                stamp = (datetime.datetime.fromtimestamp(unixtime)
                         .isoformat(" ") if unixtime else
                         "(no EXIF DateTime)")
                print(f, stamp)
            except Exception as e:
                print(f, f"(unreadable: {e})")
    return 0


def _renumber(basename, add):
    import re

    m = re.search(r"(\D*)(\d+)\.(.+)", basename)
    if not m:
        return None
    new_num = "%d" % (int(m.group(2)) + add)
    new_num = new_num.zfill(len(m.group(2)))
    return f"{m.group(1)}{new_num}.{m.group(3)}"


def cmd_add_to_name(args):
    """Renumber files in place (reference 99-add-to-name.py)."""
    for path in args.files:
        base = os.path.basename(path)
        new_base = _renumber(base, args.add)
        if new_base is None:
            log("skipping (no number):", path)
            continue
        dst = os.path.join(os.path.dirname(path), new_base)
        log("rename:", path, "→", dst)
        if args.write:
            os.rename(path, dst)
    if not args.write:
        log("(dry run — pass --write to apply)")
    return 0


def cmd_copy_and_add(args):
    """Copy images renumbering by a constant (reference 99-copy-and-add.py);
    aborts if a destination exists."""
    import shutil

    os.makedirs(args.dest, exist_ok=True)
    for f in sorted(os.listdir(args.src)):
        if not f.lower().endswith((".jpg", ".jpeg")):
            continue
        new_f = _renumber(f, args.add)
        if new_f is None:
            continue
        dst = os.path.join(args.dest, new_f)
        if os.path.exists(dst):
            log("ABORTING — exists:", dst)
            return 1
        log("cp:", os.path.join(args.src, f), dst)
        shutil.copy2(os.path.join(args.src, f), dst)
    return 0


def cmd_trim_far(args):
    """List (and optionally delete) images far from the mission center
    (reference 99-trim-far.py)."""
    from ..io.project import ProjectMgr

    proj = ProjectMgr(args.project)
    proj.load_images_info()
    rows = []
    for im in proj.image_list:
        try:
            ned, _, _ = im.get_camera_pose()
            dist = float(np.hypot(ned[0], ned[1]))
        except Exception:
            dist = 1e9
        rows.append((dist, im))
    rows.sort(key=lambda r: r[0])
    for dist, im in rows:
        marker = " DELETE" if (args.delete_further_than
                               and dist >= args.delete_further_than) else ""
        log(f"{im.name:24s} {dist:10.1f} m{marker}")
    if not args.delete_further_than:
        return 0
    victims = [im for dist, im in rows if dist >= args.delete_further_than]
    if not args.yes:
        log(f"{len(victims)} images would be removed — pass --yes to apply")
        return 0
    for im in victims:
        for sub, ext in (("cache", ".feat"), ("cache", ".desc"),
                         ("cache", ".match"), ("meta", ".json")):
            p = os.path.join(proj.analysis_dir, sub, im.name + ext)
            if os.path.exists(p):
                os.remove(p)
        img = proj.image_path(im)
        if os.path.exists(img):
            os.remove(img)
        log("removed:", im.name)
    return 0


def cmd_plot_matches(args):
    """Headless match-graph figure: camera positions + pair-count edges
    (reference 99-plot-matches.py)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..io.project import ProjectMgr

    proj = ProjectMgr(args.project)
    proj.load_images_info()
    pos = {}
    for im in proj.image_list:
        ned, _, _ = im.get_camera_pose(opt=im.has_opt_pose())
        pos[im.name] = (ned[1], ned[0])     # x=e, y=n
    fig, ax = plt.subplots(figsize=(10, 8))
    for im in proj.image_list:
        im.load_matches()
        for other, idx_pairs in (im.match_list or {}).items():
            if other in pos and len(idx_pairs) and im.name < other:
                x1, y1 = pos[im.name]
                x2, y2 = pos[other]
                ax.plot([x1, x2], [y1, y2], "b-", lw=0.5,
                        alpha=min(len(idx_pairs) / 200.0, 1.0))
    xs = [p[0] for p in pos.values()]
    ys = [p[1] for p in pos.values()]
    ax.plot(xs, ys, "ro", ms=4)
    ax.set_aspect("equal")
    ax.set_xlabel("east (m)")
    ax.set_ylabel("north (m)")
    out = args.out or os.path.join(proj.analysis_dir, "match-graph.png")
    fig.savefig(out, dpi=130, bbox_inches="tight")
    plt.close(fig)
    log("wrote match graph:", out)
    return 0


def cmd_wx_report(args, device="cuda"):
    """Mission weather report (reference 99-wx-report.py): capture window +
    midpoint location from image EXIF, SRTM surface elevation, then the
    forecast.io lookup — which degrades gracefully with no network or no
    ~/.forecastio API key."""
    from ..io import exif as exif_mod
    from ..surface import srtm as srtm_mod

    files = [f for f in sorted(os.listdir(args.project))
             if f.lower().endswith((".jpg", ".jpeg"))]
    if not files:
        log("no images found in", args.project)
        return 1
    infos = []
    for f in (files[0], files[-1]):
        lon_d, lat_d, alt_m, unixtime, *_ = exif_mod.get_pose(
            os.path.join(args.project, f))
        if lat_d is None or abs(lat_d) < 0.01:
            log("geotag missing/zero on", f)
            return 1
        infos.append((lat_d, lon_d, unixtime))
    lat = 0.5 * (infos[0][0] + infos[1][0])
    lon = 0.5 * (infos[0][1] + infos[1][1])
    t0 = infos[0][2]
    t1 = infos[1][2]
    print(f"Mission location: {lat:.6f}, {lon:.6f}")
    if t0 and t1:
        import datetime
        print("Capture window: %s → %s (%.1f min)" % (
            datetime.datetime.fromtimestamp(t0).isoformat(" "),
            datetime.datetime.fromtimestamp(t1).isoformat(" "),
            (t1 - t0) / 60.0))
    terr = srtm_mod.Terrain([lat, lon, 0.0], width_m=1000, height_m=1000,
                            step_m=100, device=device)
    elev = float(terr.interp(0.0, 0.0))
    print(f"SRTM surface elevation: {elev:.1f} m"
          + (" (flat fallback — tile not cached)" if terr.flat else ""))
    keyfile = os.path.expanduser("~/.forecastio")
    if not os.path.isfile(keyfile):
        print("(no ~/.forecastio API key — skipping weather lookup; sign up"
              " at forecast.io and save the key there)")
        return 0
    with open(keyfile) as f:
        apikey = f.read().strip()
    t = int(0.5 * ((t0 or 0) + (t1 or 0))) or None
    url = (f"https://api.darksky.net/forecast/{apikey}/{lat:.6f},{lon:.6f}"
           + (f",{t}" if t else ""))
    try:
        import urllib.request

        with urllib.request.urlopen(url, timeout=20) as r:
            wx = json.loads(r.read())
        cur = wx.get("currently", {})
        print("Conditions: %s  temp %.1f  wind %.1f @ %.0f°  gust %.1f"
              % (cur.get("summary", "?"), cur.get("temperature", 0.0),
                 cur.get("windSpeed", 0.0), cur.get("windBearing", 0.0),
                 cur.get("windGust", 0.0)))
    except Exception as e:
        print(f"(weather lookup failed — offline? {type(e).__name__}: {e})")
    return 0


def cmd_import_info(args):
    """Migrate legacy *.info pose files (aircraft-pose lla/ypr JSON) to a
    pix4d.csv (reference 99-import-ati.py, generalized: no hard-coded
    paths)."""
    import csv
    import fnmatch

    rows = []
    for f in sorted(os.listdir(args.source)):
        if not fnmatch.fnmatch(f, "*.info"):
            continue
        with open(os.path.join(args.source, f)) as fh:
            node = json.load(fh)
        pose = node.get("aircraft-pose") or node.get("aircraft_pose") or {}
        lla = pose.get("lla", [None] * 3)
        ypr = pose.get("ypr", [0.0] * 3)
        if lla[0] is None:
            log("skipping (no aircraft-pose/lla):", f)
            continue
        yaw = ypr[0] + (360.0 if ypr[0] < 0 else 0.0)
        name = os.path.splitext(f)[0] + ".JPG"
        rows.append([name, lla[0], lla[1], lla[2], ypr[2], ypr[1], yaw])
    out = args.out or os.path.join(args.source, "pix4d.csv")
    with open(out, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["File Name", "Lat (decimal degrees)",
                    "Lon (decimal degrees)", "Alt (meters MSL)",
                    "Roll (decimal degrees)", "Pitch (decimal degrees)",
                    "Yaw (decimal degrees)"])
        for name, lat, lon, alt, roll, pitch, yaw in rows:
            w.writerow([name, "%.10f" % lat, "%.10f" % lon, "%.2f" % alt,
                        "%.2f" % roll, "%.2f" % pitch, "%.2f" % yaw])
    log(f"wrote {len(rows)} poses → {out}")
    return 0


def cmd_histogram(args, device="cuda"):
    """Build + persist the neighborhood histogram-matching tables consumed
    by the explorer at texture load (reference lib/histogram.py +
    explorer.py:79)."""
    from ..io.project import ProjectMgr
    from ..render.texture import build_histograms

    proj = ProjectMgr(args.project)
    proj.load_images_info()
    hists, templates = build_histograms(proj, dist_cutoff=args.dist,
                                        self_weight=args.self_weight,
                                        device=device)
    print(f"histogram tables for {len(templates)} images saved to "
          f"{proj.analysis_dir}/histogram.pickle")
    return 0


# the subcommands that take the device
_ON_DEVICE = {"histogram", "preview-crops", "wx-report"}


def build_parser():
    p = argparse.ArgumentParser(prog="imageanalysis-utils")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("histogram",
                       help="build explorer histogram-matching tables")
    s.add_argument("project")
    s.add_argument("--dist", type=float, default=40.0)
    s.add_argument("--self-weight", type=float, default=0.1)
    s.set_defaults(fn=cmd_histogram)

    s = sub.add_parser("preview-crops",
                       help="annotation preview crops + leaflet map")
    s.add_argument("project")
    s.add_argument("--size", type=int, default=256)
    s.set_defaults(fn=cmd_preview_crops)

    s = sub.add_parser("import-annotations",
                       help="CSV → annotations.json")
    s.add_argument("project")
    s.add_argument("csv_file")
    s.set_defaults(fn=cmd_import_annotations)

    s = sub.add_parser("est-cam-transform",
                       help="avg initial→optimized attitude transform")
    s.add_argument("project")
    s.set_defaults(fn=cmd_est_cam_transform)

    s = sub.add_parser("capture-dates", help="EXIF DateTime per image")
    s.add_argument("project")
    s.set_defaults(fn=cmd_capture_dates)

    s = sub.add_parser("add-to-name", help="renumber files by a constant")
    s.add_argument("--add", required=True, type=int)
    s.add_argument("--write", action="store_true")
    s.add_argument("files", nargs="+")
    s.set_defaults(fn=cmd_add_to_name)

    s = sub.add_parser("copy-and-add",
                       help="copy images renumbering by a constant")
    s.add_argument("--src", required=True)
    s.add_argument("--dest", required=True)
    s.add_argument("--add", required=True, type=int)
    s.set_defaults(fn=cmd_copy_and_add)

    s = sub.add_parser("trim-far",
                       help="list/delete images far from mission center")
    s.add_argument("project")
    s.add_argument("--delete-further-than", type=float)
    s.add_argument("--yes", action="store_true")
    s.set_defaults(fn=cmd_trim_far)

    s = sub.add_parser("plot-matches", help="match-graph figure")
    s.add_argument("project")
    s.add_argument("--out")
    s.set_defaults(fn=cmd_plot_matches)

    s = sub.add_parser("wx-report", help="mission weather report")
    s.add_argument("project")
    s.set_defaults(fn=cmd_wx_report)

    s = sub.add_parser("import-info",
                       help="legacy *.info poses → pix4d.csv")
    s.add_argument("source")
    s.add_argument("--out")
    s.set_defaults(fn=cmd_import_info)

    s = sub.add_parser("new-camera")
    s.add_argument("image")
    s.add_argument("--db", required=True)
    s.add_argument("--ccd-width", type=float)
    s.set_defaults(fn=cmd_new_camera)

    s = sub.add_parser("vignette")
    s.add_argument("project")
    s.add_argument("--max-images", type=int, default=100)
    s.set_defaults(fn=cmd_vignette)

    s = sub.add_parser("merge")
    s.add_argument("out")
    s.add_argument("projects", nargs="+")
    s.set_defaults(fn=cmd_merge)

    s = sub.add_parser("zip")
    s.add_argument("project")
    s.add_argument("--out")
    s.add_argument("--include-cache", action="store_true")
    s.set_defaults(fn=cmd_zip)

    s = sub.add_parser("calibrate")
    s.add_argument("--images")
    s.add_argument("--movie")
    s.add_argument("--pattern", default="9x6")
    s.add_argument("--square-mm", type=float, default=25.0)
    s.add_argument("--make", default="unknown")
    s.add_argument("--model", default="unknown")
    s.add_argument("--db")
    s.add_argument("--frame-step", type=int, default=30)
    s.set_defaults(fn=cmd_calibrate)
    return p


def main(argv=None, device="cuda"):
    """The command line's entry point, on device (IMGTPU_PLATFORM in the
    environment overrides it, as in apps/process.py)."""
    args = build_parser().parse_args(argv)
    dev = main_device(device)
    if args.cmd in _ON_DEVICE:
        return args.fn(args, device=dev)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

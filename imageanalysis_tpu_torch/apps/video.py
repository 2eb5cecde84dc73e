"""Video pipeline CLI — the reference's user-facing video/ programs.

Subcommands glue the tested library layer into the same program flows:

  est-gyro-rates  feature-track a flight movie, write the per-frame motion
                  CSV + camera rotation rates (reference
                  video/1a-est-gyro-rates.py:1-774)
  stabilize       smoothed-trajectory stabilized copy of a movie
                  (reference video/1c-smooth-video.py)
  hud-overlay     flight-log → correlate → per-frame state interpolation →
                  HUD render → writer (reference
                  video/2-gen-hud-overlay.py:1-516)
  extract-geotag  grab frames every N seconds, geotag from the DJI flight
                  log, write pix4d.csv (reference
                  video/3-extract-and-geotag-frames.py:1-192)
  extract-dji     alias of extract-geotag (reference
                  video/4-extract-dji-frames.py:1-385 — same flow driven
                  from the DJI CSV/SRT logs)

Usage: ``python -m imageanalysis_tpu_torch.apps.video <subcommand> ...``.

Port of the JAX package's ``apps/video.py``: the same parser and flows;
the motion fits and the clock correlation run on the device of
``apps/process.py::main_device`` (IMGTPU_PLATFORM if set, else the card),
which is never swapped for the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..core.device import checked
from ..io.logger import log
from .process import main_device


def build_parser():
    p = argparse.ArgumentParser(description="video pipeline tools")
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("est-gyro-rates",
                       help="per-frame motion CSV + camera rotation rates")
    g.add_argument("video")
    g.add_argument("--scale", type=float, default=1.0,
                   help="feature-tracking image scale")
    g.add_argument("--max-frames", type=int)
    g.add_argument("--out", help="motion CSV path "
                                 "(default <video>_motion.csv)")

    s = sub.add_parser("stabilize", help="write a stabilized copy")
    s.add_argument("video")
    s.add_argument("--out", help="default <video>_stab.mp4")
    s.add_argument("--sigma", type=float, default=15.0,
                   help="trajectory smoothing sigma (frames)")
    s.add_argument("--zoom", type=float, default=1.05)
    s.add_argument("--max-frames", type=int)

    h = sub.add_parser("hud-overlay", help="render the HUD over a movie")
    h.add_argument("video")
    h.add_argument("--flight", required=True,
                   help="flight log CSV (time, lat, lon, alt, roll, pitch, "
                        "yaw[, vn, ve, vd, airspeed])")
    h.add_argument("--cam", help="camera config json (K, dist_coeffs, "
                                 "width_px, height_px, mount)")
    h.add_argument("--style", default="classic",
                   choices=["classic", "glass"])
    h.add_argument("--time-shift", type=float,
                   help="movie→flight clock offset in seconds; omit with "
                        "--movie-csv for FFT auto-sync")
    h.add_argument("--movie-csv",
                   help="est-gyro-rates output for clock auto-sync "
                        "(correlates movie rotation against flight yaw "
                        "rate)")
    h.add_argument("--alpha", type=float, default=1.0,
                   help="HUD blend weight")
    h.add_argument("--max-frames", type=int)
    h.add_argument("--out", help="default <video>_hud.mp4")

    for nm in ("extract-geotag", "extract-dji"):
        e = sub.add_parser(nm, help="extract + geotag frames from a movie")
        e.add_argument("video")
        e.add_argument("--log", required=True, help="DJI flight record CSV")
        e.add_argument("--out-dir", required=True)
        e.add_argument("--interval", type=float, default=1.0,
                       help="seconds between frames")
        e.add_argument("--start-unix", type=float,
                       help="unix time of the movie start (default: log "
                            "start, or the .SRT timestamp when present)")
        e.add_argument("--srt", help="DJI caption .srt for the start time")
        e.add_argument("--no-geotag", action="store_true",
                       help="skip writing GPS EXIF into the frames")
    return p


def _default_out(video, suffix):
    root, _ = os.path.splitext(video)
    return root + suffix


def cmd_est_gyro_rates(args, device):
    import json

    from ..video import frame_motion

    recs = frame_motion.estimate_motion(args.video,
                                        max_frames=args.max_frames,
                                        scale=args.scale, device=device)
    if not recs:
        log("no trackable motion found in", args.video)
        return 1
    out = args.out or _default_out(args.video, "_motion.csv")
    frame_motion.write_motion_csv(recs, out)
    # rotation-rate summary like the reference's final report
    import cv2
    cap = cv2.VideoCapture(args.video)
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    cap.release()
    rots = np.array([r[2] for r in recs], float)
    log(f"wrote {out}: {len(recs)} frames, median roll rate "
        f"{np.median(rots) * fps:.2f} deg/s")
    return 0


def cmd_stabilize(args, device):
    from ..video import stabilize

    out = args.out or _default_out(args.video, "_stab.mp4")
    n = stabilize.stabilize_video(args.video, out, sigma_frames=args.sigma,
                                  zoom=args.zoom,
                                  max_frames=args.max_frames,
                                  device=device)
    log(f"wrote {out}: {n} stabilized frames")
    return 0


def _auto_time_shift(flight, movie_csv, device):
    """FFT cross-correlation of flight yaw rate against the tracked movie
    rotation rate (reference 2-gen-hud-overlay.py's correlate step)."""
    import csv

    from ..video import correlate

    with open(movie_csv, newline="") as f:
        rows = list(csv.DictReader(f))
    mt = np.array([float(r["time"]) for r in rows])
    mrot = np.array([float(r["rotation (deg)"]) for r in rows])
    dt = np.gradient(mt)
    dt[dt <= 0] = 1.0
    mrate = np.radians(mrot) / dt
    ft = flight.t - flight.t[0]
    yaw_u = np.unwrap(np.radians(flight.cols["yaw"]))
    frate = np.gradient(yaw_u) / np.clip(np.gradient(ft), 1e-3, None)
    shift, _ = correlate.sync_clocks(ft, frate, mt, mrate, device=device)
    return float(shift)


def cmd_hud_overlay(args, device):
    from ..video import camera as vcam
    from ..video import flight_data, hud

    flight = flight_data.FlightLog(args.flight)
    if args.cam:
        cam = vcam.VirtualCamera.load(args.cam)
    else:
        import cv2
        cap = cv2.VideoCapture(args.video)
        w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)) or 1280
        h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)) or 720
        cap.release()
        f = 0.8 * w
        cam = vcam.VirtualCamera({"K": [f, 0, w / 2, 0, f, h / 2, 0, 0, 1],
                                  "dist_coeffs": [0.0] * 5,
                                  "width_px": w, "height_px": h})
        log(f"no --cam given; assuming f={f:.0f}px for {w}x{h}")
    shift = args.time_shift
    if shift is None and args.movie_csv:
        shift = _auto_time_shift(flight, args.movie_csv, device)
        log(f"auto time sync: movie + {shift:.2f}s = flight time")
    state_fn = flight.state_fn(time_shift=shift or 0.0)
    out = args.out or _default_out(args.video, "_hud.mp4")
    n = hud.overlay_video(args.video, out, cam, state_fn,
                          max_frames=args.max_frames, alpha=args.alpha,
                          style=args.style)
    log(f"wrote {out}: {n} frames with {args.style} HUD")
    return 0


def cmd_extract(args, device):
    from ..video import djilog

    flight = djilog.DjiCsv().load(args.log)
    start = args.start_unix
    if start is None and args.srt:
        entries = djilog.parse_srt(args.srt)
        for _, fields in entries:
            if "datetime" in fields:
                start = fields["datetime"]
                break
    names = djilog.extract_frames(args.video, flight, args.out_dir,
                                  interval=args.interval,
                                  video_start_unix=start,
                                  geotag_exif=not args.no_geotag)
    log(f"extracted {len(names)} geotagged frames into {args.out_dir}")
    return 0


def run(args, device="cuda"):
    """One parsed subcommand on device."""
    return {
        "est-gyro-rates": cmd_est_gyro_rates,
        "stabilize": cmd_stabilize,
        "hud-overlay": cmd_hud_overlay,
        "extract-geotag": cmd_extract,
        "extract-dji": cmd_extract,
    }[args.cmd](args, checked(device, "apps/video"))


def main(argv=None, device="cuda"):
    """The command line's entry point, on device (IMGTPU_PLATFORM in the
    environment overrides it, as in apps/process.py)."""
    dev = main_device(device)
    return run(build_parser().parse_args(argv), device=dev)


if __name__ == "__main__":
    sys.exit(main())

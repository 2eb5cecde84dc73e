"""Stray chains of the host SIFT on the 64-frame mission, and what they do
to BA.

Writes the synthetic mission of chip_smoke.py's phases 16–18 (4 strips of
16 frames, seed 0) at --size, runs ``apps/process.py`` on it with the host
detector (``--detector SIFT`` at --scale and --max-features, the ground at
0 m, chains of 2) and prints one JSON line: BA's mre, each camera's
distance from the truth (median, max), the pairs whose matches stray from
the planted homographies, and the chains whose observations lie more than
100 px from where the planted homographies put their first one (two
ground points linked into one chain), with the images they span.

The workspace stays under OUT/mission, so the reference's Step 4 can be
rerun on the same chains, and --report then prints the same line for the
workspace as it stands, without a new run:

    python -c "from imageanalysis_tpu.apps import process; process.main([
        'OUT/mission', '--camera', 'Synthetic_TestCam_none', '--camera-db',
        'OUT/db', '--ground', '0.0', '--min-chain-len', '2',
        '--refresh', 'STEP4'])"
    python scripts_torch/host_sift_chains.py OUT --report --device cpu

Usage (the card by default):
    python scripts_torch/host_sift_chains.py OUT [--size 1088 720]
        [--scale 1.0] [--max-features 4096] [--device cuda|cpu] [--report]
"""

import argparse
import json
import os
import re
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from imageanalysis_tpu_torch.apps import process  # noqa: E402
from imageanalysis_tpu_torch.core import geodesy  # noqa: E402
from imageanalysis_tpu_torch.io.project import ProjectMgr  # noqa: E402
from imageanalysis_tpu_torch.testing.synthetic import (  # noqa: E402
    CAMERA_KEY, REF_LLA, image_name, make_mission, write_mission)


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("out")
    p.add_argument("--size", type=int, nargs=2, default=(1088, 720))
    p.add_argument("--scale", default="1.0")
    p.add_argument("--max-features", default="4096")
    p.add_argument("--device", default="cuda")
    p.add_argument("--report", action="store_true",
                   help="report OUT/mission as it stands; no new run")
    args = p.parse_args()
    m = make_mission(strips=4, per_strip=16, size=tuple(args.size), seed=0,
                     device=args.device)
    d, db = os.path.join(args.out, "mission"), os.path.join(args.out, "db")
    rc = None
    if not args.report:
        write_mission(d, m, db)
        rc = process.main([d, "--camera", CAMERA_KEY, "--camera-db", db,
                           "--detector", "SIFT", "--scale", args.scale,
                           "--max-features", args.max_features, "--ground",
                           "0.0", "--min-chain-len", "2"],
                          device=args.device)
    proj = ProjectMgr(d)
    proj.load_images_info()
    lla = geodesy.ned2lla(m.ned, *REF_LLA)
    truth = geodesy.lla2ned(lla[:, 0], lla[:, 1], lla[:, 2],
                            *proj.ned_reference_lla())
    index = {image_name(i): i for i in range(len(m.ned))}
    err = np.array([np.linalg.norm(np.asarray(im.get_camera_pose(
        opt=True)[0]) - truth[index[im.name]]) for im in proj.image_list])
    thresh = float(args.size[0]) ** 0.25
    names = [im.name for im in proj.image_list]
    stray_pairs = []
    for i, im in enumerate(proj.image_list):
        im.load_features()
        im.load_matches()
    for i, im in enumerate(proj.image_list):
        for j in range(i + 1, len(names)):
            mm = np.asarray(im.match_list.get(names[j], []),
                            np.int64).reshape(-1, 2)
            if not len(mm):
                continue
            pa = np.c_[im.kp[mm[:, 0]], np.ones(len(mm))] @ m.H_ij(i, j).T
            off = np.linalg.norm(pa[:, :2] / pa[:, 2:]
                                 - proj.image_list[j].kp[mm[:, 1]], axis=1)
            if (off > 2 * thresh).any():
                stray_pairs.append([i, j, int((off > 2 * thresh).sum()),
                                    len(mm)])
    stray_chains = []
    for ch in proj.load_matches_grouped():
        (i0, uv0), rest = ch[2], ch[3:]
        dev = [float(np.linalg.norm((lambda q: q[:2] / q[2])(
            m.H_ij(i0, i) @ np.r_[uv0, 1.0]) - np.asarray(uv)))
            for i, uv in rest]
        if max(dev, default=0.0) > 100.0:
            stray_chains.append([[o[0] for o in ch[2:]],
                                 round(max(dev), 1)])
    log = "".join(open(os.path.join(proj.analysis_dir, f)).read()
                  for f in os.listdir(proj.analysis_dir)
                  if f.startswith("messages-"))
    mre = [float(x) for x in re.findall(r"BA finished: mre=([\d.]+)px",
                                        log)]
    print(json.dumps({"rc": rc, "size": args.size, "scale": args.scale,
                      "max_features": args.max_features, "ba_mre": mre,
                      "camera_err_median_m": float(np.median(err)),
                      "camera_err_max_m": float(err.max()),
                      "stray_pairs": stray_pairs,
                      "stray_chains": stray_chains,
                      "device": args.device}))


if __name__ == "__main__":
    main()

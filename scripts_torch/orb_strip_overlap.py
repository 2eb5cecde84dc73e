"""Count the host detectors' features where two frames of phase 16's
mission overlap, along a strip and across strips, as the pipeline's cv
backend detects them (the reference's cv2 calls: PIL's draft and
cv2.resize to the scale, CLAHE, cv2.ORB_create(max_features) or
cv2.SIFT_create). Prints one JSON line: for each detector and frame pair
(i, j), frame i's features, how many of them the planted homography
H_ij maps inside frame j, and that overlap's width in frame i's pixels
at the detection scale.

    python3 scripts_torch/orb_strip_overlap.py [--device cpu|cuda]
        [--scale 0.4] [--max-features 8000] [--pairs 5-6,5-21,21-37]

Strips of make_mission's default mission sit 2.5 along-track spacings
apart, so two strips overlap in a thin band along the frame's long
edge; ORB keeps no keypoint within its edge threshold (31 px at every
pyramid level) of the border, SIFT keeps some.
"""

import argparse
import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from imageanalysis_tpu_torch.features.detect import (  # noqa: E402
    DetectorConfig, detect_scaled, load_scaled_gray)
from imageanalysis_tpu_torch.testing.synthetic import (  # noqa: E402
    image_name, make_mission, write_mission)


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--scale", type=float, default=0.4)
    p.add_argument("--max-features", type=int, default=8000)
    p.add_argument("--pairs", default="5-6,5-21,21-37")
    args = p.parse_args()
    import cv2

    pairs = [tuple(int(x) for x in s.split("-"))
             for s in args.pairs.split(",")]
    m = make_mission(device=args.device)
    H, W = m.frames.shape[1:]
    out = {"scale": args.scale, "max_features": args.max_features,
           "frame": [W, H], "cv2": cv2.__version__}
    with tempfile.TemporaryDirectory() as root:
        write_mission(root, m, os.path.join(root, "db"))
        for detector in ("ORB", "SIFT"):
            cfg = DetectorConfig(detector=detector, scale=args.scale,
                                 max_features=args.max_features)
            kps = {}
            for i in sorted({i for pair in pairs for i in pair}):
                scaled, _ = load_scaled_gray(
                    os.path.join(root, image_name(i) + ".jpg"), cfg.scale,
                    "cpu")
                scaled = cv2.createCLAHE(clipLimit=3.0, tileGridSize=(
                    8, 8)).apply(scaled.numpy())
                kps[i] = detect_scaled(scaled, cfg)[0] / cfg.scale
            rows = []
            for i, j in pairs:
                h = m.H_ij(i, j)
                x = np.c_[kps[i], np.ones(len(kps[i]))] @ h.T
                x = x[:, :2] / x[:, 2:]
                inside = ((x[:, 0] >= 0) & (x[:, 0] < W) & (x[:, 1] >= 0)
                          & (x[:, 1] < H))
                # frame i's pixels that map inside frame j, along its short
                # axis (the strips' offset) and its long axis
                g = np.stack(np.meshgrid(np.arange(0, W, 4),
                                         np.arange(0, H, 4)), -1)
                g = g.reshape(-1, 2).astype(np.float64)
                y = np.c_[g, np.ones(len(g))] @ h.T
                y = y[:, :2] / y[:, 2:]
                ok = ((y[:, 0] >= 0) & (y[:, 0] < W) & (y[:, 1] >= 0)
                      & (y[:, 1] < H))
                band = ([float(np.ptp(g[ok, 0])) + 4,
                         float(np.ptp(g[ok, 1])) + 4] if ok.any()
                        else [0.0, 0.0])
                rows.append({"pair": [i, j], "features": len(kps[i]),
                             "in_overlap": int(inside.sum()),
                             "overlap_px_at_scale": [
                                 round(b * cfg.scale, 1) for b in band]})
            out[detector] = rows
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

"""nvJPEG's gray decode against PIL's on the fixture of tests/data/jpeg/.

For each fixture JPEG (a 4:2:0 colour one and a one-channel one), the
largest and the mean |Δ| in gray levels between the card's decode and the
arrays PIL wrote into gray.npz: io/jpeg.decode_gray at full size against
PIL's luma, and features/detect.load_scaled_gray at scale 0.4 (a full
decode, a 2 × 2 box mean, cv2's INTER_LINEAR taps in torch) against the
reference's load (PIL's DCT-domain draft at 1/2, cv2.resize). These are
the errors tests/test_torch_cuda.py's GRAY_MAX_ERR and GRAY_MEAN_ERR
bound. One JSON line, with the card's name and power limit. Needs a card:

    python3 scripts_torch/jpeg_fixture_errors.py
"""

import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from imageanalysis_tpu_torch.features.detect import (  # noqa: E402
    load_scaled_gray)
from imageanalysis_tpu_torch.io import jpeg  # noqa: E402

FIXTURE = os.path.join(ROOT, "tests", "data", "jpeg")


def main():
    want = np.load(os.path.join(FIXTURE, "gray.npz"))
    out = {"device": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]}
    for name in ("colour", "gray"):
        path = os.path.join(FIXTURE, f"{name}.jpg")
        got = {"1.0": jpeg.decode_gray(path, "cuda"),
               "0.4": load_scaled_gray(path, 0.4, "cuda")[0]}
        for key, g in got.items():
            err = np.abs(g.cpu().numpy().astype(int) - want[f"{name}_{key}"])
            out[f"{name}_{key}"] = {"max_abs": int(err.max()),
                                    "mean_abs": float(err.mean()),
                                    "shape": list(err.shape)}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

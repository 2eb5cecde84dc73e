"""Bisect K1's time by adding one feature at a time. Counterpart of
scripts_dev/knn_culprit_bisect.py (P3), on the port's staged K1
(imageanalysis_tpu_torch/probes/knn_stages.py, csrc/knn_probe.cu):

  v0  product + row min
  v1  + d2 (na2 + nb2 − 2ab) + bit pack + index or: row top-1
  v2  + second minimum: top-2, restarted at every B tile
  v3  + the running top-2 across B tiles
  v4  + the column minimum: K1's result
  v5  the port's knn_top2 (K1 and the decode), for reference

--body tc (the default) runs v0–v4 on the tensor-core body K1 runs
(tc_stage_raw, K1's tile), --body old on the bodies K1 ran before it
(knn_probe_raw: __dp4a for int8, FFMA for bf16).

Usage (the card by default; bench's 64 pairs × 6144 × 128):
    python scripts_torch/knn_culprit_bisect.py [--dtype int8|bf16]
        [--body tc|old] [--pairs 64] [--n 6144] [--steps 16]
        [--device cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from imageanalysis_tpu_torch.ops import knn  # noqa: E402
from imageanalysis_tpu_torch.probes import (  # noqa: E402
    device_line, knn_stages, script_inputs, time_ms)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("int8", "bf16"), default="int8")
    ap.add_argument("--body", choices=("tc", "old"), default="tc")
    ap.add_argument("--pairs", type=int, default=64)
    ap.add_argument("--n", type=int, default=6144)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    i8, bf = script_inputs(args.pairs, args.n, args.device)
    inputs = (*i8, None, None) if args.dtype == "int8" else bf
    print(device_line(args.device))

    def bench(name, fn):
        ms = time_ms(fn, args.device, args.steps)
        print(f"{name:12s} {ms:8.2f} ms/batch  "
              f"{args.pairs / ms * 1e3:8.0f} pairs/s")

    stage_raw = (knn_stages.tc_stage_raw if args.body == "tc"
                 else knn_stages.knn_probe_raw)
    for v, s in knn_stages.P3_VARIANTS.items():
        bench(f"v{v}", lambda s=s: stage_raw(*inputs, stage=s))
    if args.dtype == "int8":
        bench("v5 prod", lambda: knn.knn_top2(*i8))
    else:
        bench("v5 prod", lambda: knn.knn_top2(inputs[0], inputs[1]))


if __name__ == "__main__":
    main()

"""Stage-cost decomposition of K1, the packed 2-NN kernel: product + row
sum, + row top-1, + row top-2, + column (full). Counterpart of
scripts_dev/knn_stage_cost.py (P4), on the port's staged K1
(imageanalysis_tpu_torch/probes/knn_stages.py, csrc/knn_probe.cu): on the
tensor-core body K1 runs (the default: tc_row_sum, then tc_stage's top1,
top2 and full) or, with --body old, on the __dp4a (int8) and FFMA (bf16)
bodies K1 ran before it, the yardstick.

Usage (the card by default; bench's 64 pairs × 6144 × 128):
    python scripts_torch/knn_stage_cost.py [--dtype int8|bf16]
        [--body tc|old] [--pairs 64] [--n 6144] [--steps 32]
        [--device cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from imageanalysis_tpu_torch.probes import (  # noqa: E402
    device_line, knn_stages, script_inputs, time_ms)

NAMES = [(0, "matmul+rowsum"), (1, "+d2+pack+row-top1"),
         (2, "+row-top2(mask+min)"), (3, "full(+col)")]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("int8", "bf16"), default="int8")
    ap.add_argument("--body", choices=knn_stages.P4_BODIES, default="tc")
    ap.add_argument("--pairs", type=int, default=64)
    ap.add_argument("--n", type=int, default=6144)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    i8, bf = script_inputs(args.pairs, args.n, args.device)
    inputs = (*i8, None, None) if args.dtype == "int8" else bf
    print(device_line(args.device) + f"; {args.body} body")
    for stage, name in NAMES:
        ms = time_ms(lambda: knn_stages.p4_stage_raw(
            *inputs, stage=stage, body=args.body), args.device, args.steps)
        print(f"stage {stage} {name}: {ms:.3f} ms/batch "
              f"({args.pairs / ms * 1e3:.0f} pairs/s)")


if __name__ == "__main__":
    main()

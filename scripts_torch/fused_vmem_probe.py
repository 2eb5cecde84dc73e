"""K1 + K4 in one launch, with parts switched off. Counterpart of
scripts_dev/fused_vmem_probe.py (P2), which compiled the TPU's fused
kernel per variant to bisect a VMEM overflow; the port's single-launch
kernel (imageanalysis_tpu_torch/probes/fused.py,
csrc/knn_fused_probe.cu) runs every variant at bench's shape, holds the
compared ones against knn_match_fused (K1, then K4) and times them.
--body wg (the default) runs it on the wgmma body K1 int8 runs, --body
tc on the mma.sync body K1 ran before, --body old on its first body
(__dp4a): the yardsticks.

Usage (the card by default; variants: full nopb noepi nomain epi32 t64):
    python scripts_torch/fused_vmem_probe.py [variant ...] [--body wg|tc|old]
        [--pairs 64] [--n 6144] [--steps 16] [--device cuda|cpu]
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from imageanalysis_tpu_torch.ops import knn  # noqa: E402
from imageanalysis_tpu_torch.probes import (  # noqa: E402
    device_line, fused, time_ms)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", metavar="variant",
                    help=f"any of {' '.join(fused.VARIANTS)} (default all)")
    ap.add_argument("--body", choices=tuple(fused.BODIES), default="wg")
    ap.add_argument("--pairs", type=int, default=64)
    ap.add_argument("--n", type=int, default=6144)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    bad = set(args.variants) - set(fused.VARIANTS)
    if bad:
        ap.error(f"no variant {sorted(bad)}")
    dev = args.device
    rng = np.random.default_rng(0)
    shape = (args.pairs, args.n, 128)
    a = torch.from_numpy(rng.integers(-128, 128, shape).astype(np.int8))
    b = torch.from_numpy(rng.integers(-128, 128, shape).astype(np.int8))
    uv = torch.from_numpy(rng.uniform(0, 4000, (*shape[:2], 2))
                          .astype(np.float32))
    a, b, uv = a.to(dev), b.to(dev), uv.to(dev)
    print(f"{device_line(dev)}; {args.body} body")
    want = knn.knn_match_fused(a, b, uv, fused.RATIO)
    ms = time_ms(lambda: knn.knn_match_fused(a, b, uv, fused.RATIO), dev,
                 args.steps)
    print(f"K1 then K4 (knn_match_fused): {ms:.3f} ms/batch")
    for v in args.variants or fused.VARIANTS:
        print("variant", v, fused.VARIANTS[v])
        got = fused.fused_probe_raw(a, b, uv, v, args.body)
        c_bj, c_ok, c_pb = fused.COMPARED[v]
        same = ((not c_bj or torch.equal(got[0], want[0]))
                and (not c_ok or torch.equal(got[1].bool(), want[1]))
                and (not c_pb or torch.equal(got[2], want[2])))
        what = "+".join(n for n, c in zip(("bj", "ok", "pb"),
                                          (c_bj, c_ok, c_pb)) if c)
        ms = time_ms(lambda: fused.fused_probe_raw(a, b, uv, v, args.body),
                     dev, args.steps)
        verdict = (f"{what} {'EQUAL' if same else 'DIFFER'} to "
                   "knn_match_fused" if what else "outputs undefined, "
                   "timed only")
        print(f"RUN OK {ms:.3f} ms/batch; {verdict}")
        if not same:
            sys.exit(1)


if __name__ == "__main__":
    main()

"""Does a one-hot product on the tensor cores keep bf16-exact values?
Counterpart of scripts_dev/epilogue_dot_probe.py (P1): gathers the
hi/mid/lo limbs of known values through the port's mma.sync one-hot
gather (imageanalysis_tpu_torch/probes/mma.py, csrc/mma_probe.cu; the
plain "bf16" version on the CPU) and prints the per-limb errors against
the exact values.

Usage (the card by default):
    python scripts_torch/epilogue_dot_probe.py [--device cuda|cpu]
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from imageanalysis_tpu_torch.probes import device_line, mma  # noqa: E402

N, T = 6144, 128


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    rng = np.random.default_rng(1)
    j = rng.integers(0, N, (T,)).astype(np.int32)
    u = rng.uniform(0, 4100, (N,)).astype(np.float32)
    print(device_line(args.device))
    uv = torch.from_numpy(u).to(args.device)
    vals = mma.limbs(uv)
    print("split recombines exactly on host:",
          float(((vals[0] + vals[1]) + vals[2] - uv).abs().max()))
    out = mma.onehot_gather_raw(torch.from_numpy(j).to(args.device),
                                vals).cpu().numpy()
    tgt = vals.cpu().numpy()[:, j].T
    for k, name in enumerate(["hi", "mid", "lo"]):
        err = np.abs(out[:, k] - tgt[:, k])
        print(f"{name}: maxerr {err.max():.6g}  sample out {out[:3, k]} "
              f"tgt {tgt[:3, k]}")
    rec = (out[:, 0] + out[:, 1]) + out[:, 2]
    print("recombined maxerr:", np.abs(rec - u[j]).max())


if __name__ == "__main__":
    main()

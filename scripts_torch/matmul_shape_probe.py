"""The descriptor product's rate against K and block tile, on the tensor
cores. Counterpart of scripts_dev/matmul_shape_probe.py (P5): the port's
mma.sync product + row sum (imageanalysis_tpu_torch/probes/mma.py,
csrc/mma_probe.cu) for K in {128, 256, 512} and the TPU script's tiles
(mapped to the card's as mma.P5_TILES lists), once on one 6144 × 6144
matrix and once batched at bench's 64 matrices; then the library
yardsticks, timed only: torch.mm bf16 and torch._int_mm + row sum at the
same shape (the script's "XLA dot" controls; they write the whole
product), and the K = 1024 control.

Usage (the card by default):
    python scripts_torch/matmul_shape_probe.py [--m 6144] [--batch 64]
        [--steps 16] [--device cuda|cpu]
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from imageanalysis_tpu_torch.probes import device_line, mma, time_ms  # noqa: E402,E501


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, default=6144)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev, M = args.device, args.m
    rng = np.random.default_rng(0)

    def normal(*shape):
        return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)) \
            .to(dev).bfloat16()

    def timeit(name, fn, flops):
        ms = time_ms(fn, dev, args.steps)
        print(f"{name}: {ms:.2f} ms  {flops / ms / 1e9:.1f} TFLOP/s")

    print(device_line(dev))
    for K in mma.K_SWEEP:
        a, b = normal(1, M, K), normal(1, M, K)
        timeit(f"mma.sync bf16 K={K} ta=128 tb={M} -> tile "
               f"{mma.K_SWEEP_TILE}", lambda: mma.mm_rowsum_raw(a, b),
               2 * M * M * K)
    a, b = normal(1, M, 128), normal(1, M, 128)
    for (ta, tb), tile in mma.P5_TILES.items():
        timeit(f"mma.sync bf16 K=128 ta={ta} tb={tb} -> tile {tile}",
               lambda: mma.mm_rowsum_raw(a, b, tile), 2 * M * M * 128)
    ab, bb = normal(args.batch, M, 128), normal(args.batch, M, 128)
    timeit(f"mma.sync bf16 batch {args.batch} K=128 tile "
           f"{mma.K_SWEEP_TILE}", lambda: mma.mm_rowsum_raw(ab, bb),
           2 * args.batch * M * M * 128)
    bt = bb.transpose(1, 2)
    timeit(f"torch.bmm bf16 batch {args.batch} (product only)",
           lambda: torch.bmm(ab, bt), 2 * args.batch * M * M * 128)
    del ab, bb, bt
    timeit(f"torch.mm bf16 ({M},128)@(128,{M})+rowsum",
           lambda: torch.mm(a[0], b[0].T).float().sum(1), 2 * M * M * 128)
    ai = torch.from_numpy(rng.integers(-127, 127, (M, 128)).astype(np.int8))
    bi = torch.from_numpy(rng.integers(-127, 127, (128, M)).astype(np.int8))
    ai, bi = ai.to(dev), bi.to(dev)
    if torch.device(dev).type == "cuda":
        timeit(f"torch._int_mm int8 ({M},128)@(128,{M})+rowsum",
               lambda: torch._int_mm(ai, bi).sum(1), 2 * M * M * 128)
    a2, b2 = normal(M, 1024), normal(1024, M)
    timeit(f"torch.mm bf16 ({M},1024)@(1024,{M})+rowsum",
           lambda: torch.mm(a2, b2).float().sum(1), 2 * M * M * 1024)


if __name__ == "__main__":
    main()

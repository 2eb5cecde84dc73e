"""The descriptor product's rate against K and block tile, on the tensor
cores. Counterpart of scripts_dev/matmul_shape_probe.py (P5): the port's
wgmma product + row sum fed by TMA (imageanalysis_tpu_torch/probes/mma.py
mm_rowsum_raw, csrc/mma_probe.cu) for K in {128, 256, 512} and the TPU
script's tiles (mapped to the card's as mma.P5_TILES lists), once on one
6144 × 6144 matrix (the kernels' profiler device time: CUDA events around
one call of ~10 µs of work time the wrapper) and once batched at bench's
64 matrices (CUDA events), each beside its first body (mm_rowsum_v0_raw,
mma.sync; the TPU's tile points at mma.P5_V0_TILES) timed in turns
(wgmma, v0, v0, wgmma). Then the library yardsticks, timed only:
torch.bmm bf16, torch.mm bf16 and torch._int_mm + row sum at the same
shape (the script's "XLA dot" controls; they write the whole product) and
the K = 1024 control; on the card also a square 8192³ torch.mm (the
library's own ceiling) and the SM clock and power nvidia-smi reads while
the batch runs back to back. Each line gives TFLOP/s and, on the card,
the share of the tensor cores' bound (989 TFLOP/s bf16, the H100 SXM's
dense peak at 700 W).

Usage (the card by default):
    python scripts_torch/matmul_shape_probe.py [--m 6144] [--batch 64]
        [--steps 16] [--device cuda|cpu]
"""

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from imageanalysis_tpu_torch.probes import (  # noqa: E402
    device_line, device_ms, mma, time_ms)

PEAK_BF16 = 989e12


def clocks_under_load(fn, seconds=2.0):
    """The SM clock and power nvidia-smi reads every 100 ms while fn runs
    back to back for `seconds` (the samples of the first 0.5 s dropped),
    and the bf16 tensor peak at the median clock: 989 TFLOP/s is 132 SMs
    × 4096 flops a clock × 1.83 GHz."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    smi.terminate()
    rows = [ln.split(",") for ln in smi.communicate()[0].splitlines()
            if ln.strip()][5:]
    mhz = [float(r[0]) for r in rows]
    watts = [float(r[1]) for r in rows]
    if not mhz:
        print("clocks under load: not measured (no nvidia-smi samples)")
        return
    med = float(np.median(mhz))
    print(f"clocks under load ({len(mhz)} samples): SM {min(mhz):.0f}-"
          f"{max(mhz):.0f} MHz, median {med:.0f}; power {min(watts):.1f}-"
          f"{max(watts):.1f} W; bf16 peak at the median clock "
          f"{PEAK_BF16 * med / 1830 / 1e12:.0f} TFLOP/s")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, default=6144)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev, M = args.device, args.m
    cuda = torch.device(dev).type == "cuda"
    rng = np.random.default_rng(0)

    def normal(*shape):
        return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)) \
            .to(dev).bfloat16()

    def rate(ms, flops):
        share = (f" ({100 * flops / PEAK_BF16 / ms * 1e3:.1f}% of the "
                 "bound)" if cuda else "")
        return f"{ms:.3f} ms {flops / ms / 1e9:.1f} TFLOP/s{share}"

    def timeit(name, fn, flops):
        print(f"{name}: {rate(time_ms(fn, dev, args.steps), flops)}")

    def turns(name, new, old, flops, kernel=None):
        """new and old in turns: CUDA events around a call, or with kernel
        (on the card) the profiler's device time of its kernels whose
        name holds that."""
        t = {new: [], old: []}
        for fn in (new, old, old, new):
            t[fn].append(device_ms(fn, kernel, args.steps)
                         if kernel and cuda else time_ms(fn, dev, args.steps))
        print(f"{name}: wgmma {rate(float(np.mean(t[new])), flops)}; v0 "
              f"{rate(float(np.mean(t[old])), flops)} (in turns)")

    print(device_line(dev))
    for K in mma.K_SWEEP:
        a, b = normal(1, M, K), normal(1, M, K)
        turns(f"K={K} ta=128 tb={M} -> tile {mma.DEFAULT_TILE} (v0 "
              f"{mma.V0_K_SWEEP_TILE})", lambda: mma.mm_rowsum_raw(a, b),
              lambda: mma.mm_rowsum_v0_raw(a, b), 2 * M * M * K,
              "mm_rowsum")
    a, b = normal(1, M, 128), normal(1, M, 128)
    for tpu, tile in mma.P5_TILES.items():
        v0 = mma.P5_V0_TILES[tpu]
        turns(f"K=128 (ta, tb)={tpu} -> tile {tile} (v0 {v0})",
              lambda: mma.mm_rowsum_raw(a, b, tile),
              lambda: mma.mm_rowsum_v0_raw(a, b, v0), 2 * M * M * 128,
              "mm_rowsum")
    ab, bb = normal(args.batch, M, 128), normal(args.batch, M, 128)
    flops = 2 * args.batch * M * M * 128
    for tile in mma.TILES:
        timeit(f"batch {args.batch} K=128 wgmma tile {tile}",
               lambda: mma.mm_rowsum_raw(ab, bb, tile), flops)
    turns(f"batch {args.batch} K=128 tile {mma.DEFAULT_TILE} (v0 "
          f"{mma.V0_K_SWEEP_TILE})", lambda: mma.mm_rowsum_raw(ab, bb),
          lambda: mma.mm_rowsum_v0_raw(ab, bb), flops)
    if cuda:
        clocks_under_load(lambda: mma.mm_rowsum_raw(ab, bb))
    bt = bb.transpose(1, 2)
    timeit(f"torch.bmm bf16 batch {args.batch} (product only)",
           lambda: torch.bmm(ab, bt), flops)
    del ab, bb, bt
    if cuda:
        c1, c2 = normal(8192, 8192), normal(8192, 8192)
        timeit("torch.mm bf16 8192^3 (product only; the library's ceiling)",
               lambda: torch.mm(c1, c2), 2 * 8192 ** 3)
        del c1, c2
    timeit(f"torch.mm bf16 ({M},128)@(128,{M})+rowsum",
           lambda: torch.mm(a[0], b[0].T).float().sum(1), 2 * M * M * 128)
    ai = torch.from_numpy(rng.integers(-127, 127, (M, 128)).astype(np.int8))
    bi = torch.from_numpy(rng.integers(-127, 127, (128, M)).astype(np.int8))
    ai, bi = ai.to(dev), bi.to(dev)
    if cuda:
        timeit(f"torch._int_mm int8 ({M},128)@(128,{M})+rowsum",
               lambda: torch._int_mm(ai, bi).sum(1), 2 * M * M * 128)
    a2, b2 = normal(M, 1024), normal(1024, M)
    timeit(f"torch.mm bf16 ({M},1024)@(1024,{M})+rowsum",
           lambda: torch.mm(a2, b2).float().sum(1), 2 * M * M * 1024)


if __name__ == "__main__":
    main()

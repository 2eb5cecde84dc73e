"""Time the design of P5's wgmma product + row sum that the shipped kernel
was kept over (scripts_torch/mm_rowsum_designs.cu: wgmma's A from
registers; its head says more) against the kernel the port ships
(imageanalysis_tpu_torch/probes/mma.py mm_rowsum_raw, csrc/mma_probe.cu:
A from shared memory) at each of its tiles, at bench's batch, 64 × 6144²
× 128 bf16, in turns by the kernels' profiler device time (every call in
order, then in reverse, --rounds times; the median of each call's
rounds; CUDA events around a call would count the wrappers' unequal host
work).
The design is built here with nvcc into build/mm_rowsum_designs/
(ptxas's registers and spills printed), and held bit-exact against
mm_rowsum_plain on integer values in [-2, 2] at K = 128 and 512 at every
tile before it is timed. Needs a card:

    python3 scripts_torch/mm_rowsum_designs.py [--reps 10] [--rounds 6]
"""

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from imageanalysis_tpu_torch import _build  # noqa: E402
from imageanalysis_tpu_torch.probes import (  # noqa: E402
    device_line, device_ms, mma)

# design → its tile (BM, BN); every one A from registers (RS)
DESIGNS = dict(enumerate(mma.TILES))


def build():
    out = os.path.join(ROOT, "build", "mm_rowsum_designs")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, "libmm_rowsum_designs.so")
    nvcc = _build.find_nvcc()
    if nvcc is None:
        sys.exit("mm_rowsum_designs: needs nvcc")
    proc = subprocess.run(
        [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", lib,
         os.path.join(ROOT, "scripts_torch", "mm_rowsum_designs.cu")],
        check=True, capture_output=True, text=True)
    for name, u in _build.ptxas_usage(proc.stdout + proc.stderr).items():
        print(f"ptxas {name[-60:]}: (registers, spill stores, spill loads) "
              f"{u}")
    so = ctypes.CDLL(lib)
    so.mm_rowsum_design.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    so.mm_rowsum_design.restype = ctypes.c_int
    return so


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("mm_rowsum_designs: needs a CUDA card")
    print(device_line("cuda"))
    lib = build()
    stream = torch.cuda.current_stream().cuda_stream

    def design(d, x, y, split=1):
        out = (torch.empty if split == 1 else torch.zeros)(
            x.shape[:2], device="cuda")
        _build.check(lib.mm_rowsum_design(
            d, x.data_ptr(), y.data_ptr(), out.data_ptr(), x.shape[0],
            x.shape[1], y.shape[1], x.shape[2], split, stream),
            f"mm_rowsum_design {d}")
        return out
    gen = torch.Generator(device="cuda").manual_seed(3)
    for K in (128, 512):
        x = torch.randint(-2, 3, (2, 512, K), generator=gen,
                          device="cuda").bfloat16()
        y = torch.randint(-2, 3, (2, 1024, K), generator=gen,
                          device="cuda").bfloat16()
        want = mma.mm_rowsum_plain(x, y)
        for d in DESIGNS:
            for split in (1, 4):
                got = design(d, x, y, split)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    sys.exit(f"mm_rowsum_designs: design {d} K={K} split "
                             f"{split} differs from the plain version")
    print("every design bit-exact on integer values at K 128 and 512")
    M, B = 6144, 64
    xb = torch.randn((B, M, 128), generator=gen, device="cuda").bfloat16()
    yb = torch.randn((B, M, 128), generator=gen, device="cuda").bfloat16()
    flops = 2 * B * M * M * 128
    calls = {}
    for d, tile in DESIGNS.items():
        calls[f"RS {tile}"] = (lambda d=d: design(d, xb, yb), "rs_kernel")
        calls[f"shipped {tile}"] = (
            lambda tile=tile: mma.mm_rowsum_raw(xb, yb, tile),
            "mm_rowsum_wg_kernel")
    times = {name: [] for name in calls}
    for r in range(args.rounds):
        for name in list(calls)[::1 - 2 * (r % 2)]:
            times[name].append(device_ms(*calls[name], args.reps))
    for name, t in times.items():
        what = "A from shared memory (SS)" if name.startswith("shipped") \
            else "A from registers (RS)"
        ms = float(np.median(t))
        print(f"batch {B} K=128 {name:18s} median {ms:.3f} ms "
              f"{flops / ms / 1e9:.1f} TFLOP/s (rounds "
              f"{' '.join(f'{x:.3f}' for x in t)})  {what}")


if __name__ == "__main__":
    main()

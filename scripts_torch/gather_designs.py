"""Time the designs of P1's one-hot gather against the kernel the port
ships (imageanalysis_tpu_torch/probes/mma.py onehot_gather_raw, csrc/
mma_probe.cu) and its first body (onehot_gather_v0_raw), in turns, by
profiler device time, at the TPU probe's T = 128, N = 6144 and at smaller
shapes. The designs it was chosen over live in scripts_torch/
gather_designs.cu (its head says what each is), built here with nvcc
into build/gather_designs/; each is held bit-exact against
onehot_gather_plain(..., "bf16") before it is timed. Needs a card:

    python3 scripts_torch/gather_designs.py [--reps 50]
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
from imageanalysis_tpu_torch.probes import device_line, device_ms, mma  # noqa: E402

DESIGNS = {0: "one block of 32 warps a 16-row group (8 SMs at T = 128)",
           1: "cluster of 8 blocks a row group, cluster.sync() twice",
           2: "empty kernel, 8 blocks a row group (the launch's floor)"}


def build():
    out = os.path.join(ROOT, "build", "gather_designs")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, "libgather_designs.so")
    src = os.path.join(ROOT, "scripts_torch", "gather_designs.cu")
    nvcc = _build.find_nvcc()
    if nvcc is None:
        sys.exit("gather_designs: needs nvcc")
    subprocess.run([nvcc, *_build.NVCC_FLAGS, "-shared", "-o", lib, src],
                   check=True, capture_output=True, text=True)
    so = ctypes.CDLL(lib)
    so.gather_design.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 2 + [ctypes.c_void_p]
    so.gather_design.restype = ctypes.c_int
    return so


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("gather_designs: needs a CUDA card")
    print(device_line("cuda"))
    lib = build()
    stream = torch.cuda.current_stream().cuda_stream
    for T, N in ((128, 6144), (16, 1024), (128, 1024)):
        rng = np.random.default_rng(1)
        j = torch.from_numpy(rng.integers(0, N, (T,)).astype(np.int32)).cuda()
        u = torch.from_numpy(rng.uniform(0, 4100, (N,)).astype(np.float32))
        vals = mma.limbs(u.cuda())
        want = mma.onehot_gather_plain(j, vals, "bf16")

        def design(d):
            out = torch.empty((T, 3), device="cuda")
            _build.check(lib.gather_design(d, j.data_ptr(), vals.data_ptr(),
                                           out.data_ptr(), T, N, stream),
                         f"gather_design {d}")
            return out
        calls = {f"design {d}": (lambda d=d: design(d)) for d in DESIGNS}
        calls["shipped"] = lambda: mma.onehot_gather_raw(j, vals)
        calls["v0 (3 kernels a call)"] = lambda: mma.onehot_gather_v0_raw(
            j, vals)
        calls["index_select"] = lambda: torch.index_select(vals, 1, j)
        for name, fn in calls.items():
            if name != "design 2" and name != "index_select":
                got = fn()
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    sys.exit(f"gather_designs: {name} differs from the plain "
                             "version")
        times = {name: [] for name in calls}
        for order in (list(calls), list(calls)[::-1]):
            for name in order:
                times[name].append(device_ms(calls[name], None, args.reps))
        for name, t in times.items():
            what = DESIGNS.get(int(name[-1]), "") if name.startswith(
                "design") else ""
            print(f"T={T} N={N} {name:22s} device ms {t[0]:.5f} / {t[1]:.5f}"
                  f"  {what}")


if __name__ == "__main__":
    main()

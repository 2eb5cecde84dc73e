"""The H100's read rate from L2 and from device memory, by one read
kernel (scripts_torch/l2_read.cu, built here with nvcc into
build/l2_read/): each buffer size is read `--reps` times a launch by a
grid of 4 blocks of 512 threads an SM, 16 bytes a load with ld.global.cg,
timed by CUDA events (median of 5 launches after a warm-up); bytes read
over time. Buffers of 8 to 32 MB stay in the 50 MB L2 after the first
pass (P5's B matrix is 1.57 MB, its batch's 201 MB); 2 GB is device
memory. Needs a card:

    python3 scripts_torch/l2_read_rate.py [--reps 20]
"""

import argparse
import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from imageanalysis_tpu_torch import _build  # noqa: E402
from imageanalysis_tpu_torch.probes import device_line, time_ms  # noqa: E402

SIZES_MB = (2, 8, 16, 24, 32, 2048)


def build():
    out = os.path.join(ROOT, "build", "l2_read")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, "libl2_read.so")
    nvcc = _build.find_nvcc()
    if nvcc is None:
        sys.exit("l2_read_rate: needs nvcc")
    subprocess.run([nvcc, *_build.NVCC_FLAGS, "-shared", "-o", lib,
                    os.path.join(ROOT, "scripts_torch", "l2_read.cu")],
                   check=True, capture_output=True, text=True)
    so = ctypes.CDLL(lib)
    so.l2_read.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    so.l2_read.restype = ctypes.c_int
    return so


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("l2_read_rate: needs a CUDA card")
    print(device_line("cuda"))
    lib = build()
    blocks = 4 * torch.cuda.get_device_properties(0).multi_processor_count
    sink = torch.empty(blocks * 512, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for mb in SIZES_MB:
        buf = torch.ones(mb << 18, device="cuda")     # mb MB of f32
        n = buf.numel() // 4
        reps = args.reps if mb < 1024 else 2

        def run():
            _build.check(lib.l2_read(buf.data_ptr(), n, reps, blocks,
                                     sink.data_ptr(), stream), "l2_read")
        ms = time_ms(run, "cuda", 5)
        print(f"{mb} MB x {reps} reads: {ms:.4f} ms, "
              f"{mb * 2**20 * reps / ms / 1e9:.3f} TB/s")
        del buf


if __name__ == "__main__":
    main()

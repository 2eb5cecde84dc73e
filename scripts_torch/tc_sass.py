"""Count the machine instructions of the port's tensor-core kernels by
opcode, from the SASS of the package's built library (cuobjdump):
- the tensor-core 2-NN body's instantiations (csrc/knn_tc.cuh's
  knn_tc_kernel) at K1's tile, by mode: the product's (HMMA, IMMA, LDSM),
  the epilogue's (IMNMX or VIMNMX, FADD, FMUL, FFMA, FMNMX, LOP3, IADD3,
  SHFL, ATOMS, RED) and all of them. A probe mode that computes less than
  K1 shows here what nvcc dropped;
- with the argument p5, P5's product + row sum (csrc/mma_probe.cu): the
  wgmma kernel at each of its tiles (mm_rowsum_wg_kernel: HGMMA, the TMA
  loads UTMALDG or UBLKCP, the mbarriers' SYNCS, WARPGROUP's fences and
  waits, and no HMMA) and its first body (mm_rowsum_kernel, mma.sync);
- with the argument p2, P2's single launch (csrc/knn_fused_probe.cu): the
  kFused instantiations (modes 16-31) of the wgmma body (keys "... wg
  ROWS BN RING CONSUMERS": IGMMA) and of the mma.sync body (IMMA, no
  IDP) beside the mma.sync int8 K1's (mode 0), and its first body on
  __dp4a (knn_fused_probe_kernel: IDP, the __dp4a instruction).
Needs the CUDA toolkit:

    python3 scripts_torch/tc_sass.py [MODE ...]    # default: 0 4 5 6 7
    python3 scripts_torch/tc_sass.py p5
    python3 scripts_torch/tc_sass.py p2
"""

import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from imageanalysis_tpu_torch import _build  # noqa: E402

OPCODES = ("HMMA", "IMMA", "IDP", "LDSM", "HGMMA", "IGMMA", "UTMALDG",
           "UBLKCP", "SYNCS", "WARPGROUP", "IMNMX", "VIMNMX", "FADD", "FMUL",
           "FFMA", "FMNMX", "LOP3", "IADD3", "SHFL", "ATOMS", "RED", "BAR")
_MM = re.compile(r"mm_rowsum_(?:wg_)?kernelILi(\d+)ELi(\d+)E")
_V0 = re.compile(r"knn_fused_probe_kernelILi(\d+)ELb(\d)ELb(\d)ELb(\d)E"
                 r"Li(\d+)E")


def line(kernel, c):
    return json.dumps({"kernel": kernel, "total": sum(c.values()),
                       **{op: c[op] for op in OPCODES}})


def main():
    args = sys.argv[1:]
    kernels = _build.sass()
    if args == ["p5"]:
        for name in sorted(kernels):
            m = _MM.search(name)
            if m:
                body = "wgmma" if "wg_kernel" in name else "v0"
                print(line(f"mm_rowsum {body} {m.group(1)} {m.group(2)}",
                           _build.opcode_counts(kernels[name])))
        return
    per_key = _build.tc_kernel_usage({
        name: _build.opcode_counts(lines) for name, lines in kernels.items()})
    if args == ["p2"]:
        for key in sorted(per_key):
            dtype, mode, *tile = key.split()
            if dtype == "int8" and (16 <= int(mode) < 32 or (
                    mode == "0" and tile[0] == "128")):
                print(line(key, per_key[key]))
        for name in sorted(kernels):
            m = _V0.search(name)
            if m:     # TA, main, epi, pb, epilogue threads
                print(line("knn_fused_probe v0 " + " ".join(m.groups()),
                           _build.opcode_counts(kernels[name])))
        return
    modes = args or ["0", "4", "5", "6", "7"]
    for key in sorted(per_key):
        dtype, mode, *tile = key.split()
        if mode in modes and tile[:2] == ["128", "128"] and tile[2:] in (
                [], ["2"]):
            print(line(key, per_key[key]))


if __name__ == "__main__":
    main()

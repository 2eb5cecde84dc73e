"""Count the machine instructions of the tensor-core body's
instantiations (csrc/knn_tc.cuh's knn_tc_kernel) by opcode, from the
SASS of the package's built library (cuobjdump): the product's
(HMMA, IMMA, LDSM), the epilogue's (IMNMX or VIMNMX, FADD, FMUL, FFMA,
FMNMX, LOP3, IADD3, SHFL, ATOMS, RED) and all of them. A probe mode that computes less than
K1 shows here what nvcc dropped. Needs the CUDA toolkit:

    python3 scripts_torch/tc_sass.py [MODE ...]    # default: 0 4 5 6 7
"""

import collections
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from imageanalysis_tpu_torch import _build  # noqa: E402

OPCODES = ("HMMA", "IMMA", "LDSM", "IMNMX", "VIMNMX", "FADD", "FMUL", "FFMA",
           "FMNMX", "LOP3", "IADD3", "SHFL", "ATOMS", "RED", "BAR")


def counts(lines):
    """Opcode counts of one kernel's SASS lines ("/*0a30*/ @P0 IMNMX R1,
    ..."), the predicate and the opcode's suffixes dropped."""
    c = collections.Counter()
    for ln in lines:
        words = ln.split("*/", 1)[1].split()
        if words and words[0].startswith("@"):
            words = words[1:]
        if words:
            c[words[0].split(".")[0]] += 1
    return c


def main():
    modes = sys.argv[1:] or ["0", "4", "5", "6", "7"]
    per_key = _build.tc_kernel_usage({
        name: counts(lines) for name, lines in _build.sass().items()})
    for key in sorted(per_key):
        dtype, mode, *tile = key.split()
        if mode in modes and tile[:2] == ["128", "128"] and tile[2:] in (
                [], ["2"]):
            c = per_key[key]
            print(json.dumps({"kernel": key, "total": sum(c.values()),
                              **{op: c[op] for op in OPCODES}}))


if __name__ == "__main__":
    main()

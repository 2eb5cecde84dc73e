"""Digest the SASS of the wgmma body's production instantiations in the
package under ROOT (default: this checkout), so that two copies' 2-NN
kernels can be seen to be the same machine code:

    python3 scripts_torch/wg_sass_digests.py [ROOT] [--out FILE]

Builds ROOT's kernels into ROOT/build/ (with ROOT's own _build.py), reads
its library with cuobjdump, and prints one JSON line {"nvcc": nvcc's
release line, "digests": {"type mode wg": the first 12 hex digits of the
sha256 of its SASS}} over every "type mode wg" key (K1, K3 and the
product-only stage at 128 and 256 values a row); --out also writes it to
FILE. Written from the tree before the probes' tiles and modes joined the
body, it is imageanalysis_tpu_torch/csrc/knn_wg_sass.json, which
_build.wg_sass_changes() holds every later build to (chip_smoke.py's
phase 15 and tests/test_torch_cuda.py). Needs the CUDA toolkit (the card's
machine).
"""

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_build(root):
    """ROOT's _build.py (stdlib only) as a module of its own."""
    path = os.path.join(root, "imageanalysis_tpu_torch", "_build.py")
    spec = importlib.util.spec_from_file_location(
        f"build_{abs(hash(root))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=HERE)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    own = load_build(HERE)
    lib = load_build(os.path.abspath(args.root)).build()
    rec = {"nvcc": own.nvcc_version(), "digests": own.wg_sass_digests(lib)}
    print(json.dumps(rec, sort_keys=True), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(json.dumps(rec, indent=1, sort_keys=True) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

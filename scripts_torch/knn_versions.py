"""Time K1's int8 and bf16 modes (plain and gated) and K3 bf16 at the
main path's shapes, from the package under ROOT, and print one JSON line.

Run it once per copy of the package, each in its own process, in turns
(old, new, new, old), to compare two versions of the 2-NN kernels on one
card; each copy builds its kernels into ROOT/build/:

    python3 scripts_torch/knn_versions.py [ROOT]     # default: this repo

Shapes: the store's 256 pairs × 4096, bench.py's 64 × 6144 (int8 rows,
value − 128 of 0..99, a quarter planted; bf16 as 0..255 with f32 norms),
the gated modes at the store's shape with ~65% of the candidates gated
out, K3 at 64 × 10240. Times: median of CUDA events after warm-up.
"""

import json
import os
import sys

ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else os.path.join(
    os.path.dirname(os.path.abspath(__file__)), ".."))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from imageanalysis_tpu_torch import _build, probes  # noqa: E402
from imageanalysis_tpu_torch.ops import knn  # noqa: E402


def planted(gen, pairs, n):
    a = torch.randint(0, 100, (pairs, n, 128), generator=gen, device="cuda",
                      dtype=torch.int16)
    b = torch.randint(0, 100, (pairs, n, 128), generator=gen, device="cuda",
                      dtype=torch.int16)
    b[:, :n // 4] = (a[:, :n // 4] + 2).clamp(0, 255)
    return (a - 128).to(torch.int8), (b - 128).to(torch.int8)


def as_bf16(a, b):
    af, bf = a.float() + 128, b.float() + 128
    return af.bfloat16(), bf.bfloat16(), (af * af).sum(-1), (bf * bf).sum(-1)


def main():
    if not os.path.abspath(_build.__file__).startswith(ROOT + os.sep):
        sys.exit(f"imageanalysis_tpu_torch came from {_build.__file__}, "
                 f"not {ROOT}")
    gen = torch.Generator(device="cuda").manual_seed(2)
    _build.load()

    def t(fn, reps=5):
        return probes.time_ms(fn, "cuda", reps, 2)

    out = {}
    for name, pairs, n in (("store", 256, 4096), ("bench", 64, 6144)):
        a, b = planted(gen, pairs, n)
        f = as_bf16(a, b)
        out[f"i8_{name}"] = t(lambda: knn.knn_packed_raw(a, b))
        out[f"bf16_{name}"] = t(lambda: knn.knn_packed_raw(*f))
        if name == "store":
            gate = (torch.rand((pairs, n, 2), generator=gen, device="cuda")
                    * 1000,
                    torch.rand((pairs, n, 2), generator=gen, device="cuda")
                    * 1000, 400.0 ** 2)
            out["gated_i8"] = t(lambda: knn.knn_packed_raw(a, b, None, None,
                                                           *gate))
            out["gated_bf16"] = t(lambda: knn.knn_packed_raw(*f, *gate))
            del gate
        del a, b, f
    f = as_bf16(*planted(gen, 64, 10240))
    out["k3_bf16"] = t(lambda: knn.knn_wide_raw(*f), 3)
    print(json.dumps({"root": ROOT, "device": torch.cuda.get_device_name(0),
                      "ms": {k: round(v, 4) for k, v in out.items()}}),
          flush=True)


if __name__ == "__main__":
    main()

"""How far K3 f32 at 256 values a row lies from the truth on random
non-integer rows, on both tensor-core bodies and in the plain version.

Rows as tests/test_torch_cuda.py's random f32 tests at 256 values a row
make them (uniform 0..400, B's first quarter planted near A's, seeded
numpy), at a few tile edges and at the store's shape. For each it prints
the largest difference of the row and column values of the wgmma body
("wg", what K3 runs) and of the mma.sync body ("mma", its yardstick)
from knn_wide_plain's, as a share of 2^-20 (max |a|^2 + max |b|^2), and
how far the column minima of each, and of the plain version, lie from
the f64 truth. Needs a card:

    python3 scripts_torch/f32_256_errors.py
"""

import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from imageanalysis_tpu_torch.ops import knn  # noqa: E402
from imageanalysis_tpu_torch.probes import device_line, knn_stages  # noqa: E402

SHAPES = ((2, 256, 704), (2, 192, 8256), (2, 256, 4096))


def rows(rng, pairs, n_a, n_b):
    k = min(n_a, n_b) // 4
    a = rng.uniform(0, 400, (pairs, n_a, 256))
    b = rng.uniform(0, 400, (pairs, n_b, 256))
    b[:, :k] = a[:, :k] + rng.normal(0, 2, (pairs, k, 256))
    return (torch.from_numpy(x.astype(np.float32)).cuda() for x in (a, b))


def main():
    if not torch.cuda.is_available():
        sys.exit("f32_256_errors: needs a CUDA card")
    print(device_line("cuda"), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    rng = np.random.default_rng(42)
    for pairs, n_a, n_b in SHAPES:
        a, b = rows(rng, pairs, n_a, n_b)
        na2, nb2 = knn._sq_norms(a), knn._sq_norms(b)
        tol = 2.0 ** -20 * float(na2.max() + nb2.max())
        want = [knn._decode_wide(w)[0] for w in
                knn.knn_wide_plain(a, b, na2, nb2)]
        d = (na2[:, :, None].double() + nb2[:, None, :].double()
             - 2 * torch.bmm(a.double(), b.double().transpose(1, 2)))
        truth = d.min(1).values
        del d
        line = {"plain_cols_vs_f64": float(
            (want[1].double() - truth).abs().max())}
        for body in ("wg", "mma"):
            got = [knn._decode_wide(g)[0] for g in knn_stages.f32_d256_raw(
                a, b, na2, nb2, mode="wide", body=body)]
            err = [float((g - w).abs().max()) for g, w in zip(got, want)]
            line[f"{body}_vs_plain_rows"] = err[0]
            line[f"{body}_vs_plain_cols"] = err[1]
            line[f"{body}_cols_vs_f64"] = float(
                (got[1].double() - truth).abs().max())
        print(f"K3 f32 {pairs} x {n_a} x {n_b} at 256: 2^-20 of the norms "
              f"{tol:.3f}; " + ", ".join(
                  f"{k} {v:.3f} ({v / tol:.3f})" for k, v in line.items()),
              flush=True)


if __name__ == "__main__":
    main()

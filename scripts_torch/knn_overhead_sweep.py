"""Is K1 bound by per-tile overhead? Product + row min over a sweep of
block tiles, int8 and bf16. Counterpart of
scripts_dev/knn_overhead_sweep.py (P6), on the port's staged K1
(imageanalysis_tpu_torch/probes/knn_stages.py): each of the TPU script's
(ta, tb, ic) grid tiles maps to a card tile as that module's docstring
lists. --body wg (the default) sweeps the wgmma body K1 runs
(csrc/knn_wg.cuh; tiles A rows per block × BN B rows per streamed tile ×
ring stages × consumer warpgroups); --body tc the mma.sync body K1 ran
before it (csrc/knn_tc.cuh; BM × BN × ring stages); --body old the __dp4a
(int8) and FFMA (bf16) bodies K1 ran before that (csrc/knn_probe.cu; TA
× TB). "blocks" counts the card's blocks per batch.

Usage (the card by default; bench's 64 pairs × 6144 × 128):
    python scripts_torch/knn_overhead_sweep.py [--body wg|tc|old] [--pairs 64]
        [--n 6144] [--steps 16] [--device cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from imageanalysis_tpu_torch.probes import (  # noqa: E402
    device_line, knn_stages, script_inputs, time_ms)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--body", choices=("wg", "tc", "old"), default="wg")
    ap.add_argument("--pairs", type=int, default=64)
    ap.add_argument("--n", type=int, default=6144)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    i8, bf = script_inputs(args.pairs, args.n, args.device)
    print(device_line(args.device) + f"; body {args.body}")
    for dt_name, inputs in (("int8", i8), ("bf16", bf[:2])):
        if args.body == "wg":
            tiles = knn_stages.WG_TILES

            def run(tile):
                return knn_stages.wg_row_min_raw(*inputs, tile)
        elif args.body == "tc":
            tiles = knn_stages.TC_TILES

            def run(tile):
                return knn_stages.tc_row_min_raw(*inputs, tile)
        else:
            tiles = knn_stages.TILES[inputs[0].dtype]
            full = (*inputs, *bf[2:]) if dt_name == "bf16" else \
                (*inputs, None, None)

            def run(tile):
                return knn_stages.knn_probe_raw(
                    *full, stage=knn_stages.ROW_MIN, tile=tile)
        for (ta, tb, ic), tile in zip(knn_stages.P6_SWEEP, tiles):
            blocks = -(-args.n // tile[0]) * args.pairs
            ms = time_ms(lambda: run(tile), args.device, args.steps)
            name = (f"{dt_name} ta={ta} tb={tb} ic={ic} -> tile "
                    f"{'x'.join(map(str, tile))} blocks={blocks}")
            print(f"{name:56s} {ms:8.2f} ms/batch  "
                  f"{args.pairs / ms * 1e3:8.0f} pairs/s")


if __name__ == "__main__":
    main()

"""Phase 19 (a) and (d) of chip_smoke.py alone: phase 14's mission graph
(2812 cameras, 4,062,000 observations) solved by bundle.solve in f32
twice (first, warm: the yardstick), then through solve_sharded on a
LocalMesh of 4 shards of one card, over a process group of one rank on
NCCL and, where there are two cards or more, on a LocalMesh of distinct
cards (stages optimize --mesh 2 and --mesh all). Each sharded solve is
held to phase 14's checks; its wall prints beside the warm solve's.

    python3 scripts_torch/sharded_ba_cards.py

Exits nonzero if a check fails. Needs a card; (d) needs two.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402

from imageanalysis_tpu_torch.ba import bundle  # noqa: E402
from imageanalysis_tpu_torch.testing.synthetic import (  # noqa: E402
    make_ba_mission_graph)


def main():
    t0 = time.perf_counter()
    smi = cs.device_info()
    print("cards", torch.cuda.device_count(), flush=True)
    g = make_ba_mission_graph(device=torch.device("cuda"))
    p14 = {}
    for run in ("first", "warm"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        p14[run] = bundle.solve(g.cams0, g.pts0, g.obs, g.K, g.dist,
                                bundle.BAConfig(), verbose=False,
                                device="cuda")
        torch.cuda.synchronize()
        p14[f"{run}_wall"] = time.perf_counter() - t
        print(f"bundle.solve {run}: {p14[f'{run}_wall']:.3f} s, mre "
              f"{p14[run].mre:.4f}; {smi}", flush=True)
    del g
    checks = cs.run_sharded_ba(smi, p14)
    failed = [k for k, ok in checks.items() if not ok]
    print("FAILED", failed if failed else "none", flush=True)
    print(f"done in {time.perf_counter() - t0:.1f} s", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

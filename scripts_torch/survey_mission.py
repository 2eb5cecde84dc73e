"""Phase 22 of chip_smoke.py at any size: the reference's SyntheticMission
(the port's, on the card) laid out as benchmarks/mission_bench.py lays it
out, then apps/process.py's main with phase 16's arguments
(mission_bench.py:145-149), held to phase 22's checks.

    python3 scripts_torch/survey_mission.py                 # 2812 frames
    python3 scripts_torch/survey_mission.py --n-images 300
    python3 scripts_torch/survey_mission.py --project-dir DIR

By default the mission lives in a temporary directory that is removed at
the end. With --project-dir it stays in DIR (the camera's DB entry is
written anew in the temporary directory on every run): a second run
reuses the rendered frames (generate(skip_existing=True)) and resumes
process.main from the workspace's state, so generation and the pipeline
can run in two calls. At 2812 frames of 2176×1440 the mission took 2.58
GB of disk on an H100 run (JPEGs, .feat/.desc caches, models/; PERF.md).

Prints the card's name and power limit, phase 22's lines and, last, one
JSON line of the run's numbers. Exits nonzero if a check fails. Needs a
card.
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import chip_smoke as cs  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-images", type=int, default=2812)
    ap.add_argument("--project-dir", default=None,
                    help="keep the mission here and resume from it")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    smi = cs.device_info()
    cs.build()
    with tempfile.TemporaryDirectory() as root:
        proj_dir = (os.path.abspath(args.project_dir) if args.project_dir
                    else os.path.join(root, "survey"))
        _, numbers = cs.run_survey(root, smi, args.n_images, proj_dir)
    numbers["script_s"] = time.perf_counter() - t0
    print(json.dumps(numbers, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

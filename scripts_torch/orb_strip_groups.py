"""process.main --detector ORB --max-features 8000 on phase 16's mission
(chip_smoke.py's 64 frames of 2176×1440, written afresh) in the two
variants that chip_smoke.py's phase 18 (e), the smart strategy as a user
runs it, does not run: the smart strategy with the yaw-error corrections
off (every get_yaw_error read as 0), and the traditional strategy.
Prints one JSON line a run: rc, the phase 16 checks that fail, the
outcome's summary (groups, BA, cameras), the largest smart yaw errors,
and the pairs across strips (chip_smoke.cross_strip, as phase 18 (e)
prints them). Needs the card:

    python3 scripts_torch/orb_strip_groups.py
"""

import json
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from imageanalysis_tpu_torch.apps import process  # noqa: E402
from imageanalysis_tpu_torch.match import smart as smart_mod  # noqa: E402
from imageanalysis_tpu_torch.testing.synthetic import (  # noqa: E402
    CAMERA_KEY, make_mission, write_mission)


def main():
    smi = cs.device_info()
    cs.build()
    m = make_mission(strips=cs.STRIPS, per_strip=cs.PER_STRIP, size=cs.FRAME,
                     seed=0, device="cuda")
    get = smart_mod.SmartState.get_yaw_error
    with tempfile.TemporaryDirectory() as root:
        src, db = os.path.join(root, "mission"), os.path.join(root, "db")
        write_mission(src, m, db)
        base = ["--camera", CAMERA_KEY, "--camera-db", db, "--ground", "0.0",
                "--batch-size", "32", "--min-chain-len", "2", "--detector",
                "ORB", "--max-features", "8000"]
        for tag, extra, yaw_off in (
                ("smart, yaw corrections off", ["--match-strategy", "smart"],
                 True),
                ("traditional", [], False)):
            d = os.path.join(root, tag.split(",")[0] + str(int(yaw_off)))
            shutil.copytree(src, d)
            yaws = []

            def read(state, name):
                yaws.append(get(state, name))
                return 0.0 if yaw_off else yaws[-1]

            smart_mod.SmartState.get_yaw_error = read
            try:
                rc = process.main([d] + base + extra)
            finally:
                smart_mod.SmartState.get_yaw_error = get
            checks, out = cs.process_outcome(d, m, len(m.frames))
            print(json.dumps({
                "run": tag, "rc": rc,
                "failed": [k for k, ok in checks.items() if not ok],
                "summary": out["summary"],
                "yaw_errors_over_half_deg": sum(abs(v) > 0.5 for v in yaws),
                "largest_yaw_errors_deg": sorted(
                    round(abs(v), 2) for v in yaws)[-5:],
                "across_strips": cs.cross_strip(out["proj"]), "device": smi}),
                flush=True)


if __name__ == "__main__":
    main()

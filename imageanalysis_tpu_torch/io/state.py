"""Pipeline stage checkpoint flags: ``state/STEPn`` marker files.

Port of ``imageanalysis_tpu/io/state.py`` (pure Python, unchanged):
``check(step)`` is true if the marker exists and is not older than any
earlier step's marker; ``update(step)`` touches the marker.
"""

from __future__ import annotations

import os
import pathlib

STEPS = ["STEP1", "STEP2", "STEP3a", "STEP3b", "STEP3c", "STEP3d",
         "STEP4", "STEP5"]


class StateMgr:
    def __init__(self, state_dir: str):
        self.state_dir = state_dir
        os.makedirs(state_dir, exist_ok=True)

    def _path(self, step: str) -> str:
        return os.path.join(self.state_dir, step)

    def check(self, step: str) -> bool:
        p = self._path(step)
        if not os.path.exists(p):
            return False
        t = os.path.getmtime(p)
        # stale if any earlier step is newer (upstream data changed)
        if step in STEPS:
            for earlier in STEPS[: STEPS.index(step)]:
                pe = self._path(earlier)
                if os.path.exists(pe) and os.path.getmtime(pe) > t:
                    return False
        return True

    def update(self, step: str):
        pathlib.Path(self._path(step)).touch()

    def clear(self, step: str):
        p = self._path(step)
        if os.path.exists(p):
            os.remove(p)

"""K2's first body, kept as the yardstick of its register-window body.

``loop_blur_raw`` launches ``gauss_blur_loop_f32`` of
``csrc/gauss_blur.cu``: one block per 64 × 32 output tile, the tile and
its halo loaded through reflect101 by scalar loads, and each output
summing a runtime count of taps over shared memory in each pass. It
computes what ``features.sift.blur_raw`` computes, bit for bit; its plain
version is ``features.sift.blur_plain``. Time the two in turns on the same
inputs (``chip_smoke.py`` phase 3).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..features import sift

LAUNCHES = {"gauss_blur_loop_f32": 0}


def loop_blur_raw(img, taps):
    """The yardstick body on a CUDA tensor; a CPU tensor takes
    sift.blur_plain, any other device raises. Arguments and result as
    sift.blur_raw."""
    name = "loop_blur_raw"
    sift.check_blur(img, taps, name)
    if img.device.type == "cpu":
        return sift.blur_plain(img, taps)
    B, H, W = img.shape
    taps = np.ascontiguousarray(taps, dtype=np.float32)
    out = torch.empty_like(img)
    with torch.cuda.device(img.device):
        err = _build.load().gauss_blur_loop_f32(
            img.data_ptr(), out.data_ptr(), taps.ctypes.data, B, H, W,
            (len(taps) - 1) // 2,
            torch.cuda.current_stream(img.device).cuda_stream)
    _build.check(err, "gauss_blur_loop_f32")
    LAUNCHES["gauss_blur_loop_f32"] += 1
    return out

"""Time K2 (the Gaussian blur) at every blur of octaves 0 and 1 of a batch
of two 2176×1440 frames (upsampled 2×, as detect runs them), from the
package under ROOT, and print one JSON line.

Run it once per copy of the package, each in its own process, in turns
(old, new, new, old), to compare two versions of csrc/gauss_blur.cu on
one card; each copy builds its kernels into ROOT/build/:

    python3 scripts_torch/blur_versions.py [ROOT]    # default: this repo

Each blur is held bit-exact against features.sift.blur_plain first.
Times, per blur and summed: the median of 7 calls by CUDA events after a
warm-up call (what chip_smoke.py's kernels line reports as K2's ms), and
the device time of the gauss_blur_kernel launches from torch.profiler,
20 calls after a warm-up call (a call on octave 1 is tens of
microseconds, near the wrapper's own host time, which events around one
call also count). Both timers are this script's own, so any copy of the
package, an older one too, is timed the same way.
"""

import json
import os
import sys

ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else os.path.join(
    os.path.dirname(os.path.abspath(__file__)), ".."))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from imageanalysis_tpu_torch import _build  # noqa: E402
from imageanalysis_tpu_torch.features import sift  # noqa: E402

FRAME = (2176, 1440)        # (W, H), as chip_smoke.py's


def blur_configs():
    """(H, W, sigma) of every blur of octaves 0 and 1 for FRAME, upsampled:
    chip_smoke.py's phase 3 blurs, computed here from the package under
    ROOT, since chip_smoke.py imports what an older copy may not have."""
    W, H = FRAME
    k = 2.0 ** (1.0 / sift.N_SCALES)
    sigmas, prev = [], sift.SIGMA0
    for i in range(1, sift.N_SCALES + 3):
        total = sift.SIGMA0 * k ** i
        sigmas.append((total**2 - prev**2) ** 0.5)
        prev = total
    sig_init = (sift.SIGMA0**2 - 1.0) ** 0.5
    return ([(2 * H, 2 * W, s) for s in [sig_init] + sigmas]
            + [(H, W, s) for s in sigmas])


def events_ms(fn, reps=7):
    """Median milliseconds of fn() by CUDA events, after a warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, kernel, reps=20):
    """Device time per call of fn from torch.profiler: the CUDA kernels
    whose name contains kernel, summed and divided by reps (up to three
    tries: a profile now and then comes back without device events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(
                activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and kernel in e.key)
        if us > 0:
            return us / reps / 1e3
    sys.exit(f"the profiler saw no device time for {kernel}")


def main():
    if not os.path.abspath(_build.__file__).startswith(ROOT + os.sep):
        sys.exit(f"imageanalysis_tpu_torch came from {_build.__file__}, "
                 f"not {ROOT}")
    _build.load()
    gen = torch.Generator(device="cuda").manual_seed(1)
    ms, dev = [], []
    for H, W, sigma in blur_configs():
        x = torch.rand((2, H, W), generator=gen, device="cuda")
        if not torch.equal(sift._blur(x, sigma),
                           sift.blur_plain(x, sift._gauss_kernel(sigma))):
            sys.exit(f"K2 differs from blur_plain at {H}x{W} sigma {sigma}")
        ms.append(events_ms(lambda: sift._blur(x, sigma)))
        dev.append(device_ms(lambda: sift._blur(x, sigma),
                             "gauss_blur_kernel"))
    print(json.dumps({"root": ROOT, "device": torch.cuda.get_device_name(0),
                      "total_ms": sum(ms), "total_device_ms": sum(dev),
                      "ms": ms, "device_ms": dev}), flush=True)


if __name__ == "__main__":
    main()

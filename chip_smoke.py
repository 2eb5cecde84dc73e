#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (imageanalysis_tpu_torch).

    python3 chip_smoke.py          # needs one CUDA card

Phases, one printed line (or a few) each; any failure raises and exits
non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: the CUDA kernels of imageanalysis_tpu_torch/csrc into build/;
3. K2 (Gaussian blur) against blur_plain at every (H, W, taps) of octaves
   0 and 1 of a batch of two 2176×1440 frames: bit-exact, median times;
4. K1 (packed int8 2-NN) against knn_packed_plain at the store's shape
   (256 pairs × 4096) and at bench.py's (64 pairs × 6144): bit-exact;
5. bench.py's match workload (64 pairs of 6144 int8 descriptors, 1500
   planted matches each) through the port's match_pair_batch: pairs/s;
6. Step 3a's device path on a 64-frame 2176×1440 synthetic mission:
   CLAHE + SIFT detect, int8 store, work list, store matching; checks the
   matches against the planted homographies.

The line before the last is {"kernels": [...]}, with the launch counts of
phase 6; the last line is {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

if not os.path.isdir(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "imageanalysis_tpu_torch")):
    sys.exit("chip_smoke: run from a checkout of the repository; "
             "imageanalysis_tpu_torch/ is not beside this script")

from imageanalysis_tpu_torch import _build  # noqa: E402
from imageanalysis_tpu_torch.features import sift  # noqa: E402
from imageanalysis_tpu_torch.match import matcher, worklist  # noqa: E402
from imageanalysis_tpu_torch.match.store import DescriptorStore  # noqa: E402
from imageanalysis_tpu_torch.ops import knn  # noqa: E402
from imageanalysis_tpu_torch.testing.synthetic import make_mission  # noqa: E402

FRAME = (2176, 1440)        # (W, H), benchmarks/mission_bench.py
MAX_FEATURES = 4096
DETECT_BATCH = 16           # frames per detect dispatch (swept on the card, PERF.md)
STRIPS, PER_STRIP = 4, 16


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps, warmup=1):
    """Median milliseconds of fn() by CUDA events, after warm-up."""
    for _ in range(warmup):
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


def device_info():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}; nvidia-smi name, power.limit:")
    log(smi)
    return smi


def build():
    t0 = time.perf_counter()
    _build.load()
    usage = [ln.strip() for ln in _build.build_log.splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    log(f"[build] {time.perf_counter() - t0:.1f} s (nvcc "
        f"{_build.build_seconds:.1f} s) into {_build.BUILD_DIR}")
    for ln in usage:
        log(f"[build]   {ln}")


def blur_configs():
    """(H, W, sigma) of every blur of octaves 0 and 1 for FRAME, upsampled."""
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


def check_blur():
    gen = torch.Generator(device="cuda").manual_seed(1)
    ms = plain_ms = 0.0
    err = 0.0
    for H, W, sigma in blur_configs():
        x = torch.rand((2, H, W), generator=gen, device="cuda")
        taps = sift._gauss_kernel(sigma)
        got = sift._blur(x, sigma)
        want = sift.blur_plain(x, taps)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"K2 differs from blur_plain at {H}x{W} "
                                 f"taps {len(taps)}: max |diff| {e}")
        err = max(err, e)
        t_k = time_ms(lambda: sift._blur(x, sigma), 7)
        t_p = time_ms(lambda: sift.blur_plain(x, taps), 3)
        ms += t_k
        plain_ms += t_p
        log(f"[K2] B=2 {H}x{W} taps {len(taps):2d}: bit-exact; kernel "
            f"{t_k:.3f} ms, plain {t_p:.3f} ms")
    log(f"[K2] octaves 0-1 total: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def planted_descriptors(gen, pairs, n, n_planted):
    """int8 descriptor pairs (value − 128 of 0..99) whose first n_planted
    B rows are A rows plus small noise."""
    a = torch.randint(0, 100, (pairs, n, 128), generator=gen, device="cuda",
                      dtype=torch.int16)
    b = torch.randint(0, 100, (pairs, n, 128), generator=gen, device="cuda",
                      dtype=torch.int16)
    noise = torch.randint(-4, 5, (pairs, n_planted, 128), generator=gen,
                          device="cuda", dtype=torch.int16)
    b[:, :n_planted] = (a[:, :n_planted] + noise).clamp(0, 255)
    return (a - 128).to(torch.int8), (b - 128).to(torch.int8)


def check_knn():
    gen = torch.Generator(device="cuda").manual_seed(2)
    out = {}
    for name, pairs, n in (("store", 256, 4096), ("bench", 64, 6144)):
        a, b = planted_descriptors(gen, pairs, n, n // 4)
        rk, ck = knn.knn_packed_raw(a, b)
        rp, cp = knn.knn_packed_plain(a, b)
        torch.cuda.synchronize()
        err = max(int((rk.long() - rp.long()).abs().max()),
                  int((ck.long() - cp.long()).abs().max()))
        if not (torch.equal(rk, rp) and torch.equal(ck, cp)):
            bad = int((rk != rp).sum() + (ck != cp).sum())
            raise AssertionError(f"K1 differs from knn_packed_plain at "
                                 f"{pairs}x{n}: {bad} keys")
        t_k = time_ms(lambda: knn.knn_packed_raw(a, b), 5)
        t_p = time_ms(lambda: knn.knn_packed_plain(a, b), 2)
        log(f"[K1] {name} {pairs} pairs x {n}: bit-exact; kernel "
            f"{t_k:.3f} ms, plain {t_p:.3f} ms")
        out[name] = {"max_abs_err": err, "ms": t_k, "plain_ms": t_p}
    return out


def bench_workload(steps=16):
    import bench

    rng = np.random.default_rng(0)
    desc_a, desc_b, uv_a, uv_b = bench.make_pair_batch(rng, bench.BATCH)
    to8 = lambda d: (d.astype(np.int16) - 128).astype(np.int8)  # noqa: E731
    dev = torch.device("cuda")
    args = [torch.from_numpy(x).to(dev) for x in
            (to8(desc_a), to8(desc_b), uv_a, uv_b)]
    n = torch.full((bench.BATCH,), bench.N_FEAT, dtype=torch.int32,
                   device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def step():
        return matcher.match_pair_batch(*args, n, n, gen, ratio=0.75,
                                        thresh=7.9, n_hyp=512)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        _, ok = step()
    per_pair = ok.sum(1)
    lo = int(per_pair.min())
    dt = time.perf_counter() - t0
    pps = bench.BATCH * steps / dt
    log(f"[bench] {bench.BATCH} pairs x {bench.N_PAD} int8, {steps} steps: "
        f"{pps:.1f} pairs/s; matches/pair min {lo} mean "
        f"{float(per_pair.float().mean()):.1f} of {bench.PLANTED} planted")
    if lo < 0.95 * bench.PLANTED:
        raise AssertionError(f"bench workload kept {lo} < 95% of "
                             f"{bench.PLANTED} planted matches")
    return pps


def run_slice():
    dev = torch.device("cuda")
    W, H = FRAME
    t0 = time.perf_counter()
    frames, positions, H_ij = make_mission(strips=STRIPS, per_strip=PER_STRIP,
                                           size=FRAME, seed=0, device=dev)
    torch.cuda.synchronize()
    walls = {"generate": time.perf_counter() - t0}
    log(f"[slice] {len(frames)} frames {W}x{H} generated in "
        f"{walls['generate']:.2f} s")

    knn.KNN_PACKED_LAUNCHES = 0
    sift.BLUR_LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dets = []
    for s in range(0, len(frames), DETECT_BATCH):
        outs = sift.detect_dispatch(frames[s:s + DETECT_BATCH],
                                    max_features=MAX_FEATURES, equalize=True)
        dets += sift.detect_finalize_batch(outs)
    walls["detect"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    store = DescriptorStore.from_arrays([d[2] for d in dets],
                                        [d[0] for d in dets], device=dev)
    torch.cuda.synchronize()
    walls["store"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pairs = [(i, j) for _, i, j in
             worklist.build_work_list(positions, use_distance=True)]
    walls["worklist"] = time.perf_counter() - t0
    thresh = float(W) ** 0.25
    config = matcher.MatchConfig(batch_size=256, store_scan=4, n_hyp=512,
                                 ratio=0.75, min_pairs=25)
    t0 = time.perf_counter()
    result = matcher.match_pairs_store(store, pairs, config, thresh)
    walls["match"] = time.perf_counter() - t0
    launches = {"knn": knn.KNN_PACKED_LAUNCHES, "blur": sift.BLUR_LAUNCHES}
    peak = torch.cuda.max_memory_allocated()

    counts = [len(d[0]) for d in dets]
    for d in dets:
        if not all(np.isfinite(x).all() for x in d):
            raise AssertionError("detect returned non-finite values")
    n_in = n_all = 0
    kept = [len(m) for m in result.values() if len(m)]
    for (i, j), m in result.items():
        if not len(m):
            continue
        pa = dets[i][0][m[:, 0]].astype(np.float64)
        q = np.c_[pa, np.ones(len(pa))] @ H_ij(i, j).T
        err = np.linalg.norm(q[:, :2] / q[:, 2:] - dets[j][0][m[:, 1]],
                             axis=1)
        n_in += int((err < 2 * thresh).sum())
        n_all += len(m)
    along = [(s * PER_STRIP + k, s * PER_STRIP + k + 1)
             for s in range(STRIPS) for k in range(PER_STRIP - 1)]
    along_min = min(len(result.get(p, ())) for p in along)

    log(f"[slice] features/frame min {min(counts)} mean "
        f"{np.mean(counts):.0f}; {len(pairs)} pairs, {len(kept)} kept, "
        f"matches/kept pair mean {np.mean(kept):.1f}; along-track "
        f"neighbour min {along_min}; {n_in}/{n_all} matches within "
        f"{2 * thresh:.2f} px of the planted homography")
    log(f"[slice] detect {1e3 * walls['detect'] / len(frames):.1f} ms/img "
        f"(batch {DETECT_BATCH}); match {len(pairs) / walls['match']:.1f} "
        f"pairs/s; peak device memory {peak / 2**30:.2f} GiB; walls s "
        + json.dumps({k: round(v, 3) for k, v in walls.items()}))
    log(f"[slice] launches in the slice: K1 {launches['knn']}, "
        f"K2 {launches['blur']}")
    if launches["knn"] == 0 or launches["blur"] == 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    if along_min < 50:
        raise AssertionError(f"an along-track neighbour pair kept "
                             f"{along_min} < 50 matches")
    if n_in < 0.95 * n_all:
        raise AssertionError(f"only {n_in}/{n_all} matches agree with the "
                             f"planted homographies")
    return launches


def main():
    device_info()
    build()
    k2 = check_blur()
    k1 = check_knn()
    bench_workload()
    launches = run_slice()
    kernels = [
        dict(name="knn_packed_i8", route="cuda",
             source="imageanalysis_tpu_torch/csrc/knn_packed.cu",
             replaces="imageanalysis_tpu/ops/knn.py:105",
             launches=launches["knn"], **k1["store"]),
        dict(name="gauss_blur_f32", route="cuda",
             source="imageanalysis_tpu_torch/csrc/gauss_blur.cu",
             replaces="imageanalysis_tpu/features/sift_tpu.py:67",
             launches=launches["blur"], **k2),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

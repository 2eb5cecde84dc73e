#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (imageanalysis_tpu_torch).

    python3 chip_smoke.py              # needs one CUDA card
    python3 chip_smoke.py --profile    # + a torch.profiler rerun of phase 8

Phases, one printed line (or a few) each; any failure raises and exits
non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: the CUDA kernels of imageanalysis_tpu_torch/csrc into build/;
3. K2 (Gaussian blur) against blur_plain at every (H, W, taps) of octaves
   0 and 1 of a batch of two 2176×1440 frames: bit-exact, median times;
4. K1 (packed 2-NN) against knn_packed_plain: int8 at the store's shape
   (256 pairs × 4096) and at bench.py's (64 pairs × 6144); bf16, f32 and
   gated (int8 and bf16, ~half the candidates gated out) at the store's
   shape. Integer-valued descriptors throughout, so all bit-exact;
5. K3 (wide 2-NN) against knn_wide_plain at 64 pairs × 10240: int8 store
   rows cast to bf16 (bit-exact) and random f32 descriptors (indices
   equal modulo ties, values within 2⁻²⁰ of the norms);
6. bench.py's match workload (64 pairs of 6144 int8 descriptors, 1500
   planted matches each) through the port's match_pair_batch: pairs/s;
7. Step 3a's device path on a 64-frame 2176×1440 synthetic mission:
   CLAHE + SIFT detect, int8 store, work list, ungated store matching;
   checks the matches against the planted homographies;
8. the smart slice: phase 7's detections written as a project workspace,
   find_matches(strategy="smart") over the resident store (gated K1),
   then the yaw-error corrections and requalify_pairs, as apps/process.py
   runs them; checks find_matches's matches and triangulated surface,
   and reports what the corrections and requalify_pairs drop;
9. repetitive texture: a 16-frame mission over a tiled texture through
   the chunked f32 path: traditional (K1 bf16), traditional with bf16
   off (K1 f32) and smart (K1 bf16 gated) in chunks of 32 pairs, from a
   wrong SRTM ground; smart must keep at least twice the matches of
   traditional, ≥ 90% of them on the planted homographies, and every
   image must end with a triangulated surface in place of the SRTM one
   (printed beside the truth: the ungated retry's period-shifted
   matches pull some images' far off);
10. wide store: 64 images × 10240 planted int8 descriptors through
    match_pairs_store, which takes K3; ≥ 95% of the planted matches
    survive in every pair.

Every kernel counts its launches; each phase that drives a path sets the
counts to 0 first and reads them after. The line before the last is
{"kernels": [...]}, each kernel with the launches of the phase that
exercises it; the last line is {"ok": true, "device": {...}}.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if not os.path.isdir(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "imageanalysis_tpu_torch")):
    sys.exit("chip_smoke: run from a checkout of the repository; "
             "imageanalysis_tpu_torch/ is not beside this script")

from imageanalysis_tpu_torch import _build  # noqa: E402
from imageanalysis_tpu_torch.features import sift  # noqa: E402
from imageanalysis_tpu_torch.io.project import ProjectMgr  # noqa: E402
from imageanalysis_tpu_torch.match import matcher, smart, worklist  # noqa: E402
from imageanalysis_tpu_torch.match.store import DescriptorStore  # noqa: E402
from imageanalysis_tpu_torch.ops import knn  # noqa: E402
from imageanalysis_tpu_torch.testing.synthetic import (  # noqa: E402
    image_name, make_mission, write_workspace)

FRAME = (2176, 1440)        # (W, H), benchmarks/mission_bench.py
MAX_FEATURES = 4096
DETECT_BATCH = 16           # frames per detect dispatch (swept on the card, PERF.md)
STRIPS, PER_STRIP = 4, 16
# repetitive texture: 2 strips of 8 frames; the texture repeats every
# REP_PERIOD px of the frame, beyond the smart gate (0.2·diag = 522 px)
REP_STRIPS, REP_PER_STRIP, REP_PERIOD = 2, 8, 700
# pairs per batch (find_matches's chunks are 8 batches), and the SRTM
# ground the smart run starts from, metres above the true one (100 m
# below the cameras): it moves the prior of a pair 980 px apart by 109 px,
# which keeps the twins one period away outside the gate
REP_BATCH, REP_SRTM_M = 4, 10.0
WIDE_IMAGES, WIDE_N, WIDE_PLANTED = 64, 10240, 2000
STORE_SHAPE = (256, 4096)   # pairs × rows of the store's K1 batches


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


def reset_launches():
    for k in knn.LAUNCHES:
        knn.LAUNCHES[k] = 0
    sift.BLUR_LAUNCHES = 0


def read_launches():
    return dict(knn.LAUNCHES, gauss_blur_f32=sift.BLUR_LAUNCHES)


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


def compare_keys(name, raw, plain, args, reps=5, plain_reps=2):
    """Hold a kernel's raw keys bit-exact against its plain version on the
    same inputs; median times of both."""
    got = raw(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    err = max(int((g.long() - w.long()).abs().max())
              for g, w in zip(got, want))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        bad = sum(int((g != w).sum()) for g, w in zip(got, want))
        raise AssertionError(f"{name} differs from its plain version: "
                             f"{bad} keys")
    t_k = time_ms(lambda: raw(*args), reps)
    t_p = time_ms(lambda: plain(*args), plain_reps)
    return {"max_abs_err": err, "ms": t_k, "plain_ms": t_p}


def float_inputs(a, b, dtype):
    """int8 store rows → integer-valued 0..255 descriptors in the mode's
    dtype with the f32 squared norms of the unrounded values."""
    af = a.float() + 128.0
    bf = b.float() + 128.0
    return (af.to(dtype), bf.to(dtype), (af * af).sum(-1), (bf * bf).sum(-1))


def check_knn():
    """K1 in every mode; returns {mode: measurements}."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    out = {}
    for name, pairs, n in (("store", *STORE_SHAPE), ("bench", 64, 6144)):
        a, b = planted_descriptors(gen, pairs, n, n // 4)
        r = compare_keys("K1 int8", knn.knn_packed_raw, knn.knn_packed_plain,
                         (a, b))
        log(f"[K1] int8 {name} {pairs} pairs x {n}: bit-exact; kernel "
            f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms")
        out[f"i8_{name}"] = r
    pairs, n = STORE_SHAPE
    a, b = planted_descriptors(gen, pairs, n, n // 4)
    for mode, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        r = compare_keys(f"K1 {mode}", knn.knn_packed_raw,
                         knn.knn_packed_plain, float_inputs(a, b, dtype))
        log(f"[K1] {mode} {pairs} pairs x {n}: bit-exact; kernel "
            f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms")
        out[mode] = r
    # a prior that gates out about half the candidates: positions in a
    # 1000 px square, radius 400 px
    uv_a = torch.rand((pairs, n, 2), generator=gen, device="cuda") * 1000
    pred = torch.rand((pairs, n, 2), generator=gen, device="cuda") * 1000
    radius2 = 400.0 ** 2
    d = uv_a[0, :, None, :] - pred[0, None, :, :]
    frac = float(((d * d).sum(-1) > radius2).float().mean())
    for mode, args in (("gated_i8", (a, b, None, None)),
                       ("gated_bf16", float_inputs(a, b, torch.bfloat16))):
        r = compare_keys(f"K1 {mode}", knn.knn_packed_raw,
                         knn.knn_packed_plain,
                         (*args, uv_a, pred, radius2))
        log(f"[K1] {mode} {pairs} pairs x {n}, {100 * frac:.1f}% of the "
            f"candidates gated out: bit-exact; kernel {r['ms']:.3f} ms, "
            f"plain {r['plain_ms']:.3f} ms")
        out[mode] = r
    return out


def ties_only(q, cand, gi, wi, tol):
    """Where two index picks for the rows of q differ, their squared
    distances must tie within tol. Returns the number of differences."""
    bad = torch.nonzero(gi != wi)[:, 0]
    if len(bad):
        dg = ((q[bad] - cand[gi[bad].long()]) ** 2).sum(-1)
        dw = ((q[bad] - cand[wi[bad].long()]) ** 2).sum(-1)
        if float((dg - dw).abs().max()) > tol:
            raise AssertionError("K3 f32 indices differ beyond ties")
    return len(bad)


def check_wide():
    """K3 on int8 rows cast to bf16 (bit-exact) and on random f32 rows
    (indices modulo ties)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    pairs, n = WIDE_IMAGES, WIDE_N
    a, b = planted_descriptors(gen, pairs, n, n // 5)
    args = (a.bfloat16(), b.bfloat16(), knn._sq_norms(a), knn._sq_norms(b))
    r = compare_keys("K3 bf16", knn.knn_wide_raw, knn.knn_wide_plain, args,
                     reps=3, plain_reps=1)
    log(f"[K3] bf16 (int8 cast) {pairs} pairs x {n}: bit-exact; kernel "
        f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms")
    del args
    # random floats: the kernel's FMA order differs from cuBLAS's
    fa = torch.rand((8, n, 128), generator=gen, device="cuda") * 400
    fb = torch.rand((8, n, 128), generator=gen, device="cuda") * 400
    fb[:, :1000] = fa[:, :1000] + torch.randn((8, 1000, 128), generator=gen,
                                              device="cuda") * 2
    na, nb = knn._sq_norms(fa), knn._sq_norms(fb)
    got = [knn._decode_wide(k) for k in knn.knn_wide_raw(fa, fb, na, nb)]
    want = [knn._decode_wide(k) for k in knn.knn_wide_plain(fa, fb, na, nb)]
    torch.cuda.synchronize()
    atol = 2.0 ** -20 * float(na.max() + nb.max())
    err = max(float((g[0] - w[0]).abs().max()) for g, w in zip(got, want))
    if err > atol:
        raise AssertionError(f"K3 f32 values differ by {err} > {atol}")
    n_diff = 0
    for p in range(8):
        # rows: both picks of each A row among B's; columns: A's pick
        for c in (0, 1):
            n_diff += ties_only(fa[p], fb[p], got[0][1][p][:, c],
                                want[0][1][p][:, c], 2 * atol)
        n_diff += ties_only(fb[p], fa[p], got[1][1][p], want[1][1][p],
                            2 * atol)
    log(f"[K3] f32 random 8 pairs x {n}: values within {err:.3g} "
        f"(bound {atol:.3g}); {n_diff} indices differ, all on ties")
    r["f32_max_abs_err"] = err
    return r


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


def planted_agreement(result, kps, H_ij, thresh):
    """(matches within 2·thresh px of the planted homography, all
    matches) over {(i, j): (n, 2) rows} and per-image keypoints."""
    n_in = n_all = 0
    for (i, j), m in result.items():
        if not len(m):
            continue
        pa = kps[i][m[:, 0]].astype(np.float64)
        q = np.c_[pa, np.ones(len(pa))] @ H_ij(i, j).T
        err = np.linalg.norm(q[:, :2] / q[:, 2:] - kps[j][m[:, 1]], axis=1)
        n_in += int((err < 2 * thresh).sum())
        n_all += len(m)
    return n_in, n_all


def project_matches(proj, pairs):
    """{(i, j): (n, 2)} from a workspace's match lists."""
    il = proj.image_list
    return {(i, j): np.asarray(il[i].match_list.get(il[j].name, []),
                               np.int64).reshape(-1, 2) for i, j in pairs}


def detect(frames):
    dets = []
    for s in range(0, len(frames), DETECT_BATCH):
        outs = sift.detect_dispatch(frames[s:s + DETECT_BATCH],
                                    max_features=MAX_FEATURES, equalize=True)
        dets += sift.detect_finalize_batch(outs)
    return dets


def run_slice():
    dev = torch.device("cuda")
    W, H = FRAME
    t0 = time.perf_counter()
    m = make_mission(strips=STRIPS, per_strip=PER_STRIP, size=FRAME, seed=0,
                     device=dev)
    torch.cuda.synchronize()
    walls = {"generate": time.perf_counter() - t0}
    log(f"[slice] {len(m.frames)} frames {W}x{H} generated in "
        f"{walls['generate']:.2f} s")

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dets = detect(m.frames)
    walls["detect"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    store = DescriptorStore.from_arrays([d[2] for d in dets],
                                        [d[0] for d in dets], device=dev)
    torch.cuda.synchronize()
    walls["store"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pairs = [(i, j) for _, i, j in
             worklist.build_work_list(m.ned, use_distance=True)]
    walls["worklist"] = time.perf_counter() - t0
    thresh = float(W) ** 0.25
    config = matcher.MatchConfig(batch_size=256, store_scan=4, n_hyp=512,
                                 ratio=0.75, min_pairs=25)
    t0 = time.perf_counter()
    result = matcher.match_pairs_store(store, pairs, config, thresh)
    walls["match"] = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()

    counts = [len(d[0]) for d in dets]
    for d in dets:
        if not all(np.isfinite(x).all() for x in d):
            raise AssertionError("detect returned non-finite values")
    kept = [len(r) for r in result.values() if len(r)]
    n_in, n_all = planted_agreement(result, [d[0] for d in dets], m.H_ij,
                                    thresh)
    along = [(s * PER_STRIP + k, s * PER_STRIP + k + 1)
             for s in range(STRIPS) for k in range(PER_STRIP - 1)]
    along_min = min(len(result.get(p, ())) for p in along)

    log(f"[slice] features/frame min {min(counts)} mean "
        f"{np.mean(counts):.0f}; {len(pairs)} pairs, {len(kept)} kept, "
        f"matches/kept pair mean {np.mean(kept):.1f}; along-track "
        f"neighbour min {along_min}; {n_in}/{n_all} matches within "
        f"{2 * thresh:.2f} px of the planted homography")
    log(f"[slice] detect {1e3 * walls['detect'] / len(m.frames):.1f} ms/img "
        f"(batch {DETECT_BATCH}); match {len(pairs) / walls['match']:.1f} "
        f"pairs/s; peak device memory {peak / 2**30:.2f} GiB; walls s "
        + json.dumps({k: round(v, 3) for k, v in walls.items()}))
    log(f"[slice] launches: {launches}")
    if launches["knn_packed_i8"] == 0 or launches["gauss_blur_f32"] == 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    if along_min < 50:
        raise AssertionError(f"an along-track neighbour pair kept "
                             f"{along_min} < 50 matches")
    if n_in < 0.95 * n_all:
        raise AssertionError(f"only {n_in}/{n_all} matches agree with the "
                             f"planted homographies")
    return launches, m, dets


def profile_summary(prof, wall):
    """Device busy share of a profiled run and its kernels by time."""
    from torch.autograd import DeviceType

    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in evs) / 1e6
    log(f"[profile] device busy {busy:.3f} s of {wall:.3f} s wall "
        f"({100 * busy / wall:.1f}%)")
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:10]:
        t = e.self_device_time_total / 1e6
        log(f"[profile]   {1e3 * t:9.3f} ms {100 * t / wall:5.1f}% of wall "
            f"x{e.count:<5d} {e.key[:90]}")


def run_smart_slice(m, dets, root, profile=False):
    """Phase 7's detections as a workspace; Step 3a's smart matching stage
    over it as apps/process.py runs it: find_matches, then the yaw-error
    corrections and requalify_pairs. find_matches's output is checked
    against the planted homographies and the true ground; what the
    corrections and requalify_pairs then drop is reported. profile=True
    runs find_matches once more on a fresh copy under torch.profiler."""
    W, _ = FRAME
    t0 = time.perf_counter()
    proj = write_workspace(os.path.join(root, "smart"), m, dets)
    walls = {"workspace": time.perf_counter() - t0}
    state = smart.SmartState(proj.analysis_dir)
    config = matcher.MatchConfig(strategy="smart")
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    matcher.find_matches(proj, config, smart_state=state, device="cuda")
    torch.cuda.synchronize()
    walls["find_matches"] = time.perf_counter() - t0
    launches = read_launches()

    pairs = [(i, j) for _, i, j in worklist.build_work_list(m.ned)]
    thresh = float(W) ** 0.25
    along = [(s * PER_STRIP + k, s * PER_STRIP + k + 1)
             for s in range(STRIPS) for k in range(PER_STRIP - 1)]
    result = project_matches(proj, pairs)
    n_in, n_all = planted_agreement(result, [d[0] for d in dets], m.H_ij,
                                    thresh)
    along_min = min(len(result[p]) for p in along)
    surf = [state.data[image_name(i)].get("tri_surface_m", np.inf)
            for i in range(len(dets))]
    yaw = [state.get_yaw_error(image_name(i)) for i in range(len(dets))]
    log(f"[smart] {len(pairs)} pairs in {walls['find_matches']:.3f} s = "
        f"{len(pairs) / walls['find_matches']:.1f} pairs/s (store, gated); "
        f"{sum(bool(len(r)) for r in result.values())} kept, along-track "
        f"min {along_min}; {n_in}/{n_all} matches within {2 * thresh:.2f} px "
        f"of the planted homography; tri_surface_m min {min(surf)} max "
        f"{max(surf)} (truth 0); |yaw_error| max "
        f"{max(abs(y) for y in yaw):.1f} deg")
    log(f"[smart] launches: {launches}")

    t0 = time.perf_counter()
    body2cam = proj.get_body2cam()
    n_fix = 0
    for im in proj.image_list:
        err = state.get_yaw_error(im.name)
        if abs(err) > 0.5:
            im.set_aircraft_yaw_error_estimate(err, body2cam)
            im.save_meta()
            n_fix += 1
    n_drop = smart.requalify_pairs(proj, state, device="cuda")
    walls["requalify"] = time.perf_counter() - t0
    after = project_matches(proj, pairs)
    log(f"[smart] {n_fix} yaw errors applied, then {n_drop} pairs dropped "
        f"by requalify_pairs; along-track min after "
        f"{min(len(after[p]) for p in along)}; walls s "
        + json.dumps({k: round(v, 3) for k, v in walls.items()}))
    if launches["knn_packed_gated"] == 0:
        raise AssertionError(f"the gated K1 never launched: {launches}")
    if along_min < 50:
        raise AssertionError(f"smart: an along-track neighbour kept "
                             f"{along_min} < 50 matches")
    if n_in < 0.95 * n_all:
        raise AssertionError(f"smart: only {n_in}/{n_all} matches agree "
                             "with the planted homographies")
    if max(abs(s) for s in surf) > 2.0:
        raise AssertionError(f"smart: tri_surface_m off the ground: {surf}")

    if profile:
        from torch.profiler import ProfilerActivity
        proj = write_workspace(os.path.join(root, "smart_profiled"), m, dets)
        state = smart.SmartState(proj.analysis_dir)
        with torch.profiler.profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            matcher.find_matches(proj, config, smart_state=state,
                                 device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        profile_summary(prof, wall)
    return launches


def run_repetitive(root):
    """A tiled texture through the chunked f32 path (under 64 images):
    traditional, traditional with bf16 off, smart. Batches of REP_BATCH
    pairs make find_matches's chunks 8·REP_BATCH pairs wide, so the smart
    run takes several chunks, each gated by the surface the chunks before
    it triangulated. It starts from an SRTM ground REP_SRTM_M above the
    true one, which a triangulated surface must replace on every
    image."""
    W, _ = FRAME
    m = make_mission(strips=REP_STRIPS, per_strip=REP_PER_STRIP, size=FRAME,
                     strip_gap=1.5, seed=4, device="cuda",
                     texture_period=REP_PERIOD)
    dets = detect(m.frames)
    template = os.path.join(root, "rep")
    write_workspace(template, m, dets)
    thresh = float(W) ** 0.25
    n = len(dets)
    pairs = [(i, j) for _, i, j in worklist.build_work_list(m.ned)]
    chunks = -(-len(pairs) // (8 * REP_BATCH))
    reset_launches()
    out = {}
    for name, kw in (("traditional", {}),
                     ("traditional_f32", {"bf16": False}),
                     ("smart", {"strategy": "smart"})):
        ws = os.path.join(root, "rep_" + name)
        shutil.copytree(template, ws)
        proj = ProjectMgr(ws)
        proj.load_images_info()
        state = smart.SmartState(proj.analysis_dir)
        for im in proj.image_list:
            state.node(im.name)["srtm_surface_m"] = REP_SRTM_M
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        matcher.find_matches(proj,
                             matcher.MatchConfig(batch_size=REP_BATCH, **kw),
                             smart_state=state, device="cuda")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        result = project_matches(proj, pairs)
        n_in, n_all = planted_agreement(result, [d[0] for d in dets], m.H_ij,
                                        thresh)
        out[name] = (n_in, n_all)
        log(f"[repetitive] {name}: {n_all} matches, {n_in} within "
            f"{2 * thresh:.2f} px of the planted homography; {len(pairs)} "
            f"pairs in {chunks} chunks in {dt:.3f} s")
    # proj and state are the smart run's, the last
    surf = [state.data[im.name].get("tri_surface_m", np.inf)
            for im in proj.image_list]
    launches = read_launches()
    log(f"[repetitive] {n} frames, texture period {REP_PERIOD} px, features "
        f"mean {np.mean([len(d[0]) for d in dets]):.0f}; smart from SRTM "
        f"{REP_SRTM_M} m: tri_surface_m {surf} (truth 0; "
        f"{sum(abs(s) <= 2.0 for s in surf)} images within 2 m); launches: "
        f"{launches}")
    (s_in, s_all), (_, t_all) = out["smart"], out["traditional"]
    for key in ("knn_packed_bf16", "knn_packed_f32", "knn_packed_gated"):
        if launches[key] == 0:
            raise AssertionError(f"{key} never launched: {launches}")
    if chunks < 2:
        raise AssertionError(f"smart ran {chunks} chunk: no prior update "
                             "fed a later gate")
    if s_all < 2 * t_all:
        raise AssertionError(f"smart kept {s_all} matches, not twice "
                             f"traditional's {t_all}")
    if s_in < 0.9 * s_all:
        raise AssertionError(f"smart: only {s_in}/{s_all} matches agree "
                             "with the planted homographies")
    if not np.isfinite(surf).all():
        raise AssertionError(f"smart: an image kept the SRTM prior of "
                             f"{REP_SRTM_M} m: {surf}")
    return launches


def run_wide_store():
    """64 images of 10240 int8 rows, npad 10240 > 8192: match_pairs_store
    takes K3. Image k's first WIDE_PLANTED rows are image k−1's next
    WIDE_PLANTED rows plus noise, at positions moved by a homography."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    n_img, n, P = WIDE_IMAGES, WIDE_N, WIDE_PLANTED
    base = torch.randint(0, 100, (n_img, n, 128), generator=gen, device=dev,
                         dtype=torch.int16)
    uv = torch.rand((n_img, n, 2), generator=gen, device=dev) * 4000
    for k in range(1, n_img):
        noise = torch.randint(-4, 5, (P, 128), generator=gen, device=dev,
                              dtype=torch.int16)
        base[k, :P] = (base[k - 1, P:2 * P] + noise).clamp(0, 255)
        uv[k, :P] = uv[k - 1, P:2 * P] * torch.tensor([1.02, 0.98],
                                                      device=dev) \
            + torch.tensor([25.0, -40.0], device=dev)
    store = DescriptorStore((base - 128).to(torch.int8), uv,
                            torch.full((n_img,), n, dtype=torch.int32))
    del base
    pairs = [(k - 1, k) for k in range(1, n_img)]
    config = matcher.MatchConfig(n_hyp=512, store_scan=1)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = matcher.match_pairs_store(store, pairs, config, thresh=7.9)
    dt = time.perf_counter() - t0
    launches = read_launches()
    kept = []
    for i, j in pairs:
        m = result[(i, j)]
        kept.append(int(((m[:, 0] >= P) & (m[:, 0] < 2 * P)
                         & (m[:, 1] == m[:, 0] - P)).sum()))
    log(f"[wide] {n_img} images x {n} int8 (npad {store.npad}), "
        f"{len(pairs)} pairs in {dt:.3f} s = {len(pairs) / dt:.1f} pairs/s; "
        f"planted kept min {min(kept)} mean {np.mean(kept):.1f} of {P}; "
        f"launches: {launches}")
    if launches["knn_wide"] == 0:
        raise AssertionError(f"K3 never launched: {launches}")
    if min(kept) < 0.95 * P:
        raise AssertionError(f"wide store kept {min(kept)} < 95% of {P} "
                             "planted matches")
    return launches


def main():
    profile = "--profile" in sys.argv[1:]
    device_info()
    build()
    k2 = check_blur()
    k1 = check_knn()
    k3 = check_wide()
    bench_workload()
    slice_launches, m, dets = run_slice()
    with tempfile.TemporaryDirectory() as root:
        smart_launches = run_smart_slice(m, dets, root, profile)
        del m
        rep_launches = run_repetitive(root)
    wide_launches = run_wide_store()

    def entry(name, source, replaces, launches, r):
        return dict(name=name, route="cuda",
                    source=f"imageanalysis_tpu_torch/csrc/{source}",
                    replaces=replaces, launches=launches,
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"])

    k1_src = "imageanalysis_tpu/ops/knn.py:105"
    kernels = [
        entry("knn_packed_i8", "knn_packed.cu", k1_src,
              slice_launches["knn_packed_i8"], k1["i8_store"]),
        entry("knn_packed_gated", "knn_packed.cu", k1_src,
              smart_launches["knn_packed_gated"], k1["gated_i8"]),
        entry("knn_packed_bf16", "knn_packed.cu", k1_src,
              rep_launches["knn_packed_bf16"], k1["bf16"]),
        entry("knn_packed_f32", "knn_packed.cu", k1_src,
              rep_launches["knn_packed_f32"], k1["f32"]),
        entry("knn_wide", "knn_wide.cu", "imageanalysis_tpu/ops/knn.py:407",
              wide_launches["knn_wide"], k3),
        entry("gauss_blur_f32", "gauss_blur.cu",
              "imageanalysis_tpu/features/sift_tpu.py:67",
              slice_launches["gauss_blur_f32"], k2),
    ]
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched on its path")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (imageanalysis_tpu_torch).

    python3 chip_smoke.py              # needs one CUDA card
    python3 chip_smoke.py --profile    # + torch.profiler reruns of phases 7
                                       #   (one detect batch), 8 and 13

Phase 21 alone: a script that imports chip_smoke and calls
``device_info()``, ``build()`` and ``run_tools(root, smi)``; phase 22
likewise with ``run_survey(root, smi)``.

Phases, one printed line (or a few) each; any failure raises and exits
non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: the CUDA kernels of imageanalysis_tpu_torch/csrc into build/;
3. K2 (Gaussian blur) against blur_plain at every (H, W, taps) of octaves
   0 and 1 of a batch of two 2176×1440 frames: bit-exact, median times,
   in turns against its first body (probes.blur.loop_blur_raw, whose
   output must equal K2's);
4. K1 (packed 2-NN) against knn_packed_plain: int8 and bf16 at the
   store's shape (256 pairs × 4096) and at bench.py's (64 pairs × 6144);
   f32 and gated (int8, bf16 and f32, ~half the candidates gated out) at
   the store's shape. Integer-valued descriptors throughout (int8 over
   the full −128..127 at both shapes too), so all bit-exact; f32 also on
   rows of 256..360 (mid planes set, bit-exact) and random rows (within
   2⁻²⁰ of the norms plus one key step, indices equal modulo ties). Every
   mode runs the wgmma body (f32 as three bf16 planes; the body each ran,
   by the profiler's kernels, in the kernels line); each is timed in
   turns against the mma.sync body it replaced, and both bodies split
   into their product (their product-only stage, held against its plain
   version) and the key epilogue (the rest); each mode beside one library
   product of its type (torch._int_mm, torch.bmm); at 256 values a row
   (ORB's bits, −128/−127 in the store, and the full −128..127): int8 at
   both shapes, gated int8 and bf16 plain and gated at bench.py's, f32
   plain and gated at the store's, each bit-exact, on the wgmma body
   timed in turns with the mma.sync body it replaced and split into
   product and key epilogue, beside its bound and one library product;
5. K3 (wide 2-NN) against knn_wide_plain at 64 pairs × 10240, both
   modes on the tensor-core body (f32 as three bf16 planes): int8 store
   rows cast to bf16 and to f32 (bit-exact; each in turns against the
   FFMA body it replaced, split into the body's product and the key
   epilogue, beside torch.bmm of its type), f32 rows of 256..360 (mid
   planes set, bit-exact), and random descriptors (indices equal modulo
   ties; values within 2⁻²⁰ of the norms in f32, TC_REL_TOL in bf16);
   both modes at 256 values a row too (bit-exact on ORB's bits and the
   full range, timed beside the bound and torch.bmm);
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
    match_pairs_store, which takes K3 bf16; then the same rows as f32
    through match_pair_batch(bf16=False) in chunks of 8 pairs, which
    takes K3 f32; ≥ 95% of the planted matches survive in every pair on
    both paths, and K3 f32's keys on those rows equal K3 bf16's;
11. K4 (match epilogue) against match_epilogue_plain on K1's raw keys of
    planted int8 rows: bench.py's 64 pairs × 6144, the store's 256 ×
    4096, ungated and gated; best_j, ok and pb bit-exact;
12. the fused arm (IMGTPU_FUSED_EPILOGUE=1: K1, then K4): phase 6's
    workload through match_pair_batch, its matches equal to the unfused
    arm's, pairs/s beside phase 6's; find_matches(strategy="smart") on a
    fresh copy of phase 8's workspace, its match lists equal to phase 8's
    pair by pair;
13. Steps 3b–4 on phase 8's workspace, after its yaw corrections and
    requalify_pairs, as apps/process.py runs them: link_matches,
    triangulate_ground (the smart surface, else the flat ground),
    groups, setup_from_matches, bundle.solve, refit, write_back and the
    re-triangulation of stale chains; the poses against the mission's
    truth, the points against the ground (0 m);
14. mission-scale BA: the 2812-camera, 4,062,000-observation graph of
    scripts_dev/ba_synth_scale.py (testing/synthetic.py, on the card),
    bundle.solve twice (10 iterations), then f32 against f64 on the
    300-camera graph of scripts_dev/ba_f64_oracle.py;
15. K1 and K4 anatomy: the probes P1–P6 (imageanalysis_tpu_torch/probes)
    at their TPU probes' full shapes on bench.py's batch: every stage and
    tile of the staged K1 (P3, P4, P6; int8 and bf16, on the __dp4a and
    FFMA bodies) and P3's and P4's stages on the tensor-core body
    (tc_stage, tc_row_sum) against their plain versions on 2 of the 64
    pairs and the full stages against K1 on all 64; P4 and P3 on the
    tensor-core body, each stage or variant in turns with the old
    bodies', and both bodies' stage splits; P6's sweep on the wgmma
    body K1 runs (seven tiles a dtype: B tiles of 64, 128 and 256 rows,
    one and two m64 halves a warpgroup; each bit-exact on all 64 pairs,
    as is each tile of the mma.sync body's sweep, timed in turns with the
    mma.sync body's mapped tile, with blocks an SM and ptxas's registers
    and spills; both bodies at their K1 tiles); P5's wgmma product + row
    sum fed by TMA (bit-exact on integer values at every K, tile and
    split, within P5_REL_TOL on normal ones; its K and tile sweeps, each
    tile's plan, registers and spills; in turns with its mma.sync first
    body by device time) beside torch.bmm and torch._int_mm; P1's
    one-hot gather in one launch and
    its first body (both bit-exact with the bf16 plain version, per-limb
    errors against f32; in turns, kernel and whole-call device time and
    CUDA events, beside index_select); P2's single-launch K1 + K4 on the
    wgmma body K1 int8 runs, on the mma.sync body and on the __dp4a first
    body, each against knn_match_fused on all 64 pairs, every variant on
    the wgmma body in turns with the mma.sync body's and full also with
    K1 then K4 (device time of a call and CUDA events; the kernels each
    ran; registers, spills, ptxas notes and blocks an SM); the SASS of
    the wgmma body's production instantiations against the digests
    recorded before the probes' tiles joined it. Each probe is driven on
    its own, its counts set to 0 before and read after.
16. Steps 1→5 from JPEGs: the 64-frame mission of phases 7–8 written as a
    project folder (testing/synthetic.write_mission: JPEGs encoded by
    nvJPEG, pix4d.csv, the camera's DB entry), then
    imageanalysis_tpu_torch.apps.process.main with
    benchmarks/mission_bench.py's arguments; checks that STEP5 is
    reached, every frame has features at 2176×1440, group 0 holds ≥ 90%
    of the frames, BA's mre ≤ 1 px, the cameras lie within
    tests/test_e2e_pipeline.py's 3 m of the truth and the median point
    within phase 13's 1 m of the ground, models/ holds every render
    output and 64 512×512 textures that nvJPEG reads back, K1 int8 and
    K2 launched inside the run, neither PIL nor cv2 was imported, and a
    second main skips every stage.
    One line: the stage walls, nvJPEG's decode (gray, full size) and
    encode ms per frame, the card's name and power limit.
17. the rest of the user's command, on phase 16's mission: (a) the
    frames tagged with EXIF and DJI XMP (write_mission(exif=True)), the
    camera in the DB and no pose file, then process.main without
    --camera, with --geotiff and --histogram: Step 1 finds the camera by
    EXIF, pix4d.csv lies within its rounding of the truth, phase 16's
    checks hold, mosaic.tif, gdalscript.sh and a histogram template for
    every frame are written, K1 int8 and K2 launch inside the run; then
    Steps 1–2 again with the camera absent from the DB (fx from EXIF
    within 0.1%); (b) the card's composite against the same code on the
    CPU from the same card-decoded frames (within one level on ≥ 99.9% of
    the covered pixels), its wall and ms a frame, build_histograms' wall;
    (c) --refresh STEP4 --cam-calibration from a focal length 3% low: f
    moves ≥ 25% of the way back, k1 within 0.01 of 0, mre ≤ 1 px; (d)
    the fundamental and essential filters at bench's batch on a
    non-planar scene (≥ 90% of the planted matches kept, ≤ 5 others
    passed, in every pair; ms a batch beside homography's; the batched
    3×3 torch.linalg.svd), then find_matches with the host essential5
    refilter (every along-track neighbour keeps ≥ 50 matches). Neither
    PIL nor cv2 is imported. One line a part, with the card's name and
    power limit.
18. the stage scripts and the host detectors (after phase 17: it imports
    cv2), on phase 16's mission written afresh: (a) the reference's
    numbered workflow as CLI calls (apps/stages.py and apps/cull.py) with
    --detector TPU and phase 16's arguments: create-project, set-camera,
    set-poses, matching, clean, triangulate, groups, optimize, cull mre,
    optimize --refine, render; phase 16's checks of the outcome, the
    cameras after the first optimize within 0.05 m of phase 16's, K1 int8
    and K2 launched; each stage's wall and the cull's count; (b) matching
    --detector SIFT and ORB at the reference's defaults (scale 0.4, ORB's
    10,000 features), each on a fresh copy: every along-track neighbour
    keeps ≥ 50 matches, ≥ 95% of them on the planted homographies; ORB
    runs K1 and K3 at 256 values a row (a second ORB run at another
    setting where the defaults reach only one of them; one on a strip of
    16 frames, the chunked path's K1 bf16 at 256); the host
    detector's ms a frame; (c) process.main with no --detector flag (the
    host SIFT at scale 0.4) and phase 16's other arguments: at phase 16's
    4096 features a frame phase 16's checks; at every feature (~20,000 a
    frame, the reference's default) the same but the cameras' 3 m, which
    is printed (stray matches of low-overlap pairs linked into chains
    pull BA's cameras up to ~4 m there, as the reference's BA does on the
    same chains: ROADMAP.md queue 3); (d) the store path in float32 with
    bf16 off on (b)'s ORB workspaces, its match lists equal int8's; (e)
    process.main with (c)'s arguments and --detector ORB --max-features
    8000 --match-strategy smart: phase 16's checks but group 0's share
    and the eggs' and textures' counts, which are printed (these ORB
    settings match no pair across strips 0 and 1, so the groups split 48
    / 16: ROADMAP.md queue 3), the smart gate's K1 at 256 values a row
    launched on the int8 store only, and the run's first and last int8
    K1 calls at 256 (gated and not) held bit-exact against the plain
    version on their own inputs and timed beside their bound. One line a
    part, with the card's name and power limit.
19. the pipeline across processes (imageanalysis_tpu_torch/parallel):
    (a) phase 14's mission graph through parallel/sharded.solve_sharded
    (the point-local sharded BA, BAConfig()) on a LocalMesh of 4 shards
    of the card and over a process group of one rank on NCCL, each held
    to phase 14's checks and its mre within 2% of phase 14's f32
    bundle.solve; walls and collectives per LM iteration (count, bytes)
    beside phase 14's warm solve; (b) two ranks sharing the card
    (subprocesses of this script, gloo by the backend rule, MASTER_ADDR
    127.0.0.1, a free port, WORLD_SIZE 2) run apps/process.py with
    phase 16's arguments (but --batch-size 16: the ranks share the card's
    memory) and --match-strategy smart on phase 16's mission written
    afresh: phase 16's checks of the outcome, every image's match
    lists equal to a one-process run's of the same command, smart.json's
    yaw pairs equal to its (every rank's evidence merged), K1 int8 (plain
    or gated) and K2 launched in each rank, models/ the same files with
    each egg written once; each stage's wall per rank beside the
    one-process run's, the backend each rank used; then stages optimize
    --refine on the same two ranks, cameras within 0.05 m of the
    one-process optimize --refine; (c) where the machine has two cards or
    more, (b) again with one card a rank over NCCL, and (d) (a)'s mission
    graph on a LocalMesh of distinct cards (2, and all of them), held to
    (a)'s checks, its wall beside phase 14's. Each child has a timeout;
    one that fails or times out fails the phase.
20. the video and motion tools (imageanalysis_tpu_torch/video, motion,
    apps/video.py; after phase 19: it imports cv2) on movies made from a
    seed (testing/video.py): a 1920×1080, 30 fps, 300-frame mp4v movie of
    a ground turning about the optical axis at a planted band-limited
    rate and drifting, its flight log 2.5 s ahead, a DJI CSV and .SRT,
    and a 120-frame still movie with a block crossing it. Through
    apps/video.main on the card: (a) est-gyro-rates, the median rate
    within 1.5 deg/s of the planted one; (b) hud-overlay --movie-csv in
    both styles, 90 frames each, the correlated shift within 2/60 s; (c)
    stabilize, every frame written, rotation jitter below the input's;
    (d) extract-geotag and extract-dji from the .SRT's start, the GPS
    read back through io/exif within the writer's rounding. Then (e)
    segment_video at scale 0.5, the mover's mask IoU >= 0.5; (f)
    StreamingDMD on the same snapshots, its lasting eigenvalues (|λ| >
    0.9) within 1e-3 of exact DMD's at full rank; (g) SparseLK over 30
    frames within 0.5 px of the planted motion; (h) the lens fit on
    tracks through k1 = −0.22, k1 within 0.05. The batched fits, the
    FFT, the snapshots' singular values and the lens loss and gradient
    are each held against the same code on the CPU. One line a part:
    walls, the host tracking's ms a frame beside the card's fit of all
    pairs, the SVD's time, with the card's name and power limit. The
    phase launches no hand-written kernel.
21. the store's modes and the tools that come after a run (after phase
    20: it imports cv2), on phase 16's mission written with EXIF and XMP
    as in phase 17a, after process.main with --histogram: (a) its
    workspace through BatchMatcher's store path on phases 7-8's work
    list in each store mode (traditional: int8, uint8 (K1 bf16), float32
    with bf16 (K1 bf16) and without (K1 f32); smart: int8 and uint8,
    gated K1): every mode's match lists equal int8's pair by pair on the
    detector's integer descriptors, each mode's K1 launched, each mode's
    walls; then the same descriptors plus seeded uniform noise in
    [-0.5, 0.5) in a float32 store: K1 f32 and bf16 on one store batch
    against knn_packed_plain (indices equal modulo ties, values within
    2^-20 of the norms in f32 and TC_REL_TOL in bf16), and the store path
    on the card against the same code on the CPU on 48 pairs (>= 99% of
    the matches equal, the share printed); (b) apps/inspect.py (features,
    pair, groups, matches; review --keys in both modes on a copy: the
    dropped items' .match entries emptied, the rest untouched),
    apps/utils.py (histogram rebuilds the run's tables; import-annotations
    of 8 planted ground points, then preview-crops: each point inside its
    crop; est-cam-transform's rows finite; capture-dates the EXIF times
    written; wx-report the mean of the first and last frames' GPS within
    1e-6 deg and no weather lookup; trim-far lists every frame and deletes
    nothing; vignette, zip, new-camera (K within 1% of the DB's);
    calibrate on 8 seeded chessboard views at 2176x1440, fx within 1%;
    plot-matches), apps/zooniverse.py (chop at 512/64: 20 tiles a frame;
    paste of marks at the planted points' pixels: each within 0.5 m of
    its point), apps/explorer.py (select_top at the centre covers it and
    coverage.images_covering_point includes it; _warp_full on the card
    against the same call on the CPU through the card's texture, <= 0.1%
    of pixels differing, the extent equal; get_elevation within 1 m of 0;
    render_to draws >= 63 models into a PNG > 20 kB; the annotations'
    round trip and the KML hull of the cameras). Without matplotlib on
    the machine it prints so and skips render_to and plot-matches. One
    line a part: walls, the card's ms for paste's rays, preview-crops'
    projection and _warp_full beside its host share, with the card's name
    and power limit.
22. the survey-scale mission (run right after phase 16, before the
    phases that import cv2): the reference's SyntheticMission (the
    port's, testing/synthetic.py) renders 300 frames of 2176×1440 in
    world tiles on the card, laid out as benchmarks/mission_bench.py lays
    them out (12 rows of 25, seed 42), each warped and written by nvJPEG
    as it is made; then apps/process.py's main with phase 16's arguments
    and a second main that must skip every stage. Phase 16's checks
    (STEP5, group 0 >= 90%, the last mre <= 1 px, cameras within 3 m of
    true_camera_ned, the median point within 1 m, every models/ output,
    K1 int8 and K2 launched, neither cv2 nor PIL imported). Lines: the
    generator's wall, ms a frame and bytes on disk; the stage walls; the
    pairs attempted and kept beside the JAX package's 7,549 and 1,873 on
    the same mission; BA's iterations and mre; the cameras' mean and max
    error; peak card memory; the launches.
    scripts_torch/survey_mission.py runs it at any size (2812 frames by
    default).

Each phase prints its wall on a line of its own ("[wall] phase ..."), and
the run its total before the kernels line.

Every kernel counts its launches; each phase that drives a path sets the
counts to 0 first and reads them after. The line before the last is
{"kernels": [...]}, each kernel with the launches of the phase that
exercises it, its times, its bound (the larger of bytes over 3.35 TB/s
and operations over the H100's peak for their type) and, where one
PyTorch call computes the same function, that call's time; the last line
is {"ok": true, "device": {...}}.
"""

import collections
import contextlib
import csv
import glob
import inspect
import io
import json
import math
import os
import re
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
from imageanalysis_tpu_torch.apps import cull, process, stages  # noqa: E402
from imageanalysis_tpu_torch.ba import bundle  # noqa: E402
from imageanalysis_tpu_torch.ba import setup as ba_setup  # noqa: E402
from imageanalysis_tpu_torch.core import geodesy  # noqa: E402
from imageanalysis_tpu_torch.core.rotations import quat_multiply  # noqa: E402
from imageanalysis_tpu_torch.features import sift  # noqa: E402
from imageanalysis_tpu_torch.io import camera_db, jpeg  # noqa: E402
from imageanalysis_tpu_torch.io.project import ProjectMgr  # noqa: E402
from imageanalysis_tpu_torch.io.state import StateMgr  # noqa: E402
from imageanalysis_tpu_torch.match import (  # noqa: E402
    cleanup, groups, matcher, smart, worklist)
from imageanalysis_tpu_torch.match.store import DescriptorStore  # noqa: E402
from imageanalysis_tpu_torch.ops import knn  # noqa: E402
from imageanalysis_tpu_torch.parallel import multihost, sharded  # noqa: E402
from imageanalysis_tpu_torch import probes  # noqa: E402
from imageanalysis_tpu_torch.probes import device_ms  # noqa: E402
from imageanalysis_tpu_torch.render import (  # noqa: E402
    geotiff, histogram, texture)
from imageanalysis_tpu_torch.probes import (  # noqa: E402
    blur, fused, knn_stages, mma)
from imageanalysis_tpu_torch.testing.synthetic import (  # noqa: E402
    CAMERA_KEY, REF_LLA, SyntheticMission, camera_config, image_name,
    make_ba_grid_graph, make_ba_mission_graph, make_mission, write_mission,
    write_workspace)

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
BENCH_SHAPE = (64, 6144)    # bench.py's pairs × rows
# the H100 SXM's device-memory rate and dense peaks (NVIDIA's data sheet,
# at the 700 W limit), for the bounds in the kernels line. "f32" counts an
# FMA as two operations; an unfused FMUL or FADD is one instruction of one
# lane: 132 SMs × 128 lanes × the 1.98 GHz boost clock
HBM_BYTES_PER_S = 3.35e12
PEAK = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12,
        "f32 unfused": 132 * 128 * 1.98e9}
GATE_FLOPS = 5              # dx, dy, dx², dy², the sum: per gated candidate
# random bf16 on the tensor cores against the plain f32 product: both dots
# within 128·2⁻²⁴ of Σ|a_k b_k| ≤ (|a|² + |b|²)/2, so d2 within this × (max
# |a|² + max |b|²)
TC_REL_TOL = 2.0 ** -16
FUSED = "IMGTPU_FUSED_EPILOGUE"


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps, warmup=1):
    """Median milliseconds of fn() by CUDA events, after warm-up."""
    return probes.time_ms(fn, "cuda", reps, warmup)


def bound(n_bytes, ops):
    """(bound_ms, bound_by): the larger of n_bytes over the memory rate and
    the operations over their peaks (ops: {peak type: count})."""
    t_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    t_ops = 1e3 * sum(n / PEAK[k] for k, n in ops.items())
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def with_bound(r, n_bytes, ops, library_ms=None):
    r["bound_ms"], r["bound_by"] = bound(n_bytes, ops)
    r["library_ms"] = library_ms
    return r


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
             if "registers" in ln or "Compiling entry" in ln
             or "spill" in ln]
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
    """K2 at every blur of octaves 0-1, in turns (new, old, new, old)
    against its first body; the library yardstick is one cuDNN conv2d
    (TF32 off, the package's setting) with the 2-D outer-product taps on
    the reflect-padded input."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(1)
    ms = plain_ms = lib_ms = bound_ms = loop_ms = dev_ms = loop_dev_ms = 0.0
    err = 0.0
    by = set()
    for H, W, sigma in blur_configs():
        x = torch.rand((2, H, W), generator=gen, device="cuda")
        taps = sift._gauss_kernel(sigma)
        got = sift._blur(x, sigma)
        want = sift.blur_plain(x, taps)
        old = blur.loop_blur_raw(x, taps)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"K2 differs from blur_plain at {H}x{W} "
                                 f"taps {len(taps)}: max |diff| {e}")
        if not torch.equal(old, got):
            raise AssertionError(f"K2's first body differs at {H}x{W} taps "
                                 f"{len(taps)}")
        err = max(err, e)
        del got, want, old
        # in turns (new, old, new, old), on two measures: the median of
        # 7 calls by CUDA events (the kernels line's ms, as PR 1-6 timed
        # K2) and the profiler's device time, since a call on octave 1 is
        # tens of microseconds, near the wrapper's own host time, which
        # events around one call also count
        t_k, t_o, d_k, d_o = [], [], [], []
        for t, d, fn, kernel in (
                (t_k, d_k, lambda: sift._blur(x, sigma), "gauss_blur_kernel"),
                (t_o, d_o, lambda: blur.loop_blur_raw(x, taps),
                 "gauss_blur_loop_kernel")) * 2:
            t.append(time_ms(fn, 7))
            d.append(device_ms(fn, kernel))
        t_p = time_ms(lambda: sift.blur_plain(x, taps), 3)
        r = len(taps) // 2
        xp = F.pad(x[:, None], (r, r, r, r), mode="reflect")
        w2 = torch.from_numpy(np.outer(taps, taps)).cuda()[None, None]
        t_l = time_ms(lambda: F.conv2d(xp, w2), 3)
        del xp
        px = 2 * H * W
        # each pass: len(taps) products and len(taps) − 1 sums per pixel,
        # each rounded on its own (no FMA)
        b, kind = bound(2 * 4 * px,
                        {"f32 unfused": 2 * (2 * len(taps) - 1) * px})
        by.add(kind)
        ms += float(np.mean(t_k))
        loop_ms += float(np.mean(t_o))
        dev_ms += float(np.mean(d_k))
        loop_dev_ms += float(np.mean(d_o))
        plain_ms += t_p
        lib_ms += t_l
        bound_ms += b
        log(f"[K2] B=2 {H}x{W} taps {len(taps):2d}: bit-exact; kernel "
            f"{t_k[0]:.3f} / {t_k[1]:.3f} ms (device {d_k[0]:.3f} / "
            f"{d_k[1]:.3f}), first body {t_o[0]:.3f} / {t_o[1]:.3f} ms "
            f"(device {d_o[0]:.3f} / {d_o[1]:.3f}) in turns, plain "
            f"{t_p:.3f} ms, conv2d {t_l:.3f} ms, bound {b:.3f} ms ({kind})")
    bound_by = "operations" if by == {"operations"} else "bytes"
    log(f"[K2] octaves 0-1 total by CUDA events: kernel {ms:.3f} ms, first "
        f"body {loop_ms:.3f} ms ({loop_ms / ms:.2f}x), plain "
        f"{plain_ms:.3f} ms, conv2d {lib_ms:.3f} ms, bound {bound_ms:.3f} "
        f"ms ({'/'.join(sorted(by))}; {100 * bound_ms / ms:.1f}% of it)")
    log(f"[K2] octaves 0-1 total by profiler device time: kernel "
        f"{dev_ms:.3f} ms, first body {loop_dev_ms:.3f} ms "
        f"({loop_dev_ms / dev_ms:.2f}x; bound {100 * bound_ms / dev_ms:.1f}% "
        f"of the kernel)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "loop_ms": loop_ms, "device_ms": dev_ms,
            "loop_device_ms": loop_dev_ms,
            "timed_by": "CUDA events, median of 7 (device_ms, "
                        "loop_device_ms: profiler device time)"}


def planted_descriptors(gen, pairs, n, n_planted):
    """int8 descriptor pairs (value − 128 of 0..99) whose first n_planted
    B rows are A rows plus small noise."""
    a = torch.randint(0, 100, (pairs, n, 128), generator=gen,
                      device=gen.device, dtype=torch.int16)
    b = torch.randint(0, 100, (pairs, n, 128), generator=gen,
                      device=gen.device, dtype=torch.int16)
    noise = torch.randint(-4, 5, (pairs, n_planted, 128), generator=gen,
                          device=gen.device, dtype=torch.int16)
    b[:, :n_planted] = (a[:, :n_planted] + noise).clamp(0, 255)
    return (a - 128).to(torch.int8), (b - 128).to(torch.int8)


def compare_keys(name, raw, plain, args, reps=5, plain_reps=2):
    """Hold a kernel's outputs bit-exact against its plain version on the
    same inputs; median times of both."""
    got = raw(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    err = max(float((g.double() - w.double()).abs().max())
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


def k1_bound(pairs, n, elem_bytes, peak, gated=False, dim=128, n_b=None):
    """K1's bound at pairs × n × n_b (n_b default n): descriptors, the
    float modes' f32 norms and the gate's positions read once, row_p (8 B
    an A row) and col_p (4 B a B row) written once; the 2·n·n_b·dim
    products at the mode's peak (f32: the six bf16 products of its
    three-plane split on the tensor cores, the work the kernel does), plus
    the gate's f32 arithmetic."""
    n_b = n if n_b is None else n_b
    row = (dim * elem_bytes + (4 if elem_bytes > 1 else 0)
           + (8 if gated else 0))
    n_bytes = pairs * (n * (row + 8) + n_b * (row + 4))
    product = 2 * pairs * n * n_b * dim
    ops = {"bf16": 6 * product} if peak == "f32" else {peak: product}
    if gated:
        ops["f32"] = ops.get("f32", 0) + GATE_FLOPS * pairs * n * n_b
    return n_bytes, ops


def product_only(name, fn):
    """Median time of one library product (the 'product only' yardstick
    beside a 2-NN kernel), or None where the call is refused."""
    try:
        t = time_ms(fn, 3)
    except RuntimeError as e:
        log(f"[{name}] product only: not measured ({str(e)[:120]})")
        return None
    log(f"[{name}] product only: {t:.3f} ms")
    return t


def in_turns(new, old, reps=3):
    """Median ms of two versions of one function in turns (new, old, old,
    new): ([new, new], [old, old])."""
    t = {new: [], old: []}
    for fn in (new, old, old, new):
        t[fn].append(time_ms(fn, reps))
    return t[new], t[old]


def vs_old_body(r, name, new, old, body):
    """The tensor-core body (new) against the body it replaced (old: the
    "ffma" or "dp4a" body) in turns; old's outputs must equal new's. Sets
    r["ms"] and r[body + "_ms"] (the means of the two turns)."""
    if not all(torch.equal(g, w) for g, w in zip(old(), new())):
        raise AssertionError(f"{name}: the {body} body differs")
    t_new, t_old = in_turns(new, old)
    r["ms"] = float(np.mean(t_new))
    r[f"{body}_ms"] = float(np.mean(t_old))
    log(f"[{name}] in turns: tensor cores {t_new[0]:.3f} / {t_new[1]:.3f} "
        f"ms, {body} body {t_old[0]:.3f} / {t_old[1]:.3f} ms "
        f"({r[f'{body}_ms'] / r['ms']:.2f}x)")


def k1_body(name, fn):
    """The tensor-core body that one K1 call (fn) ran, from the kernels the
    profiler saw it launch: "wgmma: <kernel>". Raises where the call did
    not run knn_wg.cuh's wgmma body (knn_wg_kernel) alone."""
    seen = [k for k in probes.device_kernels(fn, reps=2)
            if "knn_wg_kernel" in k or "knn_tc_kernel" in k]
    if len(seen) != 1 or "knn_wg_kernel" not in seen[0]:
        raise AssertionError(f"{name} ran {seen}, not the wgmma body")
    body = seen[0].split("(")[0].replace("void ", "")
    log(f"[{name}] body: {body}")
    return f"wgmma: {body}"


def product_split(r, name, product_ms):
    """A gated K1's time on the wgmma body split into the body's product
    (product_ms, the ungated mode's product-only stage from wg_vs_mma on
    the same shape and type; f32's includes its split pre-pass) and the
    key epilogue (the rest)."""
    r["tc_product_ms"] = product_ms
    epi = r["ms"] - product_ms
    log(f"[{name}] tensor-core body split: product + row sum "
        f"{product_ms:.3f} ms, key epilogue {epi:.3f} ms "
        f"({100 * epi / r['ms']:.1f}% of the kernel)")


def full_range_descriptors(gen, pairs, n, n_planted):
    """int8 pairs over the whole −128..127 (SIFT values 0..255 − 128), the
    first n_planted B rows near A's, row 1 of each A all −128 and row 2
    all 127 (B rows 3 and 4 likewise)."""
    a = torch.randint(-128, 128, (pairs, n, 128), generator=gen,
                      device="cuda", dtype=torch.int16)
    b = torch.randint(-128, 128, (pairs, n, 128), generator=gen,
                      device="cuda", dtype=torch.int16)
    noise = torch.randint(-4, 5, (pairs, n_planted, 128), generator=gen,
                          device="cuda", dtype=torch.int16)
    b[:, :n_planted] = (a[:, :n_planted] + noise).clamp(-128, 127)
    a[:, 1], a[:, 2] = -128, 127
    b[:, 3], b[:, 4] = -128, 127
    return a.to(torch.int8), b.to(torch.int8)


def check_knn():
    """K1 in every mode; returns {mode: measurements}. Every mode (int8,
    bf16 and f32, plain and gated) runs the wgmma body (the profiler's
    kernels of one call name it: k1_body) and is timed in turns against
    the mma.sync body it replaced (knn_stages.i8_d128_raw, bf16_d128_raw,
    f32_d128_raw), both bodies split into product and key epilogue
    (wg_vs_mma; f32's product with its split pre-pass); ptxas's registers
    and spills of the wgmma instantiations at 128, which must not spill
    or carry a note."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    out = {}
    for name, pairs, n in (("store", *STORE_SHAPE), ("bench", *BENCH_SHAPE)):
        a, b = planted_descriptors(gen, pairs, n, n // 4)
        r = compare_keys("K1 int8", knn.knn_packed_raw, knn.knn_packed_plain,
                         (a, b))
        r["body"] = k1_body(f"K1 int8 {name}",
                            lambda: knn.knn_packed_raw(a, b))
        fa, fb = full_range_descriptors(gen, pairs, n, n // 4)
        compare_keys("K1 int8 full range", knn.knn_packed_raw,
                     knn.knn_packed_plain, (fa, fb), reps=1, plain_reps=1)
        del fa, fb
        wg_vs_mma(r, f"K1 int8 {pairs} x {n}", (a, b, None, None),
                  "packed")
        with_bound(r, *k1_bound(pairs, n, 1, "int8"))
        log(f"[K1] int8 {name} {pairs} pairs x {n}: bit-exact (planted "
            f"rows and the full -128..127); kernel {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
            f"({r['bound_by']})")
        # all A rows against one pair's B rows: the batch's products in
        # one call. Its int32 output alone, 4·pairs·n² bytes (9.7 GB at
        # bench's shape, 17.2 GB at the store's), takes this long at
        # 3.35 TB/s: the call is bound by its output, not its products
        bt = b[0].t()
        r["product_only_ms"] = product_only(
            f"K1 int8 torch._int_mm {pairs}x{n} x {n}",
            lambda: torch._int_mm(a.reshape(-1, 128), bt))
        del bt
        out_ms = 1e3 * 4 * pairs * n * n / HBM_BYTES_PER_S
        log(f"[K1] int8 {name}: torch._int_mm's int32 output alone takes "
            f"{out_ms:.3f} ms at 3.35 TB/s")
        out[f"i8_{name}"] = r
        fargs = float_inputs(a, b, torch.bfloat16)
        r = compare_keys(f"K1 bf16 {name}", knn.knn_packed_raw,
                         knn.knn_packed_plain, fargs, plain_reps=1)
        r["body"] = k1_body(f"K1 bf16 {name}",
                            lambda: knn.knn_packed_raw(*fargs))
        wg_vs_mma(r, f"K1 bf16 {pairs} x {n}", fargs, "packed")
        with_bound(r, *k1_bound(pairs, n, 2, "bf16"))
        bt = fargs[1].transpose(1, 2)
        r["product_only_ms"] = product_only(
            f"K1 bf16 torch.bmm {pairs} x {n} x {n}",
            lambda: torch.bmm(fargs[0], bt))
        del bt, fargs
        log(f"[K1] bf16 {name} {pairs} pairs x {n}: bit-exact; kernel "
            f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.3f} ms ({r['bound_by']})")
        out["bf16" if name == "store" else "bf16_bench"] = r
    pairs, n = STORE_SHAPE
    a, b = planted_descriptors(gen, pairs, n, n // 4)
    args = float_inputs(a, b, torch.float32)
    r = compare_keys("K1 f32", knn.knn_packed_raw, knn.knn_packed_plain,
                     args)
    r["body"] = k1_body("K1 f32", lambda: knn.knn_packed_raw(*args))
    wg_vs_mma(r, f"K1 f32 {pairs} x {n}", args, "packed")
    with_bound(r, *k1_bound(pairs, n, 4, "f32"))
    log(f"[K1] f32 {pairs} pairs x {n}: bit-exact; kernel {r['ms']:.3f} ms, "
        f"plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
        f"({r['bound_by']}) (six bf16 products)")
    # the product alone, in the mode's type (TF32 off, the package's
    # setting, so full f32 as the kernel)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the f32 yardstick would not be an "
                             "f32 product")
    bt = args[1].transpose(1, 2)
    r["product_only_ms"] = product_only(
        f"K1 f32 torch.bmm {pairs} x {n} x {n}",
        lambda: torch.bmm(args[0], bt))
    del bt, args
    out["f32"] = r
    # a prior that gates out about half the candidates: positions in a
    # 1000 px square, radius 400 px
    uv_a = torch.rand((pairs, n, 2), generator=gen, device="cuda") * 1000
    pred = torch.rand((pairs, n, 2), generator=gen, device="cuda") * 1000
    radius2 = 400.0 ** 2
    d = uv_a[0, :, None, :] - pred[0, None, :, :]
    frac = float(((d * d).sum(-1) > radius2).float().mean())
    gate = (uv_a, pred, radius2)
    for mode, args, eb, peak, ungated in (
            ("gated_i8", (a, b, None, None), 1, "int8", "i8_store"),
            ("gated_bf16", float_inputs(a, b, torch.bfloat16), 2, "bf16",
             "bf16"),
            ("gated_f32", float_inputs(a, b, torch.float32), 4, "f32",
             "f32")):
        gargs = (*args, *gate)
        r = compare_keys(f"K1 {mode}", knn.knn_packed_raw,
                         knn.knn_packed_plain, gargs)
        r["body"] = k1_body(f"K1 {mode}", lambda: knn.knn_packed_raw(*gargs))
        # in turns with the mma.sync body it replaced; the gate is
        # epilogue, so the product is the ungated mode's
        probe = rows_probe(args)[0]
        vs_old_body(r, f"K1 {mode} {pairs} x {n}",
                    lambda: knn.knn_packed_raw(*gargs),
                    lambda: probe(*gargs, body="mma"), "was")
        r["was_product_ms"] = out[ungated]["was_product_ms"]
        product_split(r, f"K1 {mode} {pairs} x {n}",
                      out[ungated]["tc_product_ms"])
        r["product_only_ms"] = out[ungated]["product_only_ms"]
        with_bound(r, *k1_bound(pairs, n, eb, peak, gated=True))
        log(f"[K1] {mode} {pairs} pairs x {n}, {100 * frac:.1f}% of the "
            f"candidates gated out: bit-exact; kernel {r['ms']:.3f} ms, "
            f"plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
            f"({r['bound_by']}); product only (ungated, same shape) "
            f"{r['product_only_ms']} ms")
        out[mode] = r
    split_planes(gen, pairs, n, gate, out)
    usage = {k: v for k, v in _build.tc_kernel_usage().items()
             if k.endswith(" wg") and (
                 k.split()[0] in ("int8", "bf16") and k.split()[1] != "2"
                 or k.split()[0] == "f32" and k.split()[1] in ("0", "1"))}
    warn = wg_notes(usage, ["a", "tLi0E", "tLi1E", "tLi3E",
                            "NS_6Bf16x3ELi0E", "NS_6Bf16x3ELi1E"])
    log(f"[K1 at 128] wgmma body, ptxas (registers, spill stores, spill "
        f"loads): {usage}; its notes: {warn or 'none'}")
    return out


def split_planes(gen, pairs, n, gate, out):
    """K1 f32 and gated f32 at the main path's shape (BM = 128) on rows
    whose mid and lo planes are not zero: integer rows of 256..360 (an
    odd value has mid = ±1; dots stay below 128 · 360² < 2²⁴, so exact)
    bit-exact, and random non-integer f32 (0..400, a quarter of B planted
    near A) within 2⁻²⁰ of the norms, indices equal modulo ties. Sets
    out[mode]["random_max_abs_err"]."""
    a = torch.randint(256, 361, (pairs, n, 128), generator=gen,
                      device="cuda", dtype=torch.int16)
    b = torch.randint(256, 361, (pairs, n, 128), generator=gen,
                      device="cuda", dtype=torch.int16)
    noise = torch.randint(-4, 5, (pairs, n // 4, 128), generator=gen,
                          device="cuda", dtype=torch.int16)
    b[:, :n // 4] = (a[:, :n // 4] + noise).clamp(256, 360)
    a, b = a.float(), b.float()
    args = (a, b, (a * a).sum(-1), (b * b).sum(-1))
    del noise
    for mode, g in (("f32", ()), ("gated_f32", gate)):
        check_equal(f"K1 {mode} on 256..360", knn.knn_packed_raw(*args, *g),
                    knn.knn_packed_plain(*args, *g))
    a = torch.rand((pairs, n, 128), generator=gen, device="cuda") * 400
    b = torch.rand((pairs, n, 128), generator=gen, device="cuda") * 400
    b[:, :n // 4] = a[:, :n // 4] + torch.randn(
        (pairs, n // 4, 128), generator=gen, device="cuda") * 2
    args = (a, b, knn._sq_norms(a), knn._sq_norms(b))
    tol = 2.0 ** -20 * float(args[2].max() + args[3].max())
    for mode, g in (("f32", ()), ("gated_f32", gate)):
        got = knn.knn_packed_raw(*args, *g)
        want = knn.knn_packed_plain(*args, *g)
        e_row, s_row, d_row = near_packed(f"K1 {mode} rows", got[0],
                                          want[0], a, b, tol)
        e_col, s_col, d_col = near_packed(f"K1 {mode} columns", got[1],
                                          want[1], b, a, tol)
        e, step = max((e_row, s_row), (e_col, s_col))
        out[mode]["random_max_abs_err"] = e
        log(f"[K1] {mode} {pairs} pairs x {n}: bit-exact on 256..360 (mid "
            f"planes set); random f32 0..400 within 2^-20 of the norms "
            f"({tol:.6g}) plus one step of a key's 10 mantissa bits: "
            f"largest difference {e:.6g}, where one key step is "
            f"{step:.6g}; {d_row + d_col} indices differ, all on ties")
        del got, want


def near_packed(name, got, want, x, y, tol, norms=None):
    """Packed keys (rows (P, n, 2) or columns (P, m)) of K1 against its
    plain version on rows x (the keys' side) and candidates y: decoded
    values within tol plus one step of a key's 10 mantissa bits, indices
    different only where their exact d2 tie within twice that, gated-out
    keys equal. norms (nx (P, n), ny (P, m)), the squared norms the
    kernel was given, make the exact d2 nx + ny − 2 x·y (the bf16 mode's
    norms of the unrounded rows beside the rounded x, y); else |x − y|².
    Raises otherwise; returns (the largest value difference, one step of
    the plain version's key where it occurs, the number of indices that
    differ)."""
    torch.cuda.synchronize()
    gv, gi = knn._decode_packed(got, got)[:2]
    wv, wi = knn._decode_packed(want, want)[:2]
    gated = (want & ~knn._IDX_MASK) == knn._GATED_BITS
    if not torch.equal(got[gated], want[gated]):
        raise AssertionError(f"{name}: gated-out keys differ")
    lim = tol + 2.0 ** -10 * wv.abs()
    err = (gv - wv).abs().masked_fill(gated, 0.0)
    if bool((err > lim).any()):
        k = int((err - lim).argmax())
        raise AssertionError(
            f"{name}: values differ by {float(err.flatten()[k])} at "
            f"{float(wv.flatten()[k])}, beyond {float(lim.flatten()[k])}")
    bad = tuple(torch.nonzero((gi != wi) & ~gated).t())
    if len(bad[0]):
        xi = x[bad[0], bad[1]].double()

        def d2(j):
            yj = y[bad[0], j[bad].long()].double()
            if norms is None:
                return ((xi - yj) ** 2).sum(-1)
            return (norms[0][bad[0], bad[1]].double()
                    + norms[1][bad[0], j[bad].long()].double()
                    - 2.0 * (xi * yj).sum(-1))

        if bool(((d2(gi) - d2(wi)).abs() > 2 * lim[bad]).any()):
            raise AssertionError(f"{name}: indices differ beyond ties")
    w = float(wv.flatten()[int(err.argmax())])
    step = 2.0 ** (math.floor(math.log2(w)) - 10) if w > 0 else 0.0
    return float(err.max()), step, len(bad[0])


def ties_only(q, cand, gi, wi, tol):
    """Where two index picks for the rows of q differ, their squared
    distances must tie within tol. Returns the number of differences."""
    bad = torch.nonzero(gi != wi)[:, 0]
    if len(bad):
        dg = ((q[bad] - cand[gi[bad].long()]) ** 2).sum(-1)
        dw = ((q[bad] - cand[wi[bad].long()]) ** 2).sum(-1)
        if float((dg - dw).abs().max()) > tol:
            raise AssertionError("K3 indices differ beyond ties")
    return len(bad)


def wg_notes(usage, kernels):
    """ptxas's (registers, spill stores, spill loads) of the wgmma body's
    instantiations keyed in usage, and its notes (e.g. C7518) on the
    mangled kernel names that start with one of kernels; raises where one
    spills or has a note."""
    warn = [w for w in _build.ptxas_warnings()
            if any(f"knn_wg_kernelI{k}" in w for k in kernels)]
    if warn or any(st or ld for _, st, ld in usage.values()):
        raise AssertionError(f"the wgmma body spills or is serialized: "
                             f"{usage}, {warn}")
    return warn


def check_wide():
    """K3 in both modes at 64 pairs × 10240 on the wgmma body: int8 store
    rows cast to bf16 and to f32, bit-exact, each in turns against the
    mma.sync body it replaced (whose keys must equal it) and both bodies
    split into product and key epilogue (wg_vs_mma), its keys also equal
    to the FFMA body's (timed beside it); f32's split pre-pass alone; f32
    also on integer rows 256..360 (mid planes set, bit-exact) and, with
    bf16, on random rows (indices modulo ties, values within a stated
    tolerance). Returns {"bf16": measurements, "f32": measurements}."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    pairs, n = WIDE_IMAGES, WIDE_N
    a, b = planted_descriptors(gen, pairs, n, n // 5)
    na, nb = knn._sq_norms(a), knn._sq_norms(b)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the f32 yardstick would not be "
                             "an f32 product")
    product = 2 * pairs * n * n * 128
    out = {}
    for mode, dtype, eb, old in (
            ("bf16", torch.bfloat16, 2, knn_stages.ffma_bf16_raw),
            ("f32", torch.float32, 4, knn_stages.ffma_f32_raw)):
        args = (a.to(dtype), b.to(dtype), na, nb)
        name = f"K3 {mode} {pairs} x {n}"
        r = compare_keys(f"K3 {mode}", knn.knn_wide_raw, knn.knn_wide_plain,
                         args, reps=3, plain_reps=1)
        vs_old_body(r, name, lambda: knn.knn_wide_raw(*args),
                    lambda: old(*args, wide=True), "ffma")
        wg_vs_mma(r, name, args, "wide")
        if mode == "f32":
            # the split pre-pass alone, both operands (part of the f32
            # times above), beside its bound: each f32 read once, its
            # three bf16 planes written once
            r["split_ms"] = time_ms(lambda: (knn.split_bf16x3_raw(args[0]),
                                             knn.split_bf16x3_raw(args[1])),
                                    5)
            r["split_bound_ms"] = bound(2 * pairs * n * 128 * (4 + 6),
                                        {})[0]
            log(f"[K3] f32 split pre-pass {pairs} x {n} x 128, both "
                f"operands: {r['split_ms']:.3f} ms (bound "
                f"{r['split_bound_ms']:.3f} ms, bytes)")
        # descriptors and norms read once; row keys (16 B) and column keys
        # (8 B) written once; f32: the six bf16 products of its split, the
        # work the kernel does, and beside it the product on the CUDA
        # cores
        with_bound(r, pairs * n * (2 * 128 * eb + 8 + 24),
                   {"bf16": (6 if mode == "f32" else 1) * product})
        if mode == "f32":
            r["ffma_bound_ms"] = bound(0, {"f32": product})[0]
        # ptxas's (registers, spill stores, spill loads) of the wgmma
        # body's K3 and product-only stage at 128 and the mma.sync
        # yardsticks' K3 (BM 128 and 64); empty if built before this run
        usage = _build.tc_kernel_usage()
        r["registers"] = {k: v for k, v in usage.items()
                          if k.startswith(f"{mode} 2 ")
                          or k == f"{mode} 3 wg"}
        notes = wg_notes({k: v for k, v in r["registers"].items()
                          if k.endswith(" wg")},
                         ["tLi2E"] if mode == "bf16" else ["NS_6Bf16x3E"])
        log(f"[K3] {mode} ptxas: {r['registers']}; the wgmma body's notes: "
            f"{notes or 'none'}")
        bt = args[1].transpose(1, 2)
        r["product_only_ms"] = product_only(
            f"K3 {mode} torch.bmm {pairs} x {n} x {n}",
            lambda: torch.bmm(args[0], bt))
        del bt, args
        log(f"[K3] {mode} (int8 cast) {pairs} pairs x {n}: bit-exact; kernel "
            f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.3f} ms ({r['bound_by']})"
            + (f" (six bf16 products); its product on the CUDA cores "
               f"{r['ffma_bound_ms']:.3f} ms" if mode == "f32" else ""))
        out[mode] = r
    del a, b, na, nb
    # f32 rows whose mid planes are set: integers 256..360 (an odd value
    # has mid = ±1; every dot stays below 128 · 360² < 2²⁴, exact), a fifth
    # of B planted near A
    a = torch.randint(256, 361, (pairs, n, 128), generator=gen,
                      device="cuda", dtype=torch.int16)
    b = torch.randint(256, 361, (pairs, n, 128), generator=gen,
                      device="cuda", dtype=torch.int16)
    b[:, :n // 5] = (a[:, :n // 5] + torch.randint(
        -4, 5, (pairs, n // 5, 128), generator=gen, device="cuda",
        dtype=torch.int16)).clamp(256, 360)
    a, b = a.float(), b.float()
    args = (a, b, (a * a).sum(-1), (b * b).sum(-1))
    check_equal("K3 f32 on 256..360", knn.knn_wide_raw(*args),
                knn.knn_wide_plain(*args))
    log(f"[K3] f32 {pairs} pairs x {n} on 256..360 (mid planes set): "
        "bit-exact")
    del a, b, args
    # random floats: the kernel's summation order differs from cuBLAS's;
    # f32 on the three-plane split within 2^-20 of the norms, bf16 (other
    # order and internal rounding of each 16-product step) within
    # TC_REL_TOL
    fa = torch.rand((8, n, 128), generator=gen, device="cuda") * 400
    fb = torch.rand((8, n, 128), generator=gen, device="cuda") * 400
    fb[:, :1000] = fa[:, :1000] + torch.randn((8, 1000, 128), generator=gen,
                                              device="cuda") * 2
    for dtype, rel in ((torch.float32, 2.0 ** -20),
                       (torch.bfloat16, TC_REL_TOL)):
        xa, xb = fa.to(dtype), fb.to(dtype)
        na, nb = knn._sq_norms(xa), knn._sq_norms(xb)
        got = [knn._decode_wide(k) for k in knn.knn_wide_raw(xa, xb, na, nb)]
        want = [knn._decode_wide(k)
                for k in knn.knn_wide_plain(xa, xb, na, nb)]
        torch.cuda.synchronize()
        atol = rel * float(na.max() + nb.max())
        err = max(float((g[0] - w[0]).abs().max()) for g, w in zip(got, want))
        mode = str(dtype)[6:]
        if err > atol:
            raise AssertionError(f"K3 {mode} values differ by {err} > {atol}")
        n_diff = 0
        xa, xb = xa.float(), xb.float()
        for p in range(8):
            # rows: both picks of each A row among B's; columns: A's pick
            for c in (0, 1):
                n_diff += ties_only(xa[p], xb[p], got[0][1][p][:, c],
                                    want[0][1][p][:, c], 2 * atol)
            n_diff += ties_only(xb[p], xa[p], got[1][1][p], want[1][1][p],
                                2 * atol)
        log(f"[K3] {mode} random 8 pairs x {n}: values within {err:.3g} "
            f"(bound {atol:.3g}); {n_diff} indices differ, all on ties")
        out["f32" if dtype == torch.float32 else "bf16"][
            "random_max_abs_err"] = err
        del xa, xb
    return out


def orb_rows(gen, pairs, n, full=False):
    """int8 rows of 256 values, a quarter of B planted near A: ORB's bits
    as the store holds them (−128/−127, 8 bits of a planted row flipped),
    or with full=True the whole −128..127 with an all −128 and an all 127
    row on each side (the largest d2, 256·255², and the extreme norms)."""
    hi = 256 if full else 2
    a = torch.randint(0, hi, (pairs, n, 256), generator=gen, device="cuda",
                      dtype=torch.int16)
    b = torch.randint(0, hi, (pairs, n, 256), generator=gen, device="cuda",
                      dtype=torch.int16)
    k = n // 4
    b[:, :k] = a[:, :k]
    b[:, :k, :8] = hi - 1 - b[:, :k, :8]
    if full:
        a[:, 1], a[:, 2] = 0, 255
        b[:, 3], b[:, 4] = 0, 255
    return (a - 128).to(torch.int8), (b - 128).to(torch.int8)


def rows_probe(args):
    """The probe that runs args' rows (their type and width: bf16, int8
    and f32 at 256 or 128 values) on either body:
    knn_stages.<type>_d<width>_raw, with its plain version."""
    tag = {torch.float32: "f32", torch.int8: "i8",
           torch.bfloat16: "bf16"}[args[0].dtype]
    name = f"{tag}_d{args[0].shape[-1]}"
    return (getattr(knn_stages, f"{name}_raw"),
            getattr(knn_stages, f"{name}_plain"))


def wg_vs_mma(r, name, args, mode):
    """bf16, int8 or f32 at 256 values a row or at 128: the wgmma body
    (K1 or K3 through its wrapper) in turns with the
    mma.sync body it replaced (knn_stages.<type>_d<width>_raw with
    body="mma", whose keys must equal it), and both bodies split into their
    product-only stage (f32: with its split pre-pass; int8: without K1's
    norm pre-pass; held bit-exact against its plain version on the first
    pairs; timed in turns) and the key epilogue. Sets r["ms"],
    r["was_ms"], r["tc_product_ms"] and r["was_product_ms"]."""
    raw = knn.knn_wide_raw if mode == "wide" else knn.knn_packed_raw
    probe, plain = rows_probe(args)
    vs_old_body(r, name, lambda: raw(*args),
                lambda: probe(*args, mode=mode, body="mma"), "was")
    x, y, p = args[0], args[1], PROBE_PLAIN_PAIRS
    want = plain(x[:p], y[:p], mode="row_sum")

    def product(body):
        return probe(x, y, mode="row_sum", body=body)

    for body in ("wg", "mma"):
        check_equal(f"{name} product-only stage ({body})",
                    [t[:p] for t in product(body)], want)
    t_new, t_old = in_turns(lambda: product("wg"), lambda: product("mma"))
    r["tc_product_ms"] = float(np.mean(t_new))
    r["was_product_ms"] = float(np.mean(t_old))
    for body, t, p_ms in (("wgmma", r["ms"], r["tc_product_ms"]),
                          ("mma.sync", r["was_ms"], r["was_product_ms"])):
        log(f"[{name}] {body} body split: product + row sum {p_ms:.3f} ms, "
            f"key epilogue {t - p_ms:.3f} ms "
            f"({100 * (t - p_ms) / t:.1f}% of the kernel)")


def random_planes_256(gen, pairs, n, gate, out):
    """K1 f32 and gated f32 at the store's shape and K3 f32 at the wide
    shape, 256 values a row, on non-integer rows whose mid and lo planes
    are set (uniform 0..400, a quarter of B planted near A): values within
    2⁻¹⁹ of the norms (at 256 values the plain version's own f32 product
    errs most: tests/test_torch_cuda.py's _F32_REL_256), K1's plus one
    step of a key's 10 mantissa bits, indices equal modulo ties. Sets
    out[case]["random_max_abs_err"]."""
    for case, (p, m) in (("f32_store", (pairs, n)),
                         ("k3_f32", (WIDE_IMAGES, WIDE_N))):
        a = torch.rand((p, m, 256), generator=gen, device="cuda") * 400
        b = torch.rand((p, m, 256), generator=gen, device="cuda") * 400
        b[:, :m // 4] = a[:, :m // 4] + torch.randn(
            (p, m // 4, 256), generator=gen, device="cuda") * 2
        args = (a, b, knn._sq_norms(a), knn._sq_norms(b))
        rel = 2.0 ** -19
        tol = rel * float(args[2].max() + args[3].max())
        modes = ((("f32_store", ()), ("gated_f32_store", gate))
                 if case == "f32_store" else (("k3_f32", None),))
        for mode, g in modes:
            wide = g is None
            got = (knn.knn_wide_raw(*args) if wide
                   else knn.knn_packed_raw(*args, *g))
            want = (knn.knn_wide_plain(*args) if wide
                    else knn.knn_packed_plain(*args, *g))
            e_row, d_row = near_256(f"{mode} rows", got[0], want[0], a, b,
                                    tol, wide)
            e_col, d_col = near_256(f"{mode} columns", got[1], want[1], b,
                                    a, tol, wide)
            out[mode]["random_max_abs_err"] = max(e_row, e_col)
            step = "" if wide else " plus a key's 10-bit step"
            log(f"[K1/K3 at 256] {mode} {p} pairs x {m}, random f32 0..400: "
                f"within {rel:.3g} of the norms ({tol:.6g}){step}: largest "
                f"difference {max(e_row, e_col):.6g}; {d_row + d_col} "
                "indices differ, all on ties")
            del got, want
        del a, b, args


def near_256(name, got, want, x, y, tol, wide):
    """near_packed for K1's packed keys, or (wide) check_wide's check of
    K3's 64-bit keys: values within tol, indices different only where
    their exact d2 tie within twice that (ties_only). Returns (largest
    difference, indices that differ)."""
    if not wide:
        e, _, d = near_packed(name, got, want, x, y, tol)
        return e, d
    (gv, gi), (wv, wi) = knn._decode_wide(got), knn._decode_wide(want)
    err = float((gv - wv).abs().max())
    if err > tol:
        raise AssertionError(f"{name}: values differ by {err} > {tol}")
    n_bad = 0
    for p in range(got.shape[0]):
        picks = ([(gi[p][:, c], wi[p][:, c]) for c in (0, 1)]
                 if got.dim() == 3 else [(gi[p], wi[p])])
        for g, w in picks:
            n_bad += ties_only(x[p], y[p], g, w, 2 * tol)
    return err, n_bad


def check_knn_256():
    """K1 (int8 at the store's and bench.py's shapes, gated int8 and bf16
    plain and gated at bench.py's, f32 plain and gated at the store's) and
    K3 (bf16 and f32 at 64 × 10240) at 256 values a row: ORB's bits and
    the full −128..127, bit-exact against the plain versions; times beside
    the bound and one library product of the same operands (the gated
    modes: their ungated mode's). Every type runs the wgmma body
    (knn_wg.cuh), timed in turns with the mma.sync body it replaced and
    split into product and key epilogue (wg_vs_mma; the gated modes in
    turns, with their ungated mode's split); f32 also on non-integer rows
    within its tolerance (random_planes_256). Returns {case:
    measurements}."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    gates = {}

    def gate_of(pairs, n):
        """a prior that gates out about half the candidates: positions in
        a 1000 px square, radius 400 px"""
        if (pairs, n) not in gates:
            gates[pairs, n] = (
                torch.rand((pairs, n, 2), generator=gen, device="cuda")
                * 1000,
                torch.rand((pairs, n, 2), generator=gen, device="cuda")
                * 1000, 400.0 ** 2)
        return gates[pairs, n]

    out = {}
    for case, (pairs, n), dtype, eb, peak in (
            ("i8_store", STORE_SHAPE, torch.int8, 1, "int8"),
            ("i8_bench", BENCH_SHAPE, torch.int8, 1, "int8"),
            ("gated_i8_bench", BENCH_SHAPE, torch.int8, 1, "int8"),
            ("bf16_bench", BENCH_SHAPE, torch.bfloat16, 2, "bf16"),
            ("gated_bf16_bench", BENCH_SHAPE, torch.bfloat16, 2, "bf16"),
            ("f32_store", STORE_SHAPE, torch.float32, 4, "f32"),
            ("gated_f32_store", STORE_SHAPE, torch.float32, 4, "f32")):
        gated = case.startswith("gated")
        gate = gate_of(pairs, n) if gated else ()
        name = f"K1 {case} {pairs} x {n} at 256"
        for full in (True, False):      # the timed rows last: ORB's bits
            a, b = orb_rows(gen, pairs, n, full)
            args = ((a, b, None, None) if dtype == torch.int8
                    else float_inputs(a, b, dtype)) + gate
            r = compare_keys(name, knn.knn_packed_raw, knn.knn_packed_plain,
                             args, reps=5 if not full else 1,
                             plain_reps=2 if not full else 1)
        with_bound(r, *k1_bound(pairs, n, eb, peak, gated=gated, dim=256))
        if not gated:
            wg_vs_mma(r, name, args, "packed")
        else:                           # the gate is epilogue: the same
            probe = rows_probe(args)[0]
            vs_old_body(r, name, lambda: knn.knn_packed_raw(*args),
                        lambda: probe(*args, body="mma"), "was")
            for k in ("tc_product_ms", "was_product_ms", "product_only_ms"):
                r[k] = out[case[len("gated_"):]][k]
        if not gated:
            x, bt = args[0].reshape(-1, 256), args[1][0].t()
            r["product_only_ms"] = product_only(
                name, (lambda: torch._int_mm(x, bt)) if dtype == torch.int8
                else (lambda: torch.bmm(args[0], args[1].transpose(1, 2))))
            del x, bt
        del args, a, b
        log(f"[K1] {case} {pairs} pairs x {n} at 256 values a row: bit-exact "
            f"(ORB's bits and the full range); kernel {r['ms']:.3f} ms, "
            f"plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
            f"({r['bound_by']}), product only {r['product_only_ms']} ms")
        out[case] = r
    pairs, n = WIDE_IMAGES, WIDE_N
    for mode, dtype, eb in (("bf16", torch.bfloat16, 2),
                            ("f32", torch.float32, 4)):
        name = f"K3 {mode} {pairs} x {n} at 256"
        for full in (True, False):
            args = float_inputs(*orb_rows(gen, pairs, n, full), dtype)
            r = compare_keys(name, knn.knn_wide_raw, knn.knn_wide_plain,
                             args, reps=3 if not full else 1, plain_reps=1)
        product = 2 * pairs * n * n * 256
        with_bound(r, pairs * n * (2 * 256 * eb + 8 + 24),
                   {"bf16": (6 if mode == "f32" else 1) * product})
        wg_vs_mma(r, name, args, "wide")
        r["product_only_ms"] = product_only(
            name, lambda: torch.bmm(args[0], args[1].transpose(1, 2)))
        del args
        log(f"[K3] {mode} {pairs} pairs x {n} at 256 values a row: "
            f"bit-exact (ORB's bits and the full range); kernel "
            f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.3f} ms ({r['bound_by']}), product only "
            f"{r['product_only_ms']} ms")
        out[f"k3_{mode}"] = r
    random_planes_256(gen, *STORE_SHAPE, gate_of(*STORE_SHAPE), out)
    del gates
    usage = {k: v for k, v in _build.tc_kernel_usage().items()
             if "_d256" in k}
    log(f"[K1/K3 at 256] ptxas (registers, spill stores, spill loads): "
        f"{usage}")
    warn = [w for w in _build.ptxas_warnings() if "knn_wg_kernel" in w]
    log(f"[K1/K3 at 256] ptxas warnings of the wgmma body: "
        f"{warn or 'none'}")
    return out


def bench_workload(steps=16):
    import bench

    args, n = _bench_args()
    gen = torch.Generator(device="cuda").manual_seed(0)

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


def profile_detect(m):
    """One detect batch (phase 7's first DETECT_BATCH frames) under
    torch.profiler, after a warm batch: device busy share, kernels by
    time and K2's share of the device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    frames = m.frames[:DETECT_BATCH]
    detect(frames)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        detect(frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log(f"[detect] profiled batch of {len(frames)} frames:")
    profile_summary(prof, wall)
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in evs)
    k2 = [e for e in evs if "gauss_blur_kernel" in e.key]
    t = sum(e.self_device_time_total for e in k2)
    log(f"[detect] K2 {t / 1e3:.3f} ms in {sum(e.count for e in k2)} "
        f"launches, {100 * t / busy:.1f}% of the device time")


def run_smart_slice(m, dets, root, profile=False):
    """Phase 7's detections as a workspace; Step 3a's smart matching stage
    over it as apps/process.py runs it: find_matches, then the yaw-error
    corrections and requalify_pairs. find_matches's output is checked
    against the planted homographies and the true ground; what the
    corrections and requalify_pairs then drop is reported. profile=True
    runs find_matches once more on a fresh copy under torch.profiler.
    The run's own first and last gated K1 int8 call are held bit-exact
    and timed in turns with the mma.sync body (check_k1_calls). Returns
    (launches, find_matches's {(i, j): matches}, the workspace after
    requalify_pairs, its smart state, check_k1_calls' list)."""
    W, _ = FRAME
    t0 = time.perf_counter()
    proj = write_workspace(os.path.join(root, "smart"), m, dets)
    walls = {"workspace": time.perf_counter() - t0}
    state = smart.SmartState(proj.analysis_dir)
    config = matcher.MatchConfig(strategy="smart")
    reset_launches()
    kind = ("int8", 128, True)
    with keeping_k1({kind}) as (_, kept):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        matcher.find_matches(proj, config, smart_state=state, device="cuda")
        torch.cuda.synchronize()
        walls["find_matches"] = time.perf_counter() - t0
    launches = read_launches()
    k1_calls = check_k1_calls(kept.get(kind, {}), "smart", "smart")
    del kept

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
        proj2 = write_workspace(os.path.join(root, "smart_profiled"), m, dets)
        state2 = smart.SmartState(proj2.analysis_dir)
        with torch.profiler.profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            matcher.find_matches(proj2, config, smart_state=state2,
                                 device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        profile_summary(prof, wall)
    return launches, result, proj, state, k1_calls


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
    del store
    f32_launches = run_wide_f32(base, uv, pairs, config)
    return {"knn_wide": launches["knn_wide"],
            "knn_wide_f32": f32_launches["knn_wide_f32"]}


def run_wide_f32(base, uv, pairs, config, chunk=8):
    """Phase 10b: the wide store's rows as f32 descriptors (their 0..255
    values) through match_pair_batch(bf16=False), f32 matching as
    MatchConfig(bf16=False) runs it, chunk pairs at a time: K3's f32
    mode. ≥ 95% of the planted matches survive in every pair; then K3
    f32's keys on those rows equal K3 bf16's bit for bit (integer rows:
    both products exact)."""
    dev = base.device
    n = base.shape[1]
    P = WIDE_PLANTED
    desc = base.float()
    gen = torch.Generator(device=dev).manual_seed(7)
    kept = []
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(0, len(pairs), chunk):
        ia = torch.tensor([i for i, _ in pairs[s:s + chunk]], device=dev)
        ib = torch.tensor([j for _, j in pairs[s:s + chunk]], device=dev)
        counts = torch.full((len(ia),), n, dtype=torch.int32, device=dev)
        best_j, ok = matcher.match_pair_batch(
            desc[ia], desc[ib], uv[ia], uv[ib], counts, counts, gen,
            ratio=config.ratio, thresh=7.9, n_hyp=config.n_hyp, bf16=False)
        planted = torch.arange(P, device=dev)
        kept += ((ok[:, P:2 * P] & (best_j[:, P:2 * P] == planted))
                 .sum(1).tolist())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    log(f"[wide] f32 (bf16=False) {len(pairs)} pairs x {n} through "
        f"match_pair_batch in chunks of {chunk}: {dt:.3f} s = "
        f"{len(pairs) / dt:.1f} pairs/s; planted kept min {min(kept)} mean "
        f"{np.mean(kept):.1f} of {P}; launches: {launches}")
    if launches["knn_wide_f32"] == 0 or launches["knn_wide"] != 0:
        raise AssertionError(f"f32 matching did not take K3 f32: {launches}")
    if min(kept) < 0.95 * P:
        raise AssertionError(f"f32 wide matching kept {min(kept)} < 95% of "
                             f"{P} planted matches")
    for s in range(0, len(pairs), chunk):
        ia = torch.tensor([i for i, _ in pairs[s:s + chunk]], device=dev)
        ib = torch.tensor([j for _, j in pairs[s:s + chunk]], device=dev)
        a, b = desc[ia], desc[ib]
        na, nb = knn._sq_norms(a), knn._sq_norms(b)
        f32 = knn.knn_wide_raw(a, b, na, nb)
        bf16 = knn.knn_wide_raw(a.bfloat16(), b.bfloat16(), na, nb)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(f32, bf16)):
            raise AssertionError(f"K3 f32's keys differ from K3 bf16's on "
                                 f"pairs {s}..{s + len(ia) - 1}")
    log(f"[wide] K3 f32's keys equal K3 bf16's bit for bit on all "
        f"{len(pairs)} pairs")
    return launches


def check_epilogue():
    """Phase 11: K4 against its plain version on K1's raw keys of planted
    int8 rows, at bench.py's shape and the store's, ungated and gated."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    out = {}
    for name, (pairs, n), gated in (("bench", BENCH_SHAPE, False),
                                    ("store", STORE_SHAPE, False),
                                    ("store_gated", STORE_SHAPE, True)):
        a, b = planted_descriptors(gen, pairs, n, n // 4)
        gate = ()
        if gated:
            gate = (torch.rand((pairs, n, 2), generator=gen, device="cuda")
                    * 1000, torch.rand((pairs, n, 2), generator=gen,
                                       device="cuda") * 1000, 400.0 ** 2)
        row_p, col_p = knn.knn_packed_raw(a, b, None, None, *gate)
        uv_b = torch.rand((pairs, n, 2), generator=gen, device="cuda") * 4000
        args = (row_p, col_p, uv_b, 0.75)
        r = compare_keys(f"K4 {name}", knn.match_epilogue_raw,
                         knn.match_epilogue_plain, args, reps=20,
                         plain_reps=3)
        call_ms, plain_call_ms = r["ms"], r["plain_ms"]

        def k1():
            return knn.knn_packed_raw(a, b, None, None, *gate)

        # a call is microseconds of device work: device time from the
        # profiler, each call right after a fresh K1 launch as on the
        # fused arm (K1's keys just written, uv_b evicted by K1's reads);
        # the kernel's alone, and all of the plain version's less K1's
        r["ms"] = device_ms(lambda: knn.match_epilogue_raw(*k1(), uv_b,
                                                           0.75),
                            "match_epilogue_kernel")
        r["plain_ms"] = (device_ms(lambda: knn.match_epilogue_plain(
            *k1(), uv_b, 0.75)) - device_ms(k1))
        r["timed_by"] = "profiler device time, after a fresh K1 launch"
        # per A row: row_p 8 B in, best_j 4 + ok 1 + pb 8 B out; per B row:
        # col_p 4 B and uv_b 8 B in
        with_bound(r, pairs * n * (8 + 13) + pairs * n * 12, {})
        kept = int(knn.match_epilogue_plain(*args)[1].sum())
        log(f"[K4] {name} {pairs} pairs x {n}: bit-exact (best_j, ok, pb); "
            f"{kept} rows ok; device time: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}); per call by CUDA events (host work "
            f"included): kernel {call_ms:.4f} ms, plain {plain_call_ms:.4f} "
            f"ms")
        out[name] = r
        del a, b, gate, args
    return out


def _bench_args():
    """bench.py's batch on the card: int8 descriptors, uv, counts."""
    import bench

    rng = np.random.default_rng(0)
    desc_a, desc_b, uv_a, uv_b = bench.make_pair_batch(rng, bench.BATCH)
    to8 = lambda d: (d.astype(np.int16) - 128).astype(np.int8)  # noqa: E731
    dev = torch.device("cuda")
    args = [torch.from_numpy(x).to(dev) for x in
            (to8(desc_a), to8(desc_b), uv_a, uv_b)]
    n = torch.full((bench.BATCH,), bench.N_FEAT, dtype=torch.int32,
                   device=dev)
    return args, n


def run_fused_bench(unfused_pps, steps=8):
    """Phase 12a: bench.py's workload through match_pair_batch, unfused
    then fused, each from the same generator seed: equal matches; then
    both arms' pairs/s in turns (unfused, fused, fused, unfused)."""
    import bench

    args, n = _bench_args()

    def step(gen):
        return matcher.match_pair_batch(*args, n, n, gen, ratio=0.75,
                                        thresh=7.9, n_hyp=512)

    def seeded():
        return torch.Generator(device="cuda").manual_seed(0)

    def arm(fused):
        if fused:
            os.environ[FUSED] = "1"
        else:
            os.environ.pop(FUSED, None)

    arm(False)
    want = step(seeded())
    arm(True)
    got = step(seeded())
    torch.cuda.synchronize()
    if not (torch.equal(got[1], want[1])
            and torch.equal(got[0][got[1]], want[0][want[1]])):
        raise AssertionError("fused bench matches differ from the unfused "
                             "arm's")
    rates = {False: [], True: []}
    gen = seeded()
    for fused in (False, True, True, False):
        arm(fused)
        step(gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            _, ok = step(gen)
        torch.cuda.synchronize()
        rates[fused].append(bench.BATCH * steps / (time.perf_counter() - t0))
        if int(ok.sum(1).min()) < 0.95 * bench.PLANTED:
            raise AssertionError("the fused bench lost planted matches")
    arm(True)
    pps = float(np.mean(rates[True]))
    log(f"[fused] bench {bench.BATCH} pairs x {bench.N_PAD} int8: matches "
        f"equal to the unfused arm's ({int(want[1].sum())}); in turns of "
        f"{steps} steps (unfused, fused, fused, unfused): unfused "
        f"{rates[False][0]:.1f}, {rates[False][1]:.1f} pairs/s, fused "
        f"{rates[True][0]:.1f}, {rates[True][1]:.1f} pairs/s; phase 6 "
        f"(unfused) {unfused_pps:.1f}")
    return pps


def run_fused_smart(m, dets, root, want):
    """Phase 12b: find_matches(strategy="smart") on a fresh copy of phase
    8's workspace with the fused arm on; match lists equal to phase 8's
    (want) pair by pair."""
    proj = write_workspace(os.path.join(root, "smart_fused"), m, dets)
    state = smart.SmartState(proj.analysis_dir)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    matcher.find_matches(proj, matcher.MatchConfig(strategy="smart"),
                         smart_state=state, device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = project_matches(proj, list(want))
    bad = [p for p in want if not np.array_equal(got[p], want[p])]
    log(f"[fused] smart find_matches: {len(want)} pairs in {dt:.3f} s = "
        f"{len(want) / dt:.1f} pairs/s; {len(want) - len(bad)} of "
        f"{len(want)} pairs' match lists equal to phase 8's")
    if bad:
        raise AssertionError(f"fused smart matches differ on {len(bad)} "
                             f"pairs, e.g. {bad[:3]}")


def quat_angle_deg(q1, q2):
    """Angles between two sets of attitude quaternions, degrees."""
    q1 = np.asarray(q1, np.float64)
    q2 = np.asarray(q2, np.float64)
    q1 = q1 / np.linalg.norm(q1, axis=-1, keepdims=True)
    q2 = q2 / np.linalg.norm(q2, axis=-1, keepdims=True)
    d = np.minimum(np.linalg.norm(q1 - q2, axis=-1),
                   np.linalg.norm(q1 + q2, axis=-1))
    return np.degrees(4.0 * np.arcsin(np.clip(d / 2.0, 0.0, 1.0)))


def steps_3b_4(proj, state):
    """apps/process.py:275-417 on one card: link → triangulate (the smart
    surface, else the flat ground: the mission's truth, since the card's
    machine has no SRTM tiles) → groups → BA on group 0 → refit onto the
    start positions → write_back → the stale chains' re-triangulation.
    Returns what phase 13 reports."""
    walls = {}

    def lap(name, t0):
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        return time.perf_counter()

    t0 = time.perf_counter()
    for im in proj.image_list:
        if im.kp is None:
            im.load_features()
        if not im.match_list:
            im.load_matches()
    matches = cleanup.link_matches(proj)
    proj.save_matches_grouped(matches)
    t0 = lap("link", t0)

    def base(image):
        n = state.node(image.name)
        return n["tri_surface_m"] if "tri_surface_m" in n else 0.0

    cleanup.triangulate_ground(proj, matches, get_base_elev=base,
                               device="cuda")
    proj.save_matches_grouped(matches)
    t0 = lap("triangulate", t0)
    grps = groups.compute(proj.image_list, matches, min_chain_len=3)
    groups.save(proj.analysis_dir, grps)
    proj.save_matches_grouped(matches)
    t0 = lap("groups", t0)
    grps = groups.load(proj.analysis_dir)
    cams0, pts0, obs, cam_names, match_map = ba_setup.setup_from_matches(
        proj, matches, group_images=grps[0] if grps else None,
        min_chain_len=3)
    t0 = lap("setup", t0)
    model = proj.camera_model()
    result = bundle.solve(cams0, pts0, obs, model.K, model.dist,
                          bundle.BAConfig(), log_fn=log, device="cuda")
    t0 = lap("solve", t0)
    new_cams, new_pts, _ = bundle.refit(result.cams, result.pts,
                                        cams0[:, :3], device="cuda")
    result = result._replace(cams=new_cams, pts=new_pts)
    ba_setup.write_back(proj, matches, result, cam_names, match_map)
    t0 = lap("refit_write_back", t0)
    active = set(int(mi) for mi in match_map)
    by_name = {im.name: i for i, im in enumerate(proj.image_list)}
    opt_imgs = {by_name[n] for n in cam_names if n in by_name}
    stale = [mi for mi, mm in enumerate(matches)
             if mi not in active and any(o[0] in opt_imgs for o in mm[2:])]
    if stale:
        cleanup.triangulate_ground(proj, matches, get_base_elev=base,
                                   subset=stale, optimized=True,
                                   device="cuda")
    proj.save_matches_grouped(matches)
    lap("stale_refresh", t0)
    return dict(matches=matches, groups=grps, cams0=cams0, obs=obs,
                cam_names=cam_names, result=result, stale=stale,
                base=base, walls=walls)


def run_steps_3b_4(proj, state, m, root, profile=False):
    """Phase 13: Steps 3b–4 on phase 8's workspace as it stands after the
    yaw corrections and requalify_pairs; checks and the poses against the
    mission's truth."""
    snapshot = os.path.join(root, "steps34_profiled")
    if profile:
        shutil.copytree(proj.project_dir, snapshot)
    t0 = time.perf_counter()
    out = steps_3b_4(proj, state)
    wall = time.perf_counter() - t0
    matches, res, cams0 = out["matches"], out["result"], out["cams0"]
    idx = [int(n.split("_")[1]) for n in out["cam_names"]]
    n_obs = sum(len(mm) - 2 for mm in matches)
    sizes = [len(g) for g in out["groups"]]
    err0 = np.linalg.norm(cams0[:, :3] - m.ned[idx], axis=1)
    err1 = np.linalg.norm(res.cams[:, :3] - m.ned[idx], axis=1)
    att0 = quat_angle_deg(cams0[:, 3:7], m.cam_quat[idx])
    att1 = quat_angle_deg(res.cams[:, 3:7], m.cam_quat[idx])
    height = -res.pts[:, 2]
    log(f"[steps34] {len(matches)} chains, {n_obs} observations; groups "
        f"{sizes}; BA {len(res.cams)} cameras, {len(res.pts)} points, "
        f"{len(out['obs'].uv)} observations")
    log(f"[steps34] BA {res.iters} iterations, cost {res.cost_history[0]:.6g}"
        f" -> {res.cost_history[-1]:.6g}, mre {res.mre:.4f} px; walls s "
        + json.dumps({k: round(v, 3) for k, v in out["walls"].items()})
        + f", total {wall:.3f} s")
    log(f"[steps34] camera position error vs truth: before BA median "
        f"{np.median(err0):.4f} max {err0.max():.4f} m, after refit median "
        f"{np.median(err1):.4f} max {err1.max():.4f} m")
    log(f"[steps34] attitude error vs truth: before BA median "
        f"{np.median(att0):.3f} max {att0.max():.3f} deg ({(att0 > 0.5).sum()}"
        f" over 0.5 deg), after median {np.median(att1):.4f} max "
        f"{att1.max():.4f} deg ({(att1 > 0.5).sum()} over 0.5 deg)")
    log(f"[steps34] BA points' height vs the ground (0 m): median "
        f"{np.median(height):.4f} m, |h| p50 {np.median(np.abs(height)):.4f}"
        f" p95 {np.percentile(np.abs(height), 95):.4f} m; "
        f"{len(out['stale'])} stale chains re-triangulated")
    # the refresh covered every stale chain: re-derive them from scratch
    # with the optimized poses and compare
    again = [list(mm) for mm in matches]
    for mi in out["stale"]:
        again[mi][0] = None
    cleanup.triangulate_ground(proj, again, get_base_elev=out["base"],
                               subset=out["stale"], optimized=True,
                               device="cuda")
    fresh = all(again[mi][0] is not None
                and np.allclose(again[mi][0], matches[mi][0])
                for mi in out["stale"])
    if not sizes or max(sizes) < 0.9 * len(proj.image_list):
        raise AssertionError(f"no group holds 90% of the images: {sizes}")
    if not res.cost_history[-1] < res.cost_history[0]:
        raise AssertionError("BA did not lower the cost")
    if res.mre > 1.0:
        raise AssertionError(f"BA mre {res.mre} px > 1.0")
    if not np.isfinite(res.pts).all():
        raise AssertionError("a BA point is not finite")
    if abs(np.median(height)) > 1.0:
        raise AssertionError(f"median BA point {np.median(height)} m off "
                             "the ground")
    if not fresh:
        raise AssertionError("the stale-chain refresh missed chains")
    if profile:
        from torch.profiler import ProfilerActivity
        proj2 = ProjectMgr(snapshot)
        proj2.load_images_info()
        with torch.profiler.profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            steps_3b_4(proj2, smart.SmartState(proj2.analysis_dir))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        log("[steps34] profiled rerun on a snapshot of the workspace:")
        profile_summary(prof, wall)
    return out


def ba_stop(res, cfg):
    """Why a solve ended: "converged" (the last accepted step cut the cost
    by less than ftol), "stalled" (an iteration accepted no step in
    max_retries) or "max_iters"."""
    h = res.cost_history
    if len(h) > 1 and 1.0 - h[-1] / h[-2] < cfg.ftol:
        return "converged"
    return "max_iters" if len(h) - 1 == cfg.max_iters else "stalled"


def run_mission_ba():
    """Phase 14: bundle.solve at mission scale with the pipeline's
    BAConfig(), in f32 twice (first, warm) and in f64; one LM iteration's
    split; then f32 against f64 on the 300-camera grid. A mission solve
    passes if it did not stall, ends within 5% of the noise floor
    ½σ²(2·n_obs − 7·n_cam − 3·n_pt) with no residual above 5 px, and f32
    ends within 0.01 px of f64's mre."""
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    g = make_ba_mission_graph(device=dev)
    torch.cuda.synchronize()
    n_cam, n_pt, n_obs = len(g.cams0), len(g.pts0), len(g.obs.uv)
    floor = 0.5 * 0.5 ** 2 * (2 * n_obs - 7 * n_cam - 3 * n_pt)
    log(f"[ba] mission graph: {n_cam} cameras, {n_pt} points, {n_obs} "
        f"observations, built on the card in {time.perf_counter() - t0:.2f} "
        f"s; noise floor of the cost {floor:.6g}")
    cfg = bundle.BAConfig()
    out = {}
    for run, dtype in (("first", torch.float32), ("warm", torch.float32),
                       ("f64", torch.float64)):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = bundle.solve(g.cams0, g.pts0, g.obs, g.K, g.dist, cfg,
                           verbose=run == "first", log_fn=log, dtype=dtype,
                           device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        stop = ba_stop(res, cfg)
        _, _, mx = bundle.ba_cost(*bundle._problem_on(
            res.cams, res.pts, g.obs, g.K, g.dist, dev, dtype))
        cost = res.cost_history[-1]
        out[run] = res
        out[f"{run}_wall"] = wall
        log(f"[ba] {run} run ({str(dtype)[6:]}): {wall:.3f} s, "
            f"{len(res.cost_history) - 1} accepted steps, stop: {stop}; "
            f"cost {res.cost_history[0]:.6g} -> {cost:.6g} "
            f"({cost / floor:.4f} of the noise floor), mre {res.mre:.4f} "
            f"px, max residual {float(mx):.3f} px, peak device memory "
            f"{peak / 2**30:.2f} GiB")
        if not (stop != "stalled" and cost <= 1.05 * floor
                and float(mx) <= 5.0 and np.isfinite(res.pts).all()):
            raise AssertionError(f"mission BA did not converge ({run})")
    r32, r64 = out["warm"], out["f64"]
    d = np.linalg.norm(r32.cams[:, :3] - r64.cams[:, :3], axis=1)
    dmre = abs(r32.mre - r64.mre)
    log(f"[ba] mission f32 vs f64: mre delta {dmre:.2e} px, final cost "
        f"ratio {r32.cost_history[-1] / r64.cost_history[-1]:.6f}, camera "
        f"position delta mean {d.mean():.2e} max {d.max():.2e} m")
    if dmre >= 0.01:
        raise AssertionError("mission f32 BA strays from f64")
    obs = bundle.observations_on(g.obs, dev)
    split = {}
    for _ in range(2):                  # the second pass is reported
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        jac = bundle.lm_jacobians(g.cams0, g.pts0, obs, g.K, g.dist, n_cam,
                                  n_pt)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        bundle.lm_solve(jac, obs.cam_idx, obs.pt_idx, 1e-3)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        bundle.ba_cost(g.cams0, g.pts0, obs, g.K, g.dist)
        torch.cuda.synchronize()
        split = {"lm_jacobians": t1 - t0, "lm_solve": t2 - t1,
                 "ba_cost": time.perf_counter() - t2}
        del jac
    log("[ba] one LM iteration at the start, s: "
        + json.dumps({k: round(v, 4) for k, v in split.items()}))
    del g, obs
    g = make_ba_grid_graph(device=dev)
    cfg = bundle.BAConfig(max_iters=40, ftol=1e-6)
    t0 = time.perf_counter()
    r32 = bundle.solve(g.cams0, g.pts0, g.obs, g.K, g.dist, cfg,
                       verbose=False, dtype=torch.float32, device=dev)
    t1 = time.perf_counter()
    r64 = bundle.solve(g.cams0, g.pts0, g.obs, g.K, g.dist, cfg,
                       verbose=False, dtype=torch.float64, device=dev)
    t2 = time.perf_counter()
    d = np.linalg.norm(r32.cams[:, :3] - r64.cams[:, :3], axis=1)
    dmre = abs(r32.mre - r64.mre)
    log(f"[ba] f32 vs f64, {len(g.cams0)} cameras, {len(g.obs.uv)} "
        f"observations: mre {r32.mre:.6f} / {r64.mre:.6f} px (delta "
        f"{dmre:.2e}), camera position delta mean {d.mean():.2e} max "
        f"{d.max():.2e} m; iterations {r32.iters} / {r64.iters}; walls "
        f"{t1 - t0:.3f} / {t2 - t1:.3f} s")
    if dmre >= 0.01 or d.mean() >= 1e-3:
        raise AssertionError("f32 BA strays from the f64 oracle")
    return out, split


PROBE_PLAIN_PAIRS = 2       # pairs of the 64 held against the plain versions
ROW_MIN_MODE = 4            # kProductRowMin (csrc/knn_common.cuh)
WG_KERNEL = "mm_rowsum_wg_kernel"   # P5's kernel, by its profiler name
P5_REL_TOL = 1e-5           # P5 on normal inputs: |kernel − plain| ≤ this
                            # × max |plain| (f32 sums of 6144·K products in
                            # another order)


def reset_probe_launches():
    for counts in (knn_stages.LAUNCHES, mma.LAUNCHES, fused.LAUNCHES):
        for k in counts:
            counts[k] = 0


def probe_launches():
    return dict(**knn_stages.LAUNCHES, **mma.LAUNCHES, **fused.LAUNCHES)


def drive(name, fn):
    """Run one probe's sweep with the probe counts set to 0 just before
    and read just after: (fn's result, {kernel: launches})."""
    reset_probe_launches()
    out = fn()
    torch.cuda.synchronize()
    counts = {k: v for k, v in probe_launches().items() if v}
    log(f"[probes] {name} launches: {counts}")
    return out, counts


def check_equal(name, got, want):
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"{name} differs from its plain version: "
                                 f"{int((g != w).sum())} values")


def probe_inputs():
    """bench.py's int8 batch (64 pairs × 6144, 1500 planted) and the same
    rows as 0..255 bf16 with their f32 norms."""
    args, _ = _bench_args()
    a, b, _, uv_b = args
    return a, b, uv_b, float_inputs(a, b, torch.bfloat16)


def compare_stages(a, b, fargs):
    """P3/P4/P6's kernel at bench's shape against its plain version on the
    first pairs (every stage at K1's tile, the row minimum at every tile),
    and its full stage against K1 on all 64 pairs; P3's and P4's stages on
    the mma.sync body (tc_stage, tc_row_sum; K1 itself runs the wgmma
    body, whose keys its full stage must equal) the same way."""
    p = PROBE_PLAIN_PAIRS
    for dtype, args in (("int8", (a, b, None, None)), ("bf16", fargs)):
        sub = tuple(None if x is None else x[:p] for x in args)
        tiles = knn_stages.TILES[args[0].dtype]
        cases = [(s, knn_stages.K1_TILE) for s in range(len(
            knn_stages.STAGES))] + [(knn_stages.ROW_MIN, t) for t in tiles]
        for stage, tile in cases:
            got = knn_stages.knn_probe_raw(*args, stage=stage, tile=tile)
            want = knn_stages.knn_probe_plain(*sub, stage=stage, tile=tile)
            check_equal(f"knn_probe {dtype} {knn_stages.STAGES[stage]} "
                        f"{tile}", [g[:p] for g in got], want)
        check_equal(f"knn_probe {dtype} full against K1",
                    knn_stages.knn_probe_raw(*args),
                    knn.knn_packed_raw(*args))
        log(f"[probes] knn_probe {dtype}: {len(cases)} stage/tile cases "
            f"bit-exact on {p} of 64 pairs; full stage = K1 on all 64")
        for stage in knn_stages.P3_VARIANTS.values():
            got = knn_stages.tc_stage_raw(*args, stage=stage)
            want = knn_stages.tc_stage_plain(*sub, stage=stage)
            check_equal(f"tc_stage {dtype} {knn_stages.STAGES[stage]}",
                        [g[:p] for g in got], want)
        check_equal(f"tc_stage {dtype} full against K1",
                    knn_stages.tc_stage_raw(*args),
                    knn.knn_packed_raw(*args))
        log(f"[probes] tc_stage {dtype}: P3's "
            f"{len(knn_stages.P3_VARIANTS)} stages on the mma.sync body "
            f"bit-exact on {p} of 64 pairs; full = K1 (the wgmma body) on "
            f"all 64")
        for stage in knn_stages.P4_TC_STAGES:
            got = knn_stages.p4_stage_raw(*args, stage=stage)
            want = knn_stages.p4_stage_plain(*sub, stage=stage)
            check_equal(f"P4 {dtype} stage {stage} on the tensor cores",
                        [g[:p] for g in got], want)
        check_equal(f"P4 {dtype} stage 3 against K1",
                    knn_stages.p4_stage_raw(*args, stage=3),
                    knn.knn_packed_raw(*args))
        log(f"[probes] P4 {dtype}: its 4 stages on the mma.sync body "
            f"(row_sum by tc_row_sum, top1, top2 and full by tc_stage) "
            f"bit-exact on {p} of 64 pairs; stage 3 = K1 on all 64")


def stage_split(t):
    """K1's time split by P3's variants: product = v0, then what each
    variant adds (running_merge: v3 − v2, the top-2 kept across tiles)."""
    return {"product": t["row_min"],
            "d2_pack_top1": t["top1"] - t["row_min"],
            "top2": t["top2"] - t["top1"],
            "running_merge": t["top2"] - t["top2_tile"],
            "column": t["full"] - t["top2"]}


def run_anatomy(a, b, fargs, library):
    """P4 and P3 at bench's shape on the mma.sync body (K1's body at 128
    before the wgmma body, so that their earlier numbers stay comparable:
    tc_row_sum and tc_stage), each stage or variant in turns with
    the old bodies' (__dp4a for int8, FFMA for bf16; knn_probe), over both
    dtypes, each in its own drive. Logs each body's stage split, each
    variant beside its bound and one library product (library: {dtype:
    ms}), and whether the tensor-core times rise variant by variant."""
    inputs = {"int8": (a, b, None, None), "bf16": fargs}
    variants = {v: knn_stages.STAGES[s]
                for v, s in knn_stages.P3_VARIANTS.items()}

    def p4_sweep():
        return {d: {s: in_turns(
            lambda s=s: knn_stages.p4_stage_raw(*args, stage=s),
            lambda s=s: knn_stages.p4_stage_raw(*args, stage=s, body="old"))
            for s in knn_stages.P4_TC_STAGES} for d, args in inputs.items()}

    def p3_sweep():
        res = {}
        for d, args in inputs.items():
            res[d] = {}
            for s in knn_stages.P3_VARIANTS.values():
                new, old = in_turns(
                    lambda s=s: knn_stages.tc_stage_raw(*args, stage=s),
                    lambda s=s: knn_stages.knn_probe_raw(*args, stage=s))
                res[d][knn_stages.STAGES[s]] = (new, old)
        return res
    p4, n4 = drive("P4", p4_sweep)
    p3, n3 = drive("P3", p3_sweep)
    tc_keys = ("knn_tc_row_sum", "knn_tc_stage")
    out = {"launches": {"P4": {k: n4.get(k, 0) for k in tc_keys},
                        "P3": {"knn_tc_stage": n3.get("knn_tc_stage", 0)}}}
    pairs, n = BENCH_SHAPE
    for dtype, args in inputs.items():
        tc = {k: float(np.mean(v[0])) for k, v in p3[dtype].items()}
        old = {k: float(np.mean(v[1])) for k, v in p3[dtype].items()}
        old_body = "__dp4a" if dtype == "int8" else "FFMA"
        bnd = bound(*(k1_bound(pairs, n, 1, "int8") if dtype == "int8"
                      else k1_bound(pairs, n, 2, "bf16")))[0]
        for v, name in variants.items():
            (t1, t2), (o1, o2) = p3[dtype][name]
            log(f"[anatomy] P3 {dtype} v{v} {name}: tensor cores {t1:.3f} / "
                f"{t2:.3f} ms, {old_body} body {o1:.3f} / {o2:.3f} ms "
                f"(in turns); bound {bnd:.3f} ms, "
                f"{'torch._int_mm' if dtype == 'int8' else 'torch.bmm'} "
                f"(product only) {library[dtype]:.3f} ms")
        chain = [tc[variants[v]] for v in sorted(variants)]
        rises = all(y >= x * 0.97 for x, y in zip(chain, chain[1:]))
        log(f"[anatomy] K1 {dtype} on the tensor cores, P3 v0..v4 ms "
            f"{[round(x, 3) for x in chain]}: "
            + ("each variant within 3% of the one before or above it" if
               rises else "a variant runs more than 3% faster than the "
               "one before it"))
        k1 = [time_ms(lambda: knn.knn_packed_raw(*args), 3) for _ in "ab"]
        log(f"[anatomy] K1 {dtype} 64 x 6144 split, ms, mma.sync body: "
            + json.dumps({k: round(x, 3) for k, x in stage_split(tc).items()})
            + f" (product {100 * tc['row_min'] / tc['full']:.1f}% of K1); "
            f"{old_body} body, in turns: "
            + json.dumps({k: round(x, 3)
                          for k, x in stage_split(old).items()})
            + f" (product {100 * old['row_min'] / old['full']:.1f}%); K1 "
            f"itself (the wgmma body) {k1[0]:.3f} / {k1[1]:.3f} ms")
        p4tc = {s: float(np.mean(v[0])) for s, v in p4[dtype].items()}
        p4old = {s: float(np.mean(v[1])) for s, v in p4[dtype].items()}
        for s, ((t1, t2), (o1, o2)) in p4[dtype].items():
            log(f"[anatomy] P4 {dtype} stage {s} "
                f"({knn_stages.STAGES[knn_stages.P4_STAGES[s]]}): tensor "
                f"cores {t1:.3f} / {t2:.3f} ms, {old_body} body {o1:.3f} / "
                f"{o2:.3f} ms (in turns; {p4old[s] / p4tc[s]:.2f}x)")
        for body, t in (("tensor-core", p4tc), (old_body, p4old)):
            log(f"[anatomy] P4 {dtype} split, {body} body, ms: "
                + json.dumps({"product_row_sum": round(t[0], 3),
                              "d2_pack_top1": round(t[1] - t[0], 3),
                              "top2": round(t[2] - t[1], 3),
                              "column": round(t[3] - t[2], 3)})
                + f"; full {t[3]:.3f}")
        out[dtype] = {"tc": tc, "old": old, "p4_tc": p4tc, "p4_old": p4old,
                      "bound_ms": bnd, "library_ms": library[dtype]}
    out["knn_top2_ms"] = time_ms(lambda: knn.knn_top2(a, b), 3)
    log(f"[anatomy] P3 v5: the port's knn_top2 (K1 + decode) "
        f"{out['knn_top2_ms']:.3f} ms")
    return out


def run_tile_sweep(a, b, fargs):
    """P6 on the wgmma body K1 runs: product + row min at each tile of
    knn_stages.WG_TILES (BN 64, 128 and 256; one and two m64 halves a
    warpgroup; two and three consumer warpgroups; rings of 2 and 3), int8
    and bf16, each held bit-exact against tc_row_min_plain on all 64
    pairs, as is each tile of the mma.sync body's sweep (TC_TILES); then
    each P6_SWEEP point's wgmma tile timed in turns with the mma.sync
    body's tile of that point, with both tiles' blocks an SM (occupancy
    calculator) and ptxas's registers and spills; then both bodies at
    their K1 tiles in turns. The old bodies' row_min stage is held to its
    plain version in compare_stages. Returns ({(dtype, wgmma tile):
    measurements, (dtype, "k1"): (wgmma ms, mma.sync ms)}, launches)."""
    inputs = {"int8": (a, b), "bf16": fargs[:2]}
    for dtype, args in inputs.items():
        want = knn_stages.tc_row_min_plain(*args)
        for tile in knn_stages.TC_TILES:
            check_equal(f"tc_row_min {dtype} {tile}",
                        knn_stages.tc_row_min_raw(*args, tile), want)
        for tile in knn_stages.WG_TILES:
            check_equal(f"wg_row_min {dtype} {tile}",
                        knn_stages.wg_row_min_raw(*args, tile), want)
        del want
    log(f"[P6] wg_row_min and tc_row_min bit-exact with tc_row_min_plain "
        f"on all {len(a)} pairs at every tile, int8 and bf16: wgmma "
        f"{knn_stages.WG_TILES}, mma.sync {knn_stages.TC_TILES}")
    usage = _build.tc_kernel_usage()
    notes = [w for w in _build.ptxas_warnings() if "4TileI" in w]
    log(f"[P6] ptxas notes on the wgmma probe tiles: {notes}")

    def sweep():
        res = {}
        for dtype, args in inputs.items():
            dt = args[0].dtype
            for (ta, tb, ic), tile, tc_tile in zip(
                    knn_stages.P6_SWEEP, knn_stages.WG_TILES,
                    knn_stages.TC_TILES):
                new, old = in_turns(
                    lambda: knn_stages.wg_row_min_raw(*args, tile),
                    lambda: knn_stages.tc_row_min_raw(*args, tc_tile))
                r = {"ms": float(np.mean(new)), "was_ms": float(np.mean(old)),
                     "was_tile": tc_tile,
                     "registers": usage.get(
                         f"{dtype} {ROW_MIN_MODE} wg "
                         + " ".join(map(str, tile))),
                     "was_registers": usage.get(
                         f"{dtype} {ROW_MIN_MODE} "
                         + " ".join(map(str, tc_tile))),
                     "blocks_per_sm": knn_stages.wg_row_min_blocks(dt, tile),
                     "was_blocks_per_sm": knn_stages.tc_row_min_blocks(
                         dt, tc_tile)}
                res[(dtype, tile)] = r
                log(f"[P6] {dtype} TPU ta={ta} tb={tb} ic={ic} -> wgmma "
                    f"{tile}: {new[0]:.3f} / {new[1]:.3f} ms, "
                    f"{r['blocks_per_sm']} block(s) an SM, ptxas "
                    f"(registers, spill stores, spill loads) "
                    f"{r['registers']}; mma.sync {tc_tile}: {old[0]:.3f} / "
                    f"{old[1]:.3f} ms, {r['was_blocks_per_sm']} blocks an "
                    f"SM, {r['was_registers']} ({r['was_ms'] / r['ms']:.2f}x)")
            k1 = knn_stages.K1_WG_TILE[dt]
            new, old = in_turns(
                lambda: knn_stages.wg_row_min_raw(*args, k1),
                lambda: knn_stages.tc_row_min_raw(*args))
            res[(dtype, "k1")] = (float(np.mean(new)), float(np.mean(old)))
            log(f"[P6] {dtype} at K1's tiles, in turns: wgmma {k1} "
                f"{new[0]:.3f} / {new[1]:.3f} ms, mma.sync "
                f"{knn_stages.K1_TC_TILE} {old[0]:.3f} / {old[1]:.3f} ms")
        return res
    return drive("P6", sweep)


def run_mma(bt_int):
    """P5: the wgmma product + row sum held against its plain version
    (integer values bit-exact at every K, tile and split; normal values
    within P5_REL_TOL), and its first body (v0) likewise at its tiles;
    then one 6144 x 6144 matrix's K and tile sweeps (the kernel's profiler
    device time: CUDA events around one call of ~10 µs of work time the
    wrapper), each tile at bench's batch, and the batch in turns with v0,
    beside torch.bmm and torch._int_mm, with each tile's plan (ring
    stages, K passes, blocks an SM) and ptxas's registers and spills."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    M = 6144
    err = 0.0
    for K in mma.K_SWEEP:
        xi = torch.randint(-2, 3, (2, M, K), generator=gen,
                           device="cuda").bfloat16()
        yi = torch.randint(-2, 3, (2, M, K), generator=gen,
                           device="cuda").bfloat16()
        want = mma.mm_rowsum_plain(xi, yi)
        for raw, tiles in ((mma.mm_rowsum_raw, mma.TILES),
                           (mma.mm_rowsum_v0_raw, mma.V0_TILES)):
            for tile in tiles:
                for split in (1, 4):
                    check_equal(f"{raw.__name__} K={K} {tile} split {split}",
                                [raw(xi, yi, tile, split)], [want])
        x = torch.randn((1, M, K), generator=gen, device="cuda").bfloat16()
        y = torch.randn((1, M, K), generator=gen, device="cuda").bfloat16()
        want = mma.mm_rowsum_plain(x, y)
        lim = P5_REL_TOL * float(want.abs().max())
        for raw in (mma.mm_rowsum_raw, mma.mm_rowsum_v0_raw):
            e = float((raw(x, y) - want).abs().max())
            if not e <= lim:
                raise AssertionError(f"{raw.__name__} K={K} normal inputs: "
                                     f"{e} > {lim}")
            if raw is mma.mm_rowsum_raw:
                err = max(err, e)
    log(f"[P5] wgmma mm_rowsum bit-exact on integer values at K "
        f"{mma.K_SWEEP} x tiles {mma.TILES} x split (1, 4), v0 at its tiles "
        f"{mma.V0_TILES}; normal values within {err:.3g} (limit "
        f"{P5_REL_TOL} of the largest sum)")
    xb = torch.randn((64, M, 128), generator=gen, device="cuda").bfloat16()
    yb = torch.randn((64, M, 128), generator=gen, device="cuda").bfloat16()
    xi, yi = xb.round().clamp(-2, 2), yb.round().clamp(-2, 2)
    want = mma.mm_rowsum_plain(xi[:2], yi[:2])
    for raw in (mma.mm_rowsum_raw, mma.mm_rowsum_v0_raw):
        check_equal(f"{raw.__name__} batch 64 (integer values)",
                    [raw(xi, yi)[:2]], [want])
    del xi, yi
    usage = _build.wg_kernel_usage()
    peak = PEAK["bf16"]

    def sweep():
        res = {"k": {}, "tile": {}, "batch": {}}
        for K in mma.K_SWEEP:
            x = torch.randn((1, M, K), generator=gen, device="cuda").bfloat16()
            y = torch.randn((1, M, K), generator=gen, device="cuda").bfloat16()
            ms = device_ms(lambda: mma.mm_rowsum_raw(x, y), WG_KERNEL)
            lib = device_ms(lambda: torch.mm(x[0], y[0].T))
            f = 2 * M * M * K
            res["k"][K] = ms
            log(f"[P5] wgmma K={K} tile {mma.DEFAULT_TILE}, one matrix "
                f"(split {mma.wg_split(1, M, M, mma.DEFAULT_TILE, 'cuda')}, "
                f"plan {mma.wg_plan(mma.DEFAULT_TILE, K)}): {ms:.4f} ms "
                f"{f / ms / 1e9:.1f} TFLOP/s, {f / peak / ms * 1e5:.1f}% "
                f"of the bound (device time); torch.mm (product only) "
                f"{lib:.4f} ms {f / lib / 1e9:.1f} TFLOP/s")
        x = torch.randn((1, M, 128), generator=gen, device="cuda").bfloat16()
        y = torch.randn((1, M, 128), generator=gen, device="cuda").bfloat16()
        f = 2 * M * M * 128
        for tpu, tile in mma.P5_TILES.items():
            ms = device_ms(lambda: mma.mm_rowsum_raw(x, y, tile), WG_KERNEL)
            res["tile"][tile] = ms
            log(f"[P5] K=128 TPU (ta, tb)={tpu} -> tile {tile}, one matrix: "
                f"{ms:.4f} ms {f / ms / 1e9:.1f} TFLOP/s, "
                f"{f / peak / ms * 1e5:.1f}% of the bound")
        f = 2 * 64 * M * M * 128
        for tile in mma.TILES:
            ms = device_ms(lambda: mma.mm_rowsum_raw(xb, yb, tile),
                           WG_KERNEL, 5)
            res["batch"][tile] = ms
            log(f"[P5] batch 64 x {M} x {M} x 128 tile {tile}: {ms:.3f} ms "
                f"{f / ms / 1e9:.1f} TFLOP/s, {f / peak / ms * 1e5:.1f}% of "
                f"the bound (device time); plan {mma.wg_plan(tile, 128)}, "
                f"ptxas (registers, "
                f"spill stores, spill loads) {usage.get(tile)}")
        calls = {WG_KERNEL: lambda: mma.mm_rowsum_raw(xb, yb),
                 "mm_rowsum_kernel": lambda: mma.mm_rowsum_v0_raw(xb, yb)}
        res["turns"] = {k: [] for k in calls}
        for k in (WG_KERNEL, "mm_rowsum_kernel", "mm_rowsum_kernel",
                  WG_KERNEL):
            res["turns"][k].append(device_ms(calls[k], k, 5))
        res["events"] = in_turns(*calls.values())
        return res
    res, counts = drive("P5", sweep)
    (n1, n2), (o1, o2) = res["turns"].values()
    ev, was_ev = (float(np.mean(t)) for t in res["events"])
    ybt = yb.transpose(1, 2)
    bmm = time_ms(lambda: torch.bmm(xb, ybt), 3)
    del ybt
    a2 = torch.randn((M, 1024), generator=gen, device="cuda").bfloat16()
    b2 = torch.randn((1024, M), generator=gen, device="cuda").bfloat16()
    k1024 = time_ms(lambda: torch.mm(a2, b2).float().sum(1), 5)
    del a2, b2
    f = 2 * 64 * M * M * 128
    ms, was = float(np.mean([n1, n2])), float(np.mean([o1, o2]))
    one, per_flop = res["k"][128], res["k"][512] / 4 / res["k"][128]
    log(f"[P5] batch 64 at bench's shape, in turns, device time: wgmma "
        f"{mma.DEFAULT_TILE} {n1:.3f} / {n2:.3f} ms ({f / ms / 1e9:.1f} "
        f"TFLOP/s, {f / peak / ms * 1e5:.1f}% of the bound), v0 "
        f"{mma.V0_K_SWEEP_TILE} {o1:.3f} / {o2:.3f} ms ({was / ms:.2f}x); "
        f"CUDA events around a call {ev:.3f} ms, v0 {was_ev:.3f}; "
        f"one matrix at K=128 {one:.4f} ms = {64 * one / ms:.2f}x the "
        f"batch's per matrix; K=512 {per_flop:.3f}x K=128's time a flop; "
        f"torch.bmm bf16 (product only) {bmm:.3f} ms "
        f"{f / bmm / 1e9:.1f} TFLOP/s; torch._int_mm (product only) "
        f"{bt_int:.3f} ms {f / bt_int / 1e9:.1f} TOP/s; K=1024 control "
        f"(torch.mm + row sum) {k1024:.3f} ms "
        f"{2 * M * M * 1024 / k1024 / 1e9:.1f} TFLOP/s")
    plain = time_ms(lambda: mma.mm_rowsum_plain(xb, yb), 1)
    r = {"max_abs_err": err, "ms": ms, "was_ms": was, "event_ms": ev,
         "was_event_ms": was_ev, "was_tile": mma.V0_K_SWEEP_TILE,
         "plain_ms": plain, "timed_by": "profiler device time",
         "sweep": {"k_ms": res["k"],
                   "tile_ms": {str(t): v for t, v in res["tile"].items()},
                   "batch_ms": {str(t): v for t, v in res["batch"].items()}}}
    # A and B read once, the row sums written once; 2·M·N·K flops a matrix
    return (with_bound(r, 64 * (2 * M * 128 * 2 + M * 4), {"bf16": f},
                       library_ms=bmm),
            {"mm_rowsum_wg": counts.get("mm_rowsum_wg", 0)})


def run_gather():
    """P1: the one-hot gather of hi/mid/lo limbs (T = 128, N = 6144, the
    script's seed): the one-launch kernel and its first body (v0) each
    bit-exact with the plain "bf16" version; the per-limb error against
    exact f32 is P1's answer. Timed in turns (new, v0, v0, new): the
    kernel's profiler device time, the whole call's (every kernel one
    call launches) and CUDA events around one call; index_select beside."""
    rng = np.random.default_rng(1)
    T, N = 128, 6144
    j = torch.from_numpy(rng.integers(0, N, (T,)).astype(np.int32)).cuda()
    u = torch.from_numpy(rng.uniform(0, 4100, (N,)).astype(np.float32)).cuda()
    vals = mma.limbs(u)
    want = mma.onehot_gather_plain(j, vals, "bf16")
    got = mma.onehot_gather_raw(j, vals)
    check_equal("onehot_gather", [got], [want])
    check_equal("onehot_gather_v0", [mma.onehot_gather_v0_raw(j, vals)],
                [want])
    exact = mma.onehot_gather_plain(j, vals, "f32")
    limb_err = (got - exact).abs().amax(0).tolist()
    rec = float(((got[:, 0] + got[:, 1]) + got[:, 2] - u[j.long()])
                .abs().max())
    calls = {"new": lambda: mma.onehot_gather_raw(j, vals),
             "v0": lambda: mma.onehot_gather_v0_raw(j, vals)}
    kernel = {"new": "onehot_gather_kernel", "v0": "onehot_gather_v0_kernel"}

    def run():
        t = {k: {"kernel": [], "call": [], "events": [], "kernels": 0}
             for k in calls}
        for k in ("new", "v0", "v0", "new"):
            per = probes.device_kernels(calls[k])
            t[k]["kernel"].append(sum(x for name, x in per.items()
                                      if kernel[k] in name))
            t[k]["call"].append(sum(per.values()))
            t[k]["kernels"] = len(per)
            t[k]["events"].append(time_ms(calls[k], 20))
        return t
    t, counts = drive("P1", run)
    if t["new"]["kernels"] != 1:
        raise AssertionError(f"onehot_gather_raw launched "
                             f"{t['new']['kernels']} kernels a call")
    lib = device_ms(lambda: torch.index_select(vals, 1, j))
    mean = {k: {m: float(np.mean(v[m])) for m in ("kernel", "call", "events")}
            for k, v in t.items()}
    r = {"max_abs_err": 0.0, "ms": mean["new"]["kernel"],
         "call_device_ms": mean["new"]["call"],
         "event_ms": mean["new"]["events"],
         "was_ms": mean["v0"]["kernel"],
         "was_call_device_ms": mean["v0"]["call"],
         "was_event_ms": mean["v0"]["events"],
         "was_kernels_a_call": t["v0"]["kernels"],
         "plain_ms": device_ms(lambda: mma.onehot_gather_plain(j, vals)),
         "timed_by": "profiler device time"}

    def pair(k, m):
        return f"{t[k][m][0]:.4f} / {t[k][m][1]:.4f}"
    log(f"[P1] one-hot mma.sync gather T={T} N={N}: both bodies bit-exact "
        f"with the bf16 plain version; per-limb max error against exact "
        f"f32 (hi, mid, lo) {limb_err}; recombined max error {rec:.3g}")
    log(f"[P1] in turns, ms: kernel device time {pair('new', 'kernel')} "
        f"(v0 {pair('v0', 'kernel')}); whole call device time, "
        f"{t['new']['kernels']} kernel(s) {pair('new', 'call')} (v0, "
        f"{t['v0']['kernels']} kernels, {pair('v0', 'call')}); CUDA events "
        f"{pair('new', 'events')} (v0 {pair('v0', 'events')}); plain "
        f"{r['plain_ms']:.4f}, index_select {lib:.4f} (device time)")
    # j, the f32 limbs and the output once; the one-hot product's flops
    return (with_bound(r, 4 * T + 4 * 3 * N + 12 * T,
                       {"bf16": 2 * T * N * 3}, library_ms=lib),
            {"onehot_gather": counts.get("onehot_gather", 0)})


def fused_usage():
    """ptxas's (registers, spill stores, spill loads) of P2's
    instantiations (kFused and its flags: modes 16-31) on both tensor-core
    bodies: the wgmma body's keyed "int8 MODE wg ROWS BN RING CONSUMERS",
    the mma.sync body's "int8 MODE BM BN STAGES"; empty when the library
    was already built."""
    return {k: v for k, v in _build.tc_kernel_usage().items()
            if 16 <= int(k.split()[1]) < 32}


def run_fused(a, b, uv_b):
    """P2: K1 + K4 in one launch on bench's workload, on the wgmma body,
    the mma.sync body and the old __dp4a body. full, nopb, epi32 and t64
    on each equal the port's knn_match_fused (two launches) on all 64
    pairs (bj, ok, and pb where COMPARED says so), every pair's counter
    back at 0 after each launch; full on the wgmma body equals its plain
    version on the first pairs; noepi and nomain are timed only. Every
    variant on the wgmma body in turns with the mma.sync body's (wg, tc,
    tc, wg; full with K1 then K4 and the wgmma body's noepi between): the
    profiler's device time of every kernel a call launches, and CUDA
    events (the old body's timing turns are cut: it is held bit-exact
    only). Logs the kernels each side ran, the wgmma instantiations'
    registers, spills, ptxas notes and blocks an SM (no spill and no note
    allowed), and the mma.sync body's (two blocks an SM, no spill)."""
    want = knn.knn_match_fused(a, b, uv_b, 0.75)
    for body in fused.BODIES:
        for v, (c_bj, c_ok, c_pb) in fused.COMPARED.items():
            got = fused.fused_probe_raw(a, b, uv_b, v, body)
            pairs = [(got[0], want[0])] * c_bj + \
                [(got[1].bool(), want[1])] * c_ok + [(got[2], want[2])] * c_pb
            check_equal(f"knn_fused_probe {v} ({body} body) against "
                        f"knn_match_fused", [g for g, _ in pairs],
                        [w for _, w in pairs])
            counter = fused._COUNTERS[(a.device, len(a))]
            if int(counter.abs().sum()):
                raise AssertionError(f"knn_fused_probe {v} ({body} body) "
                                     f"left its counters at "
                                     f"{counter.tolist()}")
    p = PROBE_PLAIN_PAIRS
    check_equal("knn_fused_probe full against its plain version",
                [x[:p] for x in fused.fused_probe_raw(a, b, uv_b)],
                fused.fused_probe_plain(a[:p], b[:p], uv_b[:p]))
    usage = fused_usage()
    wg_usage = {k: u for k, u in usage.items() if k.split()[2] == "wg"}
    # ptxas's notes (e.g. C7518, wgmma serialized) on P2's wgmma kernels
    notes = [w for w in _build.ptxas_warnings() if re.search(
        r"4TileIaLi(384|192)ELi64ELi2ELi3EEELi(1[6-9]|2\d|3[01])EE", w)]
    blocks = {(body, v): fused.fused_probe_blocks(v, body)
              for body in ("wg", "tc") for v in ("full", "t64")}
    log(f"[P2] all three bodies equal knn_match_fused on all {len(a)} pairs "
        f"(full, nopb, epi32, t64), counters back at 0; instantiations, "
        f"ptxas (registers, spill stores, spill loads): {usage}; wgmma "
        f"notes: {notes}; blocks an SM: {blocks}")
    if ((_build.build_log and len(wg_usage) != 6) or notes
            or any(st or ld for _, st, ld in wg_usage.values())
            or min(blocks["wg", v] for v in ("full", "t64")) < 1):
        raise AssertionError(f"P2's wgmma kernels must build without spill "
                             f"or note and launch: {wg_usage}, {notes}, "
                             f"{blocks}")
    if any(r > 128 or st or ld for k, (r, st, ld) in usage.items()
           if k.split()[2] == "128") or blocks["tc", "full"] != 2:
        raise AssertionError(f"P2's mma.sync kernel at BM 128 must hold two "
                             f"blocks an SM without spills: {usage}, "
                             f"{blocks}")
    extra = {"two_launch": lambda: knn.knn_match_fused(a, b, uv_b, 0.75),
             "wg_noepi": lambda: fused.fused_probe_raw(a, b, uv_b, "noepi")}

    def sweep():
        t = {}
        for v in fused.VARIANTS:
            calls = {body: (lambda body=body: fused.fused_probe_raw(
                a, b, uv_b, v, body)) for body in ("wg", "tc")}
            order = ("wg", "tc", "tc", "wg")
            if v == "full":     # with K1 then K4, and full less its tail
                calls.update(extra)
                order = ("wg", "wg_noepi", "two_launch", "tc", "tc",
                         "two_launch", "wg_noepi", "wg")
            t[v] = {k: {"device": [], "events": [], "kernels": []}
                    for k in calls}
            for k in order:
                per = probes.device_kernels(calls[k])
                t[v][k]["device"].append(sum(per.values()))
                t[v][k]["kernels"].append(per)
                t[v][k]["events"].append(time_ms(calls[k], 3))
        return t
    t, counts = drive("P2", sweep)
    mean = {v: {k: {m: float(np.mean(x[m])) for m in ("device", "events")}
                for k, x in tv.items()} for v, tv in t.items()}
    for v, tv in t.items():
        log(f"[P2] {v} in turns, ms, device time of a call / CUDA events: "
            + "; ".join(f"{k} {x['device'][0]:.3f} / {x['device'][1]:.3f}, "
                        f"{x['events'][0]:.3f} / {x['events'][1]:.3f}"
                        for k, x in tv.items()))
    kernels = {k: {name: float(np.mean([per.get(name, 0.0)
                                        for per in x["kernels"]]))
                   for name in x["kernels"][0]}
               for k, x in t["full"].items()}
    log(f"[P2] full, each kernel of a call, device ms, mean of the turns: "
        f"{json.dumps(kernels)}")

    def kernel_ms(k, name):
        return sum(ms for kn, ms in kernels[k].items() if name in kn)
    split = {"kernel_ms": kernel_ms("wg", "knn_wg_kernel"),
             "noepi_kernel_ms": kernel_ms("wg_noepi", "knn_wg_kernel"),
             "k1_ms": kernel_ms("two_launch", "knn_wg_kernel"),
             "k4_ms": kernel_ms("two_launch", "match_epilogue_kernel"),
             "was_kernel_ms": kernel_ms("tc", "knn_tc_kernel")}

    def bodies(k):
        """The 2-NN kernels that call k launched, by name."""
        return sorted({kn.split("(")[0].replace("void ", "")
                       for kn in kernels[k]
                       if "knn_wg_kernel" in kn or "knn_tc_kernel" in kn})
    ran = {k: bodies(k) for k in ("wg", "tc", "two_launch")}
    log(f"[P2] kernels: the single launch on the wgmma body ran "
        f"{ran['wg']}, on the mma.sync body {ran['tc']}; its yardstick K1 "
        f"then K4 ran {ran['two_launch']}")
    if (len(ran["wg"]) != 1 or "knn_wg_kernel" not in ran["wg"][0]
            or len(ran["tc"]) != 1 or "knn_tc_kernel" not in ran["tc"][0]):
        raise AssertionError(f"P2's bodies ran other kernels: {ran}")
    full = mean["full"]
    log(f"[P2] full: wgmma {full['wg']['device']:.3f} ms against K1 then K4 "
        f"{full['two_launch']['device']:.3f} "
        f"({full['two_launch']['device'] / full['wg']['device']:.3f}x) and "
        f"the mma.sync body {full['tc']['device']:.3f} "
        f"({full['tc']['device'] / full['wg']['device']:.2f}x); kernels "
        f"alone, ms: {json.dumps(split)}")
    pairs, n = a.shape[:2]
    r = {"max_abs_err": 0.0, "ms": full["wg"]["device"],
         "event_ms": full["wg"]["events"], "was_ms": full["tc"]["device"],
         "was_event_ms": full["tc"]["events"],
         "two_launch_ms": full["two_launch"]["device"],
         "kernels_a_call": {k: len(x) for k, x in kernels.items()},
         **split, "body": ran["wg"][0],
         "variants": {v: {"ms": m["wg"]["device"],
                          "was_ms": m["tc"]["device"],
                          "event_ms": m["wg"]["events"],
                          "was_event_ms": m["tc"]["events"]}
                      for v, m in mean.items()},
         "was_launches": counts.get("knn_fused_probe_tc", 0),
         "timed_by": "profiler device time, every kernel of a call",
         "plain_ms": time_ms(lambda: fused.fused_probe_plain(a, b, uv_b), 1)}
    # a, b and uv_b read once; bj, ok (int32) and pb written once
    return (with_bound(r, pairs * n * (2 * 128 + 8 + 4 + 4 + 8),
                       {"int8": 2 * pairs * n * n * 128}),
            {"knn_fused_probe": counts.get("knn_fused_probe", 0)})


def run_probes():
    """Phase 15: K1 and K4 anatomy — P1–P6 at their probes' full shapes,
    each held against its plain version, each driven on its own."""
    t0 = time.perf_counter()
    a, b, uv_b, fargs = probe_inputs()
    compare_stages(a, b, fargs)
    bt = b[0].t()
    int_mm = time_ms(lambda: torch._int_mm(a.reshape(-1, 128), bt), 3)
    del bt
    bmm = time_ms(lambda: torch.bmm(fargs[0], fargs[1].transpose(1, 2)), 3)
    anatomy = run_anatomy(a, b, fargs, {"int8": int_mm, "bf16": bmm})
    p6, n6 = run_tile_sweep(a, b, fargs)
    p5, n5 = run_mma(int_mm)
    p1, n1 = run_gather()
    p2, n2 = run_fused(a, b, uv_b)
    pairs, n = BENCH_SHAPE
    out = {"P5": (p5, n5), "P1": (p1, n1), "P2": (p2, n2)}
    i8 = (a, b, None, None)
    # P4: stage 0 int8 on the tensor-core body (tc_row_sum), the old
    # __dp4a body's as "was"; every stage of both dtypes on both bodies;
    # the plain version at the full 64 pairs, timed once
    r = {"max_abs_err": 0.0, "ms": anatomy["int8"]["p4_tc"][0],
         "was_ms": anatomy["int8"]["p4_old"][0],
         "plain_ms": time_ms(lambda: knn_stages.p4_stage_plain(
             *i8, stage=0), 1),
         "stages": {d: {"ms": anatomy[d]["p4_tc"],
                        "was_ms": anatomy[d]["p4_old"],
                        "bound_ms": anatomy[d]["bound_ms"],
                        "library_ms": anatomy[d]["library_ms"]}
                    for d in ("int8", "bf16")}}
    out["P4"] = (with_bound(r, *k1_bound(pairs, n, 1, "int8"),
                            library_ms=int_mm), anatomy["launches"]["P4"])
    # P3: v0 on the tensor-core body, int8, the old body's as "was"; every
    # variant of both dtypes beside its bound and library product
    r = {"max_abs_err": 0.0, "ms": anatomy["int8"]["tc"]["row_min"],
         "was_ms": anatomy["int8"]["old"]["row_min"],
         "plain_ms": time_ms(lambda: knn_stages.tc_stage_plain(
             *i8, stage=knn_stages.ROW_MIN), 1),
         "variants": {d: {"ms": anatomy[d]["tc"],
                          "was_ms": anatomy[d]["old"],
                          "bound_ms": anatomy[d]["bound_ms"],
                          "library_ms": anatomy[d]["library_ms"]}
                      for d in ("int8", "bf16")}}
    out["P3"] = (with_bound(r, *k1_bound(pairs, n, 1, "int8"),
                            library_ms=int_mm), anatomy["launches"]["P3"])
    # P6: the wgmma body at K1 bf16's tile (its int8 at K1 int8's beside
    # it), with the mma.sync body at its K1 tile as "was"; every tile of
    # the sweep in "sweep"
    (ms, was), (ms8, was8) = p6[("bf16", "k1")], p6[("int8", "k1")]
    r = {"max_abs_err": 0.0, "ms": ms, "was_ms": was, "int8_ms": ms8,
         "int8_was_ms": was8,
         "was_tile": [knn_stages.K1_TC_TILE, knn_stages.K1_TC_TILE],
         "int8_bound_ms": bound(*k1_bound(pairs, n, 1, "int8"))[0],
         "int8_library_ms": int_mm,
         "sweep": {f"{d} {' '.join(map(str, t))}": v
                   for (d, t), v in p6.items() if t != "k1"},
         "plain_ms": time_ms(lambda: knn_stages.wg_row_min_plain(
             *fargs[:2]), 1)}
    out["P6"] = (with_bound(r, *k1_bound(pairs, n, 2, "bf16"),
                            library_ms=bmm),
                 {"knn_wg_row_min": n6.get("knn_wg_row_min", 0)})
    check_wg_sass()
    log(f"[probes] phase 15 in {time.perf_counter() - t0:.1f} s")
    return out


def check_wg_sass():
    """The wgmma body's production instantiations (K1, K3 and the
    product-only stage at 128 and 256 values a row) compiled to the same
    SASS as the digests recorded before the probes' tiles and modes
    joined the body (_build.WG_SASS): raises on any difference where the
    same nvcc built both; prints the nvcc versions where they differ."""
    was_nvcc, nvcc, n, diff = _build.wg_sass_changes()
    if was_nvcc != nvcc:
        log(f"[probes] wgmma SASS digests not compared: recorded by "
            f"{was_nvcc!r}, this build by {nvcc!r}")
        return
    log(f"[probes] wgmma SASS of the {n} production instantiations "
        f"{'equal to' if not diff else 'DIFFERS from'} the recorded "
        f"digests ({nvcc}){'' if not diff else f': {diff}'}")
    if diff:
        raise AssertionError(f"production wgmma SASS changed: {diff}")


def mission_outcome(proj_dir, m):
    """A finished run's workspace against the mission's truth: (proj, its
    run log, the stage walls, each "BA finished" mre, the groups, each
    camera's distance from its true position, the median point's height
    above the ground). m is a make_mission Mission or a SyntheticMission
    that has generated its poses: its names and true_camera_ned(ref_lla)
    give the truth."""
    proj = ProjectMgr(proj_dir)
    proj.load_images_info()
    run_log = "".join(open(f).read() for f in glob.glob(
        os.path.join(proj.analysis_dir, "messages-*")))
    walls = {k: float(v) for k, v in
             re.findall(r"stage wall: (\S+) ([\d.]+)s", run_log)}
    mre = [float(v) for v in re.findall(r"BA finished: mre=([\d.]+)px",
                                        run_log)]
    grps = groups.load(proj.analysis_dir)
    truth = m.true_camera_ned(proj.ned_reference_lla())
    by_name = {name: i for i, name in enumerate(m.names)}
    err = np.array([np.linalg.norm(np.asarray(im.get_camera_pose(
        opt=im.has_opt_pose())[0]) - truth[by_name[im.name]])
        for im in proj.image_list])
    matches = proj.load_matches_grouped()
    height = -np.median([mm[0][2] for mm in matches if mm[0] is not None])
    return proj, run_log, walls, mre, grps, err, height


def run_process(root, smi):
    """Phase 16: apps/process.py's Steps 1→5 on the card from a folder of
    JPEGs (the 64-frame mission of phases 7–8, written by nvJPEG), with
    benchmarks/mission_bench.py's arguments; then the same command again,
    which must skip every stage. Returns the run's launches."""
    W, H = FRAME
    m = make_mission(strips=STRIPS, per_strip=PER_STRIP, size=FRAME, seed=0,
                     device="cuda")
    proj_dir = os.path.join(root, "mission")
    db = os.path.join(root, "cameras")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    paths = write_mission(proj_dir, m, db)
    encode_ms = 1e3 * (time.perf_counter() - t0) / len(paths)
    argv = [proj_dir, "--camera", CAMERA_KEY, "--camera-db", db,
            "--scale", "1.0", "--ground", "0.0", "--batch-size", "32",
            "--min-chain-len", "2", "--detector", "TPU",
            "--max-features", str(MAX_FEATURES)]
    jpeg.decode_gray(paths[0], "cuda")               # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in paths:
        jpeg.decode_gray(p, "cuda")
    torch.cuda.synchronize()
    decode_ms = 1e3 * (time.perf_counter() - t0) / len(paths)

    reset_launches()
    t0 = time.perf_counter()
    rc = process.main(argv)
    wall = time.perf_counter() - t0
    launches = read_launches()
    if rc != 0:
        raise AssertionError(f"process.main returned {rc}")
    checks, outcome = process_outcome(proj_dir, m, len(paths))

    reset_launches()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc2 = process.main(argv)
    again = [ln for ln in out.getvalue().splitlines()
             if ln.startswith("Step ")]
    again_launches = {k: v for k, v in read_launches().items() if v}

    log(f"[process] {len(paths)} JPEGs {W}x{H}; main {wall:.3f} s; "
        f"{outcome['summary']}; launches {launches}")
    log("[process] " + json.dumps({
        "stage_wall_s": outcome["walls"],
        "nvjpeg_decode_gray_ms_per_frame": decode_ms,
        "nvjpeg_encode_ms_per_frame": encode_ms,
        "frame": [W, H], "device": smi}))
    log(f"[process] second main: rc {rc2}, stages run {again}, launches "
        f"{again_launches}")
    checks.update({
        "K1 int8 and K2 launched": launches["knn_packed_i8"] > 0
        and launches["gauss_blur_f32"] > 0,
        "resume skips every stage": rc2 == 0 and not again
        and not again_launches,
        "no PIL or cv2 imported": not {"PIL", "cv2"} & set(sys.modules),
    })
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 16 failed: {failed}")
    return launches, wall, outcome["cams"]


def camera_positions(proj):
    """{image name: its camera's NED position} of a workspace, optimized
    where BA wrote one."""
    return {im.name: np.asarray(im.get_camera_pose(opt=im.has_opt_pose())[0])
            for im in proj.image_list}


def process_outcome(proj_dir, m, n_frames, n_ba=1):
    """Phase 16's checks of a finished run (the outcome, not the
    launches): STEP5, features in every 2176×1440 frame, group 0 ≥
    90%, n_ba BA runs and the last one's mre ≤ 1 px, cameras within 3 m
    of the truth, the median point within 1 m of the ground, every render
    output, an egg for all frames but one and a 512×512 texture for each.
    Returns (checks, {the stage walls, the cameras, a summary line, the
    run log, each camera's error, the median point's height, the group
    sizes, the BA mres, features a frame, eggs, textures})."""
    W, H = FRAME
    proj, run_log, walls, mre, grps, err, height = mission_outcome(proj_dir,
                                                                  m)
    counts, sizes = [], []
    for im in proj.image_list:
        im.load_features()
        counts.append(0 if im.kp is None else len(im.kp))
        sizes.append(im.get_size())
    models = proj.models_dir
    files = os.listdir(models)
    eggs = [f for f in files if f.endswith(".egg")]
    texs = [f for f in files if f.endswith(".JPG")]
    tex_shapes = {tuple(jpeg.decode_bgr(os.path.join(models, f), "cuda")
                        .shape) for f in texs}
    checks = {
        "STEP5 reached": proj.state.check("STEP5"),
        "features in every frame": len(counts) == n_frames
        and min(counts) > 0,
        f"frames {W}x{H}": set(sizes) == {(W, H)},
        "group 0 holds >= 90%": bool(grps)
        and len(grps[0]) >= 0.9 * n_frames,
        "BA mre <= 1 px": len(mre) == n_ba and mre[-1] <= 1.0,
        "cameras within 3 m": err.max() < 3.0,
        "median point within 1 m": abs(height) <= 1.0,
        "render outputs": all(os.path.isfile(os.path.join(models, f))
                              for f in ("surface.bin", "dummy.jpg",
                                        "surface-global.ac", "direct.ac")),
        f">= {n_frames - 1} eggs": len(eggs) >= n_frames - 1,
        f"{n_frames} textures 512x512": len(texs) == n_frames
        and tex_shapes == {(512, 512, 3)},
    }
    summary = (f"features/frame min {min(counts)} mean "
               f"{np.mean(counts):.0f}; groups {[len(g) for g in grps]}; "
               f"BA mre {mre}; camera error vs truth median "
               f"{np.median(err):.4f} max {err.max():.4f} m; median point "
               f"{height:.4f} m above the ground; {len(eggs)} eggs, "
               f"{len(texs)} textures {sorted(tex_shapes)}")
    return checks, {"walls": walls, "cams": camera_positions(proj),
                    "summary": summary, "run_log": run_log, "proj": proj,
                    "err": err, "height": height,
                    "groups": [len(g) for g in grps], "mre": mre,
                    "features": counts, "eggs": len(eggs),
                    "textures": len(texs)}


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _pix4d_rows(path):
    return [ln.split(",") for ln in open(path).read().splitlines()[1:]]


def two_view_batch(gen, pairs, n, n_planted, K, dev="cuda"):
    """bench.py's descriptor batch (planted_descriptors) with uv of a
    non-planar two-view scene: the planted rows see points 80–160 m deep
    from two cameras ~15 m and 4–8° apart, projected through K with
    0.3 px noise; the other rows lie uniformly in the frame. Returns
    (desc_a, desc_b, uv_a, uv_b)."""
    rng = np.random.default_rng(17)
    a, b = planted_descriptors(gen, pairs, n, n_planted)
    W, H = 2 * K[0, 2], 2 * K[1, 2]
    uv = rng.uniform(0, 1, (2, pairs, n, 2)) * [W, H]
    for p in range(pairs):
        depth = rng.uniform(80, 160, n_planted)
        pix = np.c_[rng.uniform(0, W, n_planted), rng.uniform(0, H, n_planted)]
        X = (np.c_[pix, np.ones(n_planted)] @ np.linalg.inv(K).T) \
            * depth[:, None]
        ang = np.radians(4.0 + 4.0 * p / pairs)
        R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                      [-np.sin(ang), 0, np.cos(ang)]])
        xb = (X @ R.T + [12.0, 8.0, 1.0]) @ K.T
        uv[0, p, :n_planted] = pix
        uv[1, p, :n_planted] = xb[:, :2] / xb[:, 2:] + rng.normal(
            0, 0.3, (n_planted, 2))
    uv_a, uv_b = (torch.from_numpy(u.astype(np.float32)).to(dev) for u in uv)
    return a, b, uv_a, uv_b


def run_transforms(proj_dir, smi, dev="cuda", pairs=BENCH_SHAPE[0],
                   n=BENCH_SHAPE[1], n_planted=1500):
    """Phase 17d: the device fundamental and essential filters at bench's
    batch on a non-planar scene (the 8-point filters degenerate on flat
    ground): in every pair ≥ 90% of the planted matches survive and ≤ 5
    others pass; ms a batch beside homography's, and the batched 3×3
    torch.linalg.svd the 8-point solves call. Then find_matches with the
    host essential5 refilter on a copy of phase 17a's workspace (the
    store path, the sequential work list): every along-track neighbour
    keeps ≥ 50 matches."""
    W, H = FRAME
    fx = 1400.0 * W / 2176.0
    K = np.array([[fx, 0, W / 2.0], [0, fx, H / 2.0], [0, 0, 1.0]])
    gen = torch.Generator(device=dev).manual_seed(5)
    a, b, uv_a, uv_b = two_view_batch(gen, pairs, n, n_planted, K, dev)
    counts = torch.full((pairs,), n, dtype=torch.int32, device=dev)
    Kt = torch.from_numpy(K.astype(np.float32)).to(dev)
    rows = torch.arange(n, device=dev)
    out, ms = {}, {}
    for t in ("homography", "fundamental", "essential"):
        def batch():
            return matcher.match_pair_batch(
                a, b, uv_a, uv_b, counts, counts, gen, ratio=0.75,
                thresh=3.0, transform=t, n_hyp=512, K=Kt)
        best_j, ok = batch()
        reps = []
        for _ in range(3):
            _sync(dev)
            t0 = time.perf_counter()
            batch()
            _sync(dev)
            reps.append(1e3 * (time.perf_counter() - t0))
        ms[t] = float(np.median(reps))
        planted = ok & (best_j == rows) & (rows < n_planted)
        out[t] = (int(planted.sum(1).min()),
                  int((ok & ~planted).sum(1).max()))
    svd_in = torch.randn((pairs * 512, 3, 3), generator=gen, device=dev)
    torch.linalg.svd(svd_in)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(5):
        torch.linalg.svd(svd_in)
    _sync(dev)
    svd_ms = 1e3 * (time.perf_counter() - t0) / 5

    ws = os.path.join(os.path.dirname(proj_dir), "essential5")
    shutil.copytree(proj_dir, ws)
    for f in glob.glob(os.path.join(ws, "ImageAnalysis", "meta", "*.match")):
        os.remove(f)
    proj = ProjectMgr(ws)
    proj.load_images_info()
    t0 = time.perf_counter()
    matcher.find_matches(proj, matcher.MatchConfig(transform="essential5",
                                                   batch_size=32),
                         use_distance=False, device=dev)
    e5_s = time.perf_counter() - t0
    il = proj.image_list
    along = [len(il[i].match_list.get(il[i + 1].name, ()))
             for i in range(len(il) - 1) if (i + 1) % PER_STRIP]
    log(f"[process-17d] {pairs} pairs x {n} int8, {n_planted} planted on a "
        f"non-planar scene; per transform (planted kept min, others passed "
        f"max): {out}; ms/batch {ms}; torch.linalg.svd of {pairs * 512} "
        f"3x3 f32 {svd_ms:.3f} ms (F calls it 3 times a batch, E 6); "
        f"essential5 find_matches {e5_s:.2f} s, along-track neighbours min "
        f"{min(along)} matches; {smi}")
    checks = {f"{t} keeps >= 90% planted": out[t][0] >= 0.9 * n_planted
              for t in ("fundamental", "essential")}
    checks.update({f"{t} passes <= 5 others": out[t][1] <= 5
                   for t in ("fundamental", "essential")})
    checks["essential5 along-track >= 50"] = min(along) >= 50
    return checks, dict(ms_per_batch=ms, svd_ms=svd_ms,
                        essential5_find_matches_s=e5_s,
                        along_track_min=min(along), kept=out)


def run_process_extras(root, smi, dev="cuda", size=FRAME, strips=STRIPS,
                       per_strip=PER_STRIP, max_features=MAX_FEATURES):
    """Phase 17: the rest of the user's command on the mission of phase
    16. (a) From EXIF: the frames tagged with EXIF and XMP, the camera in
    the DB, no pose file; process.main without --camera, with --geotiff
    and --histogram; then Steps 1–2 again with the camera absent from the
    DB (estimate_from_exif). (b) The mosaic: the card's composite against
    the same code on the CPU from the same card-decoded frames. (c)
    --refresh STEP4 --cam-calibration from a focal length 3% low. (d)
    run_transforms. Returns the launches of (a)'s run."""
    W, H = size
    m = make_mission(strips=strips, per_strip=per_strip, size=size, seed=0,
                     device=dev)
    proj_dir = os.path.join(root, "exif")
    db = os.path.join(root, "cameras")
    write_mission(proj_dir, m, db, exif=True)
    base = ["--camera-db", db, "--scale", "1.0", "--ground", "0.0",
            "--batch-size", "32", "--min-chain-len", "2", "--detector", "TPU",
            "--max-features", str(max_features)]
    checks = {}

    # (a) Steps 1 → 5 from EXIF, with --geotiff and --histogram
    reset_launches()
    t0 = time.perf_counter()
    rc = process.main([proj_dir] + base + ["--geotiff", "--histogram"])
    wall = time.perf_counter() - t0
    launches = read_launches()
    proj, run_log, walls, mre, grps, err, height = mission_outcome(proj_dir,
                                                                  m)
    truth = geodesy.ned2lla(m.ned, *REF_LLA)
    rows = _pix4d_rows(os.path.join(proj_dir, "pix4d.csv"))
    pose_err = np.zeros(4)
    for row, (lat, lon, alt), (y, p, r) in zip(rows, truth,
                                               m.aircraft_ypr):
        v = [float(x) for x in row[1:]]
        pose_err = np.maximum(pose_err, [
            max(abs(v[0] - lat), abs(v[1] - lon)), abs(v[2] - alt),
            max(abs(v[3] - r), abs(v[4] - p)),
            abs((v[5] - y + 180.0) % 360.0 - 180.0)])
    models = proj.models_dir
    hists, templates = histogram.load(proj.analysis_dir)
    cfg = camera_config(m)
    checks.update({
        "(a) rc 0, STEP5": rc == 0 and proj.state.check("STEP5"),
        "(a) camera by EXIF from the DB": proj.detect_camera() == CAMERA_KEY
        and "estimating from EXIF" not in run_log
        and proj.camera.get("ccd_width_mm") == cfg["ccd_width_mm"],
        "(a) pix4d.csv within its rounding": len(rows) == len(m.ned)
        and pose_err[0] <= 1e-4 / 3600 + 1e-9 and pose_err[1] <= 0.01
        and pose_err[2] <= 0.005 and pose_err[3] <= 0.005,
        "(a) group 0 holds >= 90%": bool(grps)
        and len(grps[0]) >= 0.9 * len(m.ned),
        "(a) BA mre <= 1 px": len(mre) == 1 and mre[0] <= 1.0,
        "(a) cameras within 3 m": err.max() < 3.0,
        "(a) median point within 1 m": abs(height) <= 1.0,
        "(a) mosaic.tif, gdalscript.sh": all(
            os.path.isfile(os.path.join(models, f))
            for f in ("mosaic.tif", "gdalscript.sh")),
        "(a) a template for every frame": templates is not None
        and sorted(templates) == sorted(im.name for im in proj.image_list),
        "(a) K1 int8 and K2 launched": launches["knn_packed_i8"] > 0
        and launches["gauss_blur_f32"] > 0,
    })
    log(f"[process-17a] {len(m.ned)} JPEGs {W}x{H} tagged with EXIF, no "
        f"pose file, --geotiff --histogram: main {wall:.3f} s; camera "
        f"{proj.camera.get('make')}_{proj.camera.get('model')}; pix4d.csv "
        f"vs truth max: latlon {pose_err[0]:.2e} deg, alt {pose_err[1]:.3f} "
        f"m, roll/pitch {pose_err[2]:.4f}, yaw {pose_err[3]:.4f} deg; groups "
        f"{[len(g) for g in grps]}; BA mre {mre}; camera error max "
        f"{err.max():.4f} m; median point {height:.4f} m; stage walls "
        f"{walls}; launches {launches}; {smi}")

    # (a') Steps 1–2 again, the camera absent from the DB
    again = os.path.join(root, "exif_nodb")
    shutil.copytree(proj_dir, again)
    empty_db = os.path.join(root, "empty_db")
    os.makedirs(empty_db)
    argv = [again] + base
    argv[2] = empty_db
    rc2 = process.main(argv + ["--refresh", "STEP1", "--refresh", "STEP2"])
    p2 = ProjectMgr(again)
    log2 = "".join(open(f).read() for f in glob.glob(
        os.path.join(p2.analysis_dir, "messages-*")))
    fx_est = float(p2.camera.getlist("K")[0])
    checks["(a) estimate_from_exif fx within 0.1%"] = (
        rc2 == 0 and "estimating from EXIF" in log2
        and abs(fx_est / m.K[0, 0] - 1.0) <= 1e-3)
    log(f"[process-17a] camera absent from the DB: Steps 1-2 rc {rc2}, fx "
        f"from EXIF {fx_est:.4f} against {m.K[0, 0]:.4f}; {smi}")

    # (b) the card's mosaic against the CPU's from the same frames; Step
    # 5's two new parts timed alone
    names = grps[0]
    _sync(dev)
    t0 = time.perf_counter()
    texture.build_histograms(proj, device=dev)
    _sync(dev)
    hist_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mosaic, extent = geotiff.composite(proj, names, resolution=0.25,
                                       ground=0.0, device=dev)
    _sync(dev)
    comp_s = time.perf_counter() - t0
    frames = {proj.image_path(im): jpeg.decode_bgr(proj.image_path(im),
                                                   dev).cpu()
              for im in proj.image_list if im.name in set(names)}
    decode = jpeg.decode_bgr
    jpeg.decode_bgr = lambda path, device="cuda", reduce=1: frames[path]
    try:
        t0 = time.perf_counter()
        cpu_mosaic, cpu_extent = geotiff.composite(
            proj, names, resolution=0.25, ground=0.0, device="cpu")
        cpu_s = time.perf_counter() - t0
    finally:
        jpeg.decode_bgr = decode
    card = mosaic.cpu().numpy().astype(int)
    host = cpu_mosaic.numpy().astype(int)
    covered = (card > 0).any(-1) | (host > 0).any(-1)
    within = (np.abs(card - host).max(-1) <= 1)[covered].mean()
    checks["(b) card vs CPU within 1 level on >= 99.9%"] = (
        extent == cpu_extent and within >= 0.999)
    equal = float((card == host).all(-1)[covered].mean())
    log(f"[process-17b] mosaic {card.shape[1]}x{card.shape[0]} at 0.25 m/px "
        f"of {len(names)} frames: composite on the card {comp_s:.3f} s "
        f"({1e3 * comp_s / len(names):.1f} ms/frame, decode included), on "
        f"the CPU {cpu_s:.3f} s; covered {covered.mean():.4f}, within one "
        f"level {within:.6f}, bit-equal {equal:.6f}; build_histograms "
        f"{hist_s:.3f} s; Step 5 of (a) {walls.get('step5_render')} s; "
        f"{smi}")

    # (c) --cam-calibration from a focal length 3% low
    K_true = float(m.K[0, 0])
    K_low = list(proj.camera.getlist("K"))
    K_low[0] = K_low[4] = 0.97 * K_true
    proj.camera.setlist("K", K_low)
    proj.save()
    t0 = time.perf_counter()
    rc3 = process.main([proj_dir] + base + ["--refresh", "STEP4",
                                            "--cam-calibration"])
    cal_s = time.perf_counter() - t0
    proj, run_log, _, mre, _, err, _ = mission_outcome(proj_dir, m)
    K_opt = proj.camera.getlist("K_opt")
    d_opt = proj.camera.getlist("dist_coeffs_opt")
    moved = (K_opt[0] - 0.97 * K_true) / (0.03 * K_true)
    checks.update({
        "(c) K_opt moved >= 25% back": rc3 == 0 and moved >= 0.25,
        "(c) dist_coeffs_opt[0] within 0.01": abs(d_opt[0]) <= 0.01,
        "(c) mre <= 1 px": mre[-1] <= 1.0,
    })
    log(f"[process-17c] --refresh STEP4 --cam-calibration from f "
        f"{0.97 * K_true:.2f} (truth {K_true:.2f}): K_opt f {K_opt[0]:.3f} "
        f"({100 * moved:.1f}% of the way back), dist_coeffs_opt "
        f"{[round(float(x), 5) for x in d_opt]}, mre {mre[-1]:.4f} px, "
        f"camera error max {err.max():.4f} m, {cal_s:.2f} s; {smi}")

    # (d) the device transforms and the host essential5 refilter
    more, numbers = run_transforms(proj_dir, smi, dev)
    checks.update(more)
    log("[process-17] " + json.dumps({
        "main_s": wall, "stage_wall_s": walls, "composite_s": comp_s,
        "composite_cpu_s": cpu_s, "histograms_s": hist_s,
        "composite_ms_per_frame": 1e3 * comp_s / len(names),
        "mosaic": [card.shape[1], card.shape[0]], "calibration_s": cal_s,
        "K_opt_moved": moved, **numbers, "device": smi}))
    checks["no PIL or cv2 imported"] = not {"PIL", "cv2"} & set(sys.modules)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 17 failed: {failed}")
    return launches



def _fresh_copy(src, dst, db, frames=None):
    """A copy of the mission's folder (JPEGs and pix4d.csv; the first
    `frames` frames only, when given) through the stages before
    matching."""
    if frames is None:
        shutil.copytree(src, dst)
    else:
        os.makedirs(dst)
        with open(os.path.join(src, "pix4d.csv")) as f:
            rows = f.read().splitlines()
        with open(os.path.join(dst, "pix4d.csv"), "w") as f:
            f.write("\n".join(rows[:frames + 1]) + "\n")
        for i in range(frames):
            shutil.copy(os.path.join(src, image_name(i) + ".jpg"), dst)
    for argv in (["create-project", dst],
                 ["set-camera", dst, "--camera", CAMERA_KEY, "--camera-db",
                  db], ["set-poses", dst]):
        if stages.main(argv) != 0:
            raise AssertionError(f"stages {argv[0]} failed on {dst}")


def host_matching(src, dst, db, m, detector, extra=(), frames=None):
    """stages matching --detector detector (reference defaults plus extra)
    on a fresh copy (of the first `frames` frames, when given: below 64
    the matcher takes the chunked float path): the host detector's wall a
    frame, the match wall, the launches, along-track neighbours' matches
    and the agreement with the planted homographies."""
    from imageanalysis_tpu_torch.features import detect as detect_mod

    _fresh_copy(src, dst, db, frames)
    detect_s = []
    run_detect = detect_mod.detect_project_features

    def timed(*a, **k):
        t0 = time.perf_counter()
        run_detect(*a, **k)
        detect_s.append(time.perf_counter() - t0)

    reset_launches()
    detect_mod.detect_project_features = timed
    try:
        t0 = time.perf_counter()
        rc = stages.main(["matching", dst, "--detector", detector, *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        detect_mod.detect_project_features = run_detect
    launches = {k: v for k, v in read_launches().items() if v}
    proj = ProjectMgr(dst)
    proj.load_images_info()
    counts = []
    for im in proj.image_list:
        im.load_features()
        im.load_descriptors()
        im.load_matches()
        counts.append(len(im.kp))
    width = proj.image_list[0].des.shape[1]
    names = [im.name for im in proj.image_list]
    if names != [image_name(i) for i in range(frames or len(m.frames))]:
        raise AssertionError(f"phase 18: unexpected images {names[:4]}")
    pairs = [(i, j) for i, im in enumerate(proj.image_list)
             for j in range(i + 1, len(names))
             if len(im.match_list.get(names[j], ()))]
    result = project_matches(proj, pairs)
    thresh = float(FRAME[0]) ** 0.25
    n_in, n_all = planted_agreement(result, [im.kp for im in proj.image_list],
                                    m.H_ij, thresh)
    along = [(s * PER_STRIP + k, s * PER_STRIP + k + 1)
             for s in range(STRIPS) for k in range(PER_STRIP - 1)
             if s * PER_STRIP + k + 1 < len(names)]
    along_min = min(len(result.get(p, ())) for p in along)
    r = {"rc": rc, "detect_ms_per_frame": 1e3 * sum(detect_s) / len(names),
         "match_s": wall - sum(detect_s), "features_min": min(counts),
         "features_max": max(counts), "width": width, "pairs": len(pairs),
         "along_min": along_min, "n_in": n_in, "n_all": n_all,
         "launches": launches}
    log(f"[stages-18b] matching --detector {detector} {' '.join(extra)} on "
        f"{len(names)} frames: "
        f"{r['detect_ms_per_frame']:.1f} ms a frame on the host, match "
        f"{r['match_s']:.3f} s; features/frame {min(counts)}..{max(counts)} "
        f"x {width}; {len(pairs)} pairs with matches, along-track min "
        f"{along_min}; {n_in}/{n_all} within {2 * thresh:.2f} px of the "
        f"planted homographies; launches {launches}")
    return r


def run_stages(root, smi, p16_wall, p16_cams):
    """Phase 18: the stage scripts and the host detectors on phase 16's
    mission, written afresh. (a) The numbered workflow as CLI calls with
    --detector TPU; (b) matching --detector SIFT and ORB at the
    reference's defaults; (c) process.main with the default detector, at
    4096 features a frame and at every feature; (d) the store path in
    float32 with bf16 off on (b)'s ORB workspaces, against int8's lists;
    (e) process.main with ORB at 8000 features and the smart strategy
    (run_orb_smart). Returns (the launches of the 256-wide kernels over
    (b)'s ORB runs, (d)'s store paths and (e)'s run; run_orb_smart's
    numbers)."""
    W, H = FRAME
    m = make_mission(strips=STRIPS, per_strip=PER_STRIP, size=FRAME, seed=0,
                     device="cuda")
    src, db = os.path.join(root, "mission"), os.path.join(root, "cameras")
    write_mission(src, m, db)
    n = len(m.frames)
    checks = {}

    # (a) the reference's numbered workflow as CLI calls
    d = os.path.join(root, "staged")
    shutil.copytree(src, d)
    seq = [("create-project", []),
           ("set-camera", ["--camera", CAMERA_KEY, "--camera-db", db]),
           ("set-poses", []),
           ("matching", ["--detector", "TPU", "--scale", "1.0",
                         "--batch-size", "32", "--max-features",
                         str(MAX_FEATURES)]),
           ("clean", []), ("triangulate", ["--method", "ground",
                                           "--ground", "0"]),
           ("groups", ["--min-chain-len", "2"]), ("optimize", []),
           ("cull mre", []), ("optimize", ["--refine"]), ("render", [])]
    walls, cams = [], None
    reset_launches()
    for name, extra in seq:
        t0 = time.perf_counter()
        rc = (cull.main([d, "mre"]) if name == "cull mre"
              else stages.main([name, d, *extra]))
        torch.cuda.synchronize()
        walls.append((" ".join([name, *extra[:1]]),
                      round(time.perf_counter() - t0, 3)))
        if rc != 0:
            raise AssertionError(f"phase 18 (a): {name} returned {rc}")
        if name == "optimize" and cams is None:
            proj = ProjectMgr(d)
            proj.load_images_info()
            cams = camera_positions(proj)
    launches = read_launches()
    more, out = process_outcome(d, m, n, n_ba=2)
    checks.update({f"(a) {k}": v for k, v in more.items()})
    culled = [int(x) for x in re.findall(r"→ (\d+) observations marked",
                                         out["run_log"])]
    off = max(np.linalg.norm(cams[k] - p16_cams[k]) for k in p16_cams)
    total = sum(w for _, w in walls)
    checks.update({
        "(a) cameras after optimize within 0.05 m of phase 16's": off <= 0.05,
        "(a) cull mre ran": len(culled) == 1,
        "(a) K1 int8 and K2 launched": launches["knn_packed_i8"] > 0
        and launches["gauss_blur_f32"] > 0,
    })
    log(f"[stages-18a] {n} JPEGs {W}x{H}, 11 CLI calls in {total:.3f} s "
        f"(phase 16's process.main {p16_wall:.3f} s); {out['summary']}; "
        f"cull mre marked {culled}; cameras after the first optimize "
        f"within {off:.4f} m of phase 16's; launches "
        f"{ {k: v for k, v in launches.items() if v} }; {smi}")
    log("[stages-18a] " + json.dumps({"stage_wall_s": walls,
                                      "total_s": total,
                                      "process_main_s": p16_wall,
                                      "device": smi}))

    # (b) the host detectors at the reference's defaults
    runs = {"SIFT": [host_matching(src, os.path.join(root, "sift"), db, m,
                                   "SIFT")]}
    orb = [host_matching(src, os.path.join(root, "orb"), db, m, "ORB")]
    # K1 at 256 up to 8192 rows a frame, K3 beyond: where the defaults
    # reach only one of them, a second run reaches the other
    if not orb[0]["launches"].get("knn_packed_i8_d256"):
        orb.append(host_matching(src, os.path.join(root, "orb_k1"), db, m,
                                 "ORB", ("--max-features", "8000")))
    if not orb[0]["launches"].get("knn_wide_d256"):
        orb.append(host_matching(src, os.path.join(root, "orb_k3"), db, m,
                                 "ORB", ("--scale", "0.6")))
    # one strip: the chunked float path, K1 bf16 at 256
    orb.append(host_matching(src, os.path.join(root, "orb_strip"), db, m,
                             "ORB", ("--max-features", "8000"),
                             frames=PER_STRIP))
    runs["ORB"] = orb
    for det, rs in runs.items():
        for i, r in enumerate(rs):
            checks.update({
                f"(b) {det} run {i} rc 0": r["rc"] == 0,
                f"(b) {det} run {i} along-track >= 50": r["along_min"] >= 50,
                f"(b) {det} run {i} >= 95% on the homographies":
                    r["n_in"] >= 0.95 * r["n_all"] > 0,
                f"(b) {det} run {i} width": r["width"] == (
                    128 if det == "SIFT" else 256)})
    d256 = {}
    for r in orb:
        for k, v in r["launches"].items():
            if k.endswith("_d256"):
                d256[k] = d256.get(k, 0) + v
    # SIFT at the defaults finds ~20,000 features a frame: the store
    # takes K3 beyond 8192 rows
    checks["(b) SIFT ran K1 int8 or K3"] = bool(
        runs["SIFT"][0]["launches"].get("knn_packed_i8")
        or runs["SIFT"][0]["launches"].get("knn_wide"))
    checks["(b) ORB ran K1 int8 at 256"] = bool(d256.get("knn_packed_i8_d256"))
    checks["(b) ORB ran K3 at 256"] = bool(d256.get("knn_wide_d256"))
    checks["(b) ORB on one strip ran K1 bf16 at 256"] = bool(
        orb[-1]["launches"].get("knn_packed_bf16_d256"))
    log("[stages-18b] " + json.dumps({
        det: [{k: v for k, v in r.items() if k != "launches"} for r in rs]
        for det, rs in runs.items()} | {"d256_launches": d256,
                                        "device": smi}))

    # (d) the store path in float32 with bf16 off on (b)'s ORB workspaces
    # of the whole mission: K1 f32 or K3 f32 at 256 values a row, as the
    # feature counts reach them; ORB's bits give the same integer
    # distances in both modes, so the lists equal the int8 mode's
    pairs = [(i, j) for _, i, j in worklist.build_work_list(
        m.ned, use_distance=True)]
    for tag in ("orb", "orb_k1", "orb_k3"):
        d = os.path.join(root, tag)
        if not os.path.isdir(d):
            continue
        proj = ProjectMgr(d)
        proj.load_images_info()
        lists, launches, walls = store_path(
            proj, pairs, [("int8", True, False), ("float32", False, False)])
        f32 = {k: launches["float32_f32"][k] for k in (
            "knn_packed_f32_d256", "knn_wide_f32_d256")}
        for k, v in f32.items():
            d256[k] = d256.get(k, 0) + v
        n_kept = sum(bool(len(r)) for r in lists["int8"].values())
        same = _same_lists(lists["float32_f32"], lists["int8"])
        checks[f"(d) {tag} float32 lists equal int8's"] = same
        checks[f"(d) {tag} f32 at 256 launched"] = sum(f32.values()) > 0
        log(f"[stages-18d] store path on {tag}'s workspace, {len(pairs)} "
            f"pairs ({n_kept} kept in int8), float32 with bf16 off against "
            f"int8: lists equal {same}; f32 launches {f32}; walls s "
            + json.dumps({n: {k: round(v, 3) for k, v in w.items()}
                          for n, w in walls.items()}) + f"; {smi}")
        del proj, lists

    # (c) process.main with the default detector (host SIFT at scale 0.4)
    # and phase 16's other arguments: at phase 16's 4096 features a frame
    # with every check of phase 16; at the reference's every feature
    # (~20,000 a frame) the same but the cameras' 3 m, which stray
    # matches of low-overlap pairs linked into chains break there, as in
    # the reference (ROADMAP.md queue 3): printed, not held
    base = ["--camera", CAMERA_KEY, "--camera-db", db, "--ground", "0.0",
            "--batch-size", "32", "--min-chain-len", "2"]
    for tag, extra in (("4096", ["--max-features", str(MAX_FEATURES)]),
                       ("defaults", [])):
        d = os.path.join(root, f"default_{tag}")
        shutil.copytree(src, d)
        reset_launches()
        t0 = time.perf_counter()
        rc = process.main([d, *base, *extra])
        wall = time.perf_counter() - t0
        launches = read_launches()
        more, out = process_outcome(d, m, n)
        if tag == "defaults":
            more.pop("cameras within 3 m")
        checks.update({f"(c) {tag} {k}": v for k, v in more.items()})
        checks[f"(c) {tag} rc 0"] = rc == 0
        checks[f"(c) {tag} K1 int8 or K3 launched, K2 not"] = (
            launches["knn_packed_i8"] + launches["knn_wide"] > 0
            and launches["gauss_blur_f32"] == 0)
        log(f"[stages-18c] process.main with the default detector (host "
            f"SIFT, scale 0.4), {' '.join(extra) or 'every feature'}, "
            f"phase 16's other arguments: {wall:.3f} s; {out['summary']}; "
            f"stage walls {out['walls']}; launches "
            f"{ {k: v for k, v in launches.items() if v} }; {smi}")

    # (e) ORB's smart path on the user's command
    p18e = run_orb_smart(root, src, m, base, smi)
    for k, v in p18e["launches"].items():
        if k.endswith("_d256"):
            d256[k] = d256.get(k, 0) + v
    checks.update(p18e.pop("checks"))
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 18 failed: {failed}")
    return d256, p18e


def cross_strip(proj):
    """{"a-b": [pairs attempted, pairs with matches, matches]} over a
    project's pairs of frames in strips a < b of phase 16's mission."""
    names = [im.name for im in proj.image_list]
    out = {}
    for i, im in enumerate(proj.image_list):
        im.load_matches()
        for other, lst in (im.match_list or {}).items():
            j = names.index(other)
            a, b = i // PER_STRIP, j // PER_STRIP
            if i < j and a != b:
                r = out.setdefault(f"{a}-{b}", [0, 0, 0])
                r[0] += 1
                r[1] += bool(len(lst))
                r[2] += len(lst)
    return dict(sorted(out.items()))


def run_orb_smart(root, src, m, base, smi):
    """Phase 18 (e): process.main on a copy of phase 16's mission at src
    with base (phase 18 (c)'s arguments) and --detector ORB --max-features
    8000 --match-strategy smart: ORB's 256-bit rows at 8000 features a
    frame (K1 at 256 values a row, below K3's 8192), whose smart gate runs
    K1 gated at 256 on the int8 store. Holds rc 0, phase 16's checks, the
    gated launches, every gated K1 call int8 at 256, and the first and
    the last int8 K1 call at 256 of each gate (their inputs as the store
    gave them) bit-exact against knn_packed_plain (check_k1_calls). The
    reference's ORB settings match no pair across strips 0 and 1 of this
    mission (the traditional strategy neither): the groups split 48 / 16
    and only group 0 gets eggs and textures (ROADMAP.md queue 3), so those
    three checks are printed, not held. Returns {checks, launches,
    gated: check_k1_calls' list for gated calls, plain: for ungated}."""
    n = len(m.frames)
    d = os.path.join(root, "orb_smart")
    shutil.copytree(src, d)
    kinds = {("int8", 256, True), ("int8", 256, False)}
    reset_launches()
    with keeping_k1(kinds) as (calls, kept):
        t0 = time.perf_counter()
        rc = process.main([d, *base, "--detector", "ORB", "--max-features",
                           "8000", "--match-strategy", "smart"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_launches()
    k1 = {name: check_k1_calls(kept.get(("int8", 256, gated), {}),
                               f"ORB smart {name}", "stages-18e")
          for name, gated in (("gated", True), ("plain", False))}
    del kept
    more, out = process_outcome(d, m, n)
    printed = {k: more.pop(k) for k in ("group 0 holds >= 90%",
                                        f">= {n - 1} eggs",
                                        f"{n} textures 512x512")}
    cross = cross_strip(out["proj"])
    gated = {k: v for k, v in calls.items() if k[2]}
    checks = {f"(e) {k}": v for k, v in more.items()}
    checks["(e) rc 0"] = rc == 0
    checks["(e) K1 gated at 256 launched"] = \
        launches["knn_packed_gated_d256"] > 0
    checks["(e) K1 gated on the int8 store only"] = bool(gated) and set(
        gated) == {("int8", 256, True)}
    log(f"[stages-18e] process.main --detector ORB --max-features 8000 "
        f"--match-strategy smart, (c)'s other arguments: {wall:.3f} s; "
        f"{out['summary']}; stage walls {out['walls']}; K1 calls (type, "
        f"width, gated): {dict(calls)}; launches "
        f"{ {k: v for k, v in launches.items() if v} }; printed, not held: "
        f"{printed}; pairs across strips (by strip pair: attempted, with "
        f"matches, matches): {cross}; {smi}")
    return {"checks": checks, "launches": launches, **k1}


P19_TIMEOUT_S = 420         # a phase 19 child's wall at most


def _ba_checks(res, floor, mx, p14_mre):
    """Phase 14's checks of a mission solve, and its mre within 2% of
    phase 14's f32 bundle.solve."""
    cfg = bundle.BAConfig()
    return {"no stall": ba_stop(res, cfg) != "stalled",
            "within 5% of the noise floor": res.cost_history[-1]
            <= 1.05 * floor,
            "no residual above 5 px": mx <= 5.0,
            "finite points": bool(np.isfinite(res.pts).all()),
            "mre within 2% of phase 14's": abs(res.mre - p14_mre)
            <= 0.02 * p14_mre}


def run_sharded_ba(smi, p14):
    """Phase 19 (a): phase 14's mission graph through solve_sharded on a
    LocalMesh of 4 shards of the card and over a process group of one
    rank on NCCL; (d), where there are two cards or more, on a LocalMesh
    of distinct cards (stages optimize --mesh 2 and --mesh all)."""
    dev = torch.device("cuda")
    g = make_ba_mission_graph(device=dev)
    n_cam, n_pt, n_obs = len(g.cams0), len(g.pts0), len(g.obs.uv)
    floor = 0.5 * 0.5 ** 2 * (2 * n_obs - 7 * n_cam - 3 * n_pt)
    checks, rows = {}, {}

    def solve(tag, mesh, part="a"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sharded.solve_sharded(g.cams0, g.pts0, g.obs, g.K, g.dist,
                                    mesh, bundle.BAConfig(), verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _, _, mx = bundle.ba_cost(*bundle._problem_on(
            res.cams, res.pts, g.obs, g.K, g.dist, dev, torch.float32))
        checks.update({f"({part}) {tag} {k}": v for k, v in _ba_checks(
            res, floor, float(mx), p14["warm"].mre).items()})
        calls, nbytes = mesh.stats["calls"], mesh.stats["bytes"]
        rows[tag] = {"wall_s": wall, "iters": res.iters,
                     "accepted": len(res.cost_history) - 1, "mre": res.mre,
                     "cost_vs_floor": res.cost_history[-1] / floor,
                     "max_residual_px": float(mx),
                     "collectives_per_iter": calls / res.iters,
                     "bytes_per_iter": nbytes / res.iters}
        log(f"[parallel-19{part}] {tag}: {wall:.3f} s (phase 14's warm "
            f"bundle.solve {p14['warm_wall']:.3f} s), {res.iters} LM "
            f"iterations, stop {ba_stop(res, bundle.BAConfig())}, cost "
            f"{res.cost_history[-1] / floor:.4f} of the noise floor, mre "
            f"{res.mre:.4f} px (phase 14 {p14['warm'].mre:.4f}), max "
            f"residual {float(mx):.3f} px; collectives {calls} "
            f"({nbytes / 2**20:.2f} MiB), {calls / res.iters:.1f} and "
            f"{nbytes / res.iters / 2**10:.1f} KiB per LM iteration; {smi}")

    solve("LocalMesh of 4 shards on the card",
          sharded.LocalMesh([dev] * 4))
    backend = multihost.initialize(0, 1, "127.0.0.1", _free_port(), dev,
                                   timeout_s=120)
    try:
        solve(f"a world of 1 on {backend}", sharded.ProcessMesh(dev))
    finally:
        multihost.shutdown()
    checks["(a) the world of 1 took NCCL"] = backend == "nccl"
    n_cards = torch.cuda.device_count()
    for n in sorted({2, n_cards}) if n_cards >= 2 else ():
        solve(f"LocalMesh of {n} cards", sharded.LocalMesh(
            [torch.device("cuda", i) for i in range(n)]), part="d")
    log("[parallel-19a] " + json.dumps({
        "graph": [n_cam, n_pt, n_obs], "p14_warm_wall_s": p14["warm_wall"],
        "runs": rows, "device": smi}))
    return checks


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def rank_child(cfg):
    """A phase 19 rank (this script with --rank <json>): process.main or
    stages.main on cfg's argv, its log to cfg's file; prints one line "P19
    <json>" (rank, backend, device, launches, stage walls, eggs
    written)."""
    reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if cfg["cmd"] == "process":
            rc = process.main(cfg["argv"])
        else:
            rc = stages.main(cfg["argv"])
    text = buf.getvalue()
    with open(cfg["log"], "w") as f:
        f.write(text)
    print("P19 " + json.dumps({
        "rc": rc, "rank": multihost.rank(), "backend": multihost.backend(),
        "device": f"cuda:{torch.cuda.current_device()}"
        if torch.cuda.is_available() else "cpu",
        "launches": read_launches(),
        "walls": {k: float(v) for k, v in
                  re.findall(r"stage wall: (\S+) ([\d.]+)s", text)},
        "eggs_written": sum(int(n) for n in re.findall(
            r"build_map: wrote (\d+) egg models", text))}), flush=True)
    multihost.shutdown()
    return 0 if rc == 0 else 1


def launch_ranks(cmd, argv, logs, per_card):
    """Two ranks of this script (--rank) running cmd with argv; each rank
    on the card 0 (gloo by the backend rule) or, per_card, on a card of
    its own (NCCL). Returns their JSON lines; a rank that fails or passes
    P19_TIMEOUT_S fails the phase, and every rank is ended on return."""
    port = str(_free_port())
    procs = []
    torch.cuda.empty_cache()        # the ranks share the card(s) with us
    try:
        for r in range(2):
            env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                       WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r),
                       LOCAL_WORLD_SIZE="2", IMGTPU_DIST_TIMEOUT="300")
            if not per_card:
                env["CUDA_VISIBLE_DEVICES"] = "0"
            cfg = {"cmd": cmd, "argv": argv, "log": f"{logs}.rank{r}.log"}
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank",
                 json.dumps(cfg)], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        deadline = time.monotonic() + P19_TIMEOUT_S
        outs = []
        for r, p in enumerate(procs):
            try:
                out, _ = p.communicate(
                    timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"phase 19: rank {r} of {cmd} passed "
                                     f"{P19_TIMEOUT_S} s") from None
            if p.returncode != 0:
                raise AssertionError(f"phase 19: rank {r} of {cmd} exited "
                                     f"{p.returncode}:\n{out[-4000:]}")
            line = [ln for ln in out.splitlines() if ln.startswith("P19 ")]
            if not line:
                raise AssertionError(f"phase 19: rank {r} of {cmd} printed "
                                     f"no result:\n{out[-4000:]}")
            outs.append(json.loads(line[-1][4:]))
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def _match_lists(proj_dir):
    """{image: {other: its (n, 2) match array as bytes}} of a workspace."""
    proj = ProjectMgr(proj_dir)
    proj.load_images_info()
    out = {}
    for im in proj.image_list:
        im.load_matches()
        out[im.name] = {k: np.asarray(v, np.int32).tobytes()
                        for k, v in im.match_list.items()}
    return out


def _yaw_pairs(proj_dir):
    with open(os.path.join(proj_dir, "ImageAnalysis", "smart.json")) as f:
        return {k: sorted(v.get("yaw_pairs", {}))
                for k, v in json.load(f).items()}


def run_ranks(root, smi, m, one, per_card):
    """Phase 19 (b), or (c) with per_card: two ranks run process.main on a
    fresh copy of the mission, then stages optimize --refine, held to the
    one-process run `one`."""
    tag = "(c)" if per_card else "(b)"
    d = os.path.join(root, "ranks_nccl" if per_card else "ranks_gloo")
    shutil.copytree(one["src"], d)
    argv = [d, *one["args"]]
    t0 = time.perf_counter()
    ranks = launch_ranks("process", argv, os.path.join(root, "p19_process"),
                         per_card)
    wall = time.perf_counter() - t0
    checks, outcome = process_outcome(d, m, len(m.frames))
    checks = {f"{tag} {k}": v for k, v in checks.items()}
    got = _match_lists(d)
    diff = [n for n in one["matches"] if got.get(n) != one["matches"][n]]
    yaw = _yaw_pairs(d)
    models = sorted(os.listdir(os.path.join(d, "ImageAnalysis", "models")))
    backends = [r["backend"] for r in ranks]
    checks.update({
        f"{tag} rc 0": all(r["rc"] == 0 for r in ranks),
        f"{tag} backend": backends == ["nccl" if per_card else "gloo"] * 2,
        f"{tag} match lists equal the one-process run's": not diff
        and set(got) == set(one["matches"]),
        f"{tag} yaw evidence of every rank": yaw == one["yaw"]
        and sum(map(len, yaw.values())) > 0,
        f"{tag} K1 int8 and K2 launched in each rank": all(
            r["launches"]["knn_packed_i8"] + r["launches"]["knn_packed_gated"]
            > 0 and r["launches"]["gauss_blur_f32"] > 0 for r in ranks),
        f"{tag} models/ as the one-process run's": models == one["models"],
        f"{tag} each egg written once": sum(r["eggs_written"] for r in ranks)
        == one["eggs_written"],
    })
    t0 = time.perf_counter()
    opt = launch_ranks("stages", ["optimize", d, "--refine"],
                       os.path.join(root, "p19_optimize"), per_card)
    opt_wall = time.perf_counter() - t0
    proj = ProjectMgr(d)
    proj.load_images_info()
    cams = camera_positions(proj)
    off = max(np.linalg.norm(cams[k] - one["opt_cams"][k])
              for k in one["opt_cams"])
    checks.update({
        f"{tag} optimize --refine rc 0": all(r["rc"] == 0 for r in opt),
        f"{tag} cameras within 0.05 m of the one-process optimize":
        off <= 0.05})
    launches = [{k: v for k, v in r["launches"].items() if v} for r in ranks]
    log(f"[parallel-19{tag[1]}] 2 ranks, backends {backends}, devices "
        f"{[r['device'] for r in ranks]}: process.main {wall:.3f} s "
        f"(one process {one['wall']:.3f} s); {outcome['summary']}; "
        f"{len(diff)} images whose match lists differ; launches {launches}; "
        f"optimize --refine {opt_wall:.3f} s (one process "
        f"{one['opt_wall']:.3f} s), cameras within {off:.4f} m; {smi}")
    log(f"[parallel-19{tag[1]}] " + json.dumps({
        "stage_wall_s": {"one_process": one["walls"],
                         **{f"rank{r['rank']}": r["walls"] for r in ranks}},
        "process_wall_s": wall, "one_process_wall_s": one["wall"],
        "optimize_wall_s": opt_wall, "one_optimize_wall_s": one["opt_wall"],
        "backends": backends, "device": smi}))
    return checks, [r["launches"] for r in ranks]


def one_process_run(root):
    """Phase 19 (b)'s yardstick: phase 16's mission written afresh, then
    process.main with phase 16's arguments and --match-strategy smart and
    stages optimize --refine in this process. Returns (checks, the
    mission, what run_ranks holds the ranks to)."""
    m = make_mission(strips=STRIPS, per_strip=PER_STRIP, size=FRAME, seed=0,
                     device="cuda")
    src, db = os.path.join(root, "mission"), os.path.join(root, "cameras")
    write_mission(src, m, db)
    # phase 16's arguments, but detection batches of DETECT_BATCH frames:
    # two ranks share the card's memory (a batch of 32 frames takes ~32
    # GiB a rank), and --match-strategy smart
    args = ["--camera", CAMERA_KEY, "--camera-db", db, "--scale", "1.0",
            "--ground", "0.0", "--batch-size", str(DETECT_BATCH),
            "--min-chain-len", "2", "--detector", "TPU", "--max-features",
            str(MAX_FEATURES), "--match-strategy", "smart"]
    d = os.path.join(root, "one")
    shutil.copytree(src, d)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = process.main([d, *args])
    wall = time.perf_counter() - t0
    checks, outcome = process_outcome(d, m, len(m.frames))
    checks = {f"(b) one process: {k}": v for k, v in checks.items()}
    checks["(b) one process: rc 0"] = rc == 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc_opt = stages.main(["optimize", d, "--refine"])
    opt_wall = time.perf_counter() - t0
    checks["(b) one process: optimize rc 0"] = rc_opt == 0
    proj = ProjectMgr(d)
    proj.load_images_info()
    one = {"src": src, "args": args, "matches": _match_lists(d),
           "yaw": _yaw_pairs(d), "wall": wall, "opt_wall": opt_wall,
           "walls": outcome["walls"], "opt_cams": camera_positions(proj),
           "models": sorted(os.listdir(proj.models_dir)),
           "eggs_written": sum(int(n) for n in re.findall(
               r"build_map: wrote (\d+) egg models", buf.getvalue()))}
    return checks, m, one


def run_parallel(root, smi, p14):
    """Phase 19: the pipeline across processes. Returns the launches of
    each rank of (b)."""
    t_phase = time.perf_counter()
    checks = run_sharded_ba(smi, p14)
    more, m, one = one_process_run(root)
    checks.update(more)
    more, launches = run_ranks(root, smi, m, one, per_card=False)
    checks.update(more)
    ran = ["(a)", "(b)"]
    if torch.cuda.device_count() >= 2:
        more, _ = run_ranks(root, smi, m, one, per_card=True)
        checks.update(more)
        ran += ["(c)", "(d)"]
    log(f"[parallel] phase 19 in {time.perf_counter() - t_phase:.1f} s; "
        f"ran {' and '.join(ran)} ({torch.cuda.device_count()} cards)")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 19 failed: {failed}")
    return launches


VIDEO_SIZE, VIDEO_FRAMES = (1920, 1080), 300   # DJI's default 1080p30, 10 s
VIDEO_SHIFT = 2.5           # the flight log's clock ahead of the movie's, s
MOVER_FRAMES, SEGMENT_SCALE = 120, 0.5
LK_FRAMES = 30
LENS_K1 = -0.22
VIDEO_START = (2023, 6, 1, 10, 0, 0)   # the DJI log's first row, local time


def _frames(path, n=None, gray=False, scale=1.0):
    import cv2

    cap = cv2.VideoCapture(path)
    out = []
    while n is None or len(out) < n:
        ok, fr = cap.read()
        if not ok:
            break
        if gray:
            fr = cv2.cvtColor(fr, cv2.COLOR_BGR2GRAY)
        if scale != 1.0:
            fr = cv2.resize(fr, (0, 0), fx=scale, fy=scale)
        out.append(fr)
    cap.release()
    return out


def _jitter_deg(rot):
    """Rotation jitter of a motion track: the std of each frame's rotation
    (deg) about a straight-line fit over the frames."""
    rot = np.asarray(rot, float)
    t = np.arange(len(rot))
    return float((rot - np.polyval(np.polyfit(t, rot, 1), t)).std())


def _lens_tracks(gen, K, n_pairs=48, n_pts=300):
    """Pixel tracks of n_pairs frame pairs through a lens of k1 = LENS_K1:
    ideal normalized points over the frame, a random similarity motion
    between the views, then distorted (the reference's lens test, at the
    movie's K)."""
    from imageanalysis_tpu_torch.core.camera import (distort_normalized,
                                                     normalized_to_pixels)

    half = np.array([K[0, 2] / K[0, 0], K[1, 2] / K[1, 1]]) * 0.95
    dist = torch.tensor([LENS_K1, 0.0, 0.0, 0.0, 0.0])
    Kt = torch.as_tensor(K, dtype=torch.float32)
    pairs = []
    for _ in range(n_pairs):
        pa = gen.uniform(-half, half, (n_pts, 2)).astype(np.float32)
        th = gen.normal(0, 0.03)
        R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        pb = (pa @ R.T + gen.normal(0, 0.03, 2)).astype(np.float32)
        pairs.append(tuple(normalized_to_pixels(distort_normalized(
            torch.from_numpy(p), dist), Kt).numpy() for p in (pa, pb)))
    return pairs


def run_video(root, smi, dev="cuda", size=VIDEO_SIZE, n_frames=VIDEO_FRAMES,
              mover_frames=MOVER_FRAMES, hud_frames=90):
    """Phase 20: the video and motion tools at 1080p on movies made from a
    seed (testing/video.py). Every apps/video subcommand through its
    main(), on the card; the motion tools; the device work of each on the
    card against the same code on the CPU. Returns the walls."""
    import cv2

    from imageanalysis_tpu_torch.apps import video as video_app
    from imageanalysis_tpu_torch.io import exif
    from imageanalysis_tpu_torch.motion import (flow, lens_distortion,
                                                segment, streaming_dmd)
    from imageanalysis_tpu_torch.testing import video as synth
    from imageanalysis_tpu_torch.video import (correlate, djilog,
                                               flight_data, frame_motion)

    import datetime

    t_phase = time.perf_counter()
    checks, walls = {}, {}
    W, H = size
    movie_path = os.path.join(root, "flight.mp4")
    t0 = time.perf_counter()
    movie = synth.write_flight_movie(movie_path, seed=20, size=size,
                                     n_frames=n_frames)
    log_path = os.path.join(root, "flight.csv")
    synth.write_flight_log(log_path, movie, VIDEO_SHIFT)
    start = datetime.datetime(*VIDEO_START)
    dji_path = os.path.join(root, "DJIFlightRecord_2023-06-01_[10-00-00]"
                            ".csv")
    n_s = int(n_frames / movie.fps) + 4
    synth.write_dji_csv(dji_path, start, n_s + 4)
    srt_path = os.path.join(root, "flight.srt")
    synth.write_srt(srt_path, start + datetime.timedelta(seconds=2), n_s)
    mover_path = os.path.join(root, "mover.mp4")
    boxes = synth.write_mover_movie(mover_path, seed=21, size=size,
                                    n_frames=mover_frames)
    walls["synthesis_s"] = time.perf_counter() - t0
    log(f"[video-20] inputs: {W}x{H} {n_frames} frames at {movie.fps:g} "
        f"fps (mp4v, cv2 {cv2.__version__}), a {mover_frames}-frame still "
        f"movie with a mover, flight log, DJI CSV and .SRT in "
        f"{walls['synthesis_s']:.2f} s")

    # (a) est-gyro-rates: the host tracking and the card's batched fits
    t0 = time.perf_counter()
    pairs = list(frame_motion.track_video(movie_path))
    track_s = time.perf_counter() - t0
    pa, pb, w = frame_motion.pad_tracks(pairs)
    fits = {d: frame_motion.fit_pairs(pa, pb, w, d) for d in (dev, "cpu")}
    fit_ms = probes.time_ms(
        lambda: frame_motion.fit_pairs(pa, pb, w, dev), dev)
    d_rot = np.abs(fits[dev][0] - fits["cpu"][0]).max()
    d_t = max(np.abs(fits[dev][k] - fits["cpu"][k]).max() for k in (1, 2))
    motion_csv = os.path.join(root, "flight_motion.csv")
    t0 = time.perf_counter()
    rc = video_app.main(["est-gyro-rates", movie_path, "--out", motion_csv],
                        device=dev)
    walls["est-gyro-rates_s"] = time.perf_counter() - t0
    with open(motion_csv) as f:
        rows = list(csv.DictReader(f))
    frames = np.array([int(r["frame"]) for r in rows])
    est = np.median([float(r["rotation (deg)"]) for r in rows]) * movie.fps
    truth = np.median(np.diff(movie.angle_deg)[frames - 1]) * movie.fps
    checks.update({
        "(a) est-gyro-rates rc 0, a row a frame pair":
            rc == 0 and len(rows) == n_frames - 1,
        "(a) median rate within 1.5 deg/s": abs(est - truth) <= 1.5,
        # float32 sums of 400 tracks ~1000 px from the origin, in another
        # order: the parity tests' 1e-2 px
        "(a) card fits = CPU fits (1e-5 rad, 1e-2 px)":
            d_rot <= 1e-5 and d_t <= 1e-2,
    })
    log(f"[video-20a] est-gyro-rates: {walls['est-gyro-rates_s']:.3f} s for "
        f"{n_frames} frames; host LK tracking {1e3 * track_s / n_frames:.2f} "
        f"ms a frame, the card's batched fit of all {len(pairs)} pairs "
        f"{fit_ms:.3f} ms; median rate {est:.3f} deg/s (planted "
        f"{truth:.3f}); card vs CPU fits: rotation {d_rot:.2e} rad, "
        f"translation {d_t:.2e} px; {smi}")

    # (b) hud-overlay with the clock found by correlation, in both styles
    flight = flight_data.FlightLog(log_path)
    shift = video_app._auto_time_shift(flight, motion_csv, dev)
    mt = np.array([float(r["time"]) for r in rows])
    mrate = np.radians([float(r["rotation (deg)"]) for r in rows]) \
        / np.clip(np.gradient(mt), 1e-9, None)
    ft = flight.t - flight.t[0]
    frate = np.gradient(np.unwrap(np.radians(flight.cols["yaw"]))) \
        / np.clip(np.gradient(ft), 1e-3, None)
    ycorr = {d: correlate.sync_clocks(ft, frate, mt, mrate, device=d)[1]
             for d in (dev, "cpu")}
    d_corr = np.abs(ycorr[dev] - ycorr["cpu"]).max() \
        / np.abs(ycorr["cpu"]).max()
    fv = np.resize(frate, 4 * len(frate))
    corr_ms = probes.time_ms(
        lambda: correlate.cross_correlate_full(fv, mrate, device=dev), dev)
    checks.update({
        "(b) shift within 2/60 s": abs(shift - VIDEO_SHIFT) <= 2.0 / 60,
        "(b) card ycorr = CPU's (1e-4 of max)": d_corr <= 1e-4,
    })
    for style in ("classic", "glass"):
        out = os.path.join(root, f"hud_{style}.mp4")
        t0 = time.perf_counter()
        rc = video_app.main(["hud-overlay", movie_path, "--flight", log_path,
                             "--movie-csv", motion_csv, "--style", style,
                             "--max-frames", str(hud_frames), "--out", out],
                            device=dev)
        walls[f"hud-overlay_{style}_s"] = time.perf_counter() - t0
        drawn = _frames(out)
        checks[f"(b) hud-overlay {style}: rc 0, {hud_frames} frames"] = \
            rc == 0 and len(drawn) == hud_frames
        log(f"[video-20b] hud-overlay --style {style} --movie-csv: "
            f"{walls[f'hud-overlay_{style}_s']:.3f} s for {len(drawn)} "
            f"frames ({1e3 * walls[f'hud-overlay_{style}_s'] / hud_frames:.1f}"
            f" ms a frame, the sync included); {smi}")
    log(f"[video-20b] clock sync: shift {shift:.4f} s (planted "
        f"{VIDEO_SHIFT}); one FFT cross-correlation of {len(fv)} x "
        f"{len(mrate)} samples {corr_ms:.3f} ms; card vs CPU ycorr "
        f"{d_corr:.2e} of its max; {smi}")

    # (c) stabilize
    stab = os.path.join(root, "flight_stab.mp4")
    t0 = time.perf_counter()
    rc = video_app.main(["stabilize", movie_path, "--out", stab], device=dev)
    walls["stabilize_s"] = time.perf_counter() - t0
    n_out = len(_frames(stab, gray=True, scale=0.05))
    # from the second pair on: the stabilizer writes frame 0 as it is and
    # corrects frame 1 by its whole offset from the smoothed trajectory
    rot_in = np.degrees(fits[dev][0])[1:]
    rot_out = [r[2] for r in
               frame_motion.estimate_motion(stab, device=dev)[1:]]
    j_in, j_out = _jitter_deg(rot_in), _jitter_deg(rot_out)
    checks.update({
        "(c) stabilize rc 0, every frame written":
            rc == 0 and n_out == n_frames,
        "(c) rotation jitter below the input's": j_out < j_in,
    })
    log(f"[video-20c] stabilize: {walls['stabilize_s']:.3f} s, {n_out} "
        f"frames; rotation jitter {j_out:.4f} deg against the input's "
        f"{j_in:.4f}; {smi}")

    # (d) extract-geotag (from the .SRT's start) and extract-dji
    dji = djilog.DjiCsv().load(dji_path)
    srt_start = djilog.parse_srt(srt_path)[0][1]["datetime"]
    gps_err = np.zeros(2)
    n_tagged = {}
    for cmd in ("extract-geotag", "extract-dji"):
        out_dir = os.path.join(root, cmd)
        t0 = time.perf_counter()
        rc = video_app.main([cmd, movie_path, "--log", dji_path, "--out-dir",
                             out_dir, "--srt", srt_path], device=dev)
        walls[f"{cmd}_s"] = time.perf_counter() - t0
        names = sorted(f for f in os.listdir(out_dir) if f.endswith(".jpg"))
        n_tagged[cmd] = len(names)
        for i, name in enumerate(names):
            lon, lat, alt, *_ = exif.get_pose(os.path.join(out_dir, name))
            q = dji.query(srt_start + i * 1.0)
            gps_err = np.maximum(gps_err, [max(abs(lat - q["lat"]),
                                               abs(lon - q["lon"])),
                                           abs(alt - q["baro_alt"])])
        checks[f"(d) {cmd} rc 0, a frame a second, pix4d.csv"] = \
            rc == 0 and len(names) == int(np.ceil(n_frames / movie.fps)) \
            and os.path.isfile(os.path.join(out_dir, "pix4d.csv"))
    # the writer's rounding: 1e-4 arc-second, 1 cm
    checks["(d) GPS read back within the writer's rounding"] = \
        gps_err[0] <= 1e-4 / 3600 + 1e-9 and gps_err[1] <= 0.005 + 1e-9
    log(f"[video-20d] extract-geotag {walls['extract-geotag_s']:.3f} s, "
        f"extract-dji {walls['extract-dji_s']:.3f} s: {n_tagged} frames; "
        f"GPS read back {gps_err[0]:.2e} deg, {gps_err[1]:.4f} m from the "
        f"log; {smi}")

    # (e) segment_video: the mover's mask against the planted block
    t0 = time.perf_counter()
    bg, masks = segment.segment_video(mover_path, max_frames=mover_frames,
                                      scale=SEGMENT_SCALE, device=dev)
    walls["segment_video_s"] = time.perf_counter() - t0
    truth = np.zeros_like(masks)
    s = SEGMENT_SCALE
    for i, (x0, y0, x1, y1) in enumerate(boxes[:len(masks)]):
        truth[i, int(y0 * s):int(y1 * s), int(x0 * s):int(x1 * s)] = True
    iou = (masks & truth).sum() / max((masks | truth).sum(), 1)
    # the snapshots as segment_video makes them
    gray = _frames(mover_path, mover_frames, gray=True, scale=s)
    F = np.stack(gray).astype(np.float32).reshape(len(gray), -1).T
    X, Y = F[:, :-1], F[:, 1:]
    Xd = torch.as_tensor(np.ascontiguousarray(X), device=dev)
    svd_ms = probes.time_ms(
        lambda: torch.linalg.svd(Xd, full_matrices=False), dev, 3)
    S = {d: torch.linalg.svd(torch.as_tensor(np.ascontiguousarray(X),
                                             device=d),
                             full_matrices=False)[1].cpu().numpy()
         for d in (dev, "cpu")}
    d_s = np.abs(S[dev] - S["cpu"]).max() / S["cpu"][0]
    checks.update({
        "(e) mover mask IoU >= 0.5": iou >= 0.5,
        "(e) card singular values = CPU's (1e-4 of the largest)":
            d_s <= 1e-4,
    })
    log(f"[video-20e] segment_video {mover_frames} frames at scale {s} "
        f"({masks.shape[2]}x{masks.shape[1]}): {walls['segment_video_s']:.3f}"
        f" s; mover IoU {iou:.4f}; SVD of the {X.shape[0]}x{X.shape[1]} "
        f"snapshots {svd_ms:.3f} ms; card vs CPU singular values "
        f"{d_s:.2e} of the largest; {smi}")

    # (f) StreamingDMD over the same snapshots against exact DMD, full rank
    t0 = time.perf_counter()
    _, ev_exact, _ = segment.exact_dmd(X, Y, device=dev)
    exact_s = time.perf_counter() - t0
    sdmd = streaming_dmd.StreamingDMD(device=dev)
    t0 = time.perf_counter()
    for k in range(X.shape[1]):
        sdmd.update(X[:, k], Y[:, k])
    _sync(dev)
    stream_s = time.perf_counter() - t0
    _, ev_stream = sdmd.compute_modes()
    from scipy.optimize import linear_sum_assignment

    cost = np.abs(ev_exact[:, None] - ev_stream[None, :])
    r, c = linear_sum_assignment(cost)
    lasting = np.abs(ev_exact[r]) > 0.9
    d_ev = cost[r, c][lasting].max() if lasting.any() else np.inf
    checks["(f) StreamingDMD's eigenvalues within 1e-3 of exact DMD's"] = \
        len(ev_stream) == len(ev_exact) and d_ev <= 1e-3
    log(f"[video-20f] StreamingDMD: {X.shape[1]} updates {stream_s:.3f} s, "
        f"exact_dmd {exact_s:.3f} s; {int(lasting.sum())} of "
        f"{len(ev_exact)} eigenvalues with |λ| > 0.9, matched within "
        f"{d_ev:.2e} (all: {cost[r, c].max():.2e}); {smi}")

    # (g) SparseLK on the flight movie against the planted motion
    tracker = flow.SparseLK(device=dev)
    canvas = int(np.ceil(np.hypot(W, H) + 2 * np.abs(movie.drift).max())) \
        + 16
    grid = np.stack(np.meshgrid(np.linspace(0.1 * W, 0.9 * W, 9),
                                np.linspace(0.1 * H, 0.9 * H, 5)), -1) \
        .reshape(-1, 2)
    lk_err, lk_inl = 0.0, []
    t0 = time.perf_counter()
    for i, g in enumerate(_frames(movie_path, LK_FRAMES, gray=True)):
        Hm, n_inl = tracker.update(g)
        if i == 0:
            continue
        A = [np.vstack([synth.view_matrix(canvas, size, -movie.angle_deg[k],
                                          movie.drift[k]), [0, 0, 1]])
             for k in (i - 1, i)]
        T = A[1] @ np.linalg.inv(A[0])
        ph = np.c_[grid, np.ones(len(grid))]
        want = (ph @ T.T)[:, :2]
        if Hm is None:
            lk_err = np.inf
            continue
        got = ph @ Hm.T
        lk_err = max(lk_err, np.abs(got[:, :2] / got[:, 2:] - want).max())
        lk_inl.append(n_inl)
    walls["sparse_lk_s"] = time.perf_counter() - t0
    checks["(g) SparseLK within 0.5 px of the planted motion"] = \
        lk_err <= 0.5
    log(f"[video-20g] SparseLK over {LK_FRAMES} frames: "
        f"{walls['sparse_lk_s']:.3f} s; homographies within {lk_err:.4f} "
        f"px of the planted motion (inliers {min(lk_inl)}–{max(lk_inl)}); "
        f"{smi}")

    # (h) the lens fit on tracks through k1 = −0.22
    gen = np.random.default_rng(22)
    K = np.array([[1500.0, 0, W / 2], [0, 1500.0, H / 2], [0, 0, 1]],
                 np.float32)
    tracks = _lens_tracks(gen, K)
    t0 = time.perf_counter()
    k1, k2, hist = lens_distortion.estimate_k1_k2(tracks, K, device=dev)
    walls["estimate_k1_k2_s"] = time.perf_counter() - t0
    lg = {}
    for d in (dev, "cpu"):
        p = torch.tensor([-0.1, 0.02], device=d, requires_grad=True)
        loss = lens_distortion.pair_loss(tracks, K, torch.device(d))
        val = loss(p)
        val.backward()
        lg[d] = (float(val.detach()), p.grad.cpu().numpy())
        if d == dev:     # one warm step's loss and gradient
            step_ms = probes.time_ms(lambda: loss(p).backward(), dev, 10)
    d_loss = abs(lg[dev][0] - lg["cpu"][0]) / abs(lg["cpu"][0])
    d_grad = np.abs(lg[dev][1] - lg["cpu"][1]).max() \
        / np.abs(lg["cpu"][1]).max()
    checks.update({
        "(h) k1 within 0.05 of the planted": abs(k1 - LENS_K1) <= 0.05,
        "(h) card loss, gradient = CPU's (rtol 1e-4, 1e-3)":
            d_loss <= 1e-4 and d_grad <= 1e-3,
    })
    log(f"[video-20h] estimate_k1_k2 over {len(tracks)} pairs x "
        f"{len(tracks[0][0])} tracks, 300 Adam steps: "
        f"{walls['estimate_k1_k2_s']:.3f} s (a warm step's loss and "
        f"gradient {step_ms:.3f} ms); k1 {k1:.4f} (planted "
        f"{LENS_K1}), k2 {k2:.4f}, loss {hist[0]:.3f} -> {hist[-1]:.5f} "
        f"px²; card vs CPU loss {d_loss:.2e}, gradient {d_grad:.2e}; {smi}")

    walls["phase_s"] = time.perf_counter() - t_phase
    log("[video-20] " + json.dumps({**walls, "device": smi}))
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 20 failed: {failed}")
    return walls


# ---------------------------------------------------------------------------
# phase 21: the store's modes and the tools that come after a run
# ---------------------------------------------------------------------------

# (dtype, bf16) of each store mode; the matcher runs int8 and uint8 in bf16
STORE_MODES = (("int8", True), ("uint8", True), ("float32", True),
               ("float32", False))
STORE_CPU_PAIRS = 48        # work-list pairs of the card-vs-CPU store match
TOOL_POINTS = 8             # planted ground points: annotations and marks
CAL_VIEWS, CAL_FX = 8, 2000.0   # chessboard views and their planted fx


def _mode_name(dtype, bf16, gated=False):
    name = dtype if bf16 or dtype != "float32" else "float32_f32"
    return name + ("_smart" if gated else "")


def _same_lists(a, b):
    return a.keys() == b.keys() and all(np.array_equal(a[p], b[p])
                                        for p in a)


def store_path(proj, pairs, runs, dev="cuda"):
    """BatchMatcher's store path over the workspace proj in each run's
    store mode (dtype, bf16, gated: the smart strategy) on the work list
    pairs. Returns ({mode: match lists}, {mode: launches}, {mode: walls})
    by _mode_name."""
    lists, launches, walls = {}, {}, {}
    for dtype, bf16, gated in runs:
        name = _mode_name(dtype, bf16, gated)
        cfg = matcher.MatchConfig(
            strategy="smart" if gated else "traditional", bf16=bf16)
        state = smart.SmartState(proj.analysis_dir) if gated else None
        bm = matcher.BatchMatcher(proj, cfg, use_store=False,
                                  smart_state=state, device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        bm.store = DescriptorStore.from_project(proj, device=dev,
                                                dtype=dtype)
        _sync(dev)
        store_s = time.perf_counter() - t0
        for im in proj.image_list:
            im.match_list = {}
        reset_launches()
        t0 = time.perf_counter()
        bm.match_pairs(pairs)
        _sync(dev)
        walls[name] = {"store_s": store_s,
                       "match_s": time.perf_counter() - t0}
        launches[name] = read_launches()
        lists[name] = project_matches(proj, pairs)
        del bm
    return lists, launches, walls


def run_store_modes(proj, m, smi, dev="cuda"):
    """Phase 21 (a): BatchMatcher's store path over a workspace of the
    mission in each store mode (traditional: int8, uint8, float32 with
    bf16 on and off; smart: int8 and uint8), on phases 7-8's work list;
    every mode's match lists equal int8's on the detector's integer
    descriptors, and the mode's K1 launched. Then non-integer rows: the
    descriptors plus seeded uniform noise in [-0.5, 0.5) in a float32
    store: K1 f32 and bf16 on one store batch against knn_packed_plain,
    and the store path on the card against the same code on the CPU.
    Returns {mode: launches}."""
    W = m.frames[0].shape[1]
    thresh = float(W) ** 0.25
    pairs = [(i, j) for _, i, j in worklist.build_work_list(
        m.ned, use_distance=True)]
    runs = [(d, b, False) for d, b in STORE_MODES] + [
        ("int8", True, True), ("uint8", True, True)]
    lists, launches, walls = store_path(proj, pairs, runs, dev)
    kernel = {"int8": "knn_packed_i8", "uint8": "knn_packed_bf16",
              "float32": "knn_packed_bf16", "float32_f32": "knn_packed_f32",
              "int8_smart": "knn_packed_gated",
              "uint8_smart": "knn_packed_gated"}
    n_kept = sum(bool(len(r)) for r in lists["int8"].values())
    checks = {
        "(a) every mode's lists equal int8's": all(
            _same_lists(lists[n], lists["int8"])
            for n in ("uint8", "float32", "float32_f32")),
        "(a) smart uint8's lists equal smart int8's": _same_lists(
            lists["uint8_smart"], lists["int8_smart"]),
        "(a) a pair kept an image": n_kept >= len(m.ned) - 1,
    }
    equal = checks["(a) every mode's lists equal int8's"]
    if torch.device(dev).type == "cuda":
        checks["(a) each mode's K1 launched"] = all(
            launches[n][k] > 0 for n, k in kernel.items())
    log(f"[tools-21a] store path over {len(m.ned)} frames, {len(pairs)} "
        f"pairs ({n_kept} kept in int8): walls s "
        + json.dumps({n: {k: round(v, 3) for k, v in w.items()}
                      for n, w in walls.items()})
        + "; launches " + json.dumps(
            {n: {k: v for k, v in launches[n].items() if v}
             for n in launches})
        + f"; lists equal int8's: {equal}; {smi}")

    # non-integer rows in a float32 store
    store = DescriptorStore.from_project(proj, device=dev, dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(21)
    rows = (torch.arange(store.npad, device=dev)[None, :, None]
            < store.counts[:, None, None])
    store.desc += (torch.rand(store.desc.shape, generator=gen, device=dev)
                   - 0.5) * rows
    if torch.device(dev).type == "cuda":
        B = min(STORE_SHAPE[0], len(pairs))
        ia = torch.tensor([p[0] for p in pairs[:B]], device=dev)
        ib = torch.tensor([p[1] for p in pairs[:B]], device=dev)
        n = int(store.counts.min()) // 64 * 64
        a = store.desc[ia, :n].contiguous()
        b = store.desc[ib, :n].contiguous()
        na2, nb2 = knn._sq_norms(a), knn._sq_norms(b)
        for dt, rel in ((torch.float32, 2.0 ** -20),
                        (torch.bfloat16, TC_REL_TOL)):
            mode = str(dt)[6:]
            xa, xb = a.to(dt).contiguous(), b.to(dt).contiguous()
            got = knn.knn_packed_raw(xa, xb, na2, nb2)
            want = knn.knn_packed_plain(xa, xb, na2, nb2)
            tol = rel * float(na2.max() + nb2.max())
            er, _, dr = near_packed(f"K1 {mode} non-integer rows", got[0],
                                    want[0], xa.float(), xb.float(), tol,
                                    norms=(na2, nb2))
            ec, _, dc = near_packed(f"K1 {mode} non-integer cols", got[1],
                                    want[1], xb.float(), xa.float(), tol,
                                    norms=(nb2, na2))
            log(f"[tools-21a] K1 {mode} on a float32 store batch of {B} "
                f"pairs x {n} non-integer rows against knn_packed_plain: "
                f"values within {max(er, ec):.4g} (tolerance {tol:.4g} "
                f"plus a key's 10-bit step); {dr + dc} indices differ, all "
                "on ties")
            del xa, xb, got, want
        del a, b
    sub = pairs[:STORE_CPU_PAIRS]
    t0 = time.perf_counter()
    got = matcher.match_pairs_store(store, sub, matcher.MatchConfig(),
                                    thresh)
    card_s = time.perf_counter() - t0
    host = DescriptorStore(store.desc.cpu(), store.uv.cpu(),
                           store.counts.cpu())
    t0 = time.perf_counter()
    want = matcher.match_pairs_store(host, sub, matcher.MatchConfig(),
                                     thresh)
    cpu_s = time.perf_counter() - t0
    same = union = 0
    for p in sub:
        g = {tuple(r) for r in got[p].tolist()}
        w = {tuple(r) for r in want[p].tolist()}
        same += len(g & w)
        union += len(g | w)
    share = same / max(union, 1)
    checks["(a) non-integer store path: >= 99% of matches equal the CPU's"] \
        = share >= 0.99 and union > 0
    log(f"[tools-21a] float32 store of non-integer rows, {len(sub)} pairs "
        f"through match_pairs_store: {same} of {union} matches equal on the "
        f"card and the CPU ({100 * share:.3f}%); card {card_s:.3f} s, CPU "
        f"{cpu_s:.3f} s; {smi}")
    del store, host
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 21 (a) failed: {failed}")
    return launches


def calibration_views(root, size, fx, n=CAL_VIEWS, seed=21):
    """n chessboard views (9 x 6 inner corners of 25 mm squares, 60 px
    each on the board image) through a camera of focal length fx at the
    centre of a size frame, as PNGs in root. tests/test_utils_inspect.py's
    views, scaled to the frame."""
    import cv2

    W, H = size
    K = np.array([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1]])
    board = np.kron((np.add.outer(np.arange(7), np.arange(10)) % 2 == 0)
                    .astype(np.uint8) * 255, np.ones((60, 60), np.uint8))
    gen = np.random.default_rng(seed)
    sq = 25.0
    z0 = fx * 0.9       # the board spans about a fifth of the frame
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        R, _ = cv2.Rodrigues(gen.normal(0, 0.25, 3))
        t = np.array([gen.normal(-20, 10), gen.normal(-20, 10),
                      gen.uniform(z0, 1.5 * z0)])
        Hb = K @ np.column_stack([R[:, 0] * (sq / 60), R[:, 1] * (sq / 60),
                                  R @ np.array([-120 * sq / 60,
                                                -90 * sq / 60, 0]) + t])
        cv2.imwrite(os.path.join(root, f"cal_{i:02d}.png"),
                    cv2.warpPerspective(board, Hb / Hb[2, 2], (W, H),
                                        borderValue=128))
    return root


def _match_files(proj_dir):
    """{image name: its .match dict} from a workspace's files."""
    import pickle

    meta = os.path.join(proj_dir, "ImageAnalysis", "meta")
    out = {}
    for f in sorted(os.listdir(meta)):
        if f.endswith(".match"):
            with open(os.path.join(meta, f), "rb") as fh:
                out[f[:-6]] = {k: np.asarray(v).reshape(-1, 2).tolist()
                               for k, v in pickle.load(fh).items()}
    return out


def _review_left(before, after, dropped):
    """The review's decisions held: the dropped pairs' entries empty in
    both directions, every other entry as it was."""
    gone = {(a, b) for a, b in dropped} | {(b, a) for a, b in dropped}
    for name, ml in before.items():
        for other, rows in ml.items():
            want = [] if (name, other) in gone else rows
            if after[name].get(other) != want:
                return False
    return True


def _tiles_per_frame(W, H, tile, overlap):
    """The tiles zooniverse's chop cuts from a W x H frame."""
    step = tile - overlap
    n_y = len({min(y, max(H - tile, 0)) for y in range(0, max(H - overlap,
                                                                 1), step)})
    n_x = len({min(x, max(W - tile, 0)) for x in range(0, max(W - overlap,
                                                                 1), step)})
    return n_x * n_y


def run_tools(root, smi, dev="cuda", size=FRAME, strips=STRIPS,
              per_strip=PER_STRIP, max_features=MAX_FEATURES):
    """Phase 21: the store's modes (run_store_modes) and the tools that
    come after a run (apps/inspect.py, utils.py, zooniverse.py,
    explorer.py, render/annotations.py, surface/coverage.py) on the
    mission of phases 16-17 written with EXIF and XMP, after process.main
    with --histogram. Returns phase 21 (a)'s launches by store mode."""
    t_phase = time.perf_counter()
    W, H = size
    m = make_mission(strips=strips, per_strip=per_strip, size=size, seed=0,
                     device=dev)
    proj_dir = os.path.join(root, "tools")
    db = os.path.join(root, "cameras")
    write_mission(proj_dir, m, db, exif=True)
    argv = [proj_dir, "--camera-db", db, "--scale", "1.0", "--ground", "0.0",
            "--batch-size", "32", "--min-chain-len", "2", "--detector", "TPU",
            "--max-features", str(max_features), "--histogram"]
    t0 = time.perf_counter()
    rc = process.main(argv, device=dev)
    wall = time.perf_counter() - t0
    proj = ProjectMgr(proj_dir)
    proj.load_images_info()
    if rc != 0 or not proj.state.check("STEP5"):
        raise AssertionError(f"phase 21: process.main returned {rc}")
    log(f"[tools-21] {len(proj.image_list)} JPEGs {W}x{H} with EXIF, "
        f"process.main --histogram {wall:.3f} s")
    p21 = run_store_modes(proj, m, smi, dev)
    run_tool_checks(root, proj_dir, m, smi, dev)
    log(f"[tools-21] phase {time.perf_counter() - t_phase:.3f} s; {smi}")
    return p21


def run_tool_checks(root, proj_dir, m, smi, dev="cuda"):
    """Phase 21 (b): the tools on a processed workspace of the mission m
    in proj_dir (its frames tagged with EXIF); scratch files under root.
    The card's name and power limit smi go on each line."""
    import datetime
    import importlib.util

    from imageanalysis_tpu_torch.apps import explorer as explorer_app
    from imageanalysis_tpu_torch.apps import inspect as inspect_app
    from imageanalysis_tpu_torch.apps import utils as utils_app
    from imageanalysis_tpu_torch.apps import zooniverse as zoo_app
    from imageanalysis_tpu_torch.render.annotations import Annotations
    from imageanalysis_tpu_torch.surface import coverage
    from imageanalysis_tpu_torch.testing.synthetic import EXIF_T0

    walls, checks, seen = {}, {}, {}
    proj = ProjectMgr(proj_dir)
    proj.load_images_info()
    n_img = len(proj.image_list)
    H, W = m.frames[0].shape[:2]
    mpl = importlib.util.find_spec("matplotlib") is not None
    log("[tools-21b] matplotlib: " + (
        "present" if mpl else "absent: render_to and plot-matches not run "
        "(the review GUI is never run here)"))

    def call(name, main, args):
        out = io.StringIO()
        _sync(dev)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = main(args, device=dev)
        _sync(dev)
        walls[name] = time.perf_counter() - t0
        checks[f"{name} rc 0"] = rc == 0
        return out.getvalue()

    # inspect
    for name, args in (("features", ["IMG_0000"]),
                       ("pair", ["IMG_0000", "IMG_0001"])):
        png = os.path.join(root, f"{name}.png")
        call(f"inspect {name}", inspect_app.main,
             [name, proj_dir] + args + ["--out", png])
        checks[f"inspect {name} wrote its PNG"] = (
            os.path.isfile(png) and os.path.getsize(png) > 1000)
    call("inspect groups", inspect_app.main, ["groups", proj_dir])
    out = call("inspect matches", inspect_app.main, ["matches", proj_dir])
    checks["inspect matches counts chains"] = "chains" in out
    review = os.path.join(root, "review")
    shutil.copytree(proj_dir, review)
    for by_image, keys in ((False, "dd"), (True, "d")):
        before = _match_files(review)
        rp = ProjectMgr(review)
        rp.load_images_info()
        items = inspect_app.ReviewSession(
            rp, "images" if by_image else "pairs", device=dev).items
        if by_image:
            im = items[0][0]
            dropped = [(im.name, o) for o in before[im.name]]
        else:
            dropped = [(a.name, b.name) for a, b in items[:len(keys)]]
        name = "inspect review --by-image" if by_image else "inspect review"
        call(name, inspect_app.main, ["review", review, "--keys", keys]
             + (["--by-image"] if by_image else []))
        checks[f"{name}: dropped emptied, the rest untouched"] = (
            len(before) == n_img and bool(dropped)
            and _review_left(before, _match_files(review), dropped))

    # utils
    from imageanalysis_tpu_torch.render import histogram as hist_mod
    hist0, tmpl0 = hist_mod.load(proj.analysis_dir)
    call("utils histogram", utils_app.main, ["histogram", proj_dir])
    hist1, tmpl1 = hist_mod.load(proj.analysis_dir)
    checks["utils histogram rebuilds the run's tables"] = (
        hist0 is not None and sorted(hist1) == sorted(hist0)
        and all(np.array_equal(hist1[k][c], hist0[k][c])
                and np.array_equal(tmpl1[k][c], tmpl0[k][c])
                for k in hist0 for c in range(3)))
    ref = proj.ned_reference_lla()
    cams = camera_positions(proj)
    names = [im.name for im in proj.image_list]
    picks = np.linspace(0, n_img - 1, TOOL_POINTS).round().astype(int)
    points = np.array([cams[names[i]] + [3.0, -2.0, 0.0] for i in picks])
    points[:, 2] = 0.0
    lla = geodesy.ned2lla(points, *ref)
    csv_path = os.path.join(root, "points.csv")
    with open(csv_path, "w") as f:
        f.write("OBJECTID,Latitude,Longitude,Altitude\n" + "".join(
            f"{k},{la:.10f},{lo:.10f},{al:.4f}\n"
            for k, (la, lo, al) in enumerate(lla)))
    call("utils import-annotations", utils_app.main,
         ["import-annotations", proj_dir, csv_path])
    out = call("utils preview-crops", utils_app.main,
               ["preview-crops", proj_dir])
    size_px = 256
    at = re.findall(r"from (\S+) at \((\d+),(\d+)\)", out)
    poses = {im.name: (np.asarray(im.get_camera_pose(opt=im.has_opt_pose())
                                  [0]),
                       np.asarray(im.get_camera_pose(
                           opt=im.has_opt_pose())[2]))
             for im in proj.image_list}
    model = proj.camera_model(optimized=True)
    uv = utils_app.project_markers(points, [poses[a[0]] for a in at], model,
                                   dev) if len(at) == TOOL_POINTS else []
    inside = [abs(u - int(cx)) <= size_px and abs(v - int(cy)) <= size_px
              for (u, v), (_, cx, cy) in zip(uv, at)]
    pdir = os.path.join(proj.analysis_dir, "annotations-preview")
    jpgs = [f for f in os.listdir(pdir) if f.endswith(".jpg")]
    checks["preview-crops: every point inside its crop, 8 JPEGs, "
           "index.html"] = (len(inside) == TOOL_POINTS and all(inside)
                            and len(jpgs) == TOOL_POINTS and os.path.isfile(
                                os.path.join(pdir, "index.html")))
    feats_t = [poses[a[0]] for a in at]
    proj_ms = probes.time_ms(lambda: utils_app.project_markers(
        points, feats_t, model, dev), dev, 10) if len(at) else float("nan")
    out = call("utils est-cam-transform", utils_app.main,
               ["est-cam-transform", proj_dir])
    rows = re.findall(r"^IMG_\d+((?:\s+\S+){6})$", out, re.M)
    vals = np.array([[float(x) for x in r.split()] for r in rows])
    grps = groups.load(proj.analysis_dir)
    seen["est-cam-transform rows, group 0"] = (len(rows), len(grps[0]))
    checks["est-cam-transform: a finite row an image of group 0"] = (
        len(rows) == len(grps[0]) >= 0.9 * n_img
        and np.isfinite(vals).all())
    out = call("utils capture-dates", utils_app.main,
               ["capture-dates", proj_dir])
    dates = re.findall(r"^(IMG_\d+)\.jpg (.+)$", out, re.M)
    want = [(image_name(i), datetime.datetime.fromtimestamp(
        EXIF_T0 + i).isoformat(" ")) for i in range(n_img)]
    checks["capture-dates: the EXIF times written"] = dates == want
    home = os.environ.get("HOME")
    os.environ["HOME"] = tempfile.mkdtemp(dir=root)  # no ~/.forecastio
    try:
        out = call("utils wx-report", utils_app.main, ["wx-report", proj_dir])
    finally:
        if home is None:
            os.environ.pop("HOME")
        else:
            os.environ["HOME"] = home
    loc = re.findall(r"Mission location: (\S+), (\S+)", out)
    truth = geodesy.ned2lla(m.ned, *REF_LLA)
    mid = 0.5 * (truth[0] + truth[-1])
    checks["wx-report: mean GPS within 1e-6 deg, no weather lookup"] = (
        len(loc) == 1 and abs(float(loc[0][0]) - mid[0]) <= 1e-6
        and abs(float(loc[0][1]) - mid[1]) <= 1e-6
        and "skipping weather lookup" in out)
    listing = sorted(os.listdir(proj_dir))
    out = call("utils trim-far", utils_app.main, ["trim-far", proj_dir])
    checks["trim-far lists every image, deletes nothing"] = (
        len(re.findall(r"^IMG_\d+\s+[\d.]+ m$", out, re.M)) == n_img
        and sorted(os.listdir(proj_dir)) == listing)
    call("utils vignette", utils_app.main,
         ["vignette", proj_dir, "--max-images", "16"])
    zip_path = os.path.join(root, "tools.zip")
    call("utils zip", utils_app.main, ["zip", proj_dir, "--out", zip_path])
    newdb = os.path.join(root, "newdb")
    call("utils new-camera", utils_app.main,
         ["new-camera", os.path.join(proj_dir, "IMG_0000.jpg"), "--db",
          newdb])
    cams_new = [json.load(open(os.path.join(newdb, f)))
                for f in os.listdir(newdb)] if os.path.isdir(newdb) else []
    checks["vignette, zip and new-camera wrote; K within 1% of the DB's"] = (
        os.path.isfile(os.path.join(proj.analysis_dir, "vignette.png"))
        and os.path.getsize(zip_path) > 0 and len(cams_new) == 1
        and abs(cams_new[0]["K"][0] / float(m.K[0, 0]) - 1.0) <= 0.01)
    cal = calibration_views(os.path.join(root, "cal"), (W, H), CAL_FX)
    caldb = os.path.join(root, "caldb")
    call("utils calibrate", utils_app.main,
         ["calibrate", "--images", cal, "--pattern", "9x6", "--square-mm",
          "25", "--db", caldb])
    cal_cfg = [json.load(open(os.path.join(caldb, f)))
               for f in os.listdir(caldb)] if os.path.isdir(caldb) else []
    checks["calibrate: fx within 1%"] = (
        len(cal_cfg) == 1 and abs(cal_cfg[0]["K"][0] / CAL_FX - 1.0) <= 0.01)
    if mpl:
        graph = os.path.join(root, "graph.png")
        call("utils plot-matches", utils_app.main,
             ["plot-matches", proj_dir, "--out", graph])
        checks["plot-matches wrote its figure"] = (
            os.path.getsize(graph) > 20_000)

    # zooniverse
    tiles_dir = os.path.join(root, "tiles")
    call("zooniverse chop", zoo_app.main,
         ["chop", proj_dir, tiles_dir, "--tile", "512", "--overlap", "64"])
    with open(os.path.join(tiles_dir, "tiles.csv")) as f:
        manifest = list(csv.DictReader(f))
    per = {}
    for r in manifest:
        per.setdefault(r["image"], []).append(r)
    n_tiles = _tiles_per_frame(W, H, 512, 64)     # 20 at 2176x1440
    seen["chop tiles"] = (len(manifest), n_tiles)
    checks[f"chop: {n_tiles} tiles a frame"] = (
        len(manifest) == n_tiles * n_img
        and all(len(v) == n_tiles for v in per.values()))
    marks = os.path.join(root, "marks.csv")
    with open(marks, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["tile", "u", "v", "comment"])
        for k, ((name, _, _), (u, v)) in enumerate(zip(at, uv)):
            # the tile of the image that holds the point farthest inside
            best = max(per[name], key=lambda r: min(
                u - int(r["x0"]), int(r["x0"]) + 512 - u,
                v - int(r["y0"]), int(r["y0"]) + 512 - v))
            w.writerow([best["tile"], u - int(best["x0"]),
                        v - int(best["y0"]), f"point {k}"])
    call("zooniverse paste", zoo_app.main,
         ["paste", proj_dir, marks, os.path.join(tiles_dir, "tiles.csv")])
    ann = Annotations(proj.analysis_dir, ref).load()
    pasted = np.array([mk["ned"] for mk in ann.markers[-TOOL_POINTS:]])
    paste_err = (np.abs(pasted - points).max()
                 if len(ann.markers) == 2 * TOOL_POINTS else np.inf)
    checks["paste: every marker within 0.5 m of its point"] = \
        paste_err <= 0.5

    def rays():
        t = [torch.as_tensor(np.asarray(x, np.float32), device=dev)
             for x in ([[float(u), float(v)] for u, v in uv],
                       [poses[a[0]][0] for a in at],
                       [poses[a[0]][1] for a in at])]
        return zoo_app.cast_marks(*t, model.K.to(dev), model.dist.to(dev))
    rays_ms = probes.time_ms(rays, dev, 10)

    # explorer and coverage
    t0 = time.perf_counter()
    ex = explorer_app.Explorer(proj_dir, device=dev)
    walls["explorer init"] = time.perf_counter() - t0
    models = ex._model_names()
    # the centre of the cameras that have a model, (n, e)
    centre = np.mean([cams[n][:2] for n in models if n in cams], 0)
    ce = (float(centre[1]), float(centre[0]))             # (e, n)
    top = ex.select_top(models, ce)
    rects = {n: coverage.image_coverage(ex._grid(n)[0]) for n in models}
    covering = coverage.images_covering_point(rects, *ce)
    seen["select_top"] = (top, ce, rects.get(top), len(covering))
    checks["select_top covers the centre; coverage includes it"] = (
        top is not None and top in covering
        and rects[top][0] <= ce[0] <= rects[top][2]
        and rects[top][1] <= ce[1] <= rects[top][3])
    _sync(dev)
    t0 = time.perf_counter()
    rgba, extent = ex._warp_full(top)
    _sync(dev)
    walls["explorer _warp_full"] = time.perf_counter() - t0
    _sync(dev)
    t0 = time.perf_counter()
    ex._warp_full(top)
    _sync(dev)
    warp_warm = time.perf_counter() - t0
    warp_dev = (probes.device_ms(lambda: ex._warp_full(top), reps=3)
                if torch.device(dev).type == "cuda" else float("nan"))
    host_ex = explorer_app.Explorer(proj_dir, device="cpu")
    tex = ex.textures.load_full(top).cpu()
    host_ex.textures.load_full = lambda name: tex
    t0 = time.perf_counter()
    rgba_cpu, extent_cpu = host_ex._warp_full(top)
    warp_cpu = time.perf_counter() - t0
    differ = float((rgba != rgba_cpu).any(-1).mean())
    seen["_warp_full extent, covered"] = (extent, float(
        (rgba[..., 3] > 0).mean()))
    checks["_warp_full card vs CPU: <= 0.1% of pixels differ, same extent"] \
        = extent == extent_cpu and differ <= 1e-3 \
        and (rgba[..., 3] > 0).mean() > 0.3
    elev = ex.get_elevation(*ce)
    checks["get_elevation at the centre within 1 m of 0"] = abs(elev) <= 1.0
    if mpl:
        png = os.path.join(root, "explorer.png")
        t0 = time.perf_counter()
        drawn = ex.render_to(png)
        walls["explorer render_to"] = time.perf_counter() - t0
        seen["render_to drawn, bytes"] = (drawn, os.path.getsize(png))
        checks["render_to draws >= 63 models into a PNG > 20 kB"] = (
            drawn >= n_img - 1 and os.path.getsize(png) > 20_000)
    n_mk = len(ex.annotations.markers)
    ex.annotations.add_marker_ned([centre[0], centre[1], 0.0], "phase 21")
    ex.annotations.save(np.array(list(cams.values())), mission_name="p21")
    again = Annotations(proj.analysis_dir, ref).load()
    kml = open(os.path.join(proj.analysis_dir, "annotations.kml")).read()
    checks["annotation round trip, KML hull of the cameras"] = (
        len(again.markers) == n_mk + 1
        and np.allclose(again.markers[-1]["ned"],
                        [centre[0], centre[1], 0.0], atol=1e-6)
        and "<LineString>" in kml)

    log(f"[tools-21b] inspect, utils, zooniverse and explorer walls s "
        + json.dumps({k: round(v, 3) for k, v in walls.items()}))
    log("[tools-21b] read back: " + json.dumps(seen, default=str))
    log(f"[tools-21b] card ms: paste's batched rays of {len(uv)} marks "
        f"{rays_ms:.3f}; preview-crops' projection of {len(uv)} points "
        f"{proj_ms:.3f}; _warp_full of {top} at 1024^2: {1e3 * warp_warm:.1f} "
        f"ms warm ({1e3 * walls['explorer _warp_full']:.1f} cold, the "
        f"texture's load included), device time {warp_dev:.3f} ms "
        f"(host share {100 * (1 - warp_dev / (1e3 * warp_warm)):.1f}%); "
        f"the CPU's {1e3 * warp_cpu:.1f} ms; {100 * differ:.4f}% of pixels "
        f"differ; paste within {paste_err:.4f} m; {smi}")
    failed = [k for k, ok in checks.items() if not ok]
    log(f"[tools-21b] {len(checks) - len(failed)}/{len(checks)} checks "
        "held")
    if failed:
        raise AssertionError(f"phase 21 (b) failed: {failed}")


# ---------------------------------------------------------------------------
# phase 22: the reference's mission generator and process.main at survey
# scale
# ---------------------------------------------------------------------------

SURVEY_FRAMES = 300         # benchmarks/mission_bench.py's default: 12 × 25
# the JAX package's records of the same missions (BENCH_mission.json,
# BENCH_mission_2812.json, BENCH_mission_2812_r4.json): pairs attempted and
# kept, beside the port's as a cross-check
JAX_PAIRS = {300: {"attempted": 7549, "kept": 1873},
             2812: {"attempted": 88941, "kept": [18260, 18283]}}


def survey_mission(proj_dir, n_images):
    """The reference's SyntheticMission (the port's, rendering on the
    card) laid out as benchmarks/mission_bench.py:57-80 lays it out:
    n_images // 25 rows, fx = 1400·W/2176, frames a quarter of the
    footprint apart at 100 m, the texture twice the ground sample
    distance, world tiles where one texture of at most 12000² cannot hold
    the grid, seed 42."""
    W, H = FRAME
    rows = max(n_images // 25, 1)
    fx = 1400.0 * W / 2176.0
    ground_w = W / fx * 100.0
    spacing = 0.25 * ground_w
    per_row = max(n_images // rows, 1)
    span = max(per_row, rows * 2.5) * spacing + 2.5 * ground_w
    tex_res = max(2.0 * 100.0 / fx, 0.05)
    tex_px = min(max(int(span / tex_res) + 512, 2048), 12000)
    return SyntheticMission(proj_dir, n_images=n_images, img_size=FRAME,
                            altitude=100.0, spacing=spacing, fx=fx,
                            texture_res=tex_res, rows=rows, seed=42,
                            texture_px=tex_px,
                            world_tiles=span > tex_px * tex_res * 0.9,
                            device="cuda")


def _pairs_kept(proj):
    """Image pairs whose match list is not empty, each counted once."""
    n = 0
    for im in proj.image_list:
        im.load_matches()
        n += sum(1 for v in (im.match_list or {}).values() if len(v))
    return n // 2


@contextlib.contextmanager
def keeping_k1(kinds):
    """knn.knn_packed_raw wrapped while the block runs: its calls counted
    by kind, (descriptor type, row width, gated), e.g. ("int8", 256,
    True), and the arguments (defaults applied) of the first and the last
    call of each kind in `kinds` kept for check_k1_calls. Yields (counts,
    kept): kept[kind] = {"first": args, "last": args}."""
    raw = knn.knn_packed_raw
    sig = inspect.signature(raw)
    counts, kept = collections.Counter(), {}

    def wrapped(*a, **kw):
        args = sig.bind(*a, **kw)
        args.apply_defaults()
        args = args.args
        kind = (str(args[0].dtype)[6:], args[0].shape[-1],
                args[4] is not None)
        counts[kind] += 1
        if kind in kinds:
            kept.setdefault(kind, {}).setdefault("first", args)
            kept[kind]["last"] = args
        return raw(*a, **kw)

    knn.knn_packed_raw = wrapped
    try:
        yield counts, kept
    finally:
        knn.knn_packed_raw = raw


def check_k1_calls(calls, where, tag):
    """K1 int8 at a run's own shapes: the first and the last K1 call of
    one kind (keeping_k1's kept[kind]; the last may hold a work list's
    remainder, fewer pairs), their inputs as the store path gave them,
    held bit-exact against knn_packed_plain and timed beside their bound
    (at 128 values a row in turns with the mma.sync body it replaced,
    knn_stages.i8_d128_raw);
    the first beside the ungated torch._int_mm product of as many rows.
    where names the run in the log, tag its phase. Returns [{batch,
    shape, gated, ms, plain_ms, bound_ms, bound_by, max_abs_err}]."""
    out = []
    for batch, args in calls.items():
        pairs, n, d = args[0].shape
        n_b = args[1].shape[1]
        gated = args[4] is not None
        name = f"K1 int8 {where} {batch} batch"
        r = compare_keys(name, knn.knn_packed_raw, knn.knn_packed_plain,
                         args)
        if d == 128:    # the mma.sync body it replaced, in turns
            vs_old_body(r, name, lambda: knn.knn_packed_raw(*args),
                        lambda: knn_stages.i8_d128_raw(*args, body="mma"),
                        "was")
        with_bound(r, *k1_bound(pairs, n, 1, "int8", gated=gated, dim=d,
                                n_b=n_b))
        r.update(batch=batch, shape=[pairs, n, n_b, d], gated=gated)
        if batch == "first":
            # every A row against the first pair's B rows, in slices
            # whose int32 output stays within 8 GiB
            x, bt = args[0].reshape(-1, d), args[1][0].t()
            step = max(1, (1 << 31) // n_b)

            def int_mm():
                for i in range(0, len(x), step):
                    torch._int_mm(x[i:i + step], bt)

            r["product_only_ms"] = product_only(f"{name} torch._int_mm",
                                                int_mm)
            del x, bt
        was = (f" (mma.sync body {r['was_ms']:.3f} ms, in turns)"
               if "was_ms" in r else "")
        log(f"[{tag}] K1 int8 {where} {batch} batch {pairs} x {n} x {n_b} "
            f"x {d} (gated {gated}): bit-exact; kernel {r['ms']:.3f} ms"
            f"{was}, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.3f} ms "
            f"({r['bound_by']}), product only {r.get('product_only_ms')} "
            f"ms")
        out.append(r)
    return out


def run_survey(root, smi, n_images=SURVEY_FRAMES, proj_dir=None):
    """Phase 22: the reference's generator on the card (survey_mission:
    each frame warped and encoded by nvJPEG as it is made, in world tiles
    from 300 frames on), then apps/process.py's main with phase 16's
    arguments (mission_bench.py:145-149) and a second main that must skip
    every stage; K1 int8 at the run's own batches (check_k1_calls).
    proj_dir (default root/survey) may hold an earlier run: its frames
    are kept (generate(skip_existing=True)) and main resumes from its
    state; the launch checks then hold only for the stages that ran. The
    camera DB goes to root/cameras. Returns (the run's launches, a dict
    of its numbers)."""
    W, H = FRAME
    proj_dir = proj_dir or os.path.join(root, "survey")
    db = os.path.join(root, "cameras")
    m = survey_mission(proj_dir, n_images)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m.generate(skip_existing=True)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_peak = torch.cuda.max_memory_allocated()
    frames = sorted(glob.glob(os.path.join(proj_dir, "IMG_*.jpg")))
    frame_bytes = sum(os.path.getsize(f) for f in frames)
    camera_db.save(CAMERA_KEY, m.camera_config(), db)
    argv = [proj_dir, "--camera", CAMERA_KEY, "--camera-db", db,
            "--scale", "1.0", "--ground", "0.0", "--batch-size", "32",
            "--min-chain-len", "2", "--detector", "TPU",
            "--max-features", str(MAX_FEATURES)]
    state_dir = os.path.join(proj_dir, "ImageAnalysis", "state")
    ran = [s for s in ("STEP3a", "STEP4", "STEP5")
           if not (os.path.isdir(state_dir) and StateMgr(state_dir).check(s))]

    solves = []
    solve = bundle.solve

    def solve_and_keep(*a, **kw):
        r = solve(*a, **kw)
        solves.append((r.iters, r.mre))
        return r

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    bundle.solve = solve_and_keep
    kind = ("int8", 128, False)
    try:
        with keeping_k1({kind}) as (_, kept):
            t0 = time.perf_counter()
            rc = process.main(argv)
            wall = time.perf_counter() - t0
    finally:
        bundle.solve = solve
    launches = read_launches()
    run_peak = torch.cuda.max_memory_allocated()
    if rc != 0:
        raise AssertionError(f"phase 22: process.main returned {rc}")
    disk = shutil.disk_usage(proj_dir)
    k1_survey = check_k1_calls(kept.get(kind, {}), "survey", "survey-22")
    del kept
    checks, outcome = process_outcome(proj_dir, m, n_images)
    proj, err, walls = outcome["proj"], outcome["err"], outcome["walls"]
    matched = [(int(a), float(b)) for a, b in re.findall(
        r"Matched (\d+) pairs in ([\d.]+)s", outcome["run_log"])]
    kept = _pairs_kept(proj)

    reset_launches()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc2 = process.main(argv)
    again = [ln for ln in out.getvalue().splitlines()
             if ln.startswith("Step ")]
    again_launches = {k: v for k, v in read_launches().items() if v}

    checks.update({
        "resume skips every stage": rc2 == 0 and not again
        and not again_launches,
        "no PIL or cv2 imported": not {"PIL", "cv2"} & set(sys.modules),
    })
    if "STEP3a" in ran:
        checks["K1 int8 and K2 launched"] = (
            launches["knn_packed_i8"] > 0 and launches["gauss_blur_f32"] > 0)
    numbers = {
        "frames": n_images, "frame": [W, H], "world_tiles": m.world_tiles,
        "generate_s": gen_s,
        "generate_ms_per_frame": 1e3 * gen_s / n_images,
        "generate_peak_card_bytes": gen_peak,
        "frames_bytes_on_disk": frame_bytes,
        "project_bytes_on_disk": sum(
            os.path.getsize(os.path.join(d, f))
            for d, _, fs in os.walk(proj_dir) for f in fs),
        "disk_free_bytes_after": disk.free,
        "stages_run": ran, "main_s": wall, "stage_wall_s": walls,
        "matched": [{"pairs": a, "s": b} for a, b in matched],
        "pairs_kept": kept, "jax_package_pairs": JAX_PAIRS.get(n_images),
        "ba": [{"iters": it, "mre_px": r} for it, r in solves],
        "ba_finished_mre_px": outcome["mre"], "groups": outcome["groups"],
        "camera_error_m": {"mean": float(err.mean()),
                           "median": float(np.median(err)),
                           "max": float(err.max())},
        "median_point_above_ground_m": float(outcome["height"]),
        "features_per_frame": {"min": int(min(outcome["features"])),
                               "mean": float(np.mean(outcome["features"]))},
        "eggs": outcome["eggs"], "textures": outcome["textures"],
        "run_peak_card_bytes": run_peak, "launches": launches,
        "k1_int8_batches": k1_survey, "device": smi,
    }
    log(f"[survey-22] generator: {n_images} frames {W}x{H} (world tiles "
        f"{m.world_tiles}) in {gen_s:.3f} s, {1e3 * gen_s / n_images:.2f} "
        f"ms a frame, {frame_bytes} bytes of JPEG, peak card memory "
        f"{gen_peak} B")
    for name, sec in walls.items():
        log(f"[survey-22] stage wall: {name} {sec:.2f}s")
    log(f"[survey-22] main {wall:.3f} s; matched {matched} (pairs, s); "
        f"{kept} pairs kept (the JAX package on the same mission: "
        f"{JAX_PAIRS.get(n_images)}); BA (iters, mre) {solves}; cameras "
        f"mean {err.mean():.4f} max {err.max():.4f} m from the truth; "
        f"median point {outcome['height']:.4f} m; groups "
        f"{numbers['groups']}; peak card memory {run_peak} B; launches "
        f"{launches}; {smi}")
    log(f"[survey-22] second main: rc {rc2}, stages run {again}, launches "
        f"{again_launches}")
    log("[survey-22] " + json.dumps(numbers, default=str))
    failed = [k for k, ok in checks.items() if not ok]
    log(f"[survey-22] {len(checks) - len(failed)}/{len(checks)} checks held")
    if failed:
        raise AssertionError(f"phase 22 failed: {failed}")
    return launches, numbers


def main():
    if sys.argv[1:2] == ["--rank"]:
        return rank_child(json.loads(sys.argv[2]))
    profile = "--profile" in sys.argv[1:]
    t_run = time.perf_counter()
    walls = {}

    def phase(name, fn, *args):
        """fn(*args), its wall printed on a line of its own."""
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t0
        log(f"[wall] phase {name}: {walls[name]:.1f} s")
        return out
    smi = phase("1 (device)", device_info)
    phase("2 (build)", build)
    k2 = phase("3 (K2)", check_blur)
    k1 = phase("4 (K1)", check_knn)
    k3 = phase("5 (K3)", check_wide)
    k256 = phase("4-5 (K1, K3 at 256 values)", check_knn_256)
    k4 = phase("11 (K4)", check_epilogue)
    bench_pps = phase("6 (bench's workload)", bench_workload)
    slice_launches, m, dets = phase("7 (slice)", run_slice)
    if profile:
        phase("7 (profile)", profile_detect, m)
    with tempfile.TemporaryDirectory() as root:
        smart_launches, smart_result, proj, state, p8 = phase(
            "8 (smart slice)", run_smart_slice, m, dets, root, profile)
        reset_launches()
        try:
            phase("12a (fused arm)", run_fused_bench, bench_pps)
            phase("12b (fused smart)", run_fused_smart, m, dets, root,
                  smart_result)
        finally:
            os.environ.pop(FUSED, None)
        fused_launches = read_launches()
        log(f"[fused] launches: {fused_launches}")
        if fused_launches["match_epilogue"] == 0:
            raise AssertionError(f"K4 never launched: {fused_launches}")
        phase("13 (Steps 3b-4)", run_steps_3b_4, proj, state, m, root,
              profile)
        del m, dets, proj
        rep_launches = phase("9 (repetitive)", run_repetitive, root)
    wide_launches = phase("10 (wide store)", run_wide_store)
    p14, _ = phase("14 (BA)", run_mission_ba)
    anatomy = phase("15 (probes)", run_probes)
    with tempfile.TemporaryDirectory() as root:
        _, p16_wall, p16_cams = phase("16 (process)", run_process, root,
                                      smi)
    # phase 22 before the phases that import cv2 (17-21)
    with tempfile.TemporaryDirectory() as root:
        p22, p22_numbers = phase("22 (survey)", run_survey, root, smi)
    with tempfile.TemporaryDirectory() as root:
        phase("17 (process extras)", run_process_extras, root, smi)
    with tempfile.TemporaryDirectory() as root:
        d256, p18e = phase("18 (stages)", run_stages, root, smi, p16_wall,
                           p16_cams)
    with tempfile.TemporaryDirectory() as root:
        p19 = phase("19 (parallel)", run_parallel, root, smi, p14)
    with tempfile.TemporaryDirectory() as root:
        phase("20 (video)", run_video, root, smi)
    with tempfile.TemporaryDirectory() as root:
        p21 = phase("21 (tools)", run_tools, root, smi)

    def entry(name, source, replaces, launches, r):
        return dict(name=name, route="cuda",
                    source=f"imageanalysis_tpu_torch/csrc/{source}",
                    replaces=replaces, launches=launches,
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"],
                    timed_by=r.get("timed_by", "CUDA events, median"),
                    **{k: r[k] for k in ("product_only_ms", "ffma_ms",
                                         "dp4a_ms", "tc_product_ms",
                                         "ffma_bound_ms", "loop_ms",
                                         "device_ms", "loop_device_ms",
                                         "random_max_abs_err", "int8_ms",
                                         "was_product_ms",
                                         "int8_dp4a_ms", "int8_bound_ms",
                                         "int8_was_ms",
                                         "int8_library_ms", "was_ms",
                                         "call_device_ms", "event_ms",
                                         "was_call_device_ms",
                                         "was_event_ms",
                                         "was_kernels_a_call", "variants",
                                         "two_launch_ms", "kernels_a_call",
                                         "was_launches", "kernel_ms",
                                         "noepi_kernel_ms", "k1_ms",
                                         "k4_ms", "was_kernel_ms",
                                         "stages", "was_tile",
                                         "sweep", "split_ms",
                                         "split_bound_ms", "body")
                       if k in r})

    def at256(launch_key, *cases):
        """The 256-wide instantiations' numbers (phases 4-5) and launches
        (phase 18's ORB runs), as d256_* keys of their kernel's entry."""
        out = {"d256_launches": d256.get(launch_key, 0)}
        for case in cases:
            tag = "d256" if len(cases) == 1 else f"d256_{case}"
            out.update({f"{tag}_{k}": k256[case][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
                "product_only_ms", "was_ms", "tc_product_ms",
                "was_product_ms", "random_max_abs_err") if k in k256[case]})
        return out

    def at19(key):
        """Phase 19's launches of a kernel, rank by rank of (b)."""
        return {"p19_launches": [r.get(key, 0) for r in p19]}

    def at22(key, batches=()):
        """Phase 22's launches of a kernel in the survey run, and its
        numbers at the run's own batches (check_k1_calls)."""
        out = {"p22_launches": p22[key]}
        for r in batches:
            out.update({f"p22_{r['batch']}_{k}": r[k] for k in (
                "shape", "ms", "was_ms", "plain_ms", "bound_ms", "bound_by",
                "max_abs_err", "product_only_ms") if k in r})
        return out

    def at18e(prefix, batches):
        """K1 int8's numbers at a run's own first and last calls
        (check_k1_calls): phase 18 (e)'s ORB smart run at 256 ("p18e"),
        phase 8's smart run at 128 ("p8")."""
        return {f"{prefix}_{r['batch']}_{k}": r[k] for r in batches
                for k in ("shape", "ms", "was_ms", "plain_ms", "bound_ms",
                          "bound_by", "max_abs_err", "product_only_ms")
                if k in r}

    def at21(key):
        """Phase 21 (a)'s launches of a kernel, by store mode."""
        return {"p21_launches": {mode: n[key] for mode, n in p21.items()}}

    k1_src = "imageanalysis_tpu/ops/knn.py:105"
    kernels = [
        dict(entry("knn_packed_i8", "knn_packed.cu", k1_src,
                   slice_launches["knn_packed_i8"], k1["i8_store"]),
             **at256("knn_packed_i8_d256", "i8_store", "i8_bench"),
             **at19("knn_packed_i8"), **at21("knn_packed_i8"),
             **at22("knn_packed_i8", p22_numbers["k1_int8_batches"]),
             **at18e("p18e", p18e["plain"])),
        dict(entry("knn_packed_gated", "knn_packed.cu", k1_src,
                   smart_launches["knn_packed_gated"], k1["gated_i8"]),
             **{f"{m}_{k}": k1[m][k] for m in ("gated_bf16", "gated_f32")
                for k in ("ms", "was_ms", "bound_ms", "tc_product_ms",
                          "was_product_ms", "body", "random_max_abs_err")
                if k in k1[m]},
             **at18e("p8", p8),
             **at19("knn_packed_gated"), **at21("knn_packed_gated"),
             **at256("knn_packed_gated_d256", "gated_i8_bench",
                     "gated_bf16_bench", "gated_f32_store"),
             **at18e("p18e", p18e["gated"])),
        dict(entry("knn_packed_bf16", "knn_packed.cu", k1_src,
                   rep_launches["knn_packed_bf16"], k1["bf16"]),
             **at256("knn_packed_bf16_d256", "bf16_bench"),
             **at21("knn_packed_bf16")),
        dict(entry("knn_packed_f32", "knn_packed.cu", k1_src,
                   rep_launches["knn_packed_f32"], k1["f32"]),
             **at256("knn_packed_f32_d256", "f32_store"),
             **at21("knn_packed_f32")),
        dict(entry("knn_wide", "knn_wide.cu",
                   "imageanalysis_tpu/ops/knn.py:407",
                   wide_launches["knn_wide"], k3["bf16"]),
             **at256("knn_wide_d256", "k3_bf16")),
        dict(entry("knn_wide_f32", "knn_wide.cu",
                   "imageanalysis_tpu/ops/knn.py:407",
                   wide_launches["knn_wide_f32"], k3["f32"]),
             **at256("knn_wide_f32_d256", "k3_f32")),
        dict(entry("gauss_blur_f32", "gauss_blur.cu",
                   "imageanalysis_tpu/features/sift_tpu.py:67",
                   slice_launches["gauss_blur_f32"], k2),
             **at19("gauss_blur_f32"), **at22("gauss_blur_f32")),
        entry("match_epilogue", "match_epilogue.cu",
              "imageanalysis_tpu/ops/knn.py:253",
              fused_launches["match_epilogue"], k4["bench"]),
    ]
    for p, name, source, replaces in (
            ("P1", "onehot_gather_bf16", "mma_probe.cu",
             "scripts_dev/epilogue_dot_probe.py:25"),
            ("P2", "knn_fused_probe", "knn_fused_probe.cu",
             "scripts_dev/fused_vmem_probe.py:26"),
            ("P3", "knn_tc_stage", "knn_probe.cu",
             "scripts_dev/knn_culprit_bisect.py:42"),
            ("P4", "knn_tc_p4_stages", "knn_probe.cu",
             "scripts_dev/knn_stage_cost.py:31"),
            ("P5", "mm_rowsum_bf16_wg", "mma_probe.cu",
             "scripts_dev/matmul_shape_probe.py:33"),
            ("P6", "knn_wg_row_min", "knn_probe.cu",
             "scripts_dev/knn_overhead_sweep.py:36")):
        r, counts = anatomy[p]
        kernels.append(entry(name, source, replaces, sum(counts.values()),
                             r))
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched on its path")
    log(f"[wall] total {time.perf_counter() - t_run:.1f} s; by phase: "
        + json.dumps({k: round(v, 1) for k, v in walls.items()}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

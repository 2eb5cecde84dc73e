"""K1's anatomy: the packed 2-NN cut down stage by stage (P3, P4, P6).

Counterpart of three TPU dev probes, each a Pallas kernel that ran K1's
work on a 64-pair batch of 6144 × 128 int8 descriptors with parts switched
off: ``scripts_dev/knn_stage_cost.py:31`` (P4),
``scripts_dev/knn_culprit_bisect.py:42`` (P3) and
``scripts_dev/knn_overhead_sweep.py:36`` (P6). On the card the parts are
the stages of ``csrc/knn_common.cuh``, compiled into its int8 body
(``__dp4a``) and float body (f32 FMAs on bf16 operands), the bodies K1
ran before the tensor-core body:

====  =============  ===================================================
 #    name           computes, per pair (row (B, n_a, 2), col (B, n_b))
====  =============  ===================================================
 0    ``row_sum``    product; row sum of the dots modulo 2³² (both slots)
 1    ``row_min``    product; row minimum of the dots (both slots)
 2    ``top1``       + d2, key = bits(f32 d2) & ~0x1FFF | j; row top-1
 3    ``top2_tile``  + row top-2, restarted at every B tile of TB rows:
                     the top-2 of the last tile
 4    ``top2``       + the running top-2 across B tiles (the row top-2)
 5    ``full``       + the column minimum by atomicMin: the ``__dp4a``
                     (int8) or FFMA (bf16) body's K1, bit for bit the
                     tensor-core K1's result
====  =============  ===================================================

``col`` is 0x7FFFFFFF everywhere below ``full``. Integer-valued
descriptors (int8, or bf16 holding 0..255) make every dot an integer below
2²⁴, so each stage's kernel and plain version agree bit for bit.

How the TPU probes map onto the card. The TPU's grid tiles (ta A rows ×
tb B rows per sequential grid step, ic an inner column chunk) have no
counterpart on the card, whose blocks run in parallel: a block owns TA A
rows and streams all of B through shared memory in tiles of TB rows, and
its 256 threads each hold a TA/16 × TB/16 register tile. So:

- P4 ``knn_stage_cost`` (ta 128, tb = n): stages 0, 1, 2, 3 → card stages
  ``row_sum``, ``top1``, ``top2``, ``full``, int8 and bf16 (with tb = n
  the TPU's top-2 was the whole row's: the card's running ``top2``). They
  run on the tensor-core body K1 runs now, at K1's tile (128, 128, 2)
  (``P4_TC_STAGES``, ``p4_stage_raw``): ``row_sum`` is
  ``tc_row_sum_raw``, the others ``tc_stage_raw``'s; the old bodies'
  stages at their K1 tile (TA, TB) = (64, 64) (``P4_STAGES``,
  ``p4_stage_raw(body="old")``) stay as the yardstick.
- P3 ``knn_culprit_bisect`` (ta 256, tb = n): v0 → ``row_min``, v1 →
  ``top1``, v2 → ``top2_tile``, v3 (+ the running r1/r2 merge in scratch)
  → ``top2``, v4 (+ the column) → ``full``, at (64, 64); v5 (the
  production ``knn_top2``) → the port's ``knn.knn_top2``. On the TPU v2
  and v3 differed by the merge carried across grid steps in VMEM; on the
  card the top-2 lives in registers across the B loop, so ``top2_tile``
  only restarts it at every tile.
- P6 ``knn_overhead_sweep`` (product + row min): each TPU (ta, tb, ic),
  in the script's order of fatter steps, → a card tile of growing area
  (A rows per block × B rows per shared tile), stage ``row_min``:

  ==================  ===========  ============
  TPU (ta, tb, ic)    card int8    card bf16
  ==================  ===========  ============
  (128, 6144, 0)      (32, 32)     (16, 64)
  (256, 6144, 0)      (32, 64)     (32, 32)
  (512, 2048, 0)      (64, 32)     (32, 64)
  (512, 6144, 1024)   (64, 64) K1  (64, 32)
  (1024, 6144, 1024)  (128, 64)    (64, 64) K1
  (2048, 6144, 2048)  (64, 128)    (16, 128)
  (6144, 6144, 2048)  (128, 128)   (32, 128)
  ==================  ===========  ============

  The float body keeps its A tile in shared memory as f32, so its tiles
  stop at TA × TB within the 48 KB of static shared memory.

  P6 also runs on the tensor-core body K1 runs now (``tc_row_min_raw``),
  whose tile is (BM A rows per block, BN B rows per streamed tile, ring
  stages), ``TC_TILES``, int8 and bf16 alike, again one to one onto the
  TPU sweep: (64, 64, 2), (128, 64, 2), (64, 128, 2), (128, 128, 2) =
  K1's, (128, 128, 3), (256, 64, 2), (256, 128, 2). The old bodies' sweep
  stays as its yardstick (and P3's v0 is its ``row_min``).

Every mode of K1 and K3 now runs a tensor-core body
(``csrc/knn_tc.cuh``); the stages here, ``full`` included, stay on the
bodies above, so each dtype's anatomy is one body's. More wrappers
measure the tensor-core body:

- ``dp4a_i8_raw``: the ``__dp4a`` body in K1's int8 modes (plain,
  gated); ``ffma_bf16_raw``: the FFMA body in K1's and K3's bf16 modes
  (plain, gated, wide); ``ffma_f32_raw``: the FFMA body in K1's and K3's
  f32 modes (plain, gated, wide). The yardsticks the tensor-core body is
  timed against; their plain versions are K1's and K3's.
- ``tc_row_sum_raw``: the ``mma.sync`` tensor-core body's product with
  the ``row_sum`` stage's wrapping row sum in place of the key epilogue, in
  any of its types (int8, bf16, f32 as three bf16 planes) and at any
  size (K1's and K3's); its plain version is ``tc_row_sum_plain``, the
  ``row_sum`` stage's arithmetic. K1's or K3's time less its time is the
  key epilogue's on that body.
- ``tc_row_min_raw``: the tensor-core body's product with the
  ``row_min`` stage's row minimum in place of the key epilogue (P6), at
  any tile of ``TC_TILES``; its plain version is ``tc_row_min_plain``.
- ``tc_stage_raw``: P3's stages (v0–v4 through ``P3_VARIANTS``,
  ``row_min`` to ``full``) on the tensor-core body K1 runs now, at K1's
  tile (128, 128, 2), int8 and bf16, the old bodies' stages
  (``knn_probe_raw``) kept as its yardstick. ``row_min`` is the body's
  row-min mode, ``top1``, ``top2_tile`` and ``top2`` K1's keys with part
  of its epilogue, ``full`` K1 itself. Its plain version
  ``tc_stage_plain`` is ``knn_probe_plain``'s arithmetic with the body's
  128-row B tile (``top2_tile``: the last, possibly half, tile).
- ``bf16_d256_raw``: bf16 rows of 256 values (ORB's) on the ``mma.sync``
  body, which K1 and K3 ran there before the ``wgmma`` body of
  ``csrc/knn_wg.cuh`` and which stays as its yardstick, or on the
  ``wgmma`` body itself, in K1's mode (plain or gated), K3's, and the
  product-only ``row_sum`` (the product / key-epilogue split at 256);
  its plain version ``bf16_d256_plain`` is K1's, K3's or
  ``tc_row_sum_plain``'s.
- ``f32_d256_raw``: the same for f32 rows of 256 values (three bf16
  planes after the split pre-pass), whose ``mma.sync`` body (64 A rows,
  one 64-row B tile) K1 and K3 ran before the ``wgmma`` body; its plain
  version ``f32_d256_plain``.
- ``i8_d256_raw``: the same for int8 rows of 256 values (ORB's bits as
  the int8 store holds them) in K1's mode (plain or gated, after K1's
  norm pre-pass) and the product-only ``row_sum``, whose ``mma.sync`` s8
  body (the 128-row tiles of 128 values at twice the k-steps) K1 ran
  before the ``wgmma`` s8 body; its plain version ``i8_d256_plain``.
"""

from __future__ import annotations

import torch

from .. import _build
from ..ops import knn
from . import check_device, check_launchable

STAGES = ("row_sum", "row_min", "top1", "top2_tile", "top2", "full")
ROW_SUM, ROW_MIN, TOP1, TOP2_TILE, TOP2, FULL = range(len(STAGES))
K1_TILE = (64, 64)
# P6's TPU sweep, in the script's order, and the card tile of each dtype
P6_SWEEP = ((128, 6144, 0), (256, 6144, 0), (512, 2048, 0),
            (512, 6144, 1024), (1024, 6144, 1024), (2048, 6144, 2048),
            (6144, 6144, 2048))
TILES = {
    torch.int8: ((32, 32), (32, 64), (64, 32), (64, 64), (128, 64),
                 (64, 128), (128, 128)),
    torch.bfloat16: ((16, 64), (32, 32), (32, 64), (64, 32), (64, 64),
                     (16, 128), (32, 128)),
}
# P6 on the tensor-core body: (BM, BN, ring stages) of each P6_SWEEP point,
# int8 and bf16 alike; K1's tile is the fourth
TC_TILES = ((64, 64, 2), (128, 64, 2), (64, 128, 2), (128, 128, 2),
            (128, 128, 3), (256, 64, 2), (256, 128, 2))
K1_TC_TILE = (128, 128, 2)
# P4's stages and P3's variants → card stages (the old bodies' P4)
P4_STAGES = {0: ROW_SUM, 1: TOP1, 2: TOP2, 3: FULL}
# P4 on the tensor-core body: TPU stage → (card stage, route)
P4_TC_STAGES = {0: (ROW_SUM, "tc_row_sum"), 1: (TOP1, "tc_stage"),
                2: (TOP2, "tc_stage"), 3: (FULL, "tc_stage")}
P4_BODIES = ("tc", "old")
P3_VARIANTS = {0: ROW_MIN, 1: TOP1, 2: TOP2_TILE, 3: TOP2, 4: FULL}

# kernel launches (not plain-version calls), by descriptor type
LAUNCHES = {"knn_probe_i8": 0, "knn_probe_bf16": 0, "knn_ffma_bf16": 0,
            "knn_ffma_f32": 0, "knn_dp4a_i8": 0, "knn_tc_row_sum": 0,
            "knn_tc_row_min": 0, "knn_tc_stage": 0, "knn_bf16_d256": 0,
            "knn_f32_d256": 0, "knn_i8_d256": 0, "knn_bf16_d128": 0,
            "knn_i8_d128": 0, "knn_f32_d128": 0}
# the tensor-core body's B tile (int8 and bf16) and A rows a block, at
# which tc_stage_raw runs every stage
TC_BN, TC_BM = 128, 128


def _check(a, b, na2, nb2, stage, tile, name):
    check_device((a, b), name)
    if (a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0]
            or a.shape[2] != 128 or b.shape[2] != 128):
        raise ValueError(f"{name}: need (B, n_a, 128) and (B, n_b, 128), "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in TILES:
        raise ValueError(f"{name}: takes int8 or bf16 descriptors, got "
                         f"{a.dtype} and {b.dtype}")
    if stage not in range(len(STAGES)):
        raise ValueError(f"{name}: no stage {stage}")
    if tuple(tile) not in TILES[a.dtype] or (stage != ROW_MIN
                                             and tuple(tile) != K1_TILE):
        raise ValueError(f"{name}: no tile {tuple(tile)} for stage "
                         f"{STAGES[stage]} of {a.dtype} (row_min takes "
                         f"{TILES[a.dtype]}, the others {K1_TILE})")
    ta, tb = tile
    n_a, n_b = a.shape[1], b.shape[1]
    if n_a % ta or n_b % tb or max(n_a, n_b) > 8192:
        raise ValueError(f"{name}: n_a={n_a}, n_b={n_b} must be multiples "
                         f"of the tile {tuple(tile)} and at most 8192")
    _check_norms(a, b, na2, nb2, stage, name)


def _check_norms(a, b, na2, nb2, stage, name):
    if a.dtype == torch.bfloat16 and stage >= TOP1 and (
            na2 is None or nb2 is None or na2.shape != a.shape[:2]
            or nb2.shape != b.shape[:2] or na2.dtype != torch.float32
            or nb2.dtype != torch.float32):
        raise ValueError(f"{name}: bf16 stages from top1 on need f32 "
                         "squared norms na2 (B, n_a) and nb2 (B, n_b)")


def _wrap32(x):
    """int64 → the int32 with the same low 32 bits."""
    return ((x + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)


def _row_sum(dot):
    """Each row's sum of its integer-valued dots modulo 2³², as int32."""
    return _wrap32(dot.long().sum(1))


def knn_probe_plain(a, b, na2=None, nb2=None, stage=FULL, tile=K1_TILE):
    """Plain version of the probe kernel: K1 up to ``stage`` (see the
    module docstring). a (B, n_a, 128), b (B, n_b, 128) int8, or bf16
    with integer values and, from ``top1`` on, the f32 squared norms na2
    (B, n_a), nb2 (B, n_b) of the unrounded descriptors. tile = (TA, TB)
    only matters to ``top2_tile`` (its last tile is b's last TB rows).
    Returns (row (B, n_a, 2) int32, col (B, n_b) int32). Loops over pairs,
    so the (n_a, n_b) temporaries stay one pair's size."""
    _check(a, b, na2, nb2, stage, tile, "knn_probe_plain")
    return _stages_plain(a, b, na2, nb2, stage, tile[1])


def _stages_plain(a, b, na2, nb2, stage, tb):
    """The stages' arithmetic; top2_tile keeps the last B tile of tb rows,
    columns ⌊(n_b − 1) / tb⌋·tb … n_b − 1 (a partial tile where tb does
    not divide n_b)."""
    if stage == FULL:
        return knn.knn_packed_plain(a, b, na2, nb2)
    B, n_a, _ = a.shape
    n_b = b.shape[1]
    dev = a.device
    row = torch.empty((B, n_a, 2), dtype=torch.int32, device=dev)
    col = torch.full((B, n_b), knn._KEY_MAX, dtype=torch.int32, device=dev)
    jb = torch.arange(n_b, dtype=torch.int32, device=dev)[None, :]
    for p in range(B):
        x, y = a[p].float(), b[p].float()
        dot = x @ y.T                   # integers below 2^24: exact
        if stage == ROW_SUM:
            v = _row_sum(dot)
        elif stage == ROW_MIN:
            v = dot.amin(1).int()
        else:
            if a.dtype == torch.int8:
                d2 = ((x * x).sum(-1)[:, None] + (y * y).sum(-1)[None, :]
                      - 2.0 * dot).int().float()
            else:
                d2 = (na2[p][:, None] + nb2[p][None, :] - 2.0 * dot) \
                    .clamp_min(0.0)
            keys = (d2.view(torch.int32) & ~knn._IDX_MASK) | jb
            if stage == TOP1:
                v = keys.amin(1)
            else:
                if stage == TOP2_TILE:
                    keys = keys[:, (n_b - 1) // tb * tb:]
                row[p] = torch.topk(keys, 2, dim=1, largest=False).values
                continue
        row[p] = v[:, None].expand(-1, 2)
    return row, col


def knn_probe_raw(a, b, na2=None, nb2=None, stage=FULL, tile=K1_TILE):
    """The probe kernel (csrc/knn_probe.cu) on a CUDA tensor, its plain
    version on a CPU tensor; raises on any other device. Arguments and
    result as knn_probe_plain. The full stage is the __dp4a (int8) or
    FFMA (bf16) body's K1, equal to K1's result bit for bit."""
    _check(a, b, na2, nb2, stage, tile, "knn_probe_raw")
    if a.device.type == "cpu":
        return knn_probe_plain(a, b, na2, nb2, stage, tile)
    bf16 = a.dtype == torch.bfloat16
    keys = bf16 and stage >= TOP1
    check_launchable((a, b) + ((na2, nb2) if keys else ()), "knn_probe_raw")
    B, n_a, _ = a.shape
    n_b = b.shape[1]
    dev = a.device
    lib = _build.load()
    row = torch.empty((B, n_a, 2), dtype=torch.int32, device=dev)
    col = torch.full((B, n_b), knn._KEY_MAX, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.knn_probe(
            a.data_ptr(), b.data_ptr(), na2.data_ptr() if keys else None,
            nb2.data_ptr() if keys else None, row.data_ptr(), col.data_ptr(),
            B, n_a, n_b, int(bf16), stage, tile[0], tile[1],
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "knn_probe")
    LAUNCHES["knn_probe_bf16" if bf16 else "knn_probe_i8"] += 1
    return row, col


def ffma_bf16_plain(a, b, na2, nb2, uv_a=None, pred_b=None, radius2=None,
                    wide=False):
    """Plain version of the FFMA bf16 body: K1's (knn_packed_plain, gated
    when uv_a is given) or, with wide=True, K3's (knn_wide_plain)."""
    if wide:
        return knn.knn_wide_plain(a, b, na2, nb2)
    return knn.knn_packed_plain(a, b, na2, nb2, uv_a, pred_b, radius2)


def ffma_bf16_raw(a, b, na2, nb2, uv_a=None, pred_b=None, radius2=None,
                  wide=False):
    """The FFMA float body on bf16 descriptors in K1's modes (row_p, col_p
    int32) or, with wide=True, K3's (row_k, col_k int64): what K1 and K3
    launched for bf16 before the tensor-core body. Arguments and result as
    knn.knn_packed_raw / knn.knn_wide_raw; a CPU tensor takes
    ffma_bf16_plain, any other device raises."""
    return _ffma_raw(a, b, na2, nb2, uv_a, pred_b, radius2, wide,
                     torch.bfloat16, "ffma_bf16_raw", "knn_ffma_bf16",
                     ffma_bf16_plain)


def _check_128(a, name):
    """The replaced bodies take rows of 128 values only (K1 and K3 also
    take 256)."""
    if a.dim() != 3 or a.shape[2] != 128:
        raise ValueError(f"{name}: takes (B, n, 128) descriptors, got "
                         f"{tuple(a.shape)}")


def _ffma_raw(a, b, na2, nb2, uv_a, pred_b, radius2, wide, dtype, name,
              entry, plain):
    """The FFMA body's wrapper for one descriptor type: checks, the plain
    version on a CPU tensor, else C entry point `entry`."""
    if a.dtype != dtype:
        raise ValueError(f"{name}: takes {dtype} descriptors, got {a.dtype}")
    _check_128(a, name)
    if wide:
        knn._check_wide(a, b, na2, nb2, name)
        if uv_a is not None:
            raise ValueError(f"{name}: the wide mode has no gate")
    else:
        knn._check_pair_batch(a, b, na2, nb2, name, 1 << knn._IDX_BITS)
        if uv_a is not None:
            knn._check_gate(uv_a, pred_b, a, b, name)
    if a.device.type == "cpu":
        return plain(a, b, na2, nb2, uv_a, pred_b, radius2, wide)
    B, n_a, _ = a.shape
    n_b = b.shape[1]
    knn._check_launch((a, b, na2, nb2, uv_a, pred_b), n_a, n_b, name)
    dev = a.device
    lib = _build.load()
    kt, kmax = (torch.int64, knn._WIDE_MAX) if wide else \
        (torch.int32, knn._KEY_MAX)
    row = torch.empty((B, n_a, 2), dtype=kt, device=dev)
    col = torch.full((B, n_b), kmax, dtype=kt, device=dev)
    ptrs = ((None, None, row.data_ptr(), col.data_ptr()) if wide else
            (row.data_ptr(), col.data_ptr(), None, None))
    gated = uv_a is not None
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(
            a.data_ptr(), b.data_ptr(), na2.data_ptr(), nb2.data_ptr(),
            knn._ptr(uv_a), knn._ptr(pred_b), radius2 if gated else 0.0,
            *ptrs, B, n_a, n_b, int(wide),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, entry)
    LAUNCHES[entry] += 1
    return row, col


def ffma_f32_plain(a, b, na2, nb2, uv_a=None, pred_b=None, radius2=None,
                   wide=False):
    """Plain version of the FFMA f32 body: K1's (knn_packed_plain, gated
    when uv_a is given) or, with wide=True, K3's (knn_wide_plain)."""
    if wide:
        return knn.knn_wide_plain(a, b, na2, nb2)
    return knn.knn_packed_plain(a, b, na2, nb2, uv_a, pred_b, radius2)


def ffma_f32_raw(a, b, na2, nb2, uv_a=None, pred_b=None, radius2=None,
                 wide=False):
    """The FFMA float body on f32 descriptors in K1's modes (row_p, col_p
    int32) or, with wide=True, K3's (row_k, col_k int64): what K1 and K3
    launched for f32 before the tensor-core body. Arguments and result as
    knn.knn_packed_raw / knn.knn_wide_raw; a CPU tensor takes
    ffma_f32_plain, any other device raises."""
    return _ffma_raw(a, b, na2, nb2, uv_a, pred_b, radius2, wide,
                     torch.float32, "ffma_f32_raw", "knn_ffma_f32",
                     ffma_f32_plain)


def dp4a_i8_plain(a, b, uv_a=None, pred_b=None, radius2=None):
    """Plain version of the __dp4a body: K1's int8 mode (gated when uv_a
    is given), knn_packed_plain."""
    return knn.knn_packed_plain(a, b, None, None, uv_a, pred_b, radius2)


def dp4a_i8_raw(a, b, uv_a=None, pred_b=None, radius2=None):
    """The __dp4a int8 body in K1's modes (row_p, col_p int32): what K1
    launched for int8 before the tensor-core body. Arguments and result
    as knn.knn_packed_raw on int8 descriptors; a CPU tensor takes
    dp4a_i8_plain, any other device raises."""
    name = "dp4a_i8_raw"
    if a.dtype != torch.int8:
        raise ValueError(f"{name}: takes int8 descriptors, got {a.dtype}")
    _check_128(a, name)
    knn._check_pair_batch(a, b, None, None, name, 1 << knn._IDX_BITS)
    gated = uv_a is not None
    if gated:
        knn._check_gate(uv_a, pred_b, a, b, name)
    if a.device.type == "cpu":
        return dp4a_i8_plain(a, b, uv_a, pred_b, radius2)
    B, n_a, _ = a.shape
    n_b = b.shape[1]
    knn._check_launch((a, b, uv_a, pred_b), n_a, n_b, name)
    dev = a.device
    lib = _build.load()
    row = torch.empty((B, n_a, 2), dtype=torch.int32, device=dev)
    col = torch.full((B, n_b), knn._KEY_MAX, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.knn_dp4a_i8(
            a.data_ptr(), b.data_ptr(), knn._ptr(uv_a), knn._ptr(pred_b),
            radius2 if gated else 0.0, row.data_ptr(), col.data_ptr(), B,
            n_a, n_b, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "knn_dp4a_i8")
    LAUNCHES["knn_dp4a_i8"] += 1
    return row, col


def _check_tc(a, b, name, dtypes, bm=64):
    """Shapes and types the tensor-core body's probe stages take: (B, n_a,
    128) and (B, n_b, 128) of one type in dtypes, n_a a multiple of bm and
    n_b of 64, on one device (CPU or CUDA)."""
    check_device((a, b), name)
    if (a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0]
            or a.shape[2] != 128 or b.shape[2] != 128
            or a.dtype != b.dtype or a.dtype not in dtypes
            or a.shape[1] % bm or b.shape[1] % 64):
        raise ValueError(f"{name}: need (B, n_a, 128) and (B, n_b, 128) of "
                         f"one of {dtypes}, n_a a multiple of {bm} and n_b "
                         f"of 64, got {tuple(a.shape)} {a.dtype} and "
                         f"{tuple(b.shape)} {b.dtype}")


_ROW_SUM_TYPES = (torch.int8, torch.bfloat16, torch.float32)
_ROW_MIN_TYPES = (torch.int8, torch.bfloat16)


def _probe_rows(a, b, reduce):
    """(row (B, n_a, 2) int32 with reduce(dots) of each A row in both
    slots, col (B, n_b) int32 0x7FFFFFFF); the dots in f32, exact for
    integer-valued descriptors. Loops over pairs."""
    B, n_a, _ = a.shape
    row = torch.stack([reduce(a[p].float() @ b[p].float().T)
                       for p in range(B)])
    col = torch.full((B, b.shape[1]), knn._KEY_MAX, dtype=torch.int32,
                     device=a.device)
    return row[:, :, None].expand(-1, -1, 2).contiguous(), col


def tc_row_sum_plain(a, b):
    """Plain version of tc_row_sum_raw: the row_sum stage's arithmetic
    (knn_probe_plain's), at any size and for f32 descriptors too
    (integer-valued, so every dot is exact)."""
    _check_tc(a, b, "tc_row_sum_plain", _ROW_SUM_TYPES)
    return _probe_rows(a, b, _row_sum)


def tc_row_sum_raw(a, b):
    """The mma.sync body's product-only stage on a CUDA tensor (what K1
    f32 and K3 run at 128, P4's stage 0; the wgmma body's at 128 is
    i8_d128_raw's and bf16_d128_raw's mode "row_sum"): a (B, n_a, 128),
    b (B, n_b, 128) int8 or integer-valued bf16 or f32 (split into its
    three bf16 planes first, as K1's and K3's f32 modes), n_a and n_b
    multiples of 64, of any size. Returns (row (B, n_a, 2) int32, each A
    row's wrapping sum of its dots in both slots; col (B, n_b) int32,
    0x7FFFFFFF): the result of tc_row_sum_plain, which a CPU tensor
    takes; any other device raises."""
    name = "tc_row_sum_raw"
    _check_tc(a, b, name, _ROW_SUM_TYPES)
    if a.device.type == "cpu":
        return tc_row_sum_plain(a, b)
    check_launchable((a, b), name)
    B, n_a, _ = a.shape
    n_b = b.shape[1]
    dev = a.device
    lib = _build.load()
    row = torch.empty((B, n_a, 2), dtype=torch.int32, device=dev)
    col = torch.full((B, n_b), knn._KEY_MAX, dtype=torch.int32, device=dev)
    f32 = a.dtype == torch.float32
    sa, sb = ((knn._split_scratch(a), knn._split_scratch(b)) if f32
              else (None, None))
    dtype = 2 if f32 else int(a.dtype == torch.bfloat16)
    with torch.cuda.device(dev):
        err = lib.knn_tc_row_sum(
            a.data_ptr(), b.data_ptr(), knn._ptr(sa), knn._ptr(sb),
            row.data_ptr(), B, n_a, n_b, dtype,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "knn_tc_row_sum")
    LAUNCHES["knn_tc_row_sum"] += 1
    return row, col


def _check_tc_tile(tile, name):
    if tuple(tile) not in TC_TILES:
        raise ValueError(f"{name}: no tile {tuple(tile)}; the tensor-core "
                         f"body's sweep is {TC_TILES}")
    return tuple(tile)


def tc_row_min_plain(a, b, tile=K1_TC_TILE):
    """Plain version of tc_row_min_raw: the row_min stage's arithmetic
    (knn_probe_plain's), each A row's minimum dot as an int in both slots
    of row, col 0x7FFFFFFF. The tile only sets the shapes taken (n_a a
    multiple of its BM)."""
    name = "tc_row_min_plain"
    bm = _check_tc_tile(tile, name)[0]
    _check_tc(a, b, name, _ROW_MIN_TYPES, bm)
    return _probe_rows(a, b, lambda dot: dot.amin(1).int())


def tc_row_min_raw(a, b, tile=K1_TC_TILE):
    """P6 on the tensor-core body: its product with the row minimum of the
    dots in place of the key epilogue, at tile (BM, BN, ring stages) of
    TC_TILES. a (B, n_a, 128), b (B, n_b, 128) int8 or integer-valued
    bf16, n_a a multiple of BM, n_b of 64. A CUDA tensor launches
    csrc/knn_probe.cu's knn_tc_row_min; a CPU tensor takes
    tc_row_min_plain; any other device raises, and so does a tile outside
    TC_TILES (ValueError). Result as tc_row_min_plain."""
    name = "tc_row_min_raw"
    bm, bn, stages = _check_tc_tile(tile, name)
    _check_tc(a, b, name, _ROW_MIN_TYPES, bm)
    if a.device.type == "cpu":
        return tc_row_min_plain(a, b, tile)
    check_launchable((a, b), name)
    B, n_a, _ = a.shape
    n_b = b.shape[1]
    dev = a.device
    lib = _build.load()
    row = torch.empty((B, n_a, 2), dtype=torch.int32, device=dev)
    col = torch.full((B, n_b), knn._KEY_MAX, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.knn_tc_row_min(
            a.data_ptr(), b.data_ptr(), row.data_ptr(), B, n_a, n_b,
            int(a.dtype == torch.bfloat16), bm, bn, stages,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "knn_tc_row_min")
    LAUNCHES["knn_tc_row_min"] += 1
    return row, col


def tc_row_min_blocks(dtype, tile):
    """Blocks of tc_row_min_raw's kernel at tile that one SM of the
    current card holds at once (the CUDA occupancy calculator's count,
    after the kernel's shared-memory opt-in); dtype torch.int8 or
    torch.bfloat16. Needs a card."""
    bm, bn, stages = _check_tc_tile(tile, "tc_row_min_blocks")
    if dtype not in _ROW_MIN_TYPES:
        raise ValueError(f"tc_row_min_blocks: no kernel for {dtype}")
    n = _build.load().knn_tc_row_min_blocks(int(dtype == torch.bfloat16),
                                            bm, bn, stages)
    _build.check(max(0, -n), "knn_tc_row_min_blocks")
    return n


def _check_tc_stage(a, b, na2, nb2, stage, name):
    _check_tc(a, b, name, _ROW_MIN_TYPES, TC_BM)
    if max(a.shape[1], b.shape[1]) > 8192:
        raise ValueError(f"{name}: n_a={a.shape[1]}, n_b={b.shape[1]} must "
                         "be at most 8192")
    if stage not in P3_VARIANTS.values():
        raise ValueError(f"{name}: no stage {stage} (P3's are "
                         f"{sorted(P3_VARIANTS.values())})")
    _check_norms(a, b, na2, nb2, stage, name)


def tc_stage_plain(a, b, na2=None, nb2=None, stage=FULL):
    """Plain version of tc_stage_raw: knn_probe_plain's arithmetic with the
    tensor-core body's B tile of TC_BN rows, so top2_tile is the top-2 of
    columns ⌊(n_b − 1) / 128⌋·128 … n_b − 1 (half a tile where n_b is an
    odd multiple of 64). Arguments and result as knn_probe_plain; n_a a
    multiple of 128, n_b of 64."""
    _check_tc_stage(a, b, na2, nb2, stage, "tc_stage_plain")
    return _stages_plain(a, b, na2, nb2, stage, TC_BN)


def tc_stage_raw(a, b, na2=None, nb2=None, stage=FULL):
    """P3's stages (row_min .. full) on the tensor-core body K1 runs, at
    K1's tile (128, 128, 2): csrc/knn_probe.cu's knn_tc_stage on a CUDA
    tensor, tc_stage_plain on a CPU tensor; any other device raises. a
    (B, n_a, 128), b (B, n_b, 128) int8, or bf16 with integer values and,
    from top1 on, their f32 squared norms na2 (B, n_a), nb2 (B, n_b); n_a
    a multiple of 128, n_b of 64, both at most 8192. int8 from top1 on
    runs K1's norm pre-pass first (two more launches, as K1); full is K1
    itself. Result as tc_stage_plain."""
    name = "tc_stage_raw"
    _check_tc_stage(a, b, na2, nb2, stage, name)
    if a.device.type == "cpu":
        return tc_stage_plain(a, b, na2, nb2, stage)
    B, n_a, _ = a.shape
    n_b = b.shape[1]
    dev = a.device
    bf16 = a.dtype == torch.bfloat16
    if stage == ROW_MIN:
        na2 = nb2 = None
    elif not bf16:                  # scratch for the norm pre-pass
        na2 = torch.empty((B, n_a), dtype=torch.float32, device=dev)
        nb2 = torch.empty((B, n_b), dtype=torch.float32, device=dev)
    check_launchable((a, b, na2, nb2), name)
    lib = _build.load()
    row = torch.empty((B, n_a, 2), dtype=torch.int32, device=dev)
    col = torch.full((B, n_b), knn._KEY_MAX, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.knn_tc_stage(
            a.data_ptr(), b.data_ptr(), knn._ptr(na2), knn._ptr(nb2),
            row.data_ptr(), col.data_ptr(), B, n_a, n_b, int(bf16), stage,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "knn_tc_stage")
    LAUNCHES["knn_tc_stage"] += 1
    return row, col


def _p4_route(stage, body, name):
    if stage not in P4_STAGES or body not in P4_BODIES:
        raise ValueError(f"{name}: no P4 stage {stage} on body {body!r} "
                         f"(stages {sorted(P4_STAGES)}, bodies {P4_BODIES})")
    return P4_TC_STAGES[stage] if body == "tc" else (P4_STAGES[stage], "old")


def p4_stage_plain(a, b, na2=None, nb2=None, stage=3, body="tc"):
    """Plain version of p4_stage_raw: the route's own plain version
    (tc_row_sum_plain, tc_stage_plain or knn_probe_plain at K1_TILE)."""
    card, route = _p4_route(stage, body, "p4_stage_plain")
    if route == "tc_row_sum":
        return tc_row_sum_plain(a, b)
    if route == "tc_stage":
        return tc_stage_plain(a, b, na2, nb2, card)
    return knn_probe_plain(a, b, na2, nb2, card)


def p4_stage_raw(a, b, na2=None, nb2=None, stage=3, body="tc"):
    """P4's TPU stage ``stage`` (0 product + row sum, 1 + d2, pack and row
    top-1, 2 + row top-2, 3 + the column: K1) on the tensor-core body
    (body "tc", P4_TC_STAGES: tc_row_sum_raw for stage 0, tc_stage_raw
    for the others) or on the old __dp4a / FFMA bodies (body "old",
    P4_STAGES: knn_probe_raw at K1_TILE), as that route's wrapper takes
    the device. a (B, n_a, 128), b (B, n_b, 128) int8, or bf16 with
    integer values and, from stage 1 on, their f32 squared norms na2,
    nb2; n_a a multiple of 128, n_b of 64. Result (row (B, n_a, 2), col
    (B, n_b)) int32, equal on both bodies."""
    card, route = _p4_route(stage, body, "p4_stage_raw")
    if route == "tc_row_sum":
        return tc_row_sum_raw(a, b)
    if route == "tc_stage":
        return tc_stage_raw(a, b, na2, nb2, card)
    return knn_probe_raw(a, b, na2, nb2, card)


# rows of 128 or 256 values on either tensor-core body: the modes of
# knn_bf16_d256, knn_i8_d256 (no "wide": K3 takes no int8), knn_f32_d256,
# knn_bf16_d128, knn_i8_d128 and knn_f32_d128 (csrc/knn_probe.cu) and the
# bodies ("mma": mma.sync, the body K1 and K3 ran there before; "wg": the
# wgmma body they run now)
D256_MODES = {"packed": 0, "wide": 2, "row_sum": 3}
BODIES = {"mma": 0, "wg": 1}
# the C entry point of each (type, width)
_ENTRIES = {(torch.bfloat16, 256): "knn_bf16_d256",
            (torch.float32, 256): "knn_f32_d256",
            (torch.int8, 256): "knn_i8_d256",
            (torch.bfloat16, 128): "knn_bf16_d128",
            (torch.int8, 128): "knn_i8_d128",
            (torch.float32, 128): "knn_f32_d128"}


def _check_rows(a, b, na2, nb2, uv_a, pred_b, mode, body, name, dtype,
                dim):
    if mode not in D256_MODES or body not in BODIES:
        raise ValueError(f"{name}: no mode {mode!r} on body {body!r} "
                         f"(modes {tuple(D256_MODES)}, bodies "
                         f"{tuple(BODIES)})")
    if a.dtype != dtype or a.dim() != 3 or a.shape[2] != dim:
        raise ValueError(f"{name}: takes (B, n, {dim}) {str(dtype)[6:]}, "
                         f"got {tuple(a.shape)} {a.dtype}")
    if mode == "wide" and dtype == torch.int8:
        raise ValueError(f"{name}: no mode 'wide' (K3 takes bf16 or f32)")
    if mode == "packed":
        knn._check_pair_batch(a, b, na2, nb2, name, 1 << knn._IDX_BITS)
        if uv_a is not None:
            knn._check_gate(uv_a, pred_b, a, b, name)
    elif uv_a is not None:
        raise ValueError(f"{name}: only the packed mode has a gate")
    elif mode == "wide":
        knn._check_wide(a, b, na2, nb2, name)
    else:
        _check_tc(a[..., :128], b[..., :128], name, (dtype,))


def _rows_plain(a, b, na2, nb2, uv_a, pred_b, radius2, mode, name, dtype,
                dim):
    _check_rows(a, b, na2, nb2, uv_a, pred_b, mode, "mma", name, dtype, dim)
    if mode == "packed":
        return knn.knn_packed_plain(a, b, na2, nb2, uv_a, pred_b, radius2)
    if mode == "wide":
        return knn.knn_wide_plain(a, b, na2, nb2)
    return _probe_rows(a, b, _row_sum)


def _rows_raw(a, b, na2, nb2, uv_a, pred_b, radius2, mode, body, dtype):
    """The launch of the *_d256_raw and *_d128_raw wrappers (their checks
    done, a and b on a CUDA card)."""
    B, n_a, dim = a.shape
    n_b = b.shape[1]
    f32 = dtype == torch.float32
    entry = _ENTRIES[dtype, dim]
    knn._check_launch((a, b, na2, nb2, uv_a, pred_b), n_a, n_b,
                      entry.replace("knn_", "") + "_raw")
    dev = a.device
    if dtype == torch.int8:
        return _i8_launch(a, b, uv_a, pred_b, radius2, mode, body, entry)
    wide = mode == "wide"
    key = torch.int64 if wide else torch.int32
    kmax = knn._WIDE_MAX if wide else knn._KEY_MAX
    row = torch.empty((B, n_a, 2), dtype=key, device=dev)
    col = torch.full((B, n_b), kmax, dtype=key, device=dev)
    rp, cp, rk, ck = ((None, None, row, col) if wide
                      else (row, col, None, None))
    # f32: scratch for the operands' three bf16 planes
    split = (knn._split_scratch(a), knn._split_scratch(b)) if f32 else ()
    with torch.cuda.device(dev):
        err = getattr(_build.load(), entry)(
            a.data_ptr(), b.data_ptr(), knn._ptr(na2), knn._ptr(nb2),
            knn._ptr(uv_a), knn._ptr(pred_b),
            radius2 if uv_a is not None else 0.0, knn._ptr(rp),
            knn._ptr(cp), knn._ptr(rk), knn._ptr(ck),
            *(x.data_ptr() for x in split), B, n_a,
            n_b, D256_MODES[mode], BODIES[body],
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, entry)
    LAUNCHES[entry] += 1
    return row, col


def _i8_launch(a, b, uv_a, pred_b, radius2, mode, body, entry):
    """i8_d256_raw's and i8_d128_raw's launch: csrc/knn_probe.cu's
    knn_i8_d256 or knn_i8_d128, with scratch for K1's norm pre-pass."""
    B, n_a, _ = a.shape
    n_b = b.shape[1]
    dev = a.device
    row = torch.empty((B, n_a, 2), dtype=torch.int32, device=dev)
    col = torch.full((B, n_b), knn._KEY_MAX, dtype=torch.int32, device=dev)
    na2 = torch.empty((B, n_a), dtype=torch.float32, device=dev)
    nb2 = torch.empty((B, n_b), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = getattr(_build.load(), entry)(
            a.data_ptr(), b.data_ptr(), na2.data_ptr(), nb2.data_ptr(),
            knn._ptr(uv_a), knn._ptr(pred_b),
            radius2 if uv_a is not None else 0.0, row.data_ptr(),
            col.data_ptr(), B, n_a, n_b, D256_MODES[mode], BODIES[body],
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, entry)
    LAUNCHES[entry] += 1
    return row, col


def _rows_wrapper(dtype, dim, yardstick):
    """The plain version and the wrapper of `dtype` rows of `dim` values
    on either body (yardstick: what the mma.sync body is at this width)."""
    tag = {torch.bfloat16: "bf16", torch.float32: "f32",
           torch.int8: "i8"}[dtype]
    name = f"{tag}_d{dim}"
    modes = ('"packed" or "row_sum"' if dtype == torch.int8
             else '"packed", "wide" or "row_sum"')

    def plain(a, b, na2=None, nb2=None, uv_a=None, pred_b=None,
              radius2=None, mode="packed"):
        return _rows_plain(a, b, na2, nb2, uv_a, pred_b, radius2, mode,
                           f"{name}_plain", dtype, dim)

    def raw(a, b, na2=None, nb2=None, uv_a=None, pred_b=None, radius2=None,
            mode="packed", body="mma"):
        _check_rows(a, b, na2, nb2, uv_a, pred_b, mode, body, f"{name}_raw",
                    dtype, dim)
        if a.device.type == "cpu":
            return plain(a, b, na2, nb2, uv_a, pred_b, radius2, mode)
        return _rows_raw(a, b, na2, nb2, uv_a, pred_b, radius2, mode, body,
                         dtype)

    plain.__name__, raw.__name__ = f"{name}_plain", f"{name}_raw"
    plain.__doc__ = (f"Plain version of {name}_raw: knn.knn_packed_plain "
                     "(gated with uv_a), knn.knn_wide_plain, or "
                     "tc_row_sum_plain's arithmetic.")
    raw.__doc__ = (
        f"{str(dtype)[6:]} rows of {dim} values, a (B, n_a, {dim}) and b "
        f"(B, n_b, {dim}), on body \"mma\" ({yardstick}) or \"wg\" (the "
        "wgmma body of csrc/knn_wg.cuh, which K1 and K3 launch), in mode "
        f"{modes} (default 'packed'): \"packed\" K1 (gated with uv_a, "
        "pred_b, radius2; row_p, "
        "col_p int32; int8 after K1's norm pre-pass, na2 and nb2 ignored), "
        "\"wide\" K3 (row_k, col_k int64), \"row_sum\" the product-only "
        "stage (each A row's wrapping sum of its dots in both slots of row "
        "(B, n_a, 2) int32, col 0x7FFFFFFF; f32 on integer-valued rows). "
        "Norms and shapes as knn.knn_packed_raw / knn.knn_wide_raw; n_a "
        f"and n_b multiples of 64. A CPU tensor takes {name}_plain; any "
        f"other device raises. Counted as {_ENTRIES[dtype, dim]}, not as "
        "K1's or K3's launches.")
    return plain, raw


bf16_d256_plain, bf16_d256_raw = _rows_wrapper(
    torch.bfloat16, 256, "the mma.sync body, K1's and K3's yardstick at "
    "this width")
f32_d256_plain, f32_d256_raw = _rows_wrapper(
    torch.float32, 256, "the mma.sync body on the three bf16 planes after "
    "the split pre-pass: 64 A rows, one 64-row B tile")
i8_d256_plain, i8_d256_raw = _rows_wrapper(
    torch.int8, 256, "the mma.sync s8 body, the 128-row tiles of 128 "
    "values at twice the k-steps")
bf16_d128_plain, bf16_d128_raw = _rows_wrapper(
    torch.bfloat16, 128, "the mma.sync body, K1's and K3's bf16 yardstick "
    "at 128: m16n8k16, 128-row A and B tiles in a cp.async ring")
f32_d128_plain, f32_d128_raw = _rows_wrapper(
    torch.float32, 128, "the mma.sync body on the three bf16 planes after "
    "the split pre-pass, K1 f32's and K3 f32's yardstick at 128: 128 A rows "
    "where n_a allows, else 64, 64-row B tiles in a cp.async ring")
i8_d128_plain, i8_d128_raw = _rows_wrapper(
    torch.int8, 128, "the mma.sync s8 body, K1 int8's yardstick at 128: "
    "m16n8k32, 128-row A and B tiles in a cp.async ring")

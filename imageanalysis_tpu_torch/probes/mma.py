"""Tensor-core yardsticks: the descriptor product with a row sum (P5), on
``wgmma`` fed by TMA, and the one-hot gather (P1) on ``mma.sync``
(``csrc/mma_probe.cu``).

- ``mm_rowsum_*`` — counterpart of ``scripts_dev/matmul_shape_probe.py:33``
  (``mm_kernel``): out[m] = Σₙ Σₖ a[m, k]·b[n, k] per matrix, f32
  accumulation, the product K1 and K3 compute with the cheapest epilogue.
  ``mm_rowsum_raw`` launches the ``wgmma`` kernel: a producer warp's TMA
  loads, two consumer warpgroups, the block's BM A rows resident while
  B streams past in BN-row tiles (``TILES``). The TPU probe swept K ∈
  {128, 256, 512} at (ta, tb) = (128, 6144) and (ta, tb) ∈ {(256,
  2048), (512, 1024), (512, 512)} at K = 128; the card's block tiles (BM
  A rows × BN B rows) take their places in the same order of growing
  area (``P5_TILES``): (512, 512) → (128, 128), (256, 2048) → (256, 64),
  (512, 1024) → (256, 128), (128, 6144) → (256, 256); the K sweep runs
  at ``DEFAULT_TILE``. ``mm_rowsum_v0_raw`` is the first body (``mma.sync``
  with synchronous tile loads), kept as the yardstick, at its own tiles
  ``V0_TILES`` (``P5_V0_TILES`` its map of the TPU's points). (For tb < n
  the TPU kernel kept the last tile's sum, its output block being
  revisited; the card sums every column.)
- ``onehot_gather_*`` — counterpart of ``scripts_dev/epilogue_dot_probe.py:25``
  (``kern``): out[t, c] = Σₙ [j[t] = n]·vals[c, n], the gather K4's TPU
  kernel ran as a one-hot dot on the matrix unit. ``precision`` names how
  the operands are rounded: ``"f32"`` keeps them (what JAX's interpret mode
  computes for the TPU's DEFAULT precision on the CPU), ``"bf16"`` rounds
  them to bf16, nearest even, first (what the TPU's matrix unit and the
  card's ``mma.sync`` do). The card kernel computes ``"bf16"`` only.
  ``limbs`` splits values into the hi/mid/lo limbs the TPU probe gathered.
  ``onehot_gather_raw`` launches one kernel on f32 vals, rounding them in
  registers; ``onehot_gather_v0_raw`` is the first body, kept as its
  yardstick (bf16 vals rounded and out zero-filled by the wrapper: three
  launches a call).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from . import check_device, check_launchable

# (BM, BN) of the wgmma kernel, in order of growing area, and its default
# (the fastest at bench's batch, PERF.md §6)
TILES = ((128, 128), (256, 64), (256, 128), (256, 256))
DEFAULT_TILE = (256, 256)
K_SWEEP = (128, 256, 512)
# matmul_shape_probe's (ta, tb) at K = 128 → the card's (BM, BN)
P5_TILES = {(512, 512): (128, 128), (256, 2048): (256, 64),
            (512, 1024): (256, 128), (128, 6144): (256, 256)}
# the first body's tiles, its K-sweep tile and its map of the TPU's points
V0_TILES = ((64, 64), (64, 128), (128, 64), (128, 128))
V0_K_SWEEP_TILE = (128, 128)
P5_V0_TILES = {(128, 6144): (64, 128), (256, 2048): (128, 128),
               (512, 1024): (128, 64), (512, 512): (64, 64)}
PRECISIONS = ("f32", "bf16")

LAUNCHES = {"mm_rowsum_wg": 0, "mm_rowsum_v0": 0, "onehot_gather": 0,
            "onehot_gather_v0": 0}


def _check_mm(a, b, name):
    dev = check_device((a, b), name)
    if (a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0]
            or a.shape[2] != b.shape[2]):
        raise ValueError(f"{name}: need (B, M, K) and (B, N, K), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise ValueError(f"{name}: takes bf16, got {a.dtype} and {b.dtype}")
    return dev


def mm_rowsum_plain(a, b):
    """Plain version: (a[p] @ b[p]ᵀ).sum(1) in f32 for each matrix p.
    a (B, M, K), b (B, N, K) bf16 → (B, M) f32. Loops over matrices."""
    _check_mm(a, b, "mm_rowsum_plain")
    return torch.stack([(a[p].float() @ b[p].float().T).sum(1)
                        for p in range(a.shape[0])])


def _check_mm_tile(a, b, tile, tiles, name):
    M, N, K = a.shape[1], b.shape[1], a.shape[2]
    if tuple(tile) not in tiles or M % tile[0] or N % tile[1] or K % 64:
        raise ValueError(f"{name}: M={M}, N={N}, K={K} do not fit the tile "
                         f"{tuple(tile)} (tiles {tiles}, K a multiple of "
                         "64)")


def best_split(blocks, n_tiles, sms, a_tiles):
    """The split s of n_tiles B tiles over blocks that minimises waves ×
    (B tiles a block + a_tiles, A's load counted in B tiles), waves =
    ⌈blocks·s / sms⌉ for blocks that hold an SM each; the smallest s of a
    tie."""
    return min(range(1, n_tiles + 1),
               key=lambda s: -(-blocks * s // sms) * (-(-n_tiles // s)
                                                     + a_tiles))


def wg_split(batch, m, n, tile, device):
    """mm_rowsum_raw's default split of each block's B tiles: best_split
    on the card's SMs, A's load BM / BN B tiles. 1 at bench's batch (1536
    blocks of 256 rows); 5 for one 6144² matrix (24 blocks) on 132
    SMs."""
    return best_split(batch * (m // tile[0]), n // tile[1],
                      _sms(torch.device(device)), tile[0] / tile[1])


@functools.lru_cache(maxsize=None)
def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_mm(entry, key, a, b, tile, n_split):
    check_launchable((a, b), entry)
    B, M, K = a.shape
    lib = _build.load()
    dev = a.device
    out = (torch.empty if n_split == 1 else torch.zeros)(
        (B, M), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), B, M, b.shape[1], K,
            tile[0], tile[1], n_split,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, entry)
    LAUNCHES[key] += 1
    return out


def mm_rowsum_raw(a, b, tile=DEFAULT_TILE, n_split=None):
    """The wgmma kernel on a CUDA tensor, mm_rowsum_plain on a CPU tensor;
    raises on any other device. a (B, M, K), b (B, N, K) bf16; tile (BM,
    BN) one of TILES with M and N multiples of it and K a multiple of 64,
    on either device (ValueError). n_split (default wg_split) splits each
    block's B tiles over that many blocks, whose sums meet by atomicAdd
    (order-free on integer values below 2²⁴, else within f32 rounding).
    One launch a call, two where n_split > 1 (out's zero fill)."""
    dev = _check_mm(a, b, "mm_rowsum_raw")
    _check_mm_tile(a, b, tile, TILES, "mm_rowsum_raw")
    if dev.type == "cpu":
        return mm_rowsum_plain(a, b)
    if n_split is None:
        n_split = wg_split(a.shape[0], a.shape[1], b.shape[1], tile, dev)
    return _launch_mm("mm_rowsum_bf16_wg", "mm_rowsum_wg", a, b, tile,
                      n_split)


def wg_plan(tile, K):
    """The wgmma kernel's plan at tile (BM, BN) and K on the current card:
    {"stages": B ring stages, "passes": K passes (A reloaded between
    them), "chunks": 64-dim chunks of A a pass, "smem": dynamic shared
    bytes, "blocks_per_sm": the occupancy calculator's count}. Needs a
    card."""
    plan = (ctypes.c_int * 5)()
    _build.check(_build.load().mm_rowsum_wg_plan(tile[0], tile[1], K, plan),
                 "mm_rowsum_wg_plan")
    return dict(zip(("stages", "passes", "chunks", "smem", "blocks_per_sm"),
                    plan))


def default_split(batch, m, n, tile, device):
    """Blocks along N per (matrix, A tile) for mm_rowsum_v0_raw, so that
    the grid holds at least two blocks per SM: 1 for a full batch, more
    for one matrix."""
    blocks = batch * (m // tile[0])
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(n // tile[1], -(-2 * sms // blocks)))


def mm_rowsum_v0_raw(a, b, tile=V0_K_SWEEP_TILE, n_split=None):
    """The first body, mm_rowsum_raw's yardstick: mma.sync fed by
    synchronous tile loads, on a CUDA tensor; mm_rowsum_plain on a CPU
    tensor; raises on any other device. tile (BM, BN) one of V0_TILES, M
    and N multiples of it, K a multiple of 64. n_split (default
    default_split) as mm_rowsum_raw's."""
    dev = _check_mm(a, b, "mm_rowsum_v0_raw")
    if dev.type == "cpu":
        return mm_rowsum_plain(a, b)
    _check_mm_tile(a, b, tile, V0_TILES, "mm_rowsum_v0_raw")
    if n_split is None:
        n_split = default_split(a.shape[0], a.shape[1], b.shape[1], tile,
                                dev)
    return _launch_mm("mm_rowsum_bf16", "mm_rowsum_v0", a, b, tile, n_split)


def limbs(u):
    """(N,) f32 → (3, N): hi = bf16(u), mid = bf16(u − hi), lo = u − hi −
    mid, each rounded as its own eager op (under jit the TPU's compiler
    cancels the f32 → bf16 → f32 round trip, ops/knn.py:377-384)."""
    hi = u.bfloat16().float()
    mid = (u - hi).bfloat16().float()
    return torch.stack([hi, mid, u - hi - mid])


def _check_gather(j, vals, precision, name):
    dev = check_device((j, vals), name)
    if precision not in PRECISIONS:
        raise ValueError(f"{name}: precision is one of {PRECISIONS}")
    if j.dim() != 1 or vals.dim() != 2 or vals.dtype != torch.float32:
        raise ValueError(f"{name}: need j (T,) and f32 vals (C, N), got "
                         f"{tuple(j.shape)} and {vals.dtype} "
                         f"{tuple(vals.shape)}")
    if j.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{name}: j must be int32 or int64")
    return dev


def onehot_gather_plain(j, vals, precision="bf16"):
    """Plain version: vals[:, j]ᵀ (T, C) f32, the operands rounded as
    ``precision`` says (the one-hot row selects one value exactly)."""
    _check_gather(j, vals, precision, "onehot_gather_plain")
    v = vals.bfloat16().float() if precision == "bf16" else vals
    return v[:, j.long()].T.contiguous()


def _check_gather_launch(j, vals, precision, name):
    """onehot_gather_plain's checks, then the kernels' own: "bf16" only,
    vals (3, N), T and N multiples of 16."""
    dev = _check_gather(j, vals, precision, name)
    if dev.type == "cpu":
        return dev
    if precision != "bf16":
        raise ValueError(f"{name}: the tensor cores take bf16 operands; "
                         "precision='f32' is the plain version's")
    T, (C, N) = j.shape[0], vals.shape
    if C != 3 or T % 16 or N % 16:
        raise ValueError(f"{name}: need vals (3, N), N and T multiples of "
                         f"16, got T={T}, vals {(C, N)}")
    return dev


def _launch_gather(entry, j, vals, out, key):
    check_launchable((j, vals), entry)
    lib = _build.load()
    with torch.cuda.device(out.device):
        err = getattr(lib, entry)(
            j.data_ptr(), vals.data_ptr(), out.data_ptr(), j.shape[0],
            vals.shape[1], torch.cuda.current_stream(out.device).cuda_stream)
    _build.check(err, entry)
    LAUNCHES[key] += 1
    return out


def onehot_gather_raw(j, vals, precision="bf16"):
    """The mma.sync one-hot gather on a CUDA tensor (precision "bf16"
    only: the kernel rounds the f32 vals to bf16, nearest even, in
    registers), the plain version on a CPU tensor; raises on any other
    device. j (T,) int32 in [0, N) with T a multiple of 16; vals (3, N)
    f32 with N a multiple of 16, contiguous. One launch a call."""
    dev = _check_gather_launch(j, vals, precision, "onehot_gather_raw")
    if dev.type == "cpu":
        return onehot_gather_plain(j, vals, precision)
    if j.dtype != torch.int32:
        raise ValueError("onehot_gather_raw: j must be int32 on the card")
    out = torch.empty((j.shape[0], 3), dtype=torch.float32, device=dev)
    return _launch_gather("onehot_gather_bf16", j, vals, out,
                          "onehot_gather")


def onehot_gather_v0_raw(j, vals, precision="bf16"):
    """The first body of the one-hot gather, the new kernel's yardstick:
    the wrapper rounds vals to bf16 and zero-fills out (two more
    launches), the kernel adds warps' partial sums into it with
    atomicAdd. Arguments, result and devices as onehot_gather_raw (j may
    be int64: the wrapper converts it)."""
    dev = _check_gather_launch(j, vals, precision, "onehot_gather_v0_raw")
    if dev.type == "cpu":
        return onehot_gather_plain(j, vals, precision)
    out = torch.zeros((j.shape[0], 3), dtype=torch.float32, device=dev)
    return _launch_gather("onehot_gather_bf16_v0",
                          j.to(torch.int32).contiguous(),
                          vals.bfloat16().contiguous(), out,
                          "onehot_gather_v0")

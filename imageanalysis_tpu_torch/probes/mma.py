"""Tensor-core yardsticks: the descriptor product with a row sum (P5) and
the one-hot gather (P1), both ``mma.sync`` m16n8k16 bf16 → f32
(``csrc/mma_probe.cu``).

- ``mm_rowsum_*`` — counterpart of ``scripts_dev/matmul_shape_probe.py:33``
  (``mm_kernel``): out[m] = Σₙ Σₖ a[m, k]·b[n, k] per matrix, f32
  accumulation, the product K1 and K3 compute with the cheapest epilogue.
  The TPU probe swept K ∈ {128, 256, 512} at (ta, tb) = (128, 6144) and
  (ta, tb) ∈ {(256, 2048), (512, 1024), (512, 512)} at K = 128; the card's
  block tiles (BM A rows × BN B rows) take their places in that order:
  (128, 6144) → (64, 128), (256, 2048) → (128, 128), (512, 1024) → (128,
  64), (512, 512) → (64, 64); the K sweep runs at (128, 128). (For tb < n
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

import torch

from .. import _build
from . import check_device, check_launchable

TILES = ((64, 64), (64, 128), (128, 64), (128, 128))
K_SWEEP = (128, 256, 512)
K_SWEEP_TILE = (128, 128)
# matmul_shape_probe's (ta, tb) at K = 128 → the card's (BM, BN)
P5_TILES = {(128, 6144): (64, 128), (256, 2048): (128, 128),
            (512, 1024): (128, 64), (512, 512): (64, 64)}
PRECISIONS = ("f32", "bf16")

LAUNCHES = {"mm_rowsum": 0, "onehot_gather": 0, "onehot_gather_v0": 0}


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


def default_split(batch, m, n, tile, device):
    """Blocks along N per (matrix, A tile), so that the grid holds at
    least two blocks per SM: 1 for a full batch, more for one matrix."""
    blocks = batch * (m // tile[0])
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(n // tile[1], -(-2 * sms // blocks)))


def mm_rowsum_raw(a, b, tile=K_SWEEP_TILE, n_split=None):
    """The mma.sync kernel on a CUDA tensor, mm_rowsum_plain on a CPU
    tensor; raises on any other device. tile (BM, BN) one of TILES, M and
    N multiples of it, K a multiple of 64. n_split (default
    default_split) splits each block's B rows over that many blocks,
    whose sums meet by atomicAdd (order-free on integer values below
    2²⁴, else within f32 rounding)."""
    dev = _check_mm(a, b, "mm_rowsum_raw")
    if dev.type == "cpu":
        return mm_rowsum_plain(a, b)
    B, M, K = a.shape
    N = b.shape[1]
    if tuple(tile) not in TILES or M % tile[0] or N % tile[1] or K % 64:
        raise ValueError(f"mm_rowsum_raw: M={M}, N={N}, K={K} do not fit "
                         f"the tile {tuple(tile)} (tiles {TILES}, K a "
                         "multiple of 64)")
    check_launchable((a, b), "mm_rowsum_raw")
    if n_split is None:
        n_split = default_split(B, M, N, tile, dev)
    lib = _build.load()
    out = torch.zeros((B, M), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.mm_rowsum_bf16(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                 B, M, N, K, tile[0], tile[1], n_split,
                                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "mm_rowsum_bf16")
    LAUNCHES["mm_rowsum"] += 1
    return out


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

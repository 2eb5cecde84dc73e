"""Exact 2-NN descriptor matching on packed int8 keys.

Port of ``imageanalysis_tpu/ops/knn.py``. Every function takes a leading
pair dimension (the reference vmaps over pairs):

- ``knn_top2_ref`` — unpacked, untruncated 2-NN from the full distance
  matrix (the reference's parity oracle);
- ``knn_packed_plain`` — the plain PyTorch version of kernel K1: the full
  int32 distance matrix, packed into (f32 bits with the low 13 bits
  cleared) | index keys, row top-2 and column minimum;
- ``knn_packed_raw`` — the K1 wrapper: ``csrc/knn_packed.cu`` on a CUDA
  tensor, ``knn_packed_plain`` on a CPU tensor;
- ``knn_top2`` — decodes the packed keys;
- ``match_pair_dense`` — Lowe ratio on squared distances, mutual check and
  the uv pick (the reference's CPU arm, as plain indexing).

Packed keys are exact for int8 descriptors: d2 <= 128 * 255^2 < 2^23
converts to f32 losslessly, and every key is unique, so the kernel and
the plain version agree bit for bit.
"""

from __future__ import annotations

import torch

from .. import _build

PAD_VALUE = 1.0e4  # descriptor fill for padded f32 rows; SIFT values are ≤ 512

_IDX_BITS = 13     # packed keys hold indices < 8192
_IDX_MASK = (1 << _IDX_BITS) - 1
_KEY_MAX = 0x7FFFFFFF
_TILE = 64         # K1 takes n_a and n_b in multiples of 64 rows
_DIM = 128

KNN_PACKED_LAUNCHES = 0  # K1 launches (not plain-version calls)


def pad_descriptors(desc, n_pad):
    """Pad (n, d) descriptors to (n_pad, d) with PAD_VALUE rows."""
    out = desc.new_full((n_pad, desc.shape[1]), PAD_VALUE)
    out[: desc.shape[0]] = desc
    return out


def knn_top2_ref(desc_a, desc_b, bf16=True):
    """Exact 2-NN by squared L2 from the materialized distance matrix.

    desc_a (..., n_a, d), desc_b (..., n_b, d). int8 descriptors compute in
    f32 (exact). bf16=True rounds float operands to bf16 and accumulates in
    f32, as the reference's bf16 dot does. Returns (row_d (..., n_a, 2),
    row_i, col_d (..., n_b), col_i)."""
    if desc_a.dtype == torch.int8:
        bf16 = False
    a = desc_a.float()
    b = desc_b.float()
    na2 = (a * a).sum(-1)
    nb2 = (b * b).sum(-1)
    if bf16:
        a = a.bfloat16().float()
        b = b.bfloat16().float()
    ab = a @ b.transpose(-1, -2)
    d2 = na2[..., :, None] + nb2[..., None, :] - 2.0 * ab
    neg_top, row_i = torch.topk(-d2, 2, dim=-1)
    col_d, col_i = d2.min(dim=-2)
    return -neg_top, row_i.int(), col_d, col_i.int()


def _check_pair_batch(desc_a, desc_b, name):
    if desc_a.device != desc_b.device:
        raise ValueError(f"{name}: descriptors on {desc_a.device} and "
                         f"{desc_b.device}")
    if desc_a.dtype != torch.int8 or desc_b.dtype != torch.int8:
        raise NotImplementedError(
            f"{name}: K1 is ported for int8 descriptors only; the bf16 and "
            f"f32 modes are not ported yet (got {desc_a.dtype}, "
            f"{desc_b.dtype})")
    if (desc_a.dim() != 3 or desc_b.dim() != 3
            or desc_a.shape[0] != desc_b.shape[0]
            or desc_a.shape[2] != _DIM or desc_b.shape[2] != _DIM):
        raise ValueError(f"{name}: need (B, n_a, {_DIM}) and (B, n_b, "
                         f"{_DIM}), got {tuple(desc_a.shape)} and "
                         f"{tuple(desc_b.shape)}")
    if max(desc_a.shape[1], desc_b.shape[1]) > (1 << _IDX_BITS):
        raise NotImplementedError(
            f"{name}: packed keys hold at most {1 << _IDX_BITS} rows; the "
            "unpacked kernel for larger sets is not ported yet")


def knn_packed_plain(desc_a, desc_b):
    """Plain version of K1. desc_a (B, n_a, 128), desc_b (B, n_b, 128) int8.

    Returns raw packed keys: row_p (B, n_a, 2) int32, the two smallest
    (bits(f32(d2)) & ~0x1FFF) | j per A row, and col_p (B, n_b) int32, the
    smallest (bits(f32(d2)) & ~0x1FFF) | i per B row. The dot runs in f32,
    which is exact here: every partial sum is an integer below 2^24 (TF32
    is off, see the package __init__). Loops over pairs so the (n_a, n_b)
    temporaries stay one pair's size."""
    _check_pair_batch(desc_a, desc_b, "knn_packed_plain")
    B, n_a, _ = desc_a.shape
    n_b = desc_b.shape[1]
    dev = desc_a.device
    row_p = torch.empty((B, n_a, 2), dtype=torch.int32, device=dev)
    col_p = torch.empty((B, n_b), dtype=torch.int32, device=dev)
    ia = torch.arange(n_a, dtype=torch.int32, device=dev)[:, None]
    jb = torch.arange(n_b, dtype=torch.int32, device=dev)[None, :]
    for p in range(B):
        a = desc_a[p].float()
        b = desc_b[p].float()
        na2 = (a * a).sum(-1)
        nb2 = (b * b).sum(-1)
        d2 = (na2[:, None] + nb2[None, :] - 2.0 * (a @ b.T)).int()
        bits = d2.float().view(torch.int32) & ~_IDX_MASK
        row_p[p] = torch.topk(bits | jb, 2, dim=1, largest=False).values
        col_p[p] = (bits | ia).amin(dim=0)
    return row_p, col_p


def knn_packed_raw(desc_a, desc_b):
    """K1: packed-key 2-NN of a batch of pairs (see knn_packed_plain for
    the outputs). A CUDA tensor launches csrc/knn_packed.cu; a CPU tensor
    takes knn_packed_plain; any other device raises. On CUDA, n_a and n_b
    must be multiples of 64 (the store pads to 256)."""
    global KNN_PACKED_LAUNCHES
    _check_pair_batch(desc_a, desc_b, "knn_packed_raw")
    dev = desc_a.device
    if dev.type == "cpu":
        return knn_packed_plain(desc_a, desc_b)
    if dev.type != "cuda":
        raise ValueError(f"knn_packed_raw: no kernel for device {dev}")
    B, n_a, _ = desc_a.shape
    n_b = desc_b.shape[1]
    if n_a % _TILE or n_b % _TILE:
        raise ValueError(f"knn_packed_raw: n_a={n_a}, n_b={n_b} must be "
                         f"multiples of {_TILE}")
    for t in (desc_a, desc_b):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("knn_packed_raw: descriptors must be "
                             "contiguous and 16-byte aligned")
    lib = _build.load()
    row_p = torch.empty((B, n_a, 2), dtype=torch.int32, device=dev)
    col_p = torch.full((B, n_b), _KEY_MAX, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.knn_packed_i8(
            desc_a.data_ptr(), desc_b.data_ptr(), row_p.data_ptr(),
            col_p.data_ptr(), B, n_a, n_b,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "knn_packed_i8")
    KNN_PACKED_LAUNCHES += 1
    return row_p, col_p


def knn_top2(desc_a, desc_b):
    """Packed 2-NN, decoded: (row_d (B, n_a, 2) f32, row_i int32,
    col_d (B, n_b) f32, col_i int32). Distances keep the packed keys'
    truncation (13 low mantissa bits cleared)."""
    row_p, col_p = knn_packed_raw(desc_a, desc_b)
    mask = ~_IDX_MASK
    row_d = (row_p & mask).view(torch.float32)
    col_d = (col_p & mask).view(torch.float32)
    return row_d, row_p & _IDX_MASK, col_d, col_p & _IDX_MASK


def match_pair_dense(desc_a, desc_b, n_a, n_b, ratio=0.75, mutual=True,
                     uv_b=None):
    """Lowe ratio + mutual check over a batch of padded descriptor pairs.

    desc_a (B, n_a_pad, 128), desc_b (B, n_b_pad, 128) int8; n_a, n_b (B,)
    real counts. Returns (best_j (B, n_a_pad) int32, ok (B, n_a_pad) bool)
    and, when uv_b (B, n_b_pad, 2) is given, pb = uv_b[best_j] as a third
    output. The ratio test is d1 < ratio²·d2 on squared distances (the
    reference's matcher.py:239-257); the mutual check keeps rows whose
    best B row picks them back."""
    row_d, row_i, _, col_i = knn_top2(desc_a, desc_b)
    dev = desc_a.device
    arange_a = torch.arange(desc_a.shape[1], dtype=torch.int32, device=dev)
    best_j = row_i[..., 0]
    d1 = row_d[..., 0].clamp_min(0.0)
    d2 = row_d[..., 1].clamp_min(0.0)
    ok = d1 < (ratio * ratio) * d2
    bj = best_j.long()
    if mutual:
        ok &= torch.gather(col_i, 1, bj) == arange_a
    ok &= arange_a < n_a.to(dev)[:, None]
    ok &= best_j < n_b.to(dev)[:, None]
    if uv_b is not None:
        pb = torch.gather(uv_b, 1, bj[..., None].expand(-1, -1, 2))
        return best_j, ok, pb
    return best_j, ok

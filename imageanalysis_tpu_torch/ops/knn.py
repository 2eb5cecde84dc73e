"""Exact 2-NN descriptor matching: kernels K1 (packed keys) and K3 (wide).

Port of ``imageanalysis_tpu/ops/knn.py``. Every function takes a leading
pair dimension (the reference vmaps over pairs):

- ``knn_top2_ref`` — unpacked, untruncated 2-NN from the full distance
  matrix, with the optional spatial gate: the reference's CPU arm;
- ``knn_packed_plain`` / ``knn_packed_raw`` — the plain PyTorch version of
  kernel K1 and its wrapper (``csrc/knn_packed.cu`` on a CUDA tensor, the
  plain version on a CPU tensor): packed (f32 bits with the low 13 bits
  cleared) | index keys, row top-2 and column minimum, for int8, bf16 and
  f32 descriptors, with or without the gate (f32 runs on the tensor
  cores as three bf16 planes, see ``split_bf16x3_plain``);
- ``split_bf16x3_plain`` / ``split_bf16x3_raw`` — the f32 modes'
  pre-pass: each f32 value as hi + mid + lo of three bf16 values,
  exactly;
- ``knn_wide_plain`` / ``knn_wide_raw`` — the same for kernel K3
  (``csrc/knn_wide.cu``): unpacked 64-bit (value, index) keys, any size,
  bf16 and f32 (f32 on the tensor cores as three bf16 planes, as K1's);
- ``knn_top2`` — the reference's dispatch: K1 up to 8192 rows, K3 beyond
  (int8 cast to bf16; no gate there), decoded;
- ``match_epilogue_plain`` / ``match_epilogue_raw`` — the plain version of
  kernel K4 and its wrapper (``csrc/match_epilogue.cu``): decode K1's raw
  keys, ratio test, mutual check and the uv pick, per A row;
- ``knn_match_fused`` — K1 in raw packed mode, then K4 (two launches);
- ``match_pair_dense`` — Lowe ratio on squared distances, mutual check and
  the uv pick. On a CPU tensor ``use_pallas`` picks the arm as the
  reference's does (None is the CPU arm); a CUDA tensor always takes the
  kernels (``kernel_arm``). With ``IMGTPU_FUSED_EPILOGUE`` set to anything
  but "0" (read at each call, default off, as the reference's switch) the
  kernel arm takes ``knn_match_fused`` where the reference does.

Packed keys are exact for int8 descriptors (d2 ≤ 128·255² < 2²³) and for
integer-valued float descriptors (every product and partial sum of the
dot is an integer below 2²⁴; f32's mid and lo planes are then 0), and
every key is unique, so each kernel and its plain version agree bit for
bit there.
"""

from __future__ import annotations

import os

import torch

from .. import _build

PAD_VALUE = 1.0e4  # descriptor fill for padded f32 rows; SIFT values are ≤ 512
_BIG = 3.0e10      # > any real squared distance: the CPU arm's gated-out value

_IDX_BITS = 13     # packed keys hold indices < 8192
_IDX_MASK = (1 << _IDX_BITS) - 1
_KEY_MAX = 0x7FFFFFFF
_GATED_BITS = _KEY_MAX & ~_IDX_MASK   # value bits of a gated-out candidate
_TILE = 64         # the kernels take n_a and n_b in multiples of 64 rows
_DIM = 128
_WIDE_MAX = (1 << 63) - 1

# kernel launches (not plain-version calls), by mode: K1 int8 ungated, K1
# gated (any dtype), K1 bf16 and f32 ungated, K3 bf16 and f32, K4; the
# split pre-pass alone (K1 f32 and K3 f32 launch it inside their own entry
# points)
LAUNCHES = dict.fromkeys(("knn_packed_i8", "knn_packed_gated",
                          "knn_packed_bf16", "knn_packed_f32", "knn_wide",
                          "knn_wide_f32", "match_epilogue", "split_bf16x3"),
                         0)


def pad_descriptors(desc, n_pad):
    """Pad (n, d) descriptors to (n_pad, d) with PAD_VALUE rows."""
    out = desc.new_full((n_pad, desc.shape[1]), PAD_VALUE)
    out[: desc.shape[0]] = desc
    return out


def _orderable(d2):
    """f32 → int64 that orders like the float, negatives included (the
    kernels' orderable(); −0 and +0 map apart, so add 0.0 first)."""
    b = d2.contiguous().view(torch.int32)
    return (b ^ ((b >> 31) & 0x7FFFFFFF)).long()


def _wide_keys(d2, idx):
    """(orderable(d2) << 32) | idx as int64: smallest value first, lowest
    index among equal values."""
    return (_orderable(d2 + 0.0) << 32) | idx


def _decode_wide(keys):
    """int64 keys → (f32 values, int32 indices)."""
    s = (keys >> 32).to(torch.int32)
    bits = s ^ ((s >> 31) & 0x7FFFFFFF)
    return bits.view(torch.float32), (keys & 0xFFFFFFFF).to(torch.int32)


def _top2_from_d2(d2):
    """Row top-2 and column minimum of one (n_a, n_b) distance matrix, ties
    to the lowest index: (row_d, row_i, col_d, col_i)."""
    n_a, n_b = d2.shape
    dev = d2.device
    jb = torch.arange(n_b, dtype=torch.int64, device=dev)[None, :]
    ia = torch.arange(n_a, dtype=torch.int64, device=dev)[:, None]
    row = torch.topk(_wide_keys(d2, jb), 2, dim=1, largest=False).values
    col = _wide_keys(d2, ia).amin(dim=0)
    return (*_decode_wide(row), *_decode_wide(col))


def _pairs(x):
    """(..., n, d) → (P, n, d) with P the product of the leading dims."""
    return x.reshape(-1, *x.shape[-2:])


def knn_top2_ref(desc_a, desc_b, bf16=True, gate_uv_a=None, gate_pred_b=None,
                 gate_radius=0.0):
    """Exact 2-NN by squared L2 from the materialized distance matrix.

    desc_a (..., n_a, d), desc_b (..., n_b, d). int8 descriptors compute in
    f32 (exact). bf16=True rounds float operands to bf16 for the dot (f32
    accumulation) and keeps the norms f32, as the reference's bf16 dot
    does. gate_* (..., n, 2): candidates farther than gate_radius px from
    the predicted position are set to 3e10 before the top-2. Ties go to
    the lowest index. Returns (row_d (..., n_a, 2), row_i, col_d (...,
    n_b), col_i). Loops over pairs, so temporaries stay one pair's size."""
    if desc_a.dtype == torch.int8:
        bf16 = False
    lead = desc_a.shape[:-2]
    a_all, b_all = _pairs(desc_a), _pairs(desc_b)
    gated = gate_radius > 0.0 and gate_uv_a is not None
    if gated:
        ua_all, pb_all = _pairs(gate_uv_a), _pairs(gate_pred_b)
        r2 = torch.tensor(float(gate_radius) ** 2, dtype=torch.float32)
    outs = []
    for p in range(a_all.shape[0]):
        a, b = a_all[p].float(), b_all[p].float()
        na2 = (a * a).sum(-1)
        nb2 = (b * b).sum(-1)
        if bf16:
            a = a.bfloat16().float()
            b = b.bfloat16().float()
        d2 = na2[:, None] + nb2[None, :] - 2.0 * (a @ b.T)
        if gated:
            diff = ua_all[p][:, None, :] - pb_all[p][None, :, :]
            gd2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
            d2 = torch.where(gd2 > r2.to(gd2.device), _BIG, d2)
        outs.append(_top2_from_d2(d2))
    row_d, row_i, col_d, col_i = (torch.stack(x) for x in zip(*outs))
    return (row_d.reshape(*lead, -1, 2), row_i.reshape(*lead, -1, 2),
            col_d.reshape(*lead, -1), col_i.reshape(*lead, -1))


# ---------------------------------------------------------------------------
# K1: packed keys
# ---------------------------------------------------------------------------

def _check_pair_batch(desc_a, desc_b, na2, nb2, name, max_rows):
    if desc_a.device != desc_b.device:
        raise ValueError(f"{name}: descriptors on {desc_a.device} and "
                         f"{desc_b.device}")
    if (desc_a.dim() != 3 or desc_b.dim() != 3
            or desc_a.shape[0] != desc_b.shape[0]
            or desc_a.shape[2] != _DIM or desc_b.shape[2] != _DIM):
        raise ValueError(f"{name}: need (B, n_a, {_DIM}) and (B, n_b, "
                         f"{_DIM}), got {tuple(desc_a.shape)} and "
                         f"{tuple(desc_b.shape)}")
    if desc_a.dtype != desc_b.dtype:
        raise ValueError(f"{name}: descriptors of {desc_a.dtype} and "
                         f"{desc_b.dtype}")
    float_in = desc_a.dtype in (torch.bfloat16, torch.float32)
    if not float_in and desc_a.dtype != torch.int8:
        raise ValueError(f"{name}: no mode for {desc_a.dtype} descriptors")
    if float_in and (na2 is None or nb2 is None
                     or na2.shape != desc_a.shape[:2]
                     or nb2.shape != desc_b.shape[:2]
                     or na2.dtype != torch.float32
                     or nb2.dtype != torch.float32):
        raise ValueError(f"{name}: float descriptors need f32 squared norms "
                         "na2 (B, n_a) and nb2 (B, n_b)")
    if max(desc_a.shape[1], desc_b.shape[1]) > max_rows:
        raise ValueError(f"{name}: packed keys hold at most {max_rows} rows "
                         f"(got {desc_a.shape[1]}, {desc_b.shape[1]}); "
                         "knn_top2 takes the wide kernel beyond")


def _check_gate(uv_a, pred_b, desc_a, desc_b, name):
    if (uv_a.shape != (*desc_a.shape[:2], 2)
            or pred_b.shape != (*desc_b.shape[:2], 2)
            or uv_a.dtype != torch.float32 or pred_b.dtype != torch.float32
            or uv_a.device != desc_a.device
            or pred_b.device != desc_a.device):
        raise ValueError(f"{name}: gate needs f32 uv_a (B, n_a, 2) and "
                         f"pred_b (B, n_b, 2) on {desc_a.device}")


def knn_packed_plain(desc_a, desc_b, na2=None, nb2=None, uv_a=None,
                     pred_b=None, radius2=None):
    """Plain version of K1 in every mode.

    desc_a (B, n_a, 128), desc_b (B, n_b, 128): int8 (norms computed here,
    exact) or bf16/f32 with the f32 squared norms na2 (B, n_a), nb2 (B,
    n_b) of the unrounded descriptors. uv_a (B, n_a, 2), pred_b (B, n_b, 2)
    f32 and radius2 turn the gate on. Returns raw packed keys: row_p (B,
    n_a, 2) int32, the two smallest bits | j per A row, and col_p (B, n_b)
    int32, the smallest bits | i per B row, where bits = f32 bits of d2
    with the low 13 bits cleared, or 0x7FFFE000 for a gated-out candidate.
    int8 d2 is exact int32; float d2 = max((‖a‖² + ‖b‖²) − 2 a·b, 0) in
    f32 with the dot in f32 (TF32 is off, see the package __init__). Loops
    over pairs so the (n_a, n_b) temporaries stay one pair's size."""
    _check_pair_batch(desc_a, desc_b, na2, nb2, "knn_packed_plain",
                      1 << _IDX_BITS)
    B, n_a, _ = desc_a.shape
    n_b = desc_b.shape[1]
    dev = desc_a.device
    gated = uv_a is not None
    if gated:
        _check_gate(uv_a, pred_b, desc_a, desc_b, "knn_packed_plain")
        r2 = torch.tensor(radius2, dtype=torch.float32, device=dev)
    row_p = torch.empty((B, n_a, 2), dtype=torch.int32, device=dev)
    col_p = torch.empty((B, n_b), dtype=torch.int32, device=dev)
    ia = torch.arange(n_a, dtype=torch.int32, device=dev)[:, None]
    jb = torch.arange(n_b, dtype=torch.int32, device=dev)[None, :]
    for p in range(B):
        a = desc_a[p].float()
        b = desc_b[p].float()
        if desc_a.dtype == torch.int8:
            d2 = ((a * a).sum(-1)[:, None] + (b * b).sum(-1)[None, :]
                  - 2.0 * (a @ b.T)).int().float()
        else:
            d2 = (na2[p][:, None] + nb2[p][None, :] - 2.0 * (a @ b.T)) \
                .clamp_min(0.0)
        bits = d2.view(torch.int32) & ~_IDX_MASK
        if gated:
            dx = uv_a[p][:, 0, None] - pred_b[p][None, :, 0]
            dy = uv_a[p][:, 1, None] - pred_b[p][None, :, 1]
            bits = torch.where(dx * dx + dy * dy > r2, _GATED_BITS, bits)
        row_p[p] = torch.topk(bits | jb, 2, dim=1, largest=False).values
        col_p[p] = (bits | ia).amin(dim=0)
    return row_p, col_p


def _check_launch(tensors, n_a, n_b, name):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if n_a % _TILE or n_b % _TILE:
        raise ValueError(f"{name}: n_a={n_a}, n_b={n_b} must be multiples "
                         f"of {_TILE}")
    for t in tensors:
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name}: inputs must be contiguous and "
                             "16-byte aligned")


def _ptr(t):
    return None if t is None else t.data_ptr()


def knn_packed_raw(desc_a, desc_b, na2=None, nb2=None, uv_a=None,
                   pred_b=None, radius2=None):
    """K1: packed-key 2-NN of a batch of pairs, in the mode its inputs
    select (see knn_packed_plain). A CUDA tensor launches
    csrc/knn_packed.cu; a CPU tensor takes knn_packed_plain; any other
    device raises. On CUDA, n_a and n_b must be multiples of 64 (the store
    pads to 256)."""
    _check_pair_batch(desc_a, desc_b, na2, nb2, "knn_packed_raw",
                      1 << _IDX_BITS)
    gated = uv_a is not None
    if gated:
        _check_gate(uv_a, pred_b, desc_a, desc_b, "knn_packed_raw")
    dev = desc_a.device
    if dev.type == "cpu":
        return knn_packed_plain(desc_a, desc_b, na2, nb2, uv_a, pred_b,
                                radius2)
    B, n_a, _ = desc_a.shape
    n_b = desc_b.shape[1]
    _check_launch((desc_a, desc_b, na2, nb2, uv_a, pred_b), n_a, n_b,
                  "knn_packed_raw")
    lib = _build.load()
    row_p = torch.empty((B, n_a, 2), dtype=torch.int32, device=dev)
    col_p = torch.full((B, n_b), _KEY_MAX, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if desc_a.dtype == torch.int8:
            # scratch for the squared norms, which the kernel's pre-pass
            # writes
            sa = torch.empty((B, n_a), dtype=torch.float32, device=dev)
            sb = torch.empty((B, n_b), dtype=torch.float32, device=dev)
            ptrs = (desc_a.data_ptr(), desc_b.data_ptr(), sa.data_ptr(),
                    sb.data_ptr())
        if desc_a.dtype == torch.int8 and not gated:
            name = "knn_packed_i8"
            err = lib.knn_packed_i8(*ptrs, row_p.data_ptr(),
                                    col_p.data_ptr(), B, n_a, n_b, stream)
        elif desc_a.dtype == torch.int8:
            name = "knn_packed_i8_gated"
            err = lib.knn_packed_i8_gated(
                *ptrs, uv_a.data_ptr(), pred_b.data_ptr(), radius2,
                row_p.data_ptr(), col_p.data_ptr(), B, n_a, n_b, stream)
        else:
            name = "knn_packed_float"
            bf16 = desc_a.dtype == torch.bfloat16
            # f32: scratch for the operands' three bf16 planes, which the
            # kernel's split pre-pass writes
            sa, sb = (None, None) if bf16 else (
                _split_scratch(desc_a), _split_scratch(desc_b))
            err = lib.knn_packed_float(
                desc_a.data_ptr(), desc_b.data_ptr(), na2.data_ptr(),
                nb2.data_ptr(), _ptr(uv_a), _ptr(pred_b),
                radius2 if gated else 0.0, row_p.data_ptr(),
                col_p.data_ptr(), _ptr(sa), _ptr(sb), B, n_a, n_b,
                int(bf16), stream)
    _build.check(err, name)
    if gated:
        LAUNCHES["knn_packed_gated"] += 1
    elif desc_a.dtype == torch.int8:
        LAUNCHES["knn_packed_i8"] += 1
    elif desc_a.dtype == torch.bfloat16:
        LAUNCHES["knn_packed_bf16"] += 1
    else:
        LAUNCHES["knn_packed_f32"] += 1
    return row_p, col_p


def _split_scratch(x):
    """Scratch for the three bf16 planes of f32 rows x (..., 128): (...,
    3, 128) bf16."""
    return torch.empty((*x.shape[:-1], 3, _DIM), dtype=torch.bfloat16,
                       device=x.device)


def split_bf16x3_plain(x):
    """Plain version of the f32 modes' pre-pass (K1's and K3's): f32 rows
    x (..., 128) → (..., 3, 128) bf16, the planes hi = bf16(x), mid = bf16(x − hi), lo = bf16(x
    − hi − mid), each rounded to nearest even; every difference is exact
    in f32, so hi + mid + lo == x for every finite f32 of descriptor
    range."""
    if x.dtype != torch.float32 or x.shape[-1] != _DIM:
        raise ValueError(f"split_bf16x3: need (..., {_DIM}) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    hi = x.bfloat16()
    r1 = x - hi.float()
    mid = r1.bfloat16()
    lo = (r1 - mid.float()).bfloat16()
    return torch.stack((hi, mid, lo), dim=-2)


def split_bf16x3_raw(x):
    """The f32 modes' split pre-pass on its own (see split_bf16x3_plain).
    A CUDA tensor launches it (csrc/knn_packed.cu), contiguous and 16-byte
    aligned; a CPU tensor takes split_bf16x3_plain; any other device
    raises."""
    if x.device.type == "cpu":
        return split_bf16x3_plain(x)
    if x.dtype != torch.float32 or x.shape[-1] != _DIM or x.numel() == 0:
        raise ValueError(f"split_bf16x3: need (..., {_DIM}) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    rows = x.numel() // _DIM
    _check_launch((x,), 0, 0, "split_bf16x3_raw")
    out = _split_scratch(x)
    with torch.cuda.device(x.device):
        err = _build.load().split_bf16x3(
            x.data_ptr(), out.data_ptr(), rows,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "split_bf16x3")
    LAUNCHES["split_bf16x3"] += 1
    return out


def _decode_packed(row_p, col_p):
    mask = ~_IDX_MASK
    return ((row_p & mask).view(torch.float32), row_p & _IDX_MASK,
            (col_p & mask).view(torch.float32), col_p & _IDX_MASK)


# ---------------------------------------------------------------------------
# K3: wide (unpacked) keys
# ---------------------------------------------------------------------------

def _check_wide(desc_a, desc_b, na2, nb2, name):
    _check_pair_batch(desc_a, desc_b, na2, nb2, name, 1 << 30)
    if desc_a.dtype == torch.int8:
        raise ValueError(f"{name}: takes bf16 or f32 descriptors (cast int8 "
                         "to bf16, exactly)")


def knn_wide_plain(desc_a, desc_b, na2, nb2):
    """Plain version of K3. desc_a (B, n_a, 128), desc_b (B, n_b, 128) bf16
    or f32 with f32 squared norms na2 (B, n_a), nb2 (B, n_b).

    d2 = (‖a‖² + ‖b‖²) − 2 a·b in f32, not clamped. Returns int64 keys
    (orderable(d2) << 32) | index: row_k (B, n_a, 2), the two smallest per
    A row, and col_k (B, n_b), the smallest per B row; ties go to the
    lowest index. Loops over pairs (the full distance matrix of one pair
    at a time)."""
    _check_wide(desc_a, desc_b, na2, nb2, "knn_wide_plain")
    B, n_a, _ = desc_a.shape
    n_b = desc_b.shape[1]
    dev = desc_a.device
    row_k = torch.empty((B, n_a, 2), dtype=torch.int64, device=dev)
    col_k = torch.empty((B, n_b), dtype=torch.int64, device=dev)
    ia = torch.arange(n_a, dtype=torch.int64, device=dev)[:, None]
    jb = torch.arange(n_b, dtype=torch.int64, device=dev)[None, :]
    for p in range(B):
        d2 = (na2[p][:, None] + nb2[p][None, :]
              - 2.0 * (desc_a[p].float() @ desc_b[p].float().T))
        row_k[p] = torch.topk(_wide_keys(d2, jb), 2, dim=1,
                              largest=False).values
        col_k[p] = _wide_keys(d2, ia).amin(dim=0)
    return row_k, col_k


def knn_wide_raw(desc_a, desc_b, na2, nb2):
    """K3: wide-key 2-NN of a batch of pairs (see knn_wide_plain). A CUDA
    tensor launches csrc/knn_wide.cu (f32: the split pre-pass, then the
    tensor-core body on three bf16 planes, counted as knn_wide_f32; bf16
    as knn_wide); a CPU tensor takes knn_wide_plain; any other device
    raises. On CUDA, n_a and n_b must be multiples of 64."""
    _check_wide(desc_a, desc_b, na2, nb2, "knn_wide_raw")
    dev = desc_a.device
    if dev.type == "cpu":
        return knn_wide_plain(desc_a, desc_b, na2, nb2)
    B, n_a, _ = desc_a.shape
    n_b = desc_b.shape[1]
    _check_launch((desc_a, desc_b, na2, nb2), n_a, n_b, "knn_wide_raw")
    lib = _build.load()
    row_k = torch.empty((B, n_a, 2), dtype=torch.int64, device=dev)
    col_k = torch.full((B, n_b), _WIDE_MAX, dtype=torch.int64, device=dev)
    bf16 = desc_a.dtype == torch.bfloat16
    # f32: scratch for the operands' three bf16 planes, which the kernel's
    # split pre-pass writes
    sa, sb = (None, None) if bf16 else (
        _split_scratch(desc_a), _split_scratch(desc_b))
    with torch.cuda.device(dev):
        err = lib.knn_wide(desc_a.data_ptr(), desc_b.data_ptr(),
                           na2.data_ptr(), nb2.data_ptr(), row_k.data_ptr(),
                           col_k.data_ptr(), _ptr(sa), _ptr(sb), B, n_a, n_b,
                           int(bf16),
                           torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "knn_wide")
    LAUNCHES["knn_wide" if bf16 else "knn_wide_f32"] += 1
    return row_k, col_k


# ---------------------------------------------------------------------------
# dispatch and match assembly
# ---------------------------------------------------------------------------

def _sq_norms(desc):
    """f32 squared norms of the unrounded descriptors, (B, n)."""
    if desc.dtype == torch.int8:
        return desc.int().square().sum(-1).float()
    d = desc.float()
    return (d * d).sum(-1)


def knn_top2(desc_a, desc_b, bf16=True, gate_uv_a=None, gate_pred_b=None,
             gate_radius=0.0):
    """Streaming 2-NN through the kernels, decoded: (row_d (B, n_a, 2) f32,
    row_i int32, col_d (B, n_b) f32, col_i int32).

    int8 descriptors take K1's int8 mode; float ones K1's bf16 mode
    (bf16=True: the dot on bf16-rounded operands, norms from the f32
    descriptors) or its f32 mode. Beyond 8192 rows K3 takes over (int8
    cast to bf16, exactly, with f32 norms); its distances are untruncated.
    K1's distances keep the packed keys' truncation. gate_* (B, n, 2) with
    gate_radius > 0 turn the spatial gate on; it needs K1 (n ≤ 8192)."""
    n_a, n_b = desc_a.shape[1], desc_b.shape[1]
    int8_in = desc_a.dtype == torch.int8
    gated = gate_radius > 0.0 and gate_uv_a is not None
    if int8_in:
        a, b, na2, nb2 = desc_a, desc_b, None, None
    else:
        dt = torch.bfloat16 if bf16 else torch.float32
        na2, nb2 = _sq_norms(desc_a), _sq_norms(desc_b)
        a, b = desc_a.to(dt).contiguous(), desc_b.to(dt).contiguous()
    if max(n_a, n_b) <= (1 << _IDX_BITS):
        if gated:
            row_p, col_p = knn_packed_raw(
                a, b, na2, nb2, gate_uv_a.float().contiguous(),
                gate_pred_b.float().contiguous(), float(gate_radius) ** 2)
        else:
            row_p, col_p = knn_packed_raw(a, b, na2, nb2)
        return _decode_packed(row_p, col_p)
    if gated:
        raise NotImplementedError(
            "spatial gating needs the packed-key kernel (n ≤ 8192); use "
            "knn_top2_ref for larger feature sets")
    if int8_in:
        na2, nb2 = _sq_norms(desc_a), _sq_norms(desc_b)
        a, b = desc_a.bfloat16(), desc_b.bfloat16()
    row_k, col_k = knn_wide_raw(a, b, na2, nb2)
    return (*_decode_wide(row_k), *_decode_wide(col_k))


def kernel_arm(device, use_pallas, gated, n_rows):
    """Whether match_pair_dense takes knn_top2 (the kernels) rather than
    knn_top2_ref (the CPU arm), for descriptors on device with n_rows =
    max(n_a, n_b).

    A CPU tensor follows the reference: use_pallas (None is False) picks
    the kernels' plain versions, except for a gate beyond 8192 rows, which
    takes the CPU arm. A CUDA tensor always takes the kernels, and
    knn_top2 raises for a gate beyond 8192 rows (BatchMatcher drops the
    gate there, as the reference's kernel arm does); use_pallas=False on
    a CUDA tensor raises ValueError."""
    if device.type != "cuda":
        return bool(use_pallas) and (not gated or n_rows <= (1 << _IDX_BITS))
    if use_pallas is False:
        raise ValueError("use_pallas=False is the CPU arm; a CUDA tensor "
                         "takes the kernels")
    return True


# ---------------------------------------------------------------------------
# K4: the fused match epilogue
# ---------------------------------------------------------------------------

def _check_epilogue(row_p, col_p, uv_b, name):
    if (row_p.dim() != 3 or row_p.shape[2] != 2 or col_p.dim() != 2
            or row_p.shape[0] != col_p.shape[0]
            or tuple(uv_b.shape) != (*col_p.shape, 2)):
        raise ValueError(f"{name}: need row_p (B, n_a, 2), col_p (B, n_b) "
                         f"and uv_b (B, n_b, 2), got {tuple(row_p.shape)}, "
                         f"{tuple(col_p.shape)} and {tuple(uv_b.shape)}")
    if (row_p.dtype != torch.int32 or col_p.dtype != torch.int32
            or uv_b.dtype != torch.float32):
        raise ValueError(f"{name}: need int32 row_p and col_p and f32 uv_b, "
                         f"got {row_p.dtype}, {col_p.dtype}, {uv_b.dtype}")
    if not row_p.device == col_p.device == uv_b.device:
        raise ValueError(f"{name}: inputs on {row_p.device}, {col_p.device} "
                         f"and {uv_b.device}")
    if max(row_p.shape[1], col_p.shape[1]) > (1 << _IDX_BITS):
        raise ValueError(f"{name}: packed keys hold at most "
                         f"{1 << _IDX_BITS} rows")


def match_epilogue_plain(row_p, col_p, uv_b, ratio=0.75):
    """Plain version of K4: K1's raw packed keys → (best_j, ok, pb).

    row_p (B, n_a, 2) int32 and col_p (B, n_b) int32 as knn_packed_raw
    returns them, uv_b (B, n_b, 2) f32. Per A row i: j = the low 13 bits
    of the best key; d1, d2 = the two keys with those bits cleared, as
    f32; ok = max(d1, 0) < ratio²·max(d2, 0) (the product rounded to f32)
    and the mutual check col_p[j]'s index == i; pb = uv_b[j]. A j ≥ n_b
    (no key of K1 names one) gives ok False and pb (0, 0). Returns
    (best_j (B, n_a) int32, ok (B, n_a) bool, pb (B, n_a, 2) f32)."""
    _check_epilogue(row_p, col_p, uv_b, "match_epilogue_plain")
    n_a, n_b = row_p.shape[1], col_p.shape[1]
    best_j = row_p[..., 0] & _IDX_MASK
    d1 = (row_p[..., 0] & ~_IDX_MASK).view(torch.float32).clamp_min(0.0)
    d2 = (row_p[..., 1] & ~_IDX_MASK).view(torch.float32).clamp_min(0.0)
    in_b = best_j < n_b
    j = torch.where(in_b, best_j, 0).long()
    col_i = torch.gather(col_p, 1, j) & _IDX_MASK
    arange_a = torch.arange(n_a, dtype=torch.int32, device=row_p.device)
    ok = (d1 < (ratio * ratio) * d2) & in_b & (col_i == arange_a)
    pb = torch.gather(uv_b, 1, j[..., None].expand(-1, -1, 2))
    return best_j, ok, torch.where(in_b[..., None], pb, 0.0)


def match_epilogue_raw(row_p, col_p, uv_b, ratio=0.75):
    """K4 (see match_epilogue_plain). A CUDA tensor launches
    csrc/match_epilogue.cu, one thread per A row; a CPU tensor takes
    match_epilogue_plain; any other device, dtype or shape raises."""
    _check_epilogue(row_p, col_p, uv_b, "match_epilogue_raw")
    dev = row_p.device
    if dev.type == "cpu":
        return match_epilogue_plain(row_p, col_p, uv_b, ratio)
    if dev.type != "cuda":
        raise ValueError(f"match_epilogue_raw: no kernel for device {dev}")
    for t in (row_p, col_p, uv_b):
        if not t.is_contiguous() or t.data_ptr() % 8:
            raise ValueError("match_epilogue_raw: inputs must be contiguous "
                             "and 8-byte aligned")
    B, n_a, _ = row_p.shape
    n_b = col_p.shape[1]
    lib = _build.load()
    best_j = torch.empty((B, n_a), dtype=torch.int32, device=dev)
    ok = torch.empty((B, n_a), dtype=torch.bool, device=dev)
    pb = torch.empty((B, n_a, 2), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.match_epilogue(
            row_p.data_ptr(), col_p.data_ptr(), uv_b.data_ptr(),
            float(ratio) ** 2, best_j.data_ptr(), ok.data_ptr(),
            pb.data_ptr(), B, n_a, n_b,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "match_epilogue")
    LAUNCHES["match_epilogue"] += 1
    return best_j, ok, pb


def knn_match_fused(desc_a, desc_b, uv_b, ratio=0.75, gate_uv_a=None,
                    gate_pred_b=None, gate_radius=0.0):
    """2-NN + ratio + mutual + uv pick in two launches: K1 in raw packed
    mode, then K4. desc_a (B, n_a, 128), desc_b (B, n_b, 128) int8 or
    float, n ≤ 8192; uv_b (B, n_b, 2). Float descriptors always run K1's
    bf16 mode (norms from the unrounded values), whatever a caller's bf16
    says, as the reference's knn_match_fused. gate_* as knn_top2. Returns
    match_epilogue_raw's (best_j, ok, pb); the caller masks padded rows."""
    if desc_a.dtype == torch.int8:
        a, b, na2, nb2 = desc_a, desc_b, None, None
    else:
        na2, nb2 = _sq_norms(desc_a), _sq_norms(desc_b)
        a = desc_a.bfloat16().contiguous()
        b = desc_b.bfloat16().contiguous()
    if gate_radius > 0.0 and gate_uv_a is not None:
        row_p, col_p = knn_packed_raw(
            a, b, na2, nb2, gate_uv_a.float().contiguous(),
            gate_pred_b.float().contiguous(), float(gate_radius) ** 2)
    else:
        row_p, col_p = knn_packed_raw(a, b, na2, nb2)
    return match_epilogue_raw(row_p, col_p, uv_b.float().contiguous(), ratio)


def _fused_epilogue_on():
    """The reference's switch, read at each call: IMGTPU_FUSED_EPILOGUE set
    to anything but "0" (default off)."""
    return os.environ.get("IMGTPU_FUSED_EPILOGUE", "0") != "0"


def match_pair_dense(desc_a, desc_b, n_a, n_b, ratio=0.75, mutual=True,
                     use_pallas=None, bf16=True, gate_uv_a=None,
                     gate_pred_b=None, gate_radius=0.0, uv_b=None):
    """Lowe ratio + mutual check over a batch of padded descriptor pairs.

    desc_a (B, n_a_pad, 128), desc_b (B, n_b_pad, 128) int8 or float;
    n_a, n_b (B,) real counts. The 2-NN arm follows kernel_arm: on the CPU
    use_pallas=True takes knn_top2 (the kernels' plain versions) and
    False or None knn_top2_ref; a CUDA tensor always takes the kernels.
    Returns (best_j (B, n_a_pad) int32, ok (B, n_a_pad) bool) and, when
    uv_b (B, n_b_pad, 2) is given, pb = uv_b[best_j] as a third output.
    The ratio test is d1 < ratio²·d2 on squared distances; the mutual
    check keeps rows whose best B row picks them back.

    The fused arm (knn_match_fused, K1 then K4) is taken under the
    reference's condition: the kernel arm, mutual, uv_b given, n_a_pad
    and n_b_pad ≤ 8192, n_a_pad a multiple of 8 and IMGTPU_FUSED_EPILOGUE
    set to anything but "0" (read at each call)."""
    gate = dict(gate_uv_a=gate_uv_a, gate_pred_b=gate_pred_b,
                gate_radius=gate_radius)
    n_rows = max(desc_a.shape[1], desc_b.shape[1])
    dev = desc_a.device
    arange_a = torch.arange(desc_a.shape[1], dtype=torch.int32, device=dev)
    arm = kernel_arm(dev, use_pallas, gate_radius > 0.0, n_rows)
    if (arm and mutual and uv_b is not None and n_rows <= (1 << _IDX_BITS)
            and desc_a.shape[1] % 8 == 0 and _fused_epilogue_on()):
        best_j, ok, pb = knn_match_fused(desc_a, desc_b, uv_b, ratio=ratio,
                                         **gate)
        ok &= arange_a < torch.as_tensor(n_a).to(dev)[:, None]
        ok &= best_j < torch.as_tensor(n_b).to(dev)[:, None]
        return best_j, ok, pb
    if arm:
        row_d, row_i, _, col_i = knn_top2(desc_a, desc_b, bf16=bf16, **gate)
    else:
        row_d, row_i, _, col_i = knn_top2_ref(desc_a, desc_b, bf16=bf16,
                                              **gate)
    best_j = row_i[..., 0]
    d1 = row_d[..., 0].clamp_min(0.0)
    d2 = row_d[..., 1].clamp_min(0.0)
    ok = d1 < (ratio * ratio) * d2
    bj = best_j.long()
    if mutual:
        ok &= torch.gather(col_i, 1, bj) == arange_a
    ok &= arange_a < torch.as_tensor(n_a).to(dev)[:, None]
    ok &= best_j < torch.as_tensor(n_b).to(dev)[:, None]
    if uv_b is not None:
        pb = torch.gather(uv_b, 1, bj[..., None].expand(-1, -1, 2))
        return best_j, ok, pb
    return best_j, ok

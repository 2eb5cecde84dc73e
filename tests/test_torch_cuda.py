"""Card-only tests of the port's CUDA kernels; they skip without a card.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed. tests/conftest.py imports JAX, so there run it
without the conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Each kernel is held against its plain PyTorch version on the same card.
On integer-valued descriptors K1 (every mode) and K3 are integer
arithmetic in f32 or int32 (on the tensor cores too, f32 as three bf16
planes, bf16 and f32 at 256 values a row on their wgmma body at that
body's tile edges and on the mma.sync bodies it replaced; on random bf16
and f32 they hold a stated tolerance), K2 (at
every radius, and its first body) rounds the same f32 products and sums
one by one, and K4 decodes, compares and gathers exactly, so the
comparisons are bit-exact. So are the f32 modes' split pre-pass and the
probes of imageanalysis_tpu_torch/probes on integer-valued inputs (the
staged K1, the FFMA bf16 and f32 and __dp4a int8 bodies, the tensor-core
body's product-only stage and its row minimum at every tile of P6's
sweep, P3's and P4's stages on it, P2's single-launch K1 + K4, P5's
wgmma row sums and their mma.sync first body, P1's one-hot gather of bf16
values and its first body). Bundle adjustment
on the card is held against the CPU within a stated tolerance (atomic
sums). nvJPEG's gray decode is held against PIL's on the JPEGs of
tests/data/jpeg/ within a stated tolerance, and the pipeline runs Steps
1→5 from JPEGs written on the card. EXIF written on the card reads back;
the geotiff warp of one frame equals the CPU's bit for bit, and the
fundamental and essential RANSAC on the card hold the CPU's results
within a stated tolerance. The point-local sharded BA on a mesh of the
card's shards and over a process group of one rank on NCCL holds
bundle.solve's result within tests/test_parallel.py's tolerances; two
ranks sharing the card get gloo, and NCCL forced on them raises. The
store's four modes (int8, uint8, float32 with bf16 on and off) give the
CPU's match lists on the card; the explorer's full-resolution warp, the
zooniverse paste's batched rays and preview-crops' projection hold the
CPU's results within stated tolerances.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from imageanalysis_tpu_torch import _build
from imageanalysis_tpu_torch.features import sift
from imageanalysis_tpu_torch.match import matcher
from imageanalysis_tpu_torch.ops import knn
from imageanalysis_tpu_torch.probes import (blur, device_kernels, fused,
                                            knn_stages, mma)

pytestmark = pytest.mark.cuda

# the initial blur and the five per-level increments of the pyramid
_SIGMAS = [(1.6**2 - 1.0) ** 0.5] + [
    1.6 * 2 ** ((i - 1) / 3) * (2 ** (2 / 3) - 1) ** 0.5 for i in range(1, 6)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def _planted(rng, pairs, n_a, n_b, n_planted, dup=False):
    """int8 rows (value − 128 of 0..99), B's first n_planted rows near A's.
    dup: every odd row of A and of B repeats the row before it, so rows,
    columns and both top-2 slots tie on d2 (the lowest index must win)."""
    a = rng.integers(0, 100, (pairs, n_a, 128))
    b = rng.integers(0, 100, (pairs, n_b, 128))
    b[:, :n_planted] = np.clip(
        a[:, :n_planted] + rng.integers(-4, 5, (pairs, n_planted, 128)), 0,
        255)
    if dup:
        a[:, 1::2] = a[:, ::2]
        b[:, 1::2] = b[:, ::2]
    return (torch.from_numpy((a - 128).astype(np.int8)),
            torch.from_numpy((b - 128).astype(np.int8)))


def _full_range(rng, pairs, n_a, n_b, n_planted):
    """int8 rows over the whole −128..127 (SIFT values 0..255 − 128), B's
    first n_planted rows near A's; A rows 1 and 2 all −128 and all 127, B
    rows 3 and 4 too, so the largest d2 (128·255²) and the extreme norms
    occur."""
    a = rng.integers(0, 256, (pairs, n_a, 128))
    b = rng.integers(0, 256, (pairs, n_b, 128))
    b[:, :n_planted] = np.clip(
        a[:, :n_planted] + rng.integers(-4, 5, (pairs, n_planted, 128)), 0,
        255)
    a[:, 1], a[:, 2] = 0, 255
    b[:, 3], b[:, 4] = 0, 255
    return (torch.from_numpy((a - 128).astype(np.int8)),
            torch.from_numpy((b - 128).astype(np.int8)))


# (n_a, n_b, dup) of K1's card cases: 64-row and 192-row A (the
# tensor-core body's 64-row blocks), n_b = 8192, a last B tile of 64 rows
# (704), duplicate rows
_K1_CASES = {"512x768": (512, 768, False), "64x8192": (64, 8192, False),
             "192x704": (192, 704, False), "dup": (256, 704, True)}


@pytest.mark.parametrize("case", list(_K1_CASES) + ["full_range"])
def test_k1_bit_exact_vs_plain(cuda, rng, case):
    if case == "full_range":
        a, b = _full_range(rng, 3, 192, 704, 50)
    else:
        n_a, n_b, dup = _K1_CASES[case]
        a, b = _planted(rng, 3, n_a, n_b, 50, dup)
    a, b = a.to(cuda), b.to(cuda)
    before = knn.LAUNCHES["knn_packed_i8"]
    got = knn.knn_packed_raw(a, b)
    assert knn.LAUNCHES["knn_packed_i8"] == before + 1
    want = knn.knn_packed_plain(a, b)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert torch.equal(g, w)


def test_k1_refuses_what_it_does_not_take(cuda):
    f = torch.zeros((1, 64, 128), device=cuda)
    with pytest.raises(ValueError):               # float without its norms
        knn.knn_packed_raw(f, f)
    odd = torch.zeros((1, 100, 128), dtype=torch.int8, device=cuda)
    before = dict(knn.LAUNCHES)
    with pytest.raises(ValueError):               # not a multiple of 64
        knn.knn_packed_raw(odd, odd)
    with pytest.raises(ValueError):               # CPU and CUDA mixed
        knn.knn_packed_raw(odd[:, :64], odd[:, :64].cpu())
    big = torch.zeros((1, 8192 + 64, 128), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):               # beyond 13 index bits
        knn.knn_packed_raw(big, big)
    assert knn.LAUNCHES == before


def _float_inputs(a, b, dtype):
    """int8 store rows → integer-valued 0..255 descriptors cast to the
    mode's dtype, with the f32 squared norms of the unrounded values."""
    af = a.float() + 128.0
    bf = b.float() + 128.0
    return (af.to(dtype), bf.to(dtype), (af * af).sum(-1),
            (bf * bf).sum(-1))


def _gate(rng, cuda, pairs, n_a, n_b, on_radius=False):
    """uv_a and a prediction that lands ~half the candidates inside a
    200 px gate. on_radius: integer positions, and B row j < n_a/2 sits
    exactly on the gate's radius from A row j (dx, dy = 120, 160: the
    distance² is 40000 = radius² in f32), which the gate keeps."""
    uv_a = rng.uniform(0, 1000, (pairs, n_a, 2))
    pred = rng.uniform(0, 1000, (pairs, n_b, 2))
    if on_radius:
        uv_a, pred = np.round(uv_a), np.round(pred)
        m = min(n_a, n_b) // 2
        pred[:, :m] = uv_a[:, :m] + np.array([120.0, 160.0])
    return (torch.from_numpy(uv_a.astype(np.float32)).to(cuda),
            torch.from_numpy(pred.astype(np.float32)).to(cuda), 200.0 ** 2)


_K3_CASES = {"256x8448": (2, 256, 8448, False),
             "8256": (2, 8256, 8256, False), "dup": (2, 192, 8256, True)}


@pytest.mark.parametrize("case", list(_K1_CASES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_k1_float_modes_bit_exact_vs_plain(cuda, rng, dtype, case):
    n_a, n_b, dup = _K1_CASES[case]
    a, b = (t.to(cuda) for t in _planted(rng, 3, n_a, n_b, 50, dup))
    args = _float_inputs(a, b, dtype)
    key = "knn_packed_bf16" if dtype == torch.bfloat16 else "knn_packed_f32"
    before = knn.LAUNCHES[key]
    got = knn.knn_packed_raw(*args)
    assert knn.LAUNCHES[key] == before + 1
    want = knn.knn_packed_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", ["512x768", "192x704_dup_on_radius"])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16,
                                   torch.float32],
                         ids=["int8", "bf16", "f32"])
def test_k1_gated_bit_exact_vs_plain(cuda, rng, dtype, case):
    n_a, n_b, edge = (512, 768, False) if case == "512x768" else \
        (192, 704, True)
    a, b = (t.to(cuda) for t in _planted(rng, 3, n_a, n_b, 50, edge))
    args = (a, b, None, None) if dtype == torch.int8 else \
        _float_inputs(a, b, dtype)
    gate = _gate(rng, cuda, 3, n_a, n_b, on_radius=edge)
    before = knn.LAUNCHES["knn_packed_gated"]
    got = knn.knn_packed_raw(*args, *gate)
    assert knn.LAUNCHES["knn_packed_gated"] == before + 1
    want = knn.knn_packed_plain(*args, *gate)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the gate is on: it moves the result away from the ungated one
    assert not torch.equal(got[0], knn.knn_packed_raw(*args)[0])


@pytest.mark.parametrize("case", list(_K3_CASES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_k3_bit_exact_vs_plain(cuda, rng, dtype, case):
    pairs, n_a, n_b, dup = _K3_CASES[case]
    a, b = (t.to(cuda) for t in _planted(rng, pairs, n_a, n_b, 100, dup))
    args = _float_inputs(a, b, dtype)
    key = "knn_wide" if dtype == torch.bfloat16 else "knn_wide_f32"
    before = knn.LAUNCHES[key]
    got = knn.knn_wide_raw(*args)
    assert knn.LAUNCHES[key] == before + 1
    want = knn.knn_wide_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# random bf16 descriptors: the tensor cores sum each dot's 128 products in
# another order (and with other internal rounding) than cuBLAS's f32 product
# in the plain version; both f32 dots lie within 128·2⁻²⁴ of Σ|a_k b_k| ≤
# (|a|² + |b|²)/2, so d2 values agree within 2⁻¹⁶ (max |a|² + max |b|²),
# plus, for K1's packed keys, one step of their 10 mantissa bits
_TC_REL = 2.0 ** -16


def _exact_d2(x, y, i, j):
    """f64 squared distances of rows x[i] and y[j] (index tensors)."""
    return ((x[i.long()].double() - y[j.long()].double()) ** 2).sum(-1)


def _near(got, want, x, y, tol, packed, name):
    """Row keys (B, n, 2) or column keys (B, m) of a kernel against its
    plain version on rows x (the keys' side) and candidates y: decoded
    values within tol (+ a key's truncation for packed), indices different
    only where their exact d2 tie within twice that; gated-out keys equal.
    Returns the largest value difference."""
    if packed:
        gv, gi, wv, wi = (*knn._decode_packed(got, got)[:2],
                          *knn._decode_packed(want, want)[:2])
        gated = (want & ~knn._IDX_MASK) == knn._GATED_BITS
        assert torch.equal(got[gated], want[gated]), name
    else:
        gv, gi = knn._decode_wide(got)
        wv, wi = knn._decode_wide(want)
        gated = torch.zeros_like(want, dtype=torch.bool)
    lim = tol + (2.0 ** -10 * wv.abs() if packed else torch.zeros_like(wv))
    err = (gv - wv).abs().masked_fill(gated, 0.0)
    assert bool(((err <= lim) | gated).all()), (name, float(err.max()))
    for p in range(got.shape[0]):
        rows = torch.arange(got.shape[1], device=got.device)
        if got.dim() == 3:
            rows = rows[:, None].expand(-1, 2)
        bad = (gi[p] != wi[p]) & ~gated[p]
        if bool(bad.any()):
            dg = _exact_d2(x[p], y[p], rows[bad], gi[p][bad])
            dw = _exact_d2(x[p], y[p], rows[bad], wi[p][bad])
            assert bool(((dg - dw).abs() <= 2 * lim[p][bad]).all()), name
    return float(err.max())


@pytest.mark.parametrize("mode", ["k1", "k1_gated", "k3"])
def test_bf16_tensor_cores_within_tolerance_on_random(cuda, rng, mode):
    """Non-integer bf16 descriptors: values within the stated tolerance,
    indices different only on ties."""
    pairs, n_a, n_b = 2, 192, 704
    a = torch.from_numpy(rng.normal(0, 0.1, (pairs, n_a, 128))
                         .astype(np.float32)).to(cuda).bfloat16()
    b = torch.from_numpy(rng.normal(0, 0.1, (pairs, n_b, 128))
                         .astype(np.float32)).to(cuda).bfloat16()
    b[:, :64] = (a[:, :64].float() + 0.01).bfloat16()
    na2, nb2 = knn._sq_norms(a), knn._sq_norms(b)
    tol = _TC_REL * float(na2.max() + nb2.max())
    gate = _gate(rng, cuda, pairs, n_a, n_b) if mode == "k1_gated" else ()
    if mode == "k3":
        got = knn.knn_wide_raw(a, b, na2, nb2)
        want = knn.knn_wide_plain(a, b, na2, nb2)
    else:
        got = knn.knn_packed_raw(a, b, na2, nb2, *gate)
        want = knn.knn_packed_plain(a, b, na2, nb2, *gate)
    torch.cuda.synchronize()
    packed = mode != "k3"
    _near(got[0], want[0], a, b, tol, packed, "rows")
    _near(got[1], want[1], b, a, tol, packed, "columns")


# random f32 descriptors on the three-plane split: the dropped plane
# products (mid·lo, lo·mid, lo·lo) are 2⁻²⁴ of Σ|a_k b_k|, and each f32
# sum is rounded in another order than cuBLAS's f32 product; the values
# hold 2⁻²⁰ (max |a|² + max |b|²), chip_smoke.py phase 5's f32 tolerance,
# plus, for the packed keys, one step of their 10 mantissa bits
_F32_REL = 2.0 ** -20


# K1 f32's A rows at 128 values a row: one, three, four and five of the
# wgmma body's 64-row blocks
_K1_F32_NA = [64, 192, 256, 320]


@pytest.mark.parametrize("n_a", _K1_F32_NA)
@pytest.mark.parametrize("mode", ["k1", "k1_gated"])
def test_k1_f32_tensor_cores_within_tolerance_on_random(cuda, rng, mode,
                                                        n_a):
    """Non-integer f32 descriptors (SIFT-like, 0..400) on the wgmma
    body at the A-row counts of _K1_F32_NA: values within the stated
    tolerance, indices different only on ties."""
    pairs, n_b = 2, 704
    a = rng.uniform(0, 400, (pairs, n_a, 128))
    b = rng.uniform(0, 400, (pairs, n_b, 128))
    b[:, :64] = a[:, :64] + rng.normal(0, 2, (pairs, 64, 128))
    a, b = (torch.from_numpy(x.astype(np.float32)).to(cuda) for x in (a, b))
    na2, nb2 = knn._sq_norms(a), knn._sq_norms(b)
    tol = _F32_REL * float(na2.max() + nb2.max())
    gate = _gate(rng, cuda, pairs, n_a, n_b) if mode == "k1_gated" else ()
    key = "knn_packed_gated" if gate else "knn_packed_f32"
    before = knn.LAUNCHES[key]
    got = knn.knn_packed_raw(a, b, na2, nb2, *gate)
    assert knn.LAUNCHES[key] == before + 1
    want = knn.knn_packed_plain(a, b, na2, nb2, *gate)
    torch.cuda.synchronize()
    _near(got[0], want[0], a, b, tol, True, "rows")
    _near(got[1], want[1], b, a, tol, True, "columns")


@pytest.mark.parametrize("n_a", _K1_F32_NA)
@pytest.mark.parametrize("gated", [False, True], ids=["k1", "k1_gated"])
def test_k1_f32_bit_exact_with_mid_planes(cuda, rng, gated, n_a):
    """Integer f32 rows of 261..360: an odd value above 256 is not one
    bf16 value, so the mid planes are set, yet every dot stays below
    128 · 360² < 2²⁴ and is exact; keys equal the plain version's bit for
    bit at the A-row counts of _K1_F32_NA."""
    a, b = (t.to(cuda) for t in _planted(rng, 2, n_a, 704, 50))
    af, bf = (x.float() + 128.0 + 261.0 for x in (a, b))
    assert bool((af != af.bfloat16().float()).any())
    args = (af, bf, (af * af).sum(-1), (bf * bf).sum(-1))
    gate = _gate(rng, cuda, 2, n_a, 704) if gated else ()
    got = knn.knn_packed_raw(*args, *gate)
    want = knn.knn_packed_plain(*args, *gate)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n_a", [192, 256])
@pytest.mark.parametrize("lift", [0, 261], ids=["0_255", "261_360"])
def test_k3_f32_tensor_cores_bit_exact_vs_plain(cuda, rng, lift, n_a):
    """K3 f32 on the tensor cores (three bf16 planes), n_b = 8256 beyond
    K1's 8192: integer rows of 0..255, and of 261..360 where odd values
    set the mid planes (every dot stays below 128 · 360² < 2²⁴, exact),
    with duplicate rows so that values tie and the lowest index must win;
    64-row (n_a 192) and 128-row (n_a 256) A blocks. Keys equal the plain
    version's bit for bit, and the launch counts as K3 f32's."""
    a, b = (t.to(cuda) for t in _planted(rng, 2, n_a, 8256, 100, dup=True))
    af, bf = (x.float() + 128.0 + lift for x in (a, b))
    assert lift == 0 or bool((af != af.bfloat16().float()).any())
    args = (af, bf, (af * af).sum(-1), (bf * bf).sum(-1))
    before = dict(knn.LAUNCHES)
    got = knn.knn_wide_raw(*args)
    assert knn.LAUNCHES["knn_wide_f32"] == before["knn_wide_f32"] + 1
    assert knn.LAUNCHES["knn_wide"] == before["knn_wide"]
    want = knn.knn_wide_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n_a", [192, 256])
def test_k3_f32_tensor_cores_within_tolerance_on_random(cuda, rng, n_a):
    """Non-integer f32 descriptors (SIFT-like, 0..400, some B rows planted
    near A's) on 64-row and 128-row A blocks: values within 2⁻²⁰ of the
    norms, indices different only on ties."""
    pairs, n_b = 2, 8256
    a = rng.uniform(0, 400, (pairs, n_a, 128))
    b = rng.uniform(0, 400, (pairs, n_b, 128))
    b[:, :64] = a[:, :64] + rng.normal(0, 2, (pairs, 64, 128))
    a, b = (torch.from_numpy(x.astype(np.float32)).to(cuda) for x in (a, b))
    na2, nb2 = knn._sq_norms(a), knn._sq_norms(b)
    tol = _F32_REL * float(na2.max() + nb2.max())
    got = knn.knn_wide_raw(a, b, na2, nb2)
    want = knn.knn_wide_plain(a, b, na2, nb2)
    torch.cuda.synchronize()
    _near(got[0], want[0], a, b, tol, False, "rows")
    _near(got[1], want[1], b, a, tol, False, "columns")


def test_split_prepass_reconstructs_exactly(cuda, rng):
    """K1 f32's pre-pass: its planes equal the plain split's bit for bit,
    and hi + mid + lo == x exactly, over normal, uniform and integer
    values (rows of any count)."""
    x = np.concatenate([rng.normal(0, 100, (3, 64, 128)),
                        rng.uniform(0, 512, (3, 64, 128)),
                        rng.integers(0, 256, (3, 64, 128))], axis=1)
    for t in (torch.from_numpy(x.astype(np.float32)),
              torch.from_numpy(rng.normal(0, 1e-3, (5, 128))
                               .astype(np.float32))):
        t = t.to(cuda)
        before = knn.LAUNCHES["split_bf16x3"]
        got = knn.split_bf16x3_raw(t)
        assert knn.LAUNCHES["split_bf16x3"] == before + 1
        assert got.shape == (*t.shape[:-1], 3, 128)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, knn.split_bf16x3_plain(t))
        rec = got.double().sum(-2)
        assert torch.equal(rec, t.double())


@pytest.mark.parametrize("lift", [0, 105], ids=["0_255", "105_360"])
@pytest.mark.parametrize("n_a", [192, 256])
def test_tc_row_sum_f32_bit_exact_vs_plain(cuda, rng, n_a, lift):
    """The tensor-core body's product-only stage on f32 (split into three
    planes), full-range integer values (0..255, or 105..360 where odd
    values above 256 set the mid planes; dots stay exact below 2²⁴):
    64-row and 128-row A blocks, 64-row B tiles."""
    a, b = (t.to(cuda) for t in _full_range(rng, 2, n_a, 704, 50))
    a, b = (x.float() + 128.0 + lift for x in (a, b))
    before = knn_stages.LAUNCHES["knn_tc_row_sum"]
    got = knn_stages.tc_row_sum_raw(a, b)
    assert knn_stages.LAUNCHES["knn_tc_row_sum"] == before + 1
    want = knn_stages.tc_row_sum_plain(a, b)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("mode", ["k1", "k1_gated", "k3", "dp4a",
                                  "dp4a_gated", "f32", "f32_gated",
                                  "k3_f32"])
def test_ffma_yardstick_bit_exact_vs_plain(cuda, rng, mode):
    """The FFMA bf16 and f32 and __dp4a int8 bodies that K1 and K3
    launched before the tensor cores, kept as their yardsticks, still
    equal the plain versions (K3's in its bf16 and f32 modes)."""
    a, b = (t.to(cuda) for t in _planted(rng, 2, 192, 704, 50))
    gate = _gate(rng, cuda, 2, 192, 704) if mode.endswith("gated") else ()
    if mode.startswith("dp4a"):
        key, raw, plain, args, kw = ("knn_dp4a_i8", knn_stages.dp4a_i8_raw,
                                     knn_stages.dp4a_i8_plain, (a, b), {})
    elif "f32" in mode:
        key, raw, plain = ("knn_ffma_f32", knn_stages.ffma_f32_raw,
                           knn_stages.ffma_f32_plain)
        args = _float_inputs(a, b, torch.float32)
        kw = {"wide": mode == "k3_f32"}
    else:
        key, raw, plain = ("knn_ffma_bf16", knn_stages.ffma_bf16_raw,
                           knn_stages.ffma_bf16_plain)
        args, kw = _float_inputs(a, b, torch.bfloat16), {"wide": mode == "k3"}
    before = knn_stages.LAUNCHES[key]
    got = raw(*args, *gate, **kw)
    assert knn_stages.LAUNCHES[key] == before + 1
    want = plain(*args, *gate, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_knn_top2_dispatch_on_card(cuda, rng):
    """≤ 8192 rows take K1, beyond them K3 (int8 cast to bf16); the card's
    decoded result equals the CPU's for the same inputs."""
    a, b = _planted(rng, 1, 256, 8448, 100)
    before = dict(knn.LAUNCHES)
    got = knn.knn_top2(a.to(cuda), b.to(cuda))
    assert knn.LAUNCHES["knn_wide"] == before["knn_wide"] + 1
    for g, w in zip(got, knn.knn_top2(a, b)):
        assert torch.equal(g.cpu(), w)
    knn.knn_top2(a[:, :, :].to(cuda), b[:, :512].to(cuda))
    assert knn.LAUNCHES["knn_packed_i8"] == before["knn_packed_i8"] + 1
    uv = torch.zeros((1, 8448, 2), device=cuda)
    with pytest.raises(NotImplementedError):
        knn.knn_top2(b.to(cuda), b.to(cuda), gate_uv_a=uv, gate_pred_b=uv,
                     gate_radius=5.0)


def test_match_pair_batch_f32_beyond_8192_takes_k3_f32(cuda, rng):
    """f32 matching (bf16=False) of float descriptors beyond 8192 rows
    launches K3 f32, not K3 bf16, and its matches equal the CPU's."""
    a, b = _planted(rng, 1, 256, 8448, 100)
    fa, fb = (x.float() + 128.0 for x in (a, b))
    uv = torch.from_numpy(rng.uniform(0, 4000, (1, 8448, 2))
                          .astype(np.float32))
    b_uv = uv.clone()
    b_uv[:, :100] = uv[:, :100] + torch.tensor([25.0, -40.0])
    n = torch.tensor([256]), torch.tensor([8448])
    pick = torch.from_numpy(rng.integers(0, 100, (1, 512, 4)))
    args = (fa, fb, uv[:, :256].contiguous(), b_uv, *n)
    before = dict(knn.LAUNCHES)
    got = matcher.match_pair_batch(*(x.to(cuda) for x in args), bf16=False,
                                   pick=pick.to(cuda))
    assert knn.LAUNCHES["knn_wide_f32"] == before["knn_wide_f32"] + 1
    assert knn.LAUNCHES["knn_wide"] == before["knn_wide"]
    want = matcher.match_pair_batch(*args, bf16=False, pick=pick,
                                    use_pallas=True)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert int(got[1].sum()) >= 95


def test_match_pair_dense_takes_the_kernels_on_card(cuda, rng):
    """A CUDA tensor never takes the CPU arm: use_pallas=False raises, and
    so does a gate beyond 8192 rows (the CPU arm keeps that gate); the
    kernel arm's result equals the CPU's."""
    a, b = (t.to(cuda) for t in _planted(rng, 1, 256, 8448, 100))
    n = torch.tensor([256]), torch.tensor([8448])
    before = dict(knn.LAUNCHES)
    bj, ok = knn.match_pair_dense(a, b, *n)
    assert knn.LAUNCHES["knn_wide"] == before["knn_wide"] + 1
    want_bj, want_ok = knn.match_pair_dense(a.cpu(), b.cpu(), *n,
                                            use_pallas=True)
    assert torch.equal(bj.cpu(), want_bj) and torch.equal(ok.cpu(), want_ok)
    with pytest.raises(ValueError):
        knn.match_pair_dense(a, b, *n, use_pallas=False)
    uv_a = torch.zeros((1, 256, 2), device=cuda)
    uv_b = torch.zeros((1, 8448, 2), device=cuda)
    with pytest.raises(NotImplementedError):
        knn.match_pair_dense(a, b, *n, gate_uv_a=uv_a, gate_pred_b=uv_b,
                             gate_radius=5.0)


@pytest.mark.parametrize("shape", [(3, 97, 130), (2, 64, 2000)])
def test_k2_bit_exact_vs_plain(cuda, rng, shape):
    img = torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32))
    img = img.to(cuda)
    before = sift.BLUR_LAUNCHES
    for sigma in _SIGMAS:
        got = sift._blur(img, sigma)
        want = sift.blur_plain(img, sift._gauss_kernel(sigma))
        torch.cuda.synchronize()
        assert torch.equal(got, want), sigma
    assert sift.BLUR_LAUNCHES == before + len(_SIGMAS)


def _taps(r):
    """Gaussian taps of radius r (2r + 1 of them), f32 numpy."""
    x = np.arange(-r, r + 1)
    k = np.exp(-0.5 * (x / max(r / 3.0, 0.5)) ** 2)
    return (k / k.sum()).astype(np.float32)


@pytest.mark.parametrize("r", range(1, 16))
def test_k2_bit_exact_vs_plain_at_every_radius(cuda, rng, r):
    """One instantiation per radius: interior tiles (16-byte loads) and
    border tiles, H and W no multiples of the 128 × 64 tile, an odd W
    (reflected scalar loads only), B = 1 and 16, and r = min(H, W) − 1."""
    taps = _taps(r)
    before = sift.BLUR_LAUNCHES
    shapes = ((1, 197, 300), (16, 70, 133), (2, r + 1, 4 * (r + 1)),
              (1, 3 * r + 5, r + 1))
    for shape in shapes:
        img = torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32))
        img = img.to(cuda)
        got = sift.blur_raw(img, taps)
        want = sift.blur_plain(img, taps)
        torch.cuda.synchronize()
        assert torch.equal(got, want), shape
    assert sift.BLUR_LAUNCHES == before + len(shapes)


def test_k2_loop_yardstick_bit_exact_vs_plain(cuda, rng):
    """K2's first body, kept as the yardstick, still equals blur_plain."""
    img = torch.from_numpy(rng.uniform(0, 1, (3, 197, 300))
                           .astype(np.float32)).to(cuda)
    before = blur.LAUNCHES["gauss_blur_loop_f32"]
    for r in (1, 10, 15):
        got = blur.loop_blur_raw(img, _taps(r))
        torch.cuda.synchronize()
        assert torch.equal(got, sift.blur_plain(img, _taps(r))), r
    assert blur.LAUNCHES["gauss_blur_loop_f32"] == before + 3


def test_k2_refuses_what_it_does_not_take(cuda):
    img = torch.zeros((1, 64, 64), device=cuda)
    with pytest.raises(ValueError):               # 33 taps > 31
        sift._blur(img, 5.2)
    with pytest.raises(ValueError):               # not contiguous
        sift._blur(torch.zeros((1, 64, 64), device=cuda).transpose(1, 2),
                   1.6)
    with pytest.raises(ValueError):               # radius ≥ the image
        sift._blur(torch.zeros((1, 8, 64), device=cuda), 3.1)


def test_detect_on_card_matches_cpu(cuda):
    """The whole detector on the card (every blur through K2) against the
    same code on the CPU: near-identical keypoint sets."""
    from imageanalysis_tpu_torch.testing.synthetic import make_mission

    frames = make_mission(strips=1, per_strip=2, size=(320, 256),
                          seed=11, device="cpu").frames
    before = sift.BLUR_LAUNCHES
    on_card = sift.detect_finalize_batch(sift.detect_dispatch(
        frames.to(cuda), max_features=512, equalize=True))
    assert sift.BLUR_LAUNCHES > before
    on_cpu = sift.detect_finalize_batch(sift.detect_dispatch(
        frames, max_features=512, equalize=True))
    for (kp_g, _, _), (kp_c, _, _) in zip(on_card, on_cpu):
        assert abs(len(kp_g) - len(kp_c)) <= 0.02 * len(kp_c)
        d = np.linalg.norm(kp_c[:, None] - kp_g[None], axis=-1).min(1)
        assert (d < 0.05).mean() >= 0.98


def _k1_raw(rng, cuda, pairs, n, gated):
    """K1's raw keys on planted int8 rows (gated: ~half the candidates
    out), and a uv_b table."""
    a, b = (t.to(cuda) for t in _planted(rng, pairs, n, n, n // 4))
    gate = _gate(rng, cuda, pairs, n, n) if gated else ()
    row_p, col_p = knn.knn_packed_raw(a, b, None, None, *gate)
    uv_b = torch.from_numpy(rng.uniform(0, 4000, (pairs, n, 2))
                            .astype(np.float32)).to(cuda)
    return row_p, col_p, uv_b


@pytest.mark.parametrize("gated", [False, True], ids=["int8", "gated"])
def test_k4_bit_exact_vs_plain(cuda, rng, gated):
    row_p, col_p, uv_b = _k1_raw(rng, cuda, 3, 512, gated)
    before = knn.LAUNCHES["match_epilogue"]
    got = knn.match_epilogue_raw(row_p, col_p, uv_b, 0.75)
    assert knn.LAUNCHES["match_epilogue"] == before + 1
    want = knn.match_epilogue_plain(row_p, col_p, uv_b, 0.75)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        assert torch.equal(g, w)
    # ungated, the planted rows pass the ratio and mutual tests; the random
    # gate keeps some
    assert int(got[1].sum()) > (0 if gated else 100)


def test_k4_refuses_what_it_does_not_take(cuda, rng):
    row_p, col_p, uv_b = _k1_raw(rng, cuda, 1, 128, False)
    before = dict(knn.LAUNCHES)
    with pytest.raises(ValueError):               # CPU and CUDA mixed
        knn.match_epilogue_raw(row_p, col_p.cpu(), uv_b)
    with pytest.raises(ValueError):               # int64 keys
        knn.match_epilogue_raw(row_p.long(), col_p, uv_b)
    with pytest.raises(ValueError):               # f64 coordinates
        knn.match_epilogue_raw(row_p, col_p, uv_b.double())
    with pytest.raises(ValueError):               # not contiguous
        knn.match_epilogue_raw(torch.cat([row_p, row_p], -1)[..., ::2],
                               col_p, uv_b)
    assert knn.LAUNCHES == before


def test_fused_arm_on_card_equals_unfused(cuda, rng, monkeypatch):
    """match_pair_dense with IMGTPU_FUSED_EPILOGUE=1 takes K1 then K4 and
    returns the unfused arm's outputs bit for bit."""
    a, b = (t.to(cuda) for t in _planted(rng, 4, 512, 768, 200))
    uv_b = torch.from_numpy(rng.uniform(0, 4000, (4, 768, 2))
                            .astype(np.float32)).to(cuda)
    n = torch.tensor([500, 512, 300, 64]), torch.tensor([768, 700, 512, 64])
    monkeypatch.delenv("IMGTPU_FUSED_EPILOGUE", raising=False)
    want = knn.match_pair_dense(a, b, *n, uv_b=uv_b)
    monkeypatch.setenv("IMGTPU_FUSED_EPILOGUE", "1")
    before = knn.LAUNCHES["match_epilogue"]
    got = knn.match_pair_dense(a, b, *n, uv_b=uv_b)
    assert knn.LAUNCHES["match_epilogue"] == before + 1
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_bundle_solve_on_card_matches_cpu(cuda):
    """The same grid graph solved on the card and on the CPU, f32. The
    card's index_add_ sums with atomics in no fixed order, so the two
    parts in the last bits and, along the weakly constrained gauge, a
    little more: mre within 1%, cost history start within 1e-5."""
    from imageanalysis_tpu_torch.ba import bundle
    from imageanalysis_tpu_torch.testing.synthetic import make_ba_grid_graph

    g = make_ba_grid_graph(n_cam=36, n_pt=1200, device="cpu",
                           dtype=torch.float32)
    cfg = bundle.BAConfig(max_iters=8, ftol=1e-6)
    on_cpu = bundle.solve(g.cams0, g.pts0, g.obs, g.K, g.dist, cfg,
                          verbose=False, device="cpu")
    on_card = bundle.solve(g.cams0, g.pts0, g.obs, g.K, g.dist, cfg,
                           verbose=False, device=cuda)
    np.testing.assert_allclose(on_card.cost_history[0],
                               on_cpu.cost_history[0], rtol=1e-5)
    np.testing.assert_allclose(on_card.mre, on_cpu.mre, rtol=1e-2)
    assert abs(on_card.iters - on_cpu.iters) <= 1
    assert np.isfinite(on_card.pts).all() and on_card.mre < 0.5


def _probe_inputs(rng, cuda, dtype):
    a, b = (t.to(cuda) for t in _planted(rng, 3, 256, 512, 64))
    return (a, b, None, None) if dtype == torch.int8 else \
        _float_inputs(a, b, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16],
                         ids=["int8", "bf16"])
def test_knn_probe_stages_bit_exact_vs_plain(cuda, rng, dtype):
    """Every stage at K1's tile and the row minimum at every tile; the
    tensor-core body's product-only stage against the row-sum stage's
    plain version, on full tiles and on 64-row A blocks with a last B
    tile of 64 rows."""
    args = _probe_inputs(rng, cuda, dtype)
    cases = [(s, knn_stages.K1_TILE) for s in range(len(knn_stages.STAGES))]
    cases += [(knn_stages.ROW_MIN, t) for t in knn_stages.TILES[dtype]]
    key = "knn_probe_i8" if dtype == torch.int8 else "knn_probe_bf16"
    before = knn_stages.LAUNCHES[key]
    for stage, tile in cases:
        got = knn_stages.knn_probe_raw(*args, stage=stage, tile=tile)
        want = knn_stages.knn_probe_plain(*args, stage=stage, tile=tile)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), (stage, tile)
    assert knn_stages.LAUNCHES[key] == before + len(cases)
    a, b = (t.to(cuda) for t in _full_range(rng, 2, 192, 704, 50))
    if dtype == torch.bfloat16:
        a, b = (x.float() + 128.0 for x in (a, b))
    before = knn_stages.LAUNCHES["knn_tc_row_sum"]
    for x, y in ((args[0], args[1]), (a.to(dtype), b.to(dtype))):
        got = knn_stages.tc_row_sum_raw(x, y)
        want = knn_stages.knn_probe_plain(x, y, stage=knn_stages.ROW_SUM)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), x.shape
    assert knn_stages.LAUNCHES["knn_tc_row_sum"] == before + 2


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16],
                         ids=["int8", "bf16"])
def test_tc_row_min_bit_exact_vs_plain_at_every_tile(cuda, rng, dtype):
    """P6 on the tensor-core body at every tile of its sweep (64- to
    256-row A blocks, 64- and 128-row B tiles, rings of 2 and 3), on full
    range integer rows with n_b an odd multiple of 64 (a last B tile of 64
    rows at BN = 128): row minima equal the plain version's, and the old
    row_min stage's, bit for bit."""
    a, b = (t.to(cuda) for t in _full_range(rng, 2, 512, 704, 50))
    if dtype == torch.bfloat16:
        a, b = ((x.float() + 128.0).bfloat16() for x in (a, b))
    want = knn_stages.tc_row_min_plain(a, b)
    old = knn_stages.knn_probe_plain(a, b, stage=knn_stages.ROW_MIN)
    assert all(torch.equal(w, o) for w, o in zip(want, old))
    before = knn_stages.LAUNCHES["knn_tc_row_min"]
    for tile in knn_stages.TC_TILES:
        got = knn_stages.tc_row_min_raw(a, b, tile)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), tile
        assert knn_stages.tc_row_min_blocks(dtype, tile) >= 1
    assert knn_stages.LAUNCHES["knn_tc_row_min"] == before + len(
        knn_stages.TC_TILES)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16],
                         ids=["int8", "bf16"])
def test_knn_probe_full_stage_is_k1(cuda, rng, dtype):
    args = _probe_inputs(rng, cuda, dtype)
    got = knn_stages.knn_probe_raw(*args)
    want = knn.knn_packed_raw(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _fused_twice(a, b, uv_b, variant, body):
    """P2 (variant, body) against K1 then K4, twice in a row: equal each
    time, the pairs' completion counters back at 0 after each launch, one
    launch counted a call on the body's count. Returns K1 then K4's ok."""
    want = knn.knn_match_fused(a, b, uv_b, 0.75)
    count = fused.BODIES[body][1]
    before = fused.LAUNCHES[count]
    c_bj, c_ok, c_pb = fused.COMPARED[variant]
    for _ in range(2):
        got = fused.fused_probe_raw(a, b, uv_b, variant, body)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1].bool(), want[1])
        if c_pb:
            assert torch.equal(got[2], want[2])
        counter = fused._COUNTERS[(a.device, a.shape[0])]
        assert int(counter.abs().sum()) == 0
    assert fused.LAUNCHES[count] == before + 2
    return want[1]


@pytest.mark.parametrize("dup", [False, True], ids=["planted", "dup"])
@pytest.mark.parametrize("body", list(fused.BODIES))
@pytest.mark.parametrize("variant", ["full", "nopb", "epi32", "t64"])
def test_fused_probe_equals_knn_match_fused(cuda, rng, variant, body, dup):
    """P2's single launch on either body against K1 then K4, twice in a
    row (the completion counters reset themselves). dup: every odd row of
    A repeats the row before it (columns tie: the lower row keeps the
    mutual match) and so does every odd B row beyond the planted ones
    (rows tie on both top-2 slots); ties must fall to the lowest index."""
    a, b = _planted(rng, 3, 512, 512, 128)
    if dup:
        a[:, 1::2] = a[:, ::2]
        b[:, 129::2] = b[:, 128::2]
    a, b = a.to(cuda), b.to(cuda)
    uv_b = torch.from_numpy(rng.uniform(0, 4000, (3, 512, 2))
                            .astype(np.float32)).to(cuda)
    ok = _fused_twice(a, b, uv_b, variant, body)
    assert int(ok.sum()) > (100 if dup else 300)


@pytest.mark.parametrize("body", list(fused.BODIES))
def test_fused_probe_t64_with_a_half_last_b_tile(cuda, rng, body):
    """t64 at n = 576, an odd multiple of 64: the tensor-core body's last
    B tile of 128 rows holds 64, so its keys and pb must skip the stale
    rows behind them."""
    a, b = (t.to(cuda) for t in _planted(rng, 2, 576, 576, 96))
    uv_b = torch.from_numpy(rng.uniform(0, 4000, (2, 576, 2))
                            .astype(np.float32)).to(cuda)
    ok = _fused_twice(a, b, uv_b, "t64", body)
    assert int(ok[:, :96].sum()) > 150


def test_fused_probe_tc_sass_is_imma(cuda):
    """P2's tensor-core instantiations (kFused, mode 16 and its flags)
    run the product as IMMA (mma.sync s8), not as the old body's __dp4a
    (IDP.4A, counted as IDP), which the old body's kernels show."""
    per_key = _build.tc_kernel_usage({
        name: _build.opcode_counts(lines)
        for name, lines in _build.sass().items()})
    keys = {k for k in per_key if k.startswith("int8 ")
            and 16 <= int(k.split()[1]) < 32}
    assert keys == {"int8 16 128 128 2", "int8 17 128 128 2",
                    "int8 18 128 128 2", "int8 20 128 128 2",
                    "int8 24 128 128 2", "int8 16 64 128 2"}, keys
    for k in keys:
        c = per_key[k]
        assert c["IDP"] == 0, (k, c)
        assert c["IMMA"] > 0 or k == "int8 20 128 128 2", (k, c)
    old = [_build.opcode_counts(lines) for name, lines in
           _build.sass().items() if "knn_fused_probe_kernel" in name]
    assert old and any(c["IDP"] > 0 for c in old)


def test_mm_rowsum_bit_exact_on_integers(cuda):
    """The first body (mm_rowsum_v0_raw), the wgmma kernel's yardstick:
    integer values in [-2, 2], every sum below 2^24 is exact in any
    order, at every tile and split; normal values within 1e-5 of the
    largest sum."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    before = mma.LAUNCHES["mm_rowsum_v0"]
    n = 0
    for K in mma.K_SWEEP:
        x = torch.randint(-2, 3, (2, 256, K), generator=gen,
                          device=cuda).bfloat16()
        y = torch.randint(-2, 3, (2, 512, K), generator=gen,
                          device=cuda).bfloat16()
        want = mma.mm_rowsum_plain(x, y)
        for tile in mma.V0_TILES:
            for split in (1, 3):
                got = mma.mm_rowsum_v0_raw(x, y, tile, split)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (K, tile, split)
                n += 1
    x = torch.randn((1, 512, 128), generator=gen, device=cuda).bfloat16()
    y = torch.randn((1, 1024, 128), generator=gen, device=cuda).bfloat16()
    want = mma.mm_rowsum_plain(x, y)
    got = mma.mm_rowsum_v0_raw(x, y)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert mma.LAUNCHES["mm_rowsum_v0"] == before + n + 1


def test_mm_rowsum_wgmma_bit_exact_on_integers(cuda):
    """The wgmma kernel (mm_rowsum_raw): first one small matrix (1 x 256 x
    256 x 64: one block, one chunk); then integer values in [-2, 2] at
    every K of the sweep and K = 192 (three chunks; K = 512 takes two or
    three passes of A at BM = 256), every tile and splits 1, 2 and 4 (N =
    1024: 4 to 16 B tiles), every sum below 2^24, so exact in any order;
    normal values within 1e-5 of the largest sum at bench's K; one launch
    counted a call; one block an SM and a ring of at least 4 stages at
    every tile."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    before = mma.LAUNCHES["mm_rowsum_wg"]
    x = torch.randint(-2, 3, (1, 256, 64), generator=gen,
                      device=cuda).bfloat16()
    got = mma.mm_rowsum_raw(x, x, (256, 64), 1)
    torch.cuda.synchronize()
    assert torch.equal(got, mma.mm_rowsum_plain(x, x))
    n = 1
    for K in (*mma.K_SWEEP, 192):
        x = torch.randint(-2, 3, (2, 512, K), generator=gen,
                          device=cuda).bfloat16()
        y = torch.randint(-2, 3, (2, 1024, K), generator=gen,
                          device=cuda).bfloat16()
        want = mma.mm_rowsum_plain(x, y)
        for tile in mma.TILES:
            for split in (1, 2, 4):
                got = mma.mm_rowsum_raw(x, y, tile, split)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (K, tile, split)
                n += 1
    x = torch.randn((2, 512, 128), generator=gen, device=cuda).bfloat16()
    y = torch.randn((2, 1024, 128), generator=gen, device=cuda).bfloat16()
    want = mma.mm_rowsum_plain(x, y)
    for tile in mma.TILES:
        got = mma.mm_rowsum_raw(x, y, tile)
        assert float((got - want).abs().max()) <= \
            1e-5 * float(want.abs().max()), tile
        n += 1
    assert mma.LAUNCHES["mm_rowsum_wg"] == before + n
    for tile in mma.TILES:
        plan = mma.wg_plan(tile, 512)
        assert plan["blocks_per_sm"] == 1 and plan["stages"] >= 4, plan


def test_mm_rowsum_wgmma_sass_is_hgmma_and_tma(cuda):
    """Every instantiation of the wgmma kernel runs its products as HGMMA
    (no mma.sync HMMA) and loads by TMA (UTMALDG), with mbarrier (SYNCS)
    and warpgroup (WARPGROUP) instructions; the first body is HMMA."""
    seen = 0
    for name, lines in _build.sass().items():
        c = _build.opcode_counts(lines)
        if "mm_rowsum_wg_kernel" in name:
            assert c["HGMMA"] > 0 and c["UTMALDG"] > 0 and c["HMMA"] == 0, (
                name, c)
            assert c["SYNCS"] > 0 and c["WARPGROUP"] > 0, (name, c)
            seen += 1
        elif "mm_rowsum_kernel" in name:
            assert c["HMMA"] > 0 and c["HGMMA"] == 0, (name, c)
    assert seen == len(mma.TILES)


@pytest.mark.parametrize("T,N", [(16, 1024), (128, 1024), (16, 6144),
                                 (128, 6144)])
def test_onehot_gather_bit_exact_vs_bf16_plain(cuda, rng, T, N):
    """The one-launch kernel (f32 vals rounded in registers) and the v0
    yardstick both equal the bf16 plain version: on limbs with lo not
    bf16-exact, and on values whose f32 → bf16 rounding is a tie (low 16
    bits 0x8000, both parities of the bit kept), which nearest even
    settles."""
    u = torch.from_numpy(rng.uniform(0, 4100, N).astype(np.float32))
    vals = mma.limbs(u.to(cuda))
    vals[2] += 1e-3                 # lo no longer bf16-exact
    ties = (vals.view(torch.int32) & ~0xFFFF) | 0x8000
    vals[:, ::2] = ties[:, ::2].view(torch.float32)
    assert (ties[:, ::2] & 0x10000).any() and not (
        ties[:, ::2] & 0x10000).all()
    j = torch.from_numpy(rng.integers(0, N, T).astype(np.int32)).to(cuda)
    j[0], j[1] = 0, N - 1
    want = mma.onehot_gather_plain(j, vals, "bf16")
    for gather, key in ((mma.onehot_gather_raw, "onehot_gather"),
                        (mma.onehot_gather_v0_raw, "onehot_gather_v0")):
        before = dict(mma.LAUNCHES)
        got = gather(j, vals)
        torch.cuda.synchronize()
        assert mma.LAUNCHES == dict(before, **{key: before[key] + 1})
        assert torch.equal(got, want), key
        with pytest.raises(ValueError, match="bf16"):
            gather(j, vals, "f32")
    exact = mma.onehot_gather_plain(j, vals, "f32")
    odd = j % 2 == 1                # not ties: hi and mid are bf16-exact
    assert torch.equal(got[odd, :2], exact[odd, :2])
    assert not torch.equal(got[:, 2], exact[:, 2])
    # one kernel a call: the profiler sees onehot_gather_kernel alone
    names = list(device_kernels(lambda: mma.onehot_gather_raw(j, vals)))
    assert len(names) == 1 and "onehot_gather_kernel" in names[0], names


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16],
                         ids=["int8", "bf16"])
def test_p4_tensor_core_route_equals_old_route(cuda, rng, dtype):
    """P4's four stages on the tensor-core body (p4_stage_raw, body "tc":
    tc_row_sum and tc_stage) equal the old bodies' (body "old") and
    their plain versions on integer rows, and stage 3 equals K1
    (knn_packed_raw); one tensor-core launch counted a stage."""
    a, b = (t.to(cuda) for t in _planted(rng, 3, 256, 704, 64, True))
    args = (a, b, None, None) if dtype == torch.int8 else \
        _float_inputs(a, b, torch.bfloat16)
    keys = ("knn_tc_row_sum", "knn_tc_stage")
    before = {k: knn_stages.LAUNCHES[k] for k in keys}
    for stage in knn_stages.P4_TC_STAGES:
        got = knn_stages.p4_stage_raw(*args, stage=stage)
        old = knn_stages.p4_stage_raw(*args, stage=stage, body="old")
        want = knn_stages.p4_stage_plain(*args, stage=stage)
        torch.cuda.synchronize()
        for g, o, w in zip(got, old, want):
            assert torch.equal(g, o) and torch.equal(g, w), stage
    k1 = knn.knn_packed_raw(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, k1))
    assert {k: knn_stages.LAUNCHES[k] - before[k] for k in keys} == {
        "knn_tc_row_sum": 1, "knn_tc_stage": 3}


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16],
                         ids=["int8", "bf16"])
def test_tc_stages_bit_exact_vs_plain(cuda, rng, dtype):
    """P3's stages on the tensor-core body (tc_stage_raw, K1's tile)
    equal tc_stage_plain for every stage: n_b = 704, an odd multiple of
    64, so top2_tile is the top-2 of the last, half-full, 128-row tile;
    duplicate rows, so the lowest index wins every tie; full equals K1
    (knn_packed_raw); one launch counted a call."""
    before = knn_stages.LAUNCHES["knn_tc_stage"]
    n = 0
    for dup in (False, True):
        a, b = (t.to(cuda) for t in _planted(rng, 2, 256, 704, 64, dup))
        args = (a, b, None, None) if dtype == torch.int8 else \
            _float_inputs(a, b, torch.bfloat16)
        for stage in knn_stages.P3_VARIANTS.values():
            got = knn_stages.tc_stage_raw(*args, stage=stage)
            want = knn_stages.tc_stage_plain(*args, stage=stage)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w), (dup, knn_stages.STAGES[stage])
            n += 1
        # the last tile's top-2 is K1's on B rows 640..703 alone
        tail = knn_stages.tc_stage_raw(*args, stage=knn_stages.TOP2_TILE)
        cut = (args[1][:, 640:].contiguous(), args[2],
               None if args[3] is None else args[3][:, 640:].contiguous())
        assert torch.equal(tail[0],
                           knn.knn_packed_raw(args[0], *cut)[0] + 640)
        got = knn_stages.tc_stage_raw(*args)
        want = knn.knn_packed_raw(*args)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        n += 2
    assert knn_stages.LAUNCHES["knn_tc_stage"] == before + n


def test_probes_refuse_what_they_do_not_take(cuda):
    a = torch.zeros((1, 128, 128), dtype=torch.int8, device=cuda)
    before = (dict(knn_stages.LAUNCHES), dict(mma.LAUNCHES),
              dict(fused.LAUNCHES))
    with pytest.raises(ValueError):               # no such tile for top1
        knn_stages.knn_probe_raw(a, a, stage=knn_stages.TOP1, tile=(32, 32))
    with pytest.raises(ValueError):               # CPU and CUDA mixed
        knn_stages.knn_probe_raw(a, a.cpu())
    with pytest.raises(ValueError):               # bf16 into the int8 body
        knn_stages.dp4a_i8_raw(a.bfloat16(), a.bfloat16())
    with pytest.raises(ValueError):               # not a multiple of 64
        knn_stages.tc_row_sum_raw(a[:, :100].contiguous(), a)
    with pytest.raises(ValueError):               # a tile off the sweep
        knn_stages.tc_row_min_raw(a, a, (128, 128, 4))
    with pytest.raises(ValueError):               # n_a not a multiple of BM
        knn_stages.tc_row_min_raw(a, a, (256, 64, 2))
    with pytest.raises(ValueError):               # n_a not a multiple of 128
        knn_stages.tc_stage_raw(a[:, :64].contiguous(), a)
    with pytest.raises(ValueError):               # j int64 on the card
        mma.onehot_gather_raw(torch.zeros(16, dtype=torch.int64,
                                          device=cuda),
                              torch.zeros((3, 64), device=cuda))
    with pytest.raises(ValueError):               # K not a multiple of 64
        x = torch.zeros((1, 128, 96), dtype=torch.bfloat16, device=cuda)
        mma.mm_rowsum_raw(x, x)
    with pytest.raises(ValueError):               # n not a multiple of 128
        fused.fused_probe_raw(a[:, :64], a[:, :64],
                              torch.zeros((1, 64, 2), device=cuda))
    with pytest.raises(ValueError):               # no such body
        fused.fused_probe_raw(a, a, torch.zeros((1, 128, 2), device=cuda),
                              body="dp4a")
    assert (dict(knn_stages.LAUNCHES), dict(mma.LAUNCHES),
            dict(fused.LAUNCHES)) == before


# --- nvJPEG (io/jpeg.py) and the pipeline from JPEGs ----------------------

_JPEG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                         "jpeg")
# nvJPEG's luma against PIL's (libjpeg's) on the fixture: the two IDCTs
# round differently; at scale 0.4 a box mean stands in for libjpeg's
# DCT-domain reduction before the same resize
GRAY_MAX_ERR, GRAY_MEAN_ERR = 4, 1.0


@pytest.mark.parametrize("name", ["colour", "gray"])
def test_nvjpeg_gray_matches_pil(cuda, name):
    from imageanalysis_tpu_torch.features.detect import load_scaled_gray
    from imageanalysis_tpu_torch.io import jpeg

    want = np.load(os.path.join(_JPEG_DIR, "gray.npz"))
    path = os.path.join(_JPEG_DIR, f"{name}.jpg")
    full = jpeg.decode_gray(path, cuda)
    scaled, size = load_scaled_gray(path, 0.4, cuda)
    assert size == (full.shape[1], full.shape[0])
    for got, key in ((full, "1.0"), (scaled, "0.4")):
        w = want[f"{name}_{key}"]
        assert got.device.type == "cuda" and tuple(got.shape) == w.shape
        err = np.abs(got.cpu().numpy().astype(int) - w)
        assert err.max() <= GRAY_MAX_ERR, (key, err.max())
        assert err.mean() <= GRAY_MEAN_ERR, (key, err.mean())


def test_nvjpeg_roundtrip_psnr(cuda, tmp_path):
    from imageanalysis_tpu_torch.io import jpeg

    bgr = jpeg.decode_bgr(os.path.join(_JPEG_DIR, "colour.jpg"), cuda)
    assert bgr.shape == (298, 402, 3) and bgr.dtype == torch.uint8
    path = str(tmp_path / "again.jpg")
    jpeg.encode_bgr(bgr, path)
    back = jpeg.decode_bgr(path, cuda)
    mse = ((back.float() - bgr.float()) ** 2).mean().item()
    assert 10 * np.log10(255.0 ** 2 / mse) >= 40.0
    half = jpeg.decode_bgr(path, cuda, reduce=2)
    assert half.shape == (149, 201, 3)
    # a one-channel JPEG decodes to B = G = R
    g = jpeg.decode_bgr(os.path.join(_JPEG_DIR, "gray.jpg"), cuda)
    assert g.shape == (299, 401, 3)
    assert torch.equal(g[..., 0], g[..., 2])


def test_process_main_on_card(cuda, tmp_path, capsys):
    """Steps 1→5 from a folder of four JPEGs written by nvJPEG."""
    from imageanalysis_tpu_torch.apps import process
    from imageanalysis_tpu_torch.io import jpeg
    from imageanalysis_tpu_torch.testing.synthetic import (
        CAMERA_KEY, make_mission, write_mission)

    m = make_mission(strips=2, per_strip=2, size=(640, 480), strip_gap=1.5,
                     seed=3, device=cuda)
    proj_dir, db = str(tmp_path / "mission"), str(tmp_path / "db")
    write_mission(proj_dir, m, db)
    argv = [proj_dir, "--camera", CAMERA_KEY, "--camera-db", db,
            "--scale", "1.0", "--ground", "0.0", "--batch-size", "4",
            "--min-chain-len", "2", "--detector", "TPU",
            "--max-features", "2048"]
    before = sift.BLUR_LAUNCHES
    assert process.main(argv) == 0
    assert sift.BLUR_LAUNCHES > before
    ia = os.path.join(proj_dir, "ImageAnalysis")
    assert os.path.isfile(os.path.join(ia, "state", "STEP5"))
    models = os.path.join(ia, "models")
    texs = sorted(f for f in os.listdir(models) if f.endswith(".JPG"))
    assert len(texs) == 4
    tex = jpeg.decode_bgr(os.path.join(models, texs[0]), cuda)
    assert tex.shape == (512, 512, 3)
    for f in ("surface.bin", "dummy.jpg", "surface-global.ac", "direct.ac"):
        assert os.path.isfile(os.path.join(models, f)), f
    capsys.readouterr()
    assert process.main(argv) == 0                # resume: every stage done
    assert "Step " not in capsys.readouterr().out
    assert not {"PIL", "cv2"} & set(sys.modules)  # the card path needs neither


# --- the rest of apps/process.py: EXIF, the geotiff warp, F and E ---------

def test_exif_round_trip_on_card(cuda, tmp_path):
    """Frames encoded by nvJPEG and tagged by io/exif's writer read back
    through its reader, make_pix4d and estimate_from_exif: the mission's
    camera key and focal length, its positions within DMS's 1e-4
    arcsecond and 0.01 m, its attitude within 0.005°; PIL and cv2 stay
    unimported."""
    from imageanalysis_tpu_torch.core import geodesy
    from imageanalysis_tpu_torch.io import camera_db, exif, pose
    from imageanalysis_tpu_torch.testing.synthetic import (
        CAMERA_KEY, REF_LLA, make_mission, write_mission)

    m = make_mission(strips=1, per_strip=3, size=(640, 480), seed=4,
                     device=cuda)
    d = str(tmp_path / "m")
    paths = write_mission(d, m, str(tmp_path / "db"), exif=True)
    assert exif.get_camera_info(paths[0])[0] == CAMERA_KEY
    assert camera_db.estimate_from_exif(paths[0])["K"][0] == \
        pytest.approx(m.K[0, 0], rel=1e-6)
    lla = geodesy.ned2lla(m.ned, *REF_LLA)
    rows = [ln.split(",") for ln in
            open(pose.make_pix4d(d)).read().splitlines()[1:]]
    for row, (lat, lon, alt), (y, p, r) in zip(rows, lla, m.aircraft_ypr):
        v = [float(x) for x in row[1:]]
        assert max(abs(v[0] - lat), abs(v[1] - lon)) <= 1e-4 / 3600 + 1e-9
        assert abs(v[2] - alt) <= 0.01
        assert max(abs(v[3] - r), abs(v[4] - p)) <= 0.005
        assert abs((v[5] - y + 180.0) % 360.0 - 180.0) <= 0.005
    assert not {"PIL", "cv2"} & set(sys.modules)


def test_geotiff_warp_card_matches_cpu(cuda):
    """One nvJPEG-decoded frame through the geotiff warp and feathering on
    the card and, moved to the CPU, through the same code there: equal bit
    for bit (float32 products, fmas as float64, IEEE division)."""
    from imageanalysis_tpu_torch.io import jpeg
    from imageanalysis_tpu_torch.render import geotiff

    img = jpeg.decode_bgr(os.path.join(_JPEG_DIR, "colour.jpg"), cuda)
    Hm = np.array([[1.6, 0.1, -280.0], [-0.05, 1.6, -250.0],
                   [1e-4, -2e-4, 1.0]])
    M = np.linalg.inv(np.linalg.inv(Hm))
    canvas = (420, 480)
    box = geotiff._frame_box(M, 402, 298, canvas, 52)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        warped, mask = geotiff.warp_frame(img.to(dev), M, box)
        out[dev.type] = (warped.cpu(), mask.cpu(), geotiff.feather_mask(
            mask, box, canvas, 50).cpu())
    for g, w in zip(out["cuda"], out["cpu"]):
        assert torch.equal(g, w)
    assert float(out["cpu"][1].sum()) > 0


@pytest.mark.parametrize("kind", ["fundamental", "essential"])
def test_ransac_epipolar_card_matches_cpu(cuda, rng, kind):
    """ransac_fundamental and ransac_essential on CUDA tensors against
    the CPU with the same draws: ok equal, masks equal on ≥ 99.5% of the
    points, models within 5e-3 up to sign and scale (f32; cuSOLVER's 3×3
    SVD against LAPACK's, the 8-point solves near-singular by
    construction, as tests/test_torch_ransac.py states against the
    reference)."""
    from imageanalysis_tpu_torch.ops import ransac

    K = np.array([[800.0, 0, 500], [0, 800, 400], [0, 0, 1]], np.float32)
    B, N = 4, 700
    pa = np.empty((B, N, 2), np.float32)
    pb = np.empty_like(pa)
    for b in range(B):
        X = np.c_[rng.uniform(-50, 50, (N, 2)), rng.uniform(80, 160, N)]
        a = 0.05 + 0.1 * b
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]])
        xa, xb = X @ K.T, (X @ R.T + [10.0 + b, 2.0, 1.0]) @ K.T
        pa[b] = xa[:, :2] / xa[:, 2:]
        pb[b] = xb[:, :2] / xb[:, 2:] + rng.normal(0, 0.5, (N, 2))
        out = rng.random(N) < 0.3
        pb[b, out] = rng.uniform(0, 1000, (out.sum(), 2))
    valid = rng.random((B, N)) < 0.8
    k = 8 if kind == "fundamental" else 12
    pick = torch.from_numpy(rng.integers(0, 512, (B, 256, k)))
    res = {}
    for dev in (cuda, torch.device("cpu")):
        args = [torch.from_numpy(x).to(dev) for x in (pa, pb, valid)]
        if kind == "essential":
            args.append(torch.from_numpy(K).to(dev))
        fn = getattr(ransac, f"ransac_{kind}")
        res[dev.type] = fn(*args, thresh=2.0, n_hyp=256, pick=pick.to(dev))
    g, w = res["cuda"], res["cpu"]
    assert torch.equal(g.ok.cpu(), w.ok) and bool(w.ok.all())
    assert (g.inliers.cpu() == w.inliers).float().mean(1).min() >= 0.995
    for b, (gm, wm) in enumerate(zip(g.model.cpu().numpy(),
                                     w.model.numpy())):
        if kind == "fundamental":     # in the Hartley frame, entries O(1)
            Ta, Tb = (_hartley(p[b][valid[b]]) for p in (pa, pb))
            gm, wm = (np.linalg.inv(Tb).T @ x @ np.linalg.inv(Ta)
                      for x in (gm, wm))
        gm, wm = gm / np.linalg.norm(gm), wm / np.linalg.norm(wm)
        gm = gm if (gm * wm).sum() > 0 else -gm
        np.testing.assert_allclose(gm, wm, atol=5e-3)



# --- the sharded BA and the process group on the card ----------------------

def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ba_grid(cuda):
    from imageanalysis_tpu_torch.testing.synthetic import make_ba_grid_graph

    return make_ba_grid_graph(n_cam=30, n_pt=600, device=cuda,
                              dtype=torch.float32)


def _close_to_one_solve(got, g, cuda):
    """tests/test_parallel.py's tolerances against bundle.solve on the
    same card: the shards sum in another order, the LM path wanders in the
    gauge-flat valley."""
    from imageanalysis_tpu_torch.ba import bundle

    one = bundle.solve(g.cams0, g.pts0, g.obs, g.K, g.dist,
                       bundle.BAConfig(max_iters=8), verbose=False,
                       device=cuda)
    np.testing.assert_allclose(got.mre, one.mre, rtol=0.02)
    np.testing.assert_allclose(got.cams[:, :3], one.cams[:, :3], atol=0.3)
    assert got.cost_history[-1] < got.cost_history[0]


def test_pointlocal_solve_on_a_local_mesh_of_the_card(cuda):
    """solve_sharded over two shards of one card (LocalMesh) against
    bundle.solve there."""
    from imageanalysis_tpu_torch.ba import bundle
    from imageanalysis_tpu_torch.parallel import sharded

    g = _ba_grid(cuda)
    mesh = sharded.LocalMesh([cuda, cuda])
    got = sharded.solve_sharded(g.cams0, g.pts0, g.obs, g.K, g.dist, mesh,
                                bundle.BAConfig(max_iters=8), verbose=False)
    _close_to_one_solve(got, g, cuda)
    assert mesh.stats["calls"] > 8


def test_pointlocal_solve_on_a_local_mesh_of_distinct_cards(cuda):
    """solve_sharded over a LocalMesh of every card (stages optimize
    --mesh all), each shard on a card of its own, against bundle.solve on
    the first."""
    from imageanalysis_tpu_torch.ba import bundle
    from imageanalysis_tpu_torch.parallel import sharded

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two cards")
    g = _ba_grid(cuda)
    mesh = sharded.LocalMesh([torch.device("cuda", i) for i in range(n)])
    got = sharded.solve_sharded(g.cams0, g.pts0, g.obs, g.K, g.dist, mesh,
                                bundle.BAConfig(max_iters=8), verbose=False)
    _close_to_one_solve(got, g, cuda)
    assert [d.index for d in mesh.devices] == list(range(n))
    assert mesh.stats["calls"] > 8


def test_pair_draws_equal_on_cpu_and_card(cuda):
    """A pair's RANSAC draws (int64 products wrapping mod 2⁶⁴) are the
    same on the CPU and on the card."""
    from imageanalysis_tpu_torch.ops.ransac import PairDraws

    keys = torch.tensor([0, 1, 7, 8191 * 8192 + 5, 2**40 + 3])
    for seed in (0, 42, 2**63 - 1):
        d = PairDraws(seed).keyed(keys)
        a = d.rand((5, 512, 4), "cpu")
        b = d.rand((5, 512, 4), cuda).cpu()
        assert torch.equal(a, b), seed


def test_solve_sharded_over_a_world_of_one_on_nccl(cuda):
    """A process group of one rank on NCCL (the backend rule's pick where
    the rank has a card), and solve_sharded over it."""
    from imageanalysis_tpu_torch.ba import bundle
    from imageanalysis_tpu_torch.parallel import multihost, sharded

    backend = multihost.initialize(0, 1, "127.0.0.1", _free_port(), "cuda",
                                   timeout_s=60)
    try:
        assert backend == "nccl" and multihost.backend() == "nccl"
        g = _ba_grid(cuda)
        mesh = sharded.ProcessMesh(cuda)
        got = sharded.solve_sharded(g.cams0, g.pts0, g.obs, g.K, g.dist,
                                    mesh, bundle.BAConfig(max_iters=8),
                                    verbose=False)
    finally:
        multihost.shutdown()
    _close_to_one_solve(got, g, cuda)


# two ranks on one card: their backend, and one all-reduce of a CUDA tensor
_RANK = """
import sys, torch
from imageanalysis_tpu_torch.parallel import multihost
backend = None if sys.argv[1] == "rule" else sys.argv[1]
rank = int(sys.argv[2])
got = multihost.initialize(rank, 2, "127.0.0.1", int(sys.argv[3]), "cuda",
                           local_rank=0, backend=backend, timeout_s=30)
t = torch.full((4,), float(rank + 1), device="cuda")
torch.distributed.all_reduce(t)
print("RANK", got, t.tolist(), flush=True)
multihost.shutdown()
"""


def _two_ranks_on_one_card(backend):
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=repo)
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, backend,
                               str(r), port], env=env, cwd=repo,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=120)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a rank hung")
    return [p.returncode for p in procs], outs


def test_backend_rule_gloo_for_ranks_sharing_a_card(cuda):
    """NCCL where each rank of the host has a card, gloo on the CPU and
    where ranks share a card; two such ranks all-reduce CUDA tensors over
    gloo."""
    from imageanalysis_tpu_torch.parallel import multihost

    n = torch.cuda.device_count()
    assert multihost.choose_backend("cuda", n) == "nccl"
    assert multihost.choose_backend("cuda", n + 1) == "gloo"
    assert multihost.choose_backend("cpu", 1) == "gloo"
    rcs, outs = _two_ranks_on_one_card("rule")
    assert rcs == [0, 0], outs
    for out in outs:
        assert "RANK gloo [3.0, 3.0, 3.0, 3.0]" in out, out


def test_nccl_that_fails_to_start_raises(cuda):
    """NCCL forced on two ranks of one card refuses them: each rank
    raises (no switch to gloo), within its timeout."""
    rcs, outs = _two_ranks_on_one_card("nccl")
    assert all(rc != 0 for rc in rcs), outs
    assert not any("RANK" in out for out in outs), outs

def _hartley(p):
    p = p.astype(np.float64)
    m = p.mean(0)
    s = np.sqrt(2.0) / np.sqrt(((p - m) ** 2).sum(1).mean())
    return np.array([[s, 0, -s * m[0]], [0, s, -s * m[1]], [0, 0, 1.0]])


# --- rows of 256 values (ORB's bits) ----------------------------------------

def _rows256(rng, pairs, n_a, n_b, kind):
    """int8 rows of 256 values, B's first quarter near A's: ORB's bits as
    the store holds them (−128/−127, 8 bits flipped), or the full
    −128..127 with an all −128 and an all 127 row on each side."""
    hi = 2 if kind == "bits" else 256
    a = rng.integers(0, hi, (pairs, n_a, 256))
    b = rng.integers(0, hi, (pairs, n_b, 256))
    k = min(n_a, n_b) // 4
    b[:, :k] = a[:, :k]
    b[:, :k, :8] = hi - 1 - b[:, :k, :8]
    if kind != "bits":
        a[:, 1], a[:, 2] = 0, 255
        b[:, 3], b[:, 4] = 0, 255
    return (torch.from_numpy((a - 128).astype(np.int8)),
            torch.from_numpy((b - 128).astype(np.int8)))


# (n_a, n_b) at the tile edges of the bodies at 256 values a row: 192 A
# rows (the wgmma body's second warpgroup half empty, the mma.sync bodies'
# 64-row blocks) or 256 (one full wgmma block); B rows ending on either
# stage of the wgmma body's two-tile ring (704: 11 tiles of 64, 384: 6)
# and the largest sets of K1 (8192, 128 tiles) and beyond (K3's 8256)
_SHAPES_256 = {"K1": ((192, 704), (256, 704), (192, 384), (256, 384),
                      (192, 8192), (256, 8192)),
               "K3": ((192, 704), (256, 704), (192, 384), (256, 384),
                      (192, 8256), (256, 8256))}


@pytest.mark.parametrize("shape", _SHAPES_256["K1"],
                         ids=[f"{a}x{b}" for a, b in _SHAPES_256["K1"]])
@pytest.mark.parametrize("gated", [False, True], ids=["plain", "gated"])
@pytest.mark.parametrize("kind", ["bits", "full_range"])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16,
                                   torch.float32],
                         ids=["int8", "bf16", "f32"])
def test_k1_256_bit_exact_vs_plain(cuda, rng, dtype, kind, gated, shape):
    """K1 in every mode at 256 values a row, 3 pairs at the tile edges of
    _SHAPES_256 (bf16 on the wgmma body), counted under its _d256
    name."""
    n_a, n_b = shape
    a, b = (t.to(cuda) for t in _rows256(rng, 3, n_a, n_b, kind))
    args = (a, b, None, None) if dtype == torch.int8 else \
        _float_inputs(a, b, dtype)
    gate = _gate(rng, cuda, 3, n_a, n_b) if gated else ()
    key = ("knn_packed_gated" if gated else
           {torch.int8: "knn_packed_i8", torch.bfloat16: "knn_packed_bf16",
            torch.float32: "knn_packed_f32"}[dtype]) + "_d256"
    before = knn.LAUNCHES[key]
    got = knn.knn_packed_raw(*args, *gate)
    assert knn.LAUNCHES[key] == before + 1
    want = knn.knn_packed_plain(*args, *gate)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("shape", _SHAPES_256["K3"],
                         ids=[f"{a}x{b}" for a, b in _SHAPES_256["K3"]])
@pytest.mark.parametrize("kind", ["bits", "full_range"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_k3_256_bit_exact_vs_plain(cuda, rng, dtype, kind, shape):
    """K3 at 256 values a row, both modes, 3 pairs at the tile edges of
    _SHAPES_256, beyond 8192 B rows too (bf16 on the wgmma body)."""
    n_a, n_b = shape
    a, b = (t.to(cuda) for t in _rows256(rng, 3, n_a, n_b, kind))
    args = _float_inputs(a, b, dtype)
    key = ("knn_wide" if dtype == torch.bfloat16 else "knn_wide_f32") \
        + "_d256"
    before = knn.LAUNCHES[key]
    got = knn.knn_wide_raw(*args)
    assert knn.LAUNCHES[key] == before + 1
    want = knn.knn_wide_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("mode", ["packed", "gated", "wide", "row_sum"])
@pytest.mark.parametrize("body", ["mma", "wg"])
def test_bf16_256_bodies_bit_exact_vs_plain(cuda, rng, body, mode):
    """bf16 at 256 values a row on both bodies through
    knn_stages.bf16_d256_raw (the mma.sync body is the wgmma body's
    yardstick): K1 plain and gated, K3 and the product-only stage, 320 A
    rows (a wgmma block and a half) against 640 B rows, on the full
    -128..127, equal to the plain versions."""
    a, b = (t.to(cuda) for t in _rows256(rng, 3, 320, 640, "full_range"))
    x, y, na2, nb2 = _float_inputs(a, b, torch.bfloat16)
    gate = _gate(rng, cuda, 3, 320, 640) if mode == "gated" else ()
    kw = dict(mode="packed" if mode == "gated" else mode)
    norms = (None, None) if mode == "row_sum" else (na2, nb2)
    before = knn_stages.LAUNCHES["knn_bf16_d256"]
    got = knn_stages.bf16_d256_raw(x, y, *norms, *gate, body=body, **kw)
    assert knn_stages.LAUNCHES["knn_bf16_d256"] == before + 1
    want = knn_stages.bf16_d256_plain(x, y, *norms, *gate, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("mode", ["packed", "gated", "wide", "row_sum"])
@pytest.mark.parametrize("body", ["mma", "wg"])
@pytest.mark.parametrize("kind", ["bits", "full_range"])
def test_f32_256_bodies_bit_exact_vs_plain(cuda, rng, kind, body, mode):
    """f32 at 256 values a row on both bodies through
    knn_stages.f32_d256_raw (the mma.sync body is the wgmma body's
    yardstick): K1 plain and gated, K3 and the product-only stage, 320 A
    rows (two and a half wgmma blocks of 128) against 640 B rows, on ORB's
    bits and the full -128..127, equal to the plain versions."""
    a, b = (t.to(cuda) for t in _rows256(rng, 3, 320, 640, kind))
    x, y, na2, nb2 = _float_inputs(a, b, torch.float32)
    gate = _gate(rng, cuda, 3, 320, 640) if mode == "gated" else ()
    kw = dict(mode="packed" if mode == "gated" else mode)
    norms = (None, None) if mode == "row_sum" else (na2, nb2)
    before = knn_stages.LAUNCHES["knn_f32_d256"]
    got = knn_stages.f32_d256_raw(x, y, *norms, *gate, body=body, **kw)
    assert knn_stages.LAUNCHES["knn_f32_d256"] == before + 1
    want = knn_stages.f32_d256_plain(x, y, *norms, *gate, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("mode", ["packed", "gated", "row_sum"])
@pytest.mark.parametrize("body", ["mma", "wg"])
@pytest.mark.parametrize("kind", ["bits", "full_range"])
def test_i8_256_bodies_bit_exact_vs_plain(cuda, rng, kind, body, mode):
    """int8 at 256 values a row on both bodies through
    knn_stages.i8_d256_raw (the mma.sync s8 body is the wgmma s8 body's
    yardstick): K1 plain and gated and the product-only stage, 320 A rows
    (a wgmma block and a half) against 640 B rows, on ORB's bits and the
    full -128..127, equal to the plain versions and counted as
    knn_i8_d256, not as K1's launches."""
    a, b = (t.to(cuda) for t in _rows256(rng, 3, 320, 640, kind))
    gate = _gate(rng, cuda, 3, 320, 640) if mode == "gated" else ()
    kw = dict(mode="row_sum" if mode == "row_sum" else "packed")
    before = knn_stages.LAUNCHES["knn_i8_d256"]
    k1 = dict(knn.LAUNCHES)
    got = knn_stages.i8_d256_raw(a, b, None, None, *gate, body=body, **kw)
    assert knn_stages.LAUNCHES["knn_i8_d256"] == before + 1
    assert knn.LAUNCHES == k1
    want = knn_stages.i8_d256_plain(a, b, None, None, *gate, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _rows128(rng, pairs, n_a, n_b, kind):
    """int8 rows of 128 values: planted SIFT-like rows (value − 128 of
    0..99, B's first quarter near A's) or the full −128..127 with an all
    −128 and an all 127 row on each side."""
    k = min(n_a, n_b) // 4
    return (_planted(rng, pairs, n_a, n_b, k) if kind == "planted"
            else _full_range(rng, pairs, n_a, n_b, k))


@pytest.mark.parametrize("mode", ["packed", "gated", "row_sum"])
@pytest.mark.parametrize("body", ["mma", "wg"])
@pytest.mark.parametrize("kind", ["planted", "full_range"])
def test_i8_128_bodies_bit_exact_vs_plain(cuda, rng, kind, body, mode):
    """int8 at 128 values a row (SIFT's in the int8 store) on both bodies
    through knn_stages.i8_d128_raw (the mma.sync s8 body is the wgmma s8
    body's yardstick): K1 plain and gated and the product-only stage, 320
    A rows (a wgmma block and a quarter) against 640 B rows, on planted
    rows and the full -128..127, equal to the plain versions and counted
    as knn_i8_d128, not as K1's launches."""
    a, b = (t.to(cuda) for t in _rows128(rng, 3, 320, 640, kind))
    gate = _gate(rng, cuda, 3, 320, 640) if mode == "gated" else ()
    kw = dict(mode="row_sum" if mode == "row_sum" else "packed")
    before = knn_stages.LAUNCHES["knn_i8_d128"]
    k1 = dict(knn.LAUNCHES)
    got = knn_stages.i8_d128_raw(a, b, None, None, *gate, body=body, **kw)
    assert knn_stages.LAUNCHES["knn_i8_d128"] == before + 1
    assert knn.LAUNCHES == k1
    want = knn_stages.i8_d128_plain(a, b, None, None, *gate, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("mode", ["packed", "gated", "row_sum"])
@pytest.mark.parametrize("body", ["mma", "wg"])
@pytest.mark.parametrize("kind", ["planted", "full_range"])
def test_bf16_128_bodies_bit_exact_vs_plain(cuda, rng, kind, body, mode):
    """bf16 at 128 values a row (integer-valued 0..255, the store's uint8
    and float32 modes) on both bodies through knn_stages.bf16_d128_raw
    (the mma.sync body is the wgmma body's yardstick): K1 plain and gated
    and the product-only stage, 320 A rows against 640 B rows, equal to
    the plain versions and counted as knn_bf16_d128."""
    a, b = (t.to(cuda) for t in _rows128(rng, 3, 320, 640, kind))
    x, y, na2, nb2 = _float_inputs(a, b, torch.bfloat16)
    gate = _gate(rng, cuda, 3, 320, 640) if mode == "gated" else ()
    kw = dict(mode="row_sum" if mode == "row_sum" else "packed")
    norms = (None, None) if mode == "row_sum" else (na2, nb2)
    before = knn_stages.LAUNCHES["knn_bf16_d128"]
    k1 = dict(knn.LAUNCHES)
    got = knn_stages.bf16_d128_raw(x, y, *norms, *gate, body=body, **kw)
    assert knn_stages.LAUNCHES["knn_bf16_d128"] == before + 1
    assert knn.LAUNCHES == k1
    want = knn_stages.bf16_d128_plain(x, y, *norms, *gate, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("mode", ["wide", "row_sum"])
@pytest.mark.parametrize("body", ["mma", "wg"])
@pytest.mark.parametrize("kind", ["planted", "full_range"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_k3_128_bodies_bit_exact_vs_plain(cuda, rng, dtype, kind, body,
                                          mode):
    """K3 bf16 and f32 at 128 values a row (integer-valued 0..255) on
    both bodies through knn_stages.bf16_d128_raw and f32_d128_raw (the
    mma.sync body is the wgmma body's yardstick): K3 and the product-only
    stage (f32: after its split pre-pass), 320 A rows against 640 B rows,
    equal to the plain versions and counted as the probe's launches, not
    as K3's."""
    a, b = (t.to(cuda) for t in _rows128(rng, 3, 320, 640, kind))
    x, y, na2, nb2 = _float_inputs(a, b, dtype)
    norms = (None, None) if mode == "row_sum" else (na2, nb2)
    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    entry = f"knn_{tag}_d128"
    before = knn_stages.LAUNCHES[entry]
    k3 = dict(knn.LAUNCHES)
    got = getattr(knn_stages, f"{tag}_d128_raw")(x, y, *norms, body=body,
                                                 mode=mode)
    assert knn_stages.LAUNCHES[entry] == before + 1
    assert knn.LAUNCHES == k3
    want = getattr(knn_stages, f"{tag}_d128_plain")(x, y, *norms, mode=mode)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n_a", [64, 320])
@pytest.mark.parametrize("gated", [False, True], ids=["plain", "gated"])
def test_k1_f32_128_wgmma_equals_mma_on_mid_planes(cuda, rng, gated, n_a):
    """K1 f32 at 128 values a row on the wgmma body (knn_packed_raw,
    counted as K1's launch) equals the mma.sync body it replaced
    (knn_stages.f32_d128_raw with body "mma", counted as knn_f32_d128)
    and the probe's wgmma route (body "wg") bit for bit, plain and
    gated, on integer rows of 261..360 (mid planes set, every dot exact),
    at one and at five 64-row blocks of A."""
    a, b = (t.to(cuda) for t in _planted(rng, 3, n_a, 640, n_a // 4))
    af, bf = (x.float() + 128.0 + 261.0 for x in (a, b))
    args = (af, bf, (af * af).sum(-1), (bf * bf).sum(-1))
    gate = _gate(rng, cuda, 3, n_a, 640) if gated else ()
    key = "knn_packed_gated" if gated else "knn_packed_f32"
    before = knn.LAUNCHES[key]
    got = knn.knn_packed_raw(*args, *gate)
    assert knn.LAUNCHES[key] == before + 1
    probe = knn_stages.LAUNCHES["knn_f32_d128"]
    k1 = dict(knn.LAUNCHES)
    mma = knn_stages.f32_d128_raw(*args, *gate, body="mma")
    wg = knn_stages.f32_d128_raw(*args, *gate, body="wg")
    assert knn_stages.LAUNCHES["knn_f32_d128"] == probe + 2
    assert knn.LAUNCHES == k1
    want = knn.knn_packed_plain(*args, *gate)
    torch.cuda.synchronize()
    for g, m, w, v in zip(got, mma, wg, want):
        assert torch.equal(g, v)
        assert torch.equal(m, v)
        assert torch.equal(w, v)


def test_k1_f32_128_wgmma_builds_without_spill(cuda, tmp_path):
    """ptxas on csrc/knn_packed.cu alone, with the package's flags: K1
    f32's wgmma instantiations at 128 values a row, plain ("f32 0 wg")
    and gated ("f32 1 wg"), are built, spill nothing and carry no ptxas
    note (C7518: wgmma serialized)."""
    nvcc = _build.find_nvcc()
    if nvcc is None:
        pytest.skip("needs nvcc")
    src = os.path.join(_build.CSRC, "knn_packed.cu")
    proc = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-c", "-o",
                           str(tmp_path / "knn_packed.o"), src],
                          capture_output=True, text=True, timeout=600)
    log = proc.stdout + proc.stderr
    assert proc.returncode == 0, log
    usage = _build.tc_kernel_usage(_build.ptxas_usage(log))
    for key in ("f32 0 wg", "f32 1 wg"):
        assert usage[key][1:] == (0, 0), (key, usage[key])
    notes = [w for w in _build.ptxas_warnings(log)
             if "knn_wg_kernelINS_6Bf16x3E" in w]
    assert not notes, notes


# (pairs, n_a, n_b) at the wgmma K3's edges at 128 values a row: n_a not
# a multiple of a block's rows (bf16 256, f32 128) with n_a != n_b, one
# 64-row B tile, one pair beyond K1's 8192 B rows, a block of f32 whose
# second warpgroup has no rows
_K3_128_SHAPES = [(3, 320, 640), (2, 192, 64), (1, 128, 8256),
                  (2, 448, 8320)]


@pytest.mark.parametrize("shape", _K3_128_SHAPES,
                         ids=[f"{p}x{a}x{b}" for p, a, b in _K3_128_SHAPES])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_k3_128_shapes_equal_plain_and_mma(cuda, rng, dtype, shape):
    """K3 at 128 values a row on the wgmma body (knn_wide_raw, counted as
    K3's launch) at its edges, integer rows with duplicates (values tie,
    the lowest index must win): keys equal the plain version's and the
    kept mma.sync yardstick's bit for bit."""
    pairs, n_a, n_b = shape
    a, b = (t.to(cuda) for t in _planted(rng, pairs, n_a, n_b,
                                         min(n_a, n_b) // 4, dup=True))
    args = _float_inputs(a, b, dtype)
    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    key = "knn_wide" if tag == "bf16" else "knn_wide_f32"
    before = knn.LAUNCHES[key]
    got = knn.knn_wide_raw(*args)
    assert knn.LAUNCHES[key] == before + 1
    want = knn.knn_wide_plain(*args)
    mma = getattr(knn_stages, f"{tag}_d128_raw")(*args, mode="wide",
                                                body="mma")
    torch.cuda.synchronize()
    for g, w, m in zip(got, want, mma):
        assert torch.equal(g, w)
        assert torch.equal(m, w)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_k3_128_within_tolerance_of_plain_and_mma_on_random(cuda, rng,
                                                            dtype):
    """Non-integer rows (uniform 0..400, a quarter of B planted near A:
    f32's mid and lo planes set) through K3 at 128 on the wgmma body, 320
    A rows against 8256 B rows: values within 2⁻²⁰ (f32) or _TC_REL
    (bf16) of the norms of the plain version's and of the mma.sync
    yardstick's, indices different only on ties."""
    pairs, n_a, n_b = 2, 320, 8256
    a = rng.uniform(0, 400, (pairs, n_a, 128))
    b = rng.uniform(0, 400, (pairs, n_b, 128))
    b[:, :n_a // 4] = a[:, :n_a // 4] + rng.normal(0, 2,
                                                   (pairs, n_a // 4, 128))
    a, b = (torch.from_numpy(v.astype(np.float32)).to(cuda).to(dtype)
            for v in (a, b))
    if dtype == torch.float32:
        lo = knn.split_bf16x3_plain(a)[..., 2, :]
        assert bool((lo != 0).any())
    na2, nb2 = knn._sq_norms(a), knn._sq_norms(b)
    rel = _F32_REL if dtype == torch.float32 else _TC_REL
    tol = rel * float(na2.max() + nb2.max())
    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    got = knn.knn_wide_raw(a, b, na2, nb2)
    for want in (knn.knn_wide_plain(a, b, na2, nb2),
                 getattr(knn_stages, f"{tag}_d128_raw")(
                     a, b, na2, nb2, mode="wide", body="mma")):
        torch.cuda.synchronize()
        _near(got[0], want[0], a, b, tol, False, "rows")
        _near(got[1], want[1], b, a, tol, False, "columns")


# at 256 values a row the values hold twice _F32_REL: the plain version's
# own f32 product rounds twice the terms at twice the magnitude of 128's;
# on these rows its K3 values lie 21-24 from the f64 truth where both
# tensor-core bodies' (wgmma and mma.sync, equal values) lie 15-16, against
# 2⁻²⁰ (max |a|² + max |b|²) = 31 (scripts_torch/f32_256_errors.py on an
# NVIDIA H100 80GB HBM3)
_F32_REL_256 = 2.0 ** -19


def _random_f32_256(rng, cuda, pairs, n_a, n_b):
    """Non-integer f32 rows of 256 values (uniform 0..400, B's first
    quarter planted near A's) with their norms and the tolerance
    _F32_REL_256 × (max |a|² + max |b|²)."""
    k = min(n_a, n_b) // 4
    a = rng.uniform(0, 400, (pairs, n_a, 256))
    b = rng.uniform(0, 400, (pairs, n_b, 256))
    b[:, :k] = a[:, :k] + rng.normal(0, 2, (pairs, k, 256))
    a, b = (torch.from_numpy(x.astype(np.float32)).to(cuda) for x in (a, b))
    na2, nb2 = knn._sq_norms(a), knn._sq_norms(b)
    return a, b, na2, nb2, _F32_REL_256 * float(na2.max() + nb2.max())


@pytest.mark.parametrize("shape", _SHAPES_256["K1"],
                         ids=[f"{a}x{b}" for a, b in _SHAPES_256["K1"]])
@pytest.mark.parametrize("gated", [False, True], ids=["plain", "gated"])
def test_k1_f32_256_within_tolerance_on_random(cuda, rng, gated, shape):
    """K1 f32 at 256 values a row (the wgmma body) on non-integer rows,
    whose mid and lo planes are set, at the tile edges of _SHAPES_256:
    values within 2⁻¹⁹ of the norms (_F32_REL_256) plus a key's 10-bit
    step, indices different only on ties."""
    n_a, n_b = shape
    a, b, na2, nb2, tol = _random_f32_256(rng, cuda, 2, n_a, n_b)
    gate = _gate(rng, cuda, 2, n_a, n_b) if gated else ()
    key = ("knn_packed_gated" if gated else "knn_packed_f32") + "_d256"
    before = knn.LAUNCHES[key]
    got = knn.knn_packed_raw(a, b, na2, nb2, *gate)
    assert knn.LAUNCHES[key] == before + 1
    want = knn.knn_packed_plain(a, b, na2, nb2, *gate)
    torch.cuda.synchronize()
    _near(got[0], want[0], a, b, tol, True, "rows")
    _near(got[1], want[1], b, a, tol, True, "columns")


@pytest.mark.parametrize("shape", _SHAPES_256["K3"],
                         ids=[f"{a}x{b}" for a, b in _SHAPES_256["K3"]])
def test_k3_f32_256_within_tolerance_on_random(cuda, rng, shape):
    """K3 f32 at 256 values a row (the wgmma body) on non-integer rows at
    the tile edges of _SHAPES_256, beyond 8192 B rows too: values within
    2⁻¹⁹ of the norms (_F32_REL_256), indices different only on
    ties."""
    n_a, n_b = shape
    a, b, na2, nb2, tol = _random_f32_256(rng, cuda, 2, n_a, n_b)
    before = knn.LAUNCHES["knn_wide_f32_d256"]
    got = knn.knn_wide_raw(a, b, na2, nb2)
    assert knn.LAUNCHES["knn_wide_f32_d256"] == before + 1
    want = knn.knn_wide_plain(a, b, na2, nb2)
    torch.cuda.synchronize()
    _near(got[0], want[0], a, b, tol, False, "rows")
    _near(got[1], want[1], b, a, tol, False, "columns")


def test_knn_wg_sass_is_hgmma(cuda):
    """The wgmma body (knn_wg_kernel) runs its products as HGMMA (wgmma),
    not as mma.sync's HMMA, in its four modes (K1 plain and gated, K3,
    the product-only stage) at 256 values a row for bf16 and f32 and at
    128 for bf16 and f32, which the mma.sync bodies' kernels at both
    widths show (the kept yardsticks of K1 and K3 at 128); its
    three int8 modes at 256 and at 128 as the integer wgmma, IGMMA, not as
    mma.sync's IMMA, which the int8 mma.sync bodies at both widths (the
    yardsticks) show."""
    per_key = _build.tc_kernel_usage({
        name: _build.opcode_counts(lines)
        for name, lines in _build.sass().items()})
    keys = {k for k in per_key if k.endswith(" wg")}
    assert keys == ({f"{t}_d256 {m} wg" for t in ("bf16", "f32")
                     for m in range(4)}
                    | {f"{t} {m} wg" for t in ("int8_d256", "int8", "bf16")
                       for m in (0, 1, 3)}
                    | {"bf16 2 wg"} | {f"f32 {m} wg" for m in range(4)}), keys
    for k in keys:
        if k.startswith("int8"):
            assert per_key[k]["IGMMA"] > 0 and per_key[k]["IMMA"] == 0 \
                and per_key[k]["HGMMA"] == 0, (k, per_key[k])
        else:
            assert per_key[k]["HGMMA"] > 0 and per_key[k]["HMMA"] == 0, \
                (k, per_key[k])
    assert per_key["bf16_d256 0 128 128 2"]["HMMA"] > 0
    assert per_key["f32_d256 0 64 64 1"]["HMMA"] > 0
    assert per_key["int8_d256 0 128 128 2"]["IMMA"] > 0
    for t, op in (("int8", "IMMA"), ("bf16", "HMMA")):
        for m in (0, 1, 3):
            assert per_key[f"{t} {m} 128 128 2"][op] > 0, (t, m)
    # the yardsticks at 128 of K1 f32 (plain and gated) and of K3
    for k in ("f32 0 128 64 2", "f32 1 128 64 2", "f32 2 128 64 2",
              "bf16 2 128 128 2"):
        assert per_key[k]["HMMA"] > 0 and per_key[k]["HGMMA"] == 0, k


# last in the file: it imports cv2, which the card path's tests above
# check is not imported
@pytest.mark.parametrize("detector", ["SIFT", "ORB"])
def test_cv_detector_matching_stage_on_card(cuda, tmp_path, detector):
    """The stage scripts on a four-frame mission written on the card, with
    the host's OpenCV detector: matching runs the 2-NN kernels on the card
    (the float path below 64 images: K1 bf16, or K3 bf16 beyond 8192
    features, as ORB's ~9,900 a 640×480 frame; at 256 values a row for
    ORB) and every along-track pair keeps matches."""
    from imageanalysis_tpu_torch.apps import stages
    from imageanalysis_tpu_torch.io.project import ProjectMgr
    from imageanalysis_tpu_torch.testing.synthetic import (
        CAMERA_KEY, image_name, make_mission, write_mission)

    m = make_mission(strips=2, per_strip=2, size=(640, 480), strip_gap=1.5,
                     seed=3, device=cuda)
    d, db = str(tmp_path / "mission"), str(tmp_path / "db")
    write_mission(d, m, db)
    for argv in (["create-project", d],
                 ["set-camera", d, "--camera", CAMERA_KEY, "--camera-db", db],
                 ["set-poses", d]):
        assert stages.main(argv) == 0
    keys = [k + ("_d256" if detector == "ORB" else "")
            for k in ("knn_packed_bf16", "knn_wide")]
    before = sum(knn.LAUNCHES[k] for k in keys)
    assert stages.main(["matching", d, "--detector", detector, "--scale",
                        "1.0", "--batch-size", "4"]) == 0
    assert sum(knn.LAUNCHES[k] for k in keys) > before
    proj = ProjectMgr(d)
    proj.load_images_info()
    assert proj.state.check("STEP3a")
    width = 128 if detector == "SIFT" else 256
    for im in proj.image_list:
        assert im.load_descriptors() and im.des.shape[1] == width
        im.load_matches()
    by = {im.name: im for im in proj.image_list}
    for s in range(2):
        a, b = by[image_name(2 * s)], by[image_name(2 * s + 1)]
        assert len(a.match_list.get(b.name, ())) >= 50


# the video and motion tools (they import cv2, so after the card path's
# tests above): the same code on the card and on the CPU
def test_video_fits_and_correlation_card_match_cpu(cuda, rng):
    """The batched similarity fits of estimate_motion and the FFT
    cross-correlation of sync_clocks: float32 on both, sums in another
    order."""
    from imageanalysis_tpu_torch.video import correlate, frame_motion

    pa = rng.uniform(0, 1920, (64, 400, 2)).astype(np.float32)
    th = rng.normal(0, 0.01, 64)
    R = np.stack([np.cos(th), -np.sin(th), np.sin(th), np.cos(th)], -1) \
        .reshape(64, 1, 2, 2).astype(np.float32)
    pb = (np.einsum("bnij,bnj->bni", np.broadcast_to(R, (64, 400, 2, 2)),
                    pa) + rng.normal(0, 3, (64, 1, 2))).astype(np.float32)
    w = (rng.uniform(size=(64, 400)) < 0.8).astype(np.float32)
    got = frame_motion.fit_pairs(pa, pb, w, cuda)
    want = frame_motion.fit_pairs(pa, pb, w, "cpu")
    np.testing.assert_allclose(got[0], want[0], atol=1e-5)
    np.testing.assert_allclose(got[1:], want[1:], atol=1e-2)
    np.testing.assert_allclose(got[0], th, atol=1e-4)
    a, b = rng.normal(size=3000), rng.normal(size=600)
    yc = correlate.cross_correlate_full(a, b, device=cuda)
    yh = correlate.cross_correlate_full(a, b, device="cpu")
    assert np.abs(yc - yh).max() <= 1e-4 * np.abs(yh).max()


def test_dmd_and_lens_gradient_card_match_cpu(cuda, rng):
    """exact_dmd's SVD (singular values; vectors up to sign through the
    eigenvalues) and the lens loss and its autograd gradient."""
    from imageanalysis_tpu_torch.motion import lens_distortion, segment

    # a static mode and a conjugate pair (|λ| = 1, 0.95) in 20,000 pixels
    lam = np.array([1.0, 0.95 * np.exp(0.4j), 0.95 * np.exp(-0.4j)])
    phic = rng.normal(size=20000) + 1j * rng.normal(size=20000)
    phi = np.column_stack([rng.normal(size=20000), phic, np.conj(phic)])
    X = np.real(phi @ (lam[:, None] ** np.arange(40)[None, :])) \
        .astype(np.float32) + rng.normal(0, 1e-3, (20000, 40)) \
        .astype(np.float32)
    s = [torch.linalg.svd(torch.as_tensor(X, device=d),
                          full_matrices=False)[1].cpu().numpy()
         for d in (cuda, "cpu")]
    np.testing.assert_allclose(s[0], s[1], atol=1e-4 * s[1][0])
    ev = [np.sort_complex(segment.exact_dmd(X[:, :-1], X[:, 1:], rank=3,
                                            device=d)[1])
          for d in (cuda, "cpu")]
    np.testing.assert_allclose(ev[0], ev[1], atol=1e-4)
    np.testing.assert_allclose(ev[1], np.sort_complex(lam), atol=1e-3)
    K = np.array([[1500.0, 0, 960], [0, 1500.0, 540], [0, 0, 1]],
                 np.float32)
    tracks = [(rng.uniform(0, 1900, (300, 2)).astype(np.float32),) * 2
              for _ in range(8)]
    tracks = [(a, a + rng.normal(0, 1, 2).astype(np.float32))
              for a, _ in tracks]
    out = []
    for d in (cuda, torch.device("cpu")):
        p = torch.tensor([-0.1, 0.02], device=d, requires_grad=True)
        val = lens_distortion.pair_loss(tracks, K, d)(p)
        val.backward()
        out.append((float(val.detach()), p.grad.cpu().numpy()))
    assert abs(out[0][0] - out[1][0]) <= 1e-4 * abs(out[1][0])
    np.testing.assert_allclose(out[0][1], out[1][1],
                               atol=1e-3 * np.abs(out[1][1]).max())


def test_sparse_lk_card_matches_cpu(cuda, rng):
    """SparseLK's homography RANSAC draws alike on both devices (PairDraws
    keyed by the frame counter): the same H within float32 sums, the
    inlier count within 1% (points at the threshold may fall either
    way)."""
    import cv2

    from imageanalysis_tpu_torch.motion import flow

    base = cv2.GaussianBlur(rng.uniform(0, 255, (540, 960))
                            .astype(np.float32), (0, 0), 2)
    base = cv2.normalize(base, None, 0, 255, cv2.NORM_MINMAX) \
        .astype(np.uint8)
    H_true = np.array([[1.0, 0.01, 6.0], [-0.01, 1.0, -4.0], [0, 0, 1.0]])
    warped = cv2.warpPerspective(base, H_true, (960, 540))
    out = []
    for d in (cuda, "cpu"):
        tracker = flow.SparseLK(device=d)
        tracker.update(base)
        out.append(tracker.update(warped))
    (Hc, nc), (Hh, nh) = out
    assert nh > 100 and abs(nc - nh) <= max(2, 0.01 * nh)
    np.testing.assert_allclose(Hc, Hh, atol=1e-3)
    np.testing.assert_allclose(Hc[:2, 2], H_true[:2, 2], atol=0.5)


@pytest.mark.parametrize("tool", ["overlay_video", "stabilize_video"])
def test_video_writer_that_does_not_open_raises_on_card(cuda, tmp_path,
                                                        tool):
    """The deliberate divergence on the card's OpenCV: a writer that cv2
    cannot open raises (the reference writes nothing, silently)."""
    import cv2

    from imageanalysis_tpu_torch.testing import video as synth
    from imageanalysis_tpu_torch.video import camera, hud, stabilize

    path = str(tmp_path / "in.mp4")
    synth.write_flight_movie(path, seed=1, size=(320, 240), n_frames=12)
    assert cv2.VideoCapture(path).isOpened()
    out = str(tmp_path / "no_such_dir" / "out.mp4")
    with pytest.raises(OSError, match="VideoWriter"):
        if tool == "overlay_video":
            cam = camera.VirtualCamera({"K": [200.0, 0, 160, 0, 200.0, 120,
                                              0, 0, 1]})
            hud.overlay_video(path, out, cam,
                              lambda t: dict(ned=[0, 0, -100.0],
                                             quat=[1.0, 0, 0, 0],
                                             ypr_deg=(0, 0, 0)),
                              max_frames=2)
        else:
            stabilize.stabilize_video(path, out, device=cuda)


_STORE_MODES = {"int8": ("int8", True, "knn_packed_i8"),
                "uint8": ("uint8", True, "knn_packed_bf16"),
                "float32-bf16": ("float32", True, "knn_packed_bf16"),
                "float32-f32": ("float32", False, "knn_packed_f32")}


@pytest.mark.parametrize("mode", list(_STORE_MODES))
def test_store_modes_card_match_cpu(cuda, rng, mode):
    """The store path (match_pairs_store, homography RANSAC with the pair's
    draws) in each store mode on 4 images of ~900 planted integer rows
    (counts below npad): the card's match lists equal the CPU's (the
    kernels' plain versions there), and the mode's K1 launched."""
    from imageanalysis_tpu_torch.match.store import DescriptorStore

    dtype, bf16, kernel = _STORE_MODES[mode]
    base = rng.integers(0, 120, (1000, 128))
    pos = rng.uniform(50, 950, (1000, 2))
    des, uv = [], []
    for i in range(4):
        keep = np.sort(rng.choice(1000, 900 - 20 * i, replace=False))
        des.append(np.clip(base[keep] + rng.integers(-3, 4, (len(keep), 128)),
                           0, 255).astype(np.float32))
        uv.append((pos[keep] + [7.0 * i, -3.0 * i]).astype(np.float32))
    pairs = [(0, 1), (1, 2), (2, 3), (0, 2), (1, 3)]
    got = {}
    for dev in ("cuda", "cpu"):
        store = DescriptorStore.from_arrays(des, uv, device=dev, dtype=dtype)
        assert store.dtype == dtype and store.npad == 1024
        before = knn.LAUNCHES[kernel]
        got[dev] = matcher.match_pairs_store(
            store, pairs, matcher.MatchConfig(bf16=bf16, use_pallas=True),
            thresh=4.0)
        if dev == "cuda":
            assert knn.LAUNCHES[kernel] > before
    for p in pairs:
        np.testing.assert_array_equal(got["cuda"][p], got["cpu"][p])
        assert len(got["cuda"][p]) > 500


def test_explorer_warp_full_card_matches_cpu(cuda, rng):
    """The explorer's full-resolution warp of a texture over an 8 × 8 quad
    mesh (the egg's grid, slightly warped): the card's raster equals the
    CPU's on ≥ 99.9% of the pixels, with the same extent."""
    import types

    from imageanalysis_tpu_torch.apps.explorer import Explorer

    import cv2

    tex = cv2.GaussianBlur(rng.integers(0, 256, (480, 640, 3),
                                        dtype=np.uint8), (0, 0), 2.0)
    g = np.linspace(0.0, 1.0, 9)
    u, v = np.meshgrid(g, g)
    uvs = np.stack([u.ravel(), v.ravel()], 1)
    verts = np.c_[40.0 * u.ravel() + 0.8 * np.sin(3 * v.ravel()),
                  30.0 * v.ravel() + 0.5 * u.ravel() ** 2,
                  np.zeros(81)]
    quads = np.array([[r * 9 + c, r * 9 + c + 1, (r + 1) * 9 + c + 1,
                       (r + 1) * 9 + c] for r in range(8) for c in range(8)])
    out = {}
    for dev in ("cuda", "cpu"):
        ex = Explorer.__new__(Explorer)
        ex._grids = {"img": (verts, uvs, quads)}
        t = torch.from_numpy(tex).to(dev)
        ex.textures = types.SimpleNamespace(load_full=lambda name, t=t: t)
        out[dev] = ex._warp_full("img", res=1024)
    (card, ext_c), (host, ext_h) = out["cuda"], out["cpu"]
    assert ext_c == ext_h and card.shape == host.shape == (1024, 1024, 4)
    assert (card != host).any(-1).mean() <= 1e-3
    assert (card[..., 3] > 0).mean() > 0.5


def _poses(rng, n):
    ned = np.c_[rng.uniform(-50, 50, (n, 2)), -rng.uniform(80, 100, n)]
    # camera poses look down: pitch −90° (the mount's) with a little tilt
    ypr = np.c_[rng.uniform(-np.pi, np.pi, n),
                rng.normal(-np.pi / 2, 0.05, n), rng.normal(0, 0.05, n)]
    from imageanalysis_tpu_torch.core.rotations import quat_from_ypr

    quat = quat_from_ypr(*torch.from_numpy(ypr.T.astype(np.float32)))
    return ned.astype(np.float32), quat.numpy()


def test_paste_rays_card_match_cpu(cuda, rng):
    """zooniverse's batched rays of 500 marks in 20 cameras: the card's
    ground points within 1e-3 m of the CPU's."""
    from imageanalysis_tpu_torch.apps.zooniverse import cast_marks

    ned, quat = _poses(rng, 20)
    cam = rng.integers(0, 20, 500)
    uv = rng.uniform([0, 0], [2176, 1440], (500, 2)).astype(np.float32)
    K = np.array([[1800.0, 0, 1088], [0, 1800.0, 720], [0, 0, 1]],
                 np.float32)
    dist = np.array([-0.05, 0.01, 0.0, 0.0, 0.0], np.float32)
    hits = {}
    for dev in ("cuda", "cpu"):
        def t(x, dev=dev):
            return torch.as_tensor(x, device=dev)
        hits[dev] = cast_marks(t(uv), t(ned[cam]), t(quat[cam]), t(K),
                               t(dist), 1.5).cpu().numpy()
    assert np.abs(hits["cuda"] - hits["cpu"]).max() <= 1e-3
    assert np.allclose(hits["cpu"][:, 2], -1.5)


def test_preview_projection_card_matches_cpu(cuda, rng):
    """preview-crops' projection of 300 ground points, each into its own
    camera: the card's pixels within 1e-3 px of the CPU's."""
    import types

    from imageanalysis_tpu_torch.apps.utils import project_markers

    ned, quat = _poses(rng, 300)
    feats = np.c_[ned[:, :2] + rng.uniform(-20, 20, (300, 2)),
                  np.zeros(300)]
    model = types.SimpleNamespace(
        K=torch.tensor([[1800.0, 0, 1088], [0, 1800.0, 720], [0, 0, 1]]),
        dist=torch.tensor([-0.05, 0.01, 0.001, -0.001, 0.0]))
    poses = list(zip(ned, quat))
    uv = {dev: project_markers(feats, poses, model, dev)
          for dev in ("cuda", "cpu")}
    assert np.abs(uv["cuda"] - uv["cpu"]).max() <= 1e-3
    assert np.isfinite(uv["cpu"]).all()


# --- the reference's mission generator (testing/synthetic.py) --------------

def _generate_recording(monkeypatch, m):
    """m.generate() with every frame it encodes kept on the CPU."""
    from imageanalysis_tpu_torch.testing import synthetic

    frames = []
    encode = synthetic.jpeg.encode_bgr

    def keep(img, path, quality=95):
        frames.append(img[..., 0].cpu())
        encode(img, path, quality)

    monkeypatch.setattr(synthetic.jpeg, "encode_bgr", keep)
    records = m.generate()
    monkeypatch.setattr(synthetic.jpeg, "encode_bgr", encode)
    return records, frames


@pytest.mark.parametrize("mode", ["texture", "world_tiles"])
def test_generator_card_matches_cpu(cuda, tmp_path, monkeypatch, mode):
    """SyntheticMission on the card against the CPU: the same poses and
    pix4d.csv bytes; textures and frames within one gray level on ≥ 99.9%
    of texels and pixels (the texture arithmetic emulates its fmas in
    float64 on both, so it comes out equal)."""
    from imageanalysis_tpu_torch.testing import synthetic

    tex = {dev: synthetic.cv_ground_texture(np.random.default_rng(5), 1707,
                                            device=dev).cpu()
           for dev in ("cuda", "cpu")}
    d = (tex["cuda"].int() - tex["cpu"].int()).abs()
    assert d.max() <= 1 and (d == 0).float().mean() >= 0.999
    kw = (dict(n_images=8, img_size=(320, 240), altitude=100.0, spacing=6.0,
               fx=280.0, seed=11, rows=2) if mode == "texture" else
          dict(n_images=4, img_size=(640, 480), altitude=90.0, spacing=12.0,
               seed=3, texture_res=0.15, world_tiles=True))
    out = {}
    for dev in ("cuda", "cpu"):
        m = synthetic.SyntheticMission(str(tmp_path / dev), device=dev, **kw)
        records, frames = _generate_recording(monkeypatch, m)
        pix4d = open(tmp_path / dev / "pix4d.csv").read()
        out[dev] = (records, frames, pix4d)
    (rc, fc, pc), (rp, fp, pp) = out["cuda"], out["cpu"]
    assert pc == pp
    assert [(n, list(ned), ypr) for n, ned, ypr in rc] == \
        [(n, list(ned), ypr) for n, ned, ypr in rp]
    assert len(fc) == len(fp) == kw["n_images"]
    for a, b in zip(fc, fp):
        d = (a.int() - b.int()).abs()
        assert d.max() <= 1 and (d == 0).float().mean() >= 0.999


def test_generator_card_memory_flat(cuda, tmp_path, monkeypatch):
    """A 2-row world-tiles mission of 50 frames of 2176×1440 (the survey
    layout of benchmarks/mission_bench.py): from frame 10 on, the card
    memory held as a frame starts, less the tile cache (at most 32 tiles)
    and the frame's patch, stays where it was, and no frame's peak above
    them grows with the frame count."""
    from imageanalysis_tpu_torch.testing import synthetic

    def held(t):        # the caching allocator's blocks: 512-byte steps
        return -(-t.numel() * t.element_size() // 512) * 512

    fx = 1400.0
    m = synthetic.SyntheticMission(
        str(tmp_path / "m"), n_images=50, img_size=(2176, 1440),
        altitude=100.0, spacing=0.25 * 2176 / fx * 100.0, fx=fx,
        texture_res=2.0 * 100.0 / fx, rows=2, seed=42, world_tiles=True,
        device="cuda")
    before, peaks, tiles = [], [], []
    render = m._render

    def measured(tex, *a):
        torch.cuda.synchronize()
        base = sum(held(t) for t in m.world._cache.values()) + held(tex)
        before.append(torch.cuda.memory_allocated() - base)
        torch.cuda.reset_peak_memory_stats()
        render(tex, *a)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base)
        tiles.append(len(m.world._cache))

    monkeypatch.setattr(m, "_render", measured)
    m.generate()
    assert len(before) == 50 and max(tiles) <= 32
    assert before[9:] == [before[9]] * 41, before
    assert max(peaks[10:]) <= max(peaks[:10]) * 1.5, peaks

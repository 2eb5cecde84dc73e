"""Port parity: the 2-NN kernels K1 (packed keys, every mode) and K3
(wide keys), knn_top2's dispatch, the CPU arm and match_pair_dense.

The same seeded numpy inputs go through the JAX package (its Pallas
kernels in interpret mode, as tests/test_ops_knn.py runs them on the CPU)
and through imageanalysis_tpu_torch, at SIFT's 128 values a row and at
ORB's 256 (its bits as int8 −128/−127 in the store, 0..255-valued floats
on the chunked path). On integer-valued descriptors the
distances are integer arithmetic in every mode, so the comparisons are
bit-exact; on random float descriptors indices agree modulo ties and
values within 2⁻⁹ relative (the packed keys' truncation plus f32
accumulation order, the bound of tests/test_ops_knn.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageanalysis_tpu.ops import knn as jknn
from imageanalysis_tpu_torch.ops import knn as tknn
from torch_threads import one_torch_thread  # noqa: F401


def _planted(rng, n_a, n_b, n_planted, dim=128):
    """int8 (value − 128) SIFT-like rows; B's first n_planted rows are A's
    plus small noise, so the 2-NN has true matches and near ties."""
    a = rng.integers(0, 100, (n_a, dim))
    b = rng.integers(0, 100, (n_b, dim))
    b[:n_planted] = np.clip(
        a[:n_planted] + rng.integers(-4, 5, (n_planted, dim)), 0, 255)
    return (a - 128).astype(np.int8), (b - 128).astype(np.int8)


def _planted_bits(rng, n_a, n_b, n_planted):
    """ORB-like rows: 256 bits as the store holds them (int8 −128/−127);
    B's first n_planted rows are A's with 8 bits flipped. Distances are
    small integers, so exact ties abound."""
    a = rng.integers(0, 2, (n_a, 256))
    b = rng.integers(0, 2, (n_b, 256))
    b[:n_planted] = a[:n_planted]
    flip = np.argsort(rng.random((n_planted, 256)), axis=1)[:, :8]
    np.put_along_axis(b[:n_planted], flip,
                      1 - np.take_along_axis(b[:n_planted], flip, 1), 1)
    return (a - 128).astype(np.int8), (b - 128).astype(np.int8)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _jax_packed(a, b):
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    na2 = jnp.sum(jnp.square(ja.astype(jnp.int32)), -1, keepdims=True)
    nb2 = jnp.sum(jnp.square(jb.astype(jnp.int32)), -1, keepdims=True)
    rp, cp = jknn._knn_packed_raw(ja, jb, na2, nb2, 256, b.shape[0])
    return np.asarray(rp), np.asarray(cp)[0]


@pytest.mark.parametrize("dim", [128, 256])
def test_knn_packed_plain_bit_exact_vs_pallas(rng, dim):
    a, b = (_planted(rng, 512, 768, 200) if dim == 128
            else _planted_bits(rng, 512, 768, 200))
    rp, cp = _jax_packed(a, b)
    trp, tcp = tknn.knn_packed_plain(_t(a)[None], _t(b)[None])
    np.testing.assert_array_equal(trp[0].numpy(), rp)
    np.testing.assert_array_equal(tcp[0].numpy(), cp)


def test_knn_top2_decode_bit_exact_vs_pallas(rng):
    a, b = _planted(rng, 512, 768, 300)
    want = [np.asarray(x) for x in jknn.knn_top2(jnp.asarray(a),
                                                 jnp.asarray(b))]
    got = [x[0].numpy() for x in tknn.knn_top2(_t(a)[None], _t(b)[None])]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_knn_packed_raw_on_cpu_is_plain_and_uncounted(rng):
    a, b = _planted(rng, 2 * 64, 3 * 64, 50)
    a2 = np.stack([a, a[::-1]])
    b2 = np.stack([b, b[::-1]])
    before = dict(tknn.LAUNCHES)
    got = tknn.knn_packed_raw(_t(a2), _t(b2))
    want = tknn.knn_packed_plain(_t(a2), _t(b2))
    assert tknn.LAUNCHES == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # a batch of pairs equals the pairs one at a time
    one = tknn.knn_packed_plain(_t(a2[1:]), _t(b2[1:]))
    assert torch.equal(got[0][1], one[0][0])
    assert torch.equal(got[1][1], one[1][0])


@pytest.mark.parametrize("mutual", [True, False])
def test_match_pair_dense_bit_exact_vs_reference(rng, mutual):
    a, b = _planted(rng, 512, 768, 250)
    n_a, n_b = 480, 700
    uv_b = rng.uniform(0, 4000, (768, 2)).astype(np.float32)
    bj, ok, pb = (np.asarray(x) for x in jknn.match_pair_dense(
        jnp.asarray(a), jnp.asarray(b), n_a, n_b, ratio=0.75, mutual=mutual,
        use_pallas=True, uv_b=jnp.asarray(uv_b)))
    tbj, tok, tpb = (x[0].numpy() for x in tknn.match_pair_dense(
        _t(a)[None], _t(b)[None], torch.tensor([n_a]), torch.tensor([n_b]),
        ratio=0.75, mutual=mutual, use_pallas=True, uv_b=_t(uv_b)[None]))
    np.testing.assert_array_equal(tbj, bj)
    np.testing.assert_array_equal(tok, ok)
    np.testing.assert_array_equal(tpb, pb)
    assert ok.sum() > 150                      # the planted pairs survive


def test_knn_top2_ref_matches_reference(rng):
    a = rng.uniform(0, 120, (96, 128)).astype(np.float32)
    b = rng.uniform(0, 120, (80, 128)).astype(np.float32)
    for bf16 in (False, True):
        want = [np.asarray(x) for x in jknn.knn_top2_ref(
            jnp.asarray(a), jnp.asarray(b), bf16=bf16)]
        got = [x.numpy() for x in tknn.knn_top2_ref(_t(a), _t(b),
                                                    bf16=bf16)]
        # f32 sums in another order: distances to f32 rounding of ~1e6
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
        np.testing.assert_allclose(got[2], want[2], rtol=1e-5)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[3], want[3])


def test_pad_descriptors_matches_reference(rng):
    d = rng.uniform(0, 200, (37, 128)).astype(np.float32)
    want = np.asarray(jknn.pad_descriptors(jnp.asarray(d), 64))
    np.testing.assert_array_equal(tknn.pad_descriptors(_t(d), 64).numpy(),
                                  want)


def test_k1_wrapper_rejects_unported_modes():
    """What K1 does not take raises: float descriptors without their f32
    norms, more rows than 13 index bits hold (knn_top2 sends those to K3),
    other dtypes and unbatched shapes; a gate beyond 8192 rows has no
    kernel (the reference's knn_top2 raises there too)."""
    f = torch.zeros((1, 64, 128), dtype=torch.float32)
    with pytest.raises(ValueError, match="norms"):
        tknn.knn_packed_raw(f, f)
    big = torch.zeros((1, 8192 + 64, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match="8192"):
        tknn.knn_packed_raw(big, big)
    i16 = torch.zeros((1, 64, 128), dtype=torch.int16)
    with pytest.raises(ValueError, match="no mode"):
        tknn.knn_packed_raw(i16, i16)
    with pytest.raises(ValueError):
        tknn.knn_packed_raw(torch.zeros((64, 128), dtype=torch.int8),
                            torch.zeros((64, 128), dtype=torch.int8))
    uv = torch.zeros((1, 8192 + 64, 2))
    with pytest.raises(NotImplementedError):
        tknn.knn_top2(big, big, gate_uv_a=uv, gate_pred_b=uv,
                      gate_radius=10.0)
    with pytest.raises(ValueError, match="bf16 or f32"):
        tknn.knn_wide_raw(big, big, None, None)
    w = torch.zeros((1, 64, 192), dtype=torch.int8)    # neither 128 nor 256
    with pytest.raises(ValueError, match="128 or 256"):
        tknn.knn_packed_raw(w, w)
    with pytest.raises(ValueError, match="128 or 256"):
        tknn.knn_packed_raw(torch.zeros((1, 64, 128), dtype=torch.int8),
                            torch.zeros((1, 64, 256), dtype=torch.int8))


# ---------------------------------------------------------------------------
# K1's float and gated modes, K3, and knn_top2's dispatch
# ---------------------------------------------------------------------------

def _planted_u8(rng, n_a, n_b, n_planted, dim=128):
    """Integer-valued 0..255 SIFT-like float32 rows (the chunked path's
    descriptors); B's first n_planted rows are A's plus small noise."""
    a, b = _planted(rng, n_a, n_b, n_planted, dim)
    return ((a.astype(np.int16) + 128).astype(np.float32),
            (b.astype(np.int16) + 128).astype(np.float32))


def _jax_top2(a, b, **kw):
    return [np.asarray(x) for x in jknn.knn_top2(jnp.asarray(a),
                                                 jnp.asarray(b), **kw)]


def _port_top2(a, b, **kw):
    kw = {k: _t(v)[None] if isinstance(v, np.ndarray) else v
          for k, v in kw.items()}
    return [x[0].numpy() for x in tknn.knn_top2(_t(a)[None], _t(b)[None],
                                                **kw)]


def _d2_full(a, b, bf16):
    """float64 distances of the operands the kernels multiply (bf16-rounded
    when bf16) with the norms of the unrounded rows."""
    na2 = (a.astype(np.float64) ** 2).sum(1)
    nb2 = (b.astype(np.float64) ** 2).sum(1)
    if bf16:
        a = torch.from_numpy(a).bfloat16().double().numpy()
        b = torch.from_numpy(b).bfloat16().double().numpy()
    return na2[:, None] + nb2[None, :] - 2.0 * (a.astype(np.float64)
                                                @ b.astype(np.float64).T)


def _equal_modulo_ties(got, want, d_full, rtol=2.0 ** -9, atol=0.0):
    """Index equality except where the two picks' distances tie within
    rtol·d + atol (the ratio and mutual tests cannot tell those apart)."""
    rows = np.nonzero(got != want)[0]
    for r in rows:
        dg, dw = d_full[r, got[r]], d_full[r, want[r]]
        assert abs(dg - dw) <= rtol * abs(dw) + atol, (r, dg, dw)
    return len(rows)


@pytest.mark.parametrize("dim", [128, 256])
@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
def test_k1_float_modes_bit_exact_vs_pallas(rng, bf16, dim):
    """K1's bf16 and f32 modes (the chunked path's f32 descriptors) on
    integer-valued inputs: every decoded value and index bit-exact."""
    a, b = _planted_u8(rng, 512, 1024, 256, dim)
    want = _jax_top2(a, b, bf16=bf16)
    got = _port_top2(a, b, bf16=bf16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _twins(rng, n=256):
    """tests/test_ops_knn.py's twin descriptor sets: every A row has a
    near-identical twin 500 px away, and a perfect position prior."""
    base = rng.integers(0, 200, (n // 2, 128))

    def noise():
        return rng.integers(-2, 3, (n // 2, 128))

    a8 = np.clip(np.concatenate([base + noise(), base + noise()]), 0, 255)
    b8 = np.clip(np.concatenate([base + noise(), base + noise()]), 0, 255)
    uv_a = np.zeros((n, 2), np.float32)
    uv_a[:, 0] = 100.0 + 500.0 * (np.arange(n) >= n // 2)
    uv_a[:, 1] = np.tile(np.arange(n // 2) * 3.0, 2)
    return a8, b8, uv_a


@pytest.mark.parametrize("dtype", ["int8", "bf16", "f32"])
def test_k1_gated_bit_exact_vs_pallas(rng, dtype):
    """K1's gated mode on the twins case (test_ops_knn.py:220): the plain
    version equals the gated Pallas kernel bit for bit, and the gate
    recovers the true correspondences that the ratio test alone loses."""
    a8, b8, uv_a = _twins(rng)
    if dtype == "int8":
        a, b = ((x - 128).astype(np.int8) for x in (a8, b8))
    else:
        a, b = a8.astype(np.float32), b8.astype(np.float32)
    gate = dict(gate_uv_a=uv_a, gate_pred_b=uv_a, gate_radius=50.0)
    kw = {} if dtype == "int8" else {"bf16": dtype == "bf16"}
    want = _jax_top2(a, b, **gate, **kw)
    got = _port_top2(a, b, **gate, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    n = len(a)
    bj, ok = (x[0].numpy() for x in tknn.match_pair_dense(
        _t(a)[None], _t(b)[None], torch.tensor([n]), torch.tensor([n]),
        use_pallas=True, gate_uv_a=_t(uv_a)[None], gate_pred_b=_t(uv_a)[None],
        gate_radius=50.0, **kw))
    assert ok.sum() > 0.9 * n
    assert np.array_equal(bj[ok], np.arange(n)[ok])
    _, ok_plain = tknn.match_pair_dense(_t(a)[None], _t(b)[None],
                                        torch.tensor([n]), torch.tensor([n]),
                                        use_pallas=True, **kw)
    assert ok_plain.sum() < 0.1 * n


@pytest.mark.parametrize("device,use_pallas,gated,n_rows,want", [
    ("cpu", None, False, 256, False),
    ("cpu", True, False, 8448, True),
    ("cpu", True, True, 8192, True),
    ("cpu", True, True, 8448, False),     # the reference keeps the gate
    ("cuda", None, True, 8448, True),     # knn_top2 raises there
    ("cuda", True, False, 256, True),
    ("cuda", False, False, 256, ValueError),
])
def test_kernel_arm_follows_reference_on_cpu_and_kernels_on_card(
        device, use_pallas, gated, n_rows, want):
    """The 2-NN arm of match_pair_dense: a CPU tensor picks as the
    reference does by use_pallas; a CUDA tensor always takes the
    kernels."""
    args = (torch.device(device), use_pallas, gated, n_rows)
    if want is ValueError:
        with pytest.raises(ValueError):
            tknn.kernel_arm(*args)
    else:
        assert tknn.kernel_arm(*args) is want


def test_cpu_arm_gate_matches_reference(rng):
    """knn_top2_ref's gate (the CPU arm of the smart path) against the
    reference's: distances to f32 rounding, indices exact."""
    a8, b8, uv_a = _twins(rng, 128)
    pred = uv_a + rng.normal(0, 30.0, uv_a.shape).astype(np.float32)
    a, b = a8.astype(np.float32), b8.astype(np.float32)
    want = [np.asarray(x) for x in jknn.knn_top2_ref(
        jnp.asarray(a), jnp.asarray(b), bf16=True,
        gate_uv_a=jnp.asarray(uv_a), gate_pred_b=jnp.asarray(pred),
        gate_radius=40.0)]
    got = [x.numpy() for x in tknn.knn_top2_ref(
        _t(a), _t(b), bf16=True, gate_uv_a=_t(uv_a), gate_pred_b=_t(pred),
        gate_radius=40.0)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dim", [128, 256])
@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_k3_bit_exact_vs_pallas(rng, dtype, dim):
    """K3 at (256, 8448): knn_top2's dispatch sends it beyond 8192 rows
    (int8 cast to bf16); the default tiles give a (2, 1) grid. Values,
    row_i[:, 0] and col_i bit-exact on integer inputs; row_i[:, 1] equal
    modulo ties (the Pallas merge and the 64-bit keys may name different
    second indices on an exact tie; only the two values and the best
    index are used downstream). At 256 the rows are ORB's bits in int8,
    or 0..255-valued floats."""
    if dim == 256 and dtype == "int8":
        a, b = _planted_bits(rng, 256, 8448, 200)
    else:
        a, b = _planted(rng, 256, 8448, 200, dim)
    bf16 = True
    if dtype == "bf16":
        a, b = ((x.astype(np.int16) + 128).astype(np.float32) for x in (a, b))
    want = _jax_top2(a, b, bf16=bf16)
    got = _port_top2(a, b, bf16=bf16)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1][:, 0], want[1][:, 0])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    _equal_modulo_ties(got[1][:, 1], want[1][:, 1],
                       _d2_full(a.astype(np.float32), b.astype(np.float32),
                                False), rtol=0.0)


def test_k1_k3_random_floats_within_tolerance(rng):
    """Random (non-integer) float descriptors, K1 in its bf16 mode (512 ×
    1024) and K3 in its f32 mode (128 × 8448). The f32 sums run in
    another order, so: values within 2⁻⁹ relative (the packed keys'
    truncation) plus 2⁻²⁰·max(‖a‖² + ‖b‖²) absolute (f32 cancellation in
    (‖a‖² + ‖b‖²) − 2a·b, which near-duplicates expose), and indices equal
    modulo ties within that bound."""
    for (n_a, n_b), bf16 in (((512, 1024), True), ((128, 8448), False)):
        a = rng.uniform(0, 400, (n_a, 128)).astype(np.float32)
        b = rng.uniform(0, 400, (n_b, 128)).astype(np.float32)
        b[:100] = a[:100] + rng.normal(0, 2.0, (100, 128))
        want = _jax_top2(a, b, bf16=bf16)
        got = _port_top2(a, b, bf16=bf16)
        d_full = _d2_full(a, b, bf16)
        atol = 2.0 ** -20 * float((a.astype(np.float64) ** 2).sum(1).max()
                                  + (b.astype(np.float64) ** 2).sum(1).max())
        for col in (0, 1):
            _equal_modulo_ties(got[1][:, col], want[1][:, col], d_full,
                               atol=atol)
        _equal_modulo_ties(got[3], want[3], d_full.T, atol=atol)
        np.testing.assert_allclose(got[0], want[0], rtol=2.0 ** -9,
                                   atol=atol)
        np.testing.assert_allclose(got[2], want[2], rtol=2.0 ** -9,
                                   atol=atol)


@pytest.mark.parametrize("dim", [128, 256])
def test_split_bf16x3_plain_reconstructs_exactly(rng, dim):
    """K1 f32's pre-pass, plain version, at SIFT's 128 values a row and
    ORB's 256: the three bf16 planes of seeded f32 descriptors (uniform
    SIFT-like, normal, integer) add up to the value exactly, hi is the
    value rounded to bf16, and |mid| ≤ 2⁻⁸ |x|, |lo| ≤ 2⁻¹⁶ |x| (the
    orders the product relies on)."""
    x = np.concatenate([rng.uniform(0, 512, (64, dim)),
                        rng.normal(0, 100, (64, dim)),
                        rng.integers(0, 256, (64, dim))]).astype(np.float32)
    t = _t(x)
    planes = tknn.split_bf16x3_plain(t)
    assert planes.shape == (192, 3, dim) and planes.dtype == torch.bfloat16
    hi, mid, lo = (planes[:, i].double() for i in range(3))
    assert torch.equal(hi + mid + lo, t.double())
    assert torch.equal(planes[:, 0], t.bfloat16())
    ax = t.double().abs()
    assert bool((mid.abs() <= 2.0 ** -8 * ax).all())
    assert bool((lo.abs() <= 2.0 ** -16 * ax).all())
    assert not bool((planes[128:, 1:] != 0).any())    # integers: hi only

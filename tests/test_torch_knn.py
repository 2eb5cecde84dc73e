"""Port parity: packed int8 2-NN (kernel K1) and match_pair_dense.

The same seeded numpy inputs go through the JAX package (its Pallas K1 in
interpret mode, as tests/test_ops_knn.py runs it on the CPU) and through
imageanalysis_tpu_torch. Packed keys are integer arithmetic, so the
comparisons are bit-exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageanalysis_tpu.ops import knn as jknn
from imageanalysis_tpu_torch.ops import knn as tknn


def _planted(rng, n_a, n_b, n_planted):
    """int8 (value − 128) SIFT-like rows; B's first n_planted rows are A's
    plus small noise, so the 2-NN has true matches and near ties."""
    a = rng.integers(0, 100, (n_a, 128))
    b = rng.integers(0, 100, (n_b, 128))
    b[:n_planted] = np.clip(
        a[:n_planted] + rng.integers(-4, 5, (n_planted, 128)), 0, 255)
    return (a - 128).astype(np.int8), (b - 128).astype(np.int8)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _jax_packed(a, b):
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    na2 = jnp.sum(jnp.square(ja.astype(jnp.int32)), -1, keepdims=True)
    nb2 = jnp.sum(jnp.square(jb.astype(jnp.int32)), -1, keepdims=True)
    rp, cp = jknn._knn_packed_raw(ja, jb, na2, nb2, 256, b.shape[0])
    return np.asarray(rp), np.asarray(cp)[0]


def test_knn_packed_plain_bit_exact_vs_pallas(rng):
    a, b = _planted(rng, 512, 768, 200)
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
    before = tknn.KNN_PACKED_LAUNCHES
    got = tknn.knn_packed_raw(_t(a2), _t(b2))
    want = tknn.knn_packed_plain(_t(a2), _t(b2))
    assert tknn.KNN_PACKED_LAUNCHES == before
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
        ratio=0.75, mutual=mutual, uv_b=_t(uv_b)[None]))
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
    f = torch.zeros((1, 64, 128), dtype=torch.float32)
    with pytest.raises(NotImplementedError):
        tknn.knn_packed_raw(f, f)
    big = torch.zeros((1, 8192 + 64, 128), dtype=torch.int8)
    with pytest.raises(NotImplementedError):
        tknn.knn_packed_raw(big, big)
    with pytest.raises(ValueError):
        tknn.knn_packed_raw(torch.zeros((64, 128), dtype=torch.int8),
                            torch.zeros((64, 128), dtype=torch.int8))

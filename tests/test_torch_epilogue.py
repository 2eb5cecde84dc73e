"""Port parity: kernel K4 (the fused match epilogue), knn_match_fused and
the fused arm of match_pair_dense.

The same seeded numpy inputs go through the JAX package's knn_match_fused
(K1 and K4 as Pallas kernels in interpret mode, as tests/test_ops_knn.py
runs them on the CPU) and through the port, where a CPU tensor takes the
kernels' plain versions. Integer-valued descriptors make every distance
exact integer arithmetic, so best_j, ok and pb are compared bit for bit
(pb is an exact gather). The cases follow tests/test_ops_knn.py:147-215:
packed int8, the gated twins, and float descriptors, which the fused path
always runs in bf16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageanalysis_tpu.ops import knn as jknn
from imageanalysis_tpu_torch.ops import knn as tknn
from torch_threads import one_torch_thread  # noqa: F401


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _packed_case(rng):
    """tests/test_ops_knn.py's packed-exact case: 512 × 640 int8 rows, 200
    planted."""
    a8 = rng.integers(0, 256, (512, 128)).astype(np.uint8)
    b8 = rng.integers(0, 256, (640, 128)).astype(np.uint8)
    b8[:200] = np.clip(a8[:200].astype(int)
                       + rng.integers(-3, 4, (200, 128)), 0, 255)
    a = (a8.astype(np.int16) - 128).astype(np.int8)
    b = (b8.astype(np.int16) - 128).astype(np.int8)
    uv_b = rng.uniform(0, 4000, (640, 2)).astype(np.float32)
    return a, b, uv_b, {}


def _gated_case(rng):
    """The twins of tests/test_ops_knn.py:196: every row has a near twin
    500 px away, and a perfect position prior behind a 50 px gate."""
    n = 256
    base = rng.integers(0, 200, (n // 2, 128))

    def noise():
        return rng.integers(-2, 3, (n // 2, 128))

    a8 = np.clip(np.concatenate([base + noise(), base + noise()]), 0, 255)
    b8 = np.clip(np.concatenate([base + noise(), base + noise()]), 0, 255)
    uv_a = np.zeros((n, 2), np.float32)
    uv_a[:, 0] = 100.0 + 500.0 * (np.arange(n) >= n // 2)
    uv_a[:, 1] = np.tile(np.arange(n // 2) * 3.0, 2)
    gate = dict(gate_uv_a=uv_a, gate_pred_b=uv_a, gate_radius=50.0)
    return ((a8 - 128).astype(np.int8), (b8 - 128).astype(np.int8),
            uv_a + 1.0, gate)


def _float_case(rng):
    """The packed case as integer-valued 0..255 float rows (the chunked
    path's descriptors): exact in bf16, and every dot below 2²⁴."""
    a, b, uv_b, _ = _packed_case(rng)
    return (a.astype(np.float32) + 128.0, b.astype(np.float32) + 128.0,
            uv_b, {})


_CASES = {"packed": _packed_case, "gated": _gated_case,
          "float": _float_case}


def _reference_fused(a, b, uv_b, gate):
    jgate = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
             for k, v in gate.items()}
    return [np.asarray(x) for x in jknn.knn_match_fused(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(uv_b), ratio=0.75,
        **jgate)]


def _port_fused(a, b, uv_b, gate):
    tgate = {k: _t(v)[None] if isinstance(v, np.ndarray) else v
             for k, v in gate.items()}
    return [x[0].numpy() for x in tknn.knn_match_fused(
        _t(a)[None], _t(b)[None], _t(uv_b)[None], ratio=0.75, **tgate)]


@pytest.mark.parametrize("case", sorted(_CASES))
def test_knn_match_fused_bit_exact_vs_reference(rng, case):
    """The port's knn_match_fused (K1's and K4's plain versions on a CPU
    tensor, no kernel launch) against the reference's two Pallas
    launches."""
    a, b, uv_b, gate = _CASES[case](rng)
    want = _reference_fused(a, b, uv_b, gate)
    before = dict(tknn.LAUNCHES)
    got = _port_fused(a, b, uv_b, gate)
    assert tknn.LAUNCHES == before
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert want[1].sum() > 100                 # the planted rows survive


def test_epilogue_plain_equals_unfused_decode(rng):
    """K4's plain version on K1's raw keys reproduces the unfused decode
    (knn_top2, ratio on the decoded values, col_i[best_j] == i, uv_b
    gather) bit for bit, over a batch of two pairs."""
    a, b, uv_b, _ = _packed_case(rng)
    a2, b2 = _t(np.stack([a, a[::-1]])), _t(np.stack([b, b[::-1]]))
    uv2 = _t(np.stack([uv_b, uv_b[::-1]]))
    row_p, col_p = tknn.knn_packed_plain(a2, b2)
    bj, ok, pb = tknn.match_epilogue_plain(row_p, col_p, uv2, 0.75)
    row_d, row_i, _, col_i = tknn.knn_top2(a2, b2)
    want_bj = row_i[..., 0]
    d1 = row_d[..., 0].clamp_min(0.0)
    d2 = row_d[..., 1].clamp_min(0.0)
    want_ok = (d1 < 0.75 ** 2 * d2) & (
        torch.gather(col_i, 1, want_bj.long())
        == torch.arange(512, dtype=torch.int32))
    assert torch.equal(bj, want_bj) and torch.equal(ok, want_ok)
    assert torch.equal(pb, torch.gather(
        uv2, 1, want_bj.long()[..., None].expand(-1, -1, 2)))
    raw = tknn.match_epilogue_raw(row_p, col_p, uv2, 0.75)
    for g, w in zip(raw, (bj, ok, pb)):
        assert torch.equal(g, w)


def _dense(a, b, n_a, n_b, uv_b, **kw):
    return tknn.match_pair_dense(
        _t(a)[None], _t(b)[None], torch.tensor([n_a]), torch.tensor([n_b]),
        ratio=0.75, use_pallas=True, uv_b=_t(uv_b)[None], **kw)


def _spy_fused(monkeypatch):
    calls = []
    fused = tknn.knn_match_fused

    def spy(*args, **kw):
        calls.append(1)
        return fused(*args, **kw)

    monkeypatch.setattr(tknn, "knn_match_fused", spy)
    return calls


def test_match_pair_dense_fused_arm_equals_unfused_on_int8(rng,
                                                          monkeypatch):
    """IMGTPU_FUSED_EPILOGUE=1, read when match_pair_dense decides, sends
    the kernel arm through knn_match_fused; on int8 its outputs equal the
    unfused arm's bit for bit, padded rows masked the same way."""
    a, b, uv_b, _ = _packed_case(rng)
    calls = _spy_fused(monkeypatch)
    monkeypatch.delenv("IMGTPU_FUSED_EPILOGUE", raising=False)
    want = _dense(a, b, 480, 600, uv_b)
    assert not calls
    monkeypatch.setenv("IMGTPU_FUSED_EPILOGUE", "1")
    got = _dense(a, b, 480, 600, uv_b)
    assert len(calls) == 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # "0" is off, as the reference's switch
    monkeypatch.setenv("IMGTPU_FUSED_EPILOGUE", "0")
    _dense(a, b, 480, 600, uv_b)
    assert len(calls) == 1


def test_match_pair_dense_fused_arm_runs_bf16_on_floats(rng, monkeypatch):
    """The trap of knn.py:337-342: on float descriptors the fused arm runs
    K1's bf16 mode even with bf16=False; it equals the reference's
    knn_match_fused with match_pair_dense's masks, and the gate passes
    through."""
    fa, fb, uv_b, _ = _float_case(rng)
    monkeypatch.setenv("IMGTPU_FUSED_EPILOGUE", "1")
    calls = _spy_fused(monkeypatch)
    k1_dtypes = []
    packed_raw = tknn.knn_packed_raw

    def spy_k1(a, *args, **kw):
        k1_dtypes.append(a.dtype)
        return packed_raw(a, *args, **kw)

    monkeypatch.setattr(tknn, "knn_packed_raw", spy_k1)
    got = [x[0].numpy() for x in _dense(fa, fb, 480, 600, uv_b, bf16=False)]
    assert k1_dtypes == [torch.bfloat16]
    bj, ok, pb = _reference_fused(fa, fb, uv_b, {})
    ok = ok & (np.arange(512) < 480) & (bj < 600)
    for g, w in zip(got, (bj, ok, pb)):
        np.testing.assert_array_equal(g, w)
    a, b, uv, gate = _gated_case(rng)
    n = len(a)
    got = [x[0].numpy() for x in _dense(
        a, b, n, n, uv, gate_uv_a=_t(gate["gate_uv_a"])[None],
        gate_pred_b=_t(gate["gate_pred_b"])[None], gate_radius=50.0)]
    assert len(calls) == 2
    assert got[1].sum() > 0.9 * n
    assert np.array_equal(got[0][got[1]], np.arange(n)[got[1]])


def test_match_epilogue_raw_refuses_what_it_does_not_take():
    """Wrong dtypes, shapes or devices raise; nothing runs."""
    row_p = torch.zeros((1, 64, 2), dtype=torch.int32)
    col_p = torch.zeros((1, 64), dtype=torch.int32)
    uv_b = torch.zeros((1, 64, 2))
    before = dict(tknn.LAUNCHES)
    with pytest.raises(ValueError, match="int32"):
        tknn.match_epilogue_raw(row_p.long(), col_p, uv_b)
    with pytest.raises(ValueError, match="int32"):
        tknn.match_epilogue_raw(row_p, col_p, uv_b.double())
    with pytest.raises(ValueError, match="need row_p"):
        tknn.match_epilogue_raw(row_p, col_p[:, :32], uv_b)
    with pytest.raises(ValueError, match="no kernel"):
        tknn.match_epilogue_raw(*(x.to("meta") for x in (row_p, col_p,
                                                         uv_b)))
    assert tknn.LAUNCHES == before

"""Card-only tests of the port's CUDA kernels; they skip without a card.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed. tests/conftest.py imports JAX, so there run it
without the conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Each kernel is held against its plain PyTorch version on the same card.
On integer-valued descriptors K1 (every mode) and K3 are integer
arithmetic in f32 or int32, and K2 rounds the same f32 products and sums
one by one, so the comparisons are bit-exact.
"""

import numpy as np
import pytest
import torch

from imageanalysis_tpu_torch.features import sift
from imageanalysis_tpu_torch.ops import knn

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


def _planted(rng, pairs, n_a, n_b, n_planted):
    a = rng.integers(0, 100, (pairs, n_a, 128))
    b = rng.integers(0, 100, (pairs, n_b, 128))
    b[:, :n_planted] = np.clip(
        a[:, :n_planted] + rng.integers(-4, 5, (pairs, n_planted, 128)), 0,
        255)
    return (torch.from_numpy((a - 128).astype(np.int8)),
            torch.from_numpy((b - 128).astype(np.int8)))


@pytest.mark.parametrize("n_a,n_b", [(512, 768), (64, 8192)])
def test_k1_bit_exact_vs_plain(cuda, rng, n_a, n_b):
    a, b = (t.to(cuda) for t in _planted(rng, 3, n_a, n_b, 50))
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


def _gate(rng, cuda, pairs, n_a, n_b):
    """uv_a and a prediction that lands ~half the candidates inside a
    200 px gate."""
    uv_a = torch.from_numpy(rng.uniform(0, 1000, (pairs, n_a, 2))
                            .astype(np.float32)).to(cuda)
    pred = torch.from_numpy(rng.uniform(0, 1000, (pairs, n_b, 2))
                            .astype(np.float32)).to(cuda)
    return uv_a, pred, 200.0 ** 2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_k1_float_modes_bit_exact_vs_plain(cuda, rng, dtype):
    a, b = (t.to(cuda) for t in _planted(rng, 3, 512, 768, 50))
    args = _float_inputs(a, b, dtype)
    key = "knn_packed_bf16" if dtype == torch.bfloat16 else "knn_packed_f32"
    before = knn.LAUNCHES[key]
    got = knn.knn_packed_raw(*args)
    assert knn.LAUNCHES[key] == before + 1
    want = knn.knn_packed_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16,
                                   torch.float32],
                         ids=["int8", "bf16", "f32"])
def test_k1_gated_bit_exact_vs_plain(cuda, rng, dtype):
    a, b = (t.to(cuda) for t in _planted(rng, 3, 512, 768, 50))
    args = (a, b, None, None) if dtype == torch.int8 else \
        _float_inputs(a, b, dtype)
    gate = _gate(rng, cuda, 3, 512, 768)
    before = knn.LAUNCHES["knn_packed_gated"]
    got = knn.knn_packed_raw(*args, *gate)
    assert knn.LAUNCHES["knn_packed_gated"] == before + 1
    want = knn.knn_packed_plain(*args, *gate)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the gate is on: it moves the result away from the ungated one
    assert not torch.equal(got[0], knn.knn_packed_raw(*args)[0])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_k3_bit_exact_vs_plain(cuda, rng, dtype):
    a, b = (t.to(cuda) for t in _planted(rng, 2, 256, 8448, 100))
    args = _float_inputs(a, b, dtype)
    before = knn.LAUNCHES["knn_wide"]
    got = knn.knn_wide_raw(*args)
    assert knn.LAUNCHES["knn_wide"] == before + 1
    want = knn.knn_wide_plain(*args)
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
                          seed=11).frames
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

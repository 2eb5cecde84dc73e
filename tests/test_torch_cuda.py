"""Card-only tests of the port's CUDA kernels; they skip without a card.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed. tests/conftest.py imports JAX, so there run it
without the conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Each kernel is held against its plain PyTorch version on the same card.
Both are integer arithmetic (K1) or the same separately rounded f32
products and sums (K2), so the comparisons are bit-exact.
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
    before = knn.KNN_PACKED_LAUNCHES
    got = knn.knn_packed_raw(a, b)
    assert knn.KNN_PACKED_LAUNCHES == before + 1
    want = knn.knn_packed_plain(a, b)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert torch.equal(g, w)


def test_k1_refuses_what_it_does_not_take(cuda):
    f = torch.zeros((1, 64, 128), device=cuda)
    with pytest.raises(NotImplementedError):      # bf16/f32 modes
        knn.knn_packed_raw(f, f)
    odd = torch.zeros((1, 100, 128), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):               # not a multiple of 64
        knn.knn_packed_raw(odd, odd)
    before = knn.KNN_PACKED_LAUNCHES
    with pytest.raises(ValueError):               # CPU and CUDA mixed
        knn.knn_packed_raw(odd[:, :64], odd[:, :64].cpu())
    assert knn.KNN_PACKED_LAUNCHES == before


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

    frames, _, _ = make_mission(strips=1, per_strip=2, size=(320, 256),
                                seed=11)
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

"""Port parity: Gaussian blur (kernel K2) and the SIFT detector.

Inputs are seeded numpy arrays (or frames of the port's synthetic mission)
that go through the JAX package on the CPU and through
imageanalysis_tpu_torch. Tolerances and their reasons:

- blur: 2 ulp, or 1e-6 absolute on [0, 1] images — the port sums the taps
  in the reference's order in separate ops, but XLA on the CPU may
  contract a multiply and an add into one FMA;
- detect: ≥ 98% of the reference's keypoints have a port keypoint within
  0.05 px at the same octave and orientation, and on those the descriptor
  bytes are within 1 on ≥ 99% of entries — the 2× upsample, the 3×3
  solves and the atan2/exp of the orientation stage differ in the last
  bits, and descriptor bytes are rounded.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageanalysis_tpu.features import sift_tpu as jsift
from imageanalysis_tpu.ops import clahe as jclahe
from imageanalysis_tpu_torch.features import sift as tsift
from imageanalysis_tpu_torch.testing.synthetic import make_mission
from torch_threads import one_torch_thread  # noqa: F401

# every sigma the pyramid blurs with: the initial blur, then the five
# per-level increments
_SIGMAS = [(1.6**2 - 1.0) ** 0.5] + [
    1.6 * 2 ** ((i - 1) / 3) * (2 ** (2 / 3) - 1) ** 0.5 for i in range(1, 6)]


def _assert_blur_close(got, want):
    ulp = np.spacing(np.abs(want).astype(np.float32))
    err = np.abs(got - want)
    assert ((err <= 2 * ulp) | (err <= 1e-6)).all(), err.max()


@pytest.mark.parametrize("impl,sigma", [
    ("jnp", _SIGMAS[0]), ("jnp", _SIGMAS[2]), ("jnp", _SIGMAS[5]),
    ("pallas", _SIGMAS[0]), ("pallas", _SIGMAS[5])])
def test_blur_plain_matches_reference(rng, monkeypatch, impl, sigma):
    """Both arms of the reference _blur: the jnp tap sums, and the Pallas
    row kernel K2 in interpret mode (selected by patching BLUR_IMPL), at
    the fewest (9) and most (21) taps; the interpret mode's compile is
    the cost of each Pallas case."""
    monkeypatch.setattr(jsift, "BLUR_IMPL", impl)
    img = rng.uniform(0, 1, (2, 40, 56)).astype(np.float32)
    want = np.asarray(jsift._blur(jnp.asarray(img), sigma))
    got = tsift.blur_plain(torch.from_numpy(img),
                           tsift._gauss_kernel(sigma)).numpy()
    _assert_blur_close(got, want)


def test_blur_wrapper_on_cpu_is_plain_and_uncounted(rng):
    img = torch.from_numpy(rng.uniform(0, 1, (3, 33, 47)).astype(np.float32))
    before = tsift.BLUR_LAUNCHES
    for sigma in _SIGMAS:
        assert torch.equal(tsift._blur(img, sigma),
                           tsift.blur_plain(img, tsift._gauss_kernel(sigma)))
    assert tsift.BLUR_LAUNCHES == before
    with pytest.raises(ValueError):
        tsift._blur(img.double(), 1.6)


def test_downsample_and_octave_stack_match_reference(rng):
    img = rng.uniform(0, 1, (2, 48, 64)).astype(np.float32)
    gs_j, dogs_j = jsift._octave_stack(jnp.asarray(img), tsift.SIGMA0)
    gs_t, dogs_t = tsift._octave_stack(torch.from_numpy(img), tsift.SIGMA0)
    for gj, gt in zip(gs_j + dogs_j, gs_t + dogs_t):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=2e-6)
    np.testing.assert_array_equal(
        tsift._downsample2(gs_t[3]).numpy(),
        np.asarray(jsift._downsample2(jnp.asarray(gs_t[3].numpy()))))


@pytest.fixture(scope="module")
def detect_case():
    """One 256×320 frame of the port's mission, its CLAHE, and the
    reference detector run once on each (one compile: JAX's
    detect_dispatch(equalize=True) is clahe then _detect_batch)."""
    frames = make_mission(strips=1, per_strip=1, size=(320, 256),
                          seed=11, device="cpu").frames
    frame = frames.numpy()
    eq = np.array(jclahe.clahe(jnp.asarray(frame)))
    per_octave, n_octaves = tsift._octave_plan(256, 320, 512, True)

    def ref(x):
        return [np.asarray(o)[0] for o in jsift._detect_batch(
            jnp.asarray(x), per_octave, n_octaves, upsample=True,
            out_slots=512)]

    return frame, eq, (per_octave, n_octaves), ref(eq), ref(frame)


def _assert_detect_close(got, want):
    """got/want: (kp, meta, desc) of the valid slots."""
    (tkp, tmeta, tdesc), (jkp, jmeta, jdesc) = got, want
    assert len(jkp) > 150 and abs(len(tkp) - len(jkp)) <= 0.02 * len(jkp)
    dist = np.linalg.norm(jkp[:, None] - tkp[None], axis=-1)
    dang = np.abs((jmeta[:, None, 1] - tmeta[None, :, 1] + 180) % 360 - 180)
    same_oct = jmeta[:, None, 3] == tmeta[None, :, 3]
    cost = np.where(same_oct & (dang < 0.5), dist, np.inf)
    nn = cost.argmin(1)
    hit = cost[np.arange(len(jkp)), nn] < 0.05
    assert hit.mean() >= 0.98, hit.mean()
    dd = np.abs(jdesc[hit].astype(int) - tdesc[nn[hit]].astype(int))
    assert (dd <= 1).mean() >= 0.99, (dd <= 1).mean()


def test_detect_batch_matches_reference(detect_case):
    _, eq, (per_octave, n_octaves), want, _ = detect_case
    got = [o[0].numpy() for o in tsift._detect_batch(
        torch.from_numpy(eq), per_octave, n_octaves, upsample=True,
        out_slots=512)]
    assert [g.shape for g in got] == [w.shape for w in want]
    assert got[2].dtype == np.uint8 and want[2].dtype == np.uint8
    v_t, v_j = got[3], want[3]
    _assert_detect_close((got[0][v_t], got[1][v_t], got[2][v_t]),
                         (want[0][v_j], want[1][v_j], want[2][v_j]))


def test_detect_dispatch_equalize_matches_reference(detect_case):
    frame, _, _, want, _ = detect_case
    outs = tsift.detect_dispatch(torch.from_numpy(frame), max_features=512,
                                 equalize=True)
    assert [tuple(o.shape) for o in outs] == [(1,) + w.shape for w in want]
    (kp, meta, desc), = tsift.detect_finalize_batch(outs)
    assert desc.dtype == np.float32
    v = want[3]
    _assert_detect_close((kp, meta, desc), (want[0][v], want[1][v],
                                            want[2][v]))


def test_detect_without_clahe_matches_reference(detect_case):
    frame, _, _, _, want = detect_case
    kp, meta, desc, valid = tsift.detect_and_compute_batch(
        frame, max_features=512)
    v = want[3]
    _assert_detect_close((kp[0][valid[0]], meta[0][valid[0]],
                          desc[0][valid[0]]),
                         (want[0][v], want[1][v], want[2][v]))

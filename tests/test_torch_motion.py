"""Port parity: the motion tools (``motion/``) on the CPU.

The same seeded inputs go through the reference and the port (on the
CPU). Tolerances:

- ``exact_dmd``: the sorted eigenvalues within 1e-4, and each mode times
  its amplitude (free of the eigenvectors' scale and of the singular
  vectors' signs) within 1e-4 of its largest entry; ``background_model``'s
  background within 1e-3 of its range; ``segment_video``'s background
  within one grey level and its masks on at most 0.1% of the pixels apart;
- ``StreamingDMD`` from one carried state (``from_arrays``): ``update``'s
  operators in full coordinates (Qx Gx Qxᵀ, Qy Gy Qyᵀ, Qy A Qxᵀ, free of
  the bases' signs) and ``compute_modes``' eigenvalues within 1e-4;
- ``SparseLK``: the homography's translation within 0.05 px of the
  reference's and the inlier count within 2% (the RANSAC draws differ, so
  inlier counts are compared, not draws);
- ``estimate_k1_k2`` at 40 iterations: the loss history within rtol 1e-3,
  (k1, k2) within 1e-4.

A device that is neither the CPU nor CUDA raises at every entry point of
the video and motion tools.
"""

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp  # noqa: E402

from imageanalysis_tpu.motion import (  # noqa: E402
    flow as jflow, lens_distortion as jlens, segment as jsegment,
    streaming_dmd as jsdmd)
from imageanalysis_tpu_torch.apps import video as tvideo_app  # noqa: E402
from imageanalysis_tpu_torch.core import camera as tcamera  # noqa: E402
from imageanalysis_tpu_torch.motion import (  # noqa: E402
    flow as tflow, lens_distortion as tlens, segment as tsegment,
    streaming_dmd as tsdmd)
from imageanalysis_tpu_torch.testing import video as synth  # noqa: E402
from imageanalysis_tpu_torch.video import (  # noqa: E402
    correlate as tcorrelate, frame_motion as tframe_motion,
    stabilize as tstabilize)
from torch_threads import one_torch_thread  # noqa: E402,F401


def _planted_system(rng, n, T, lam, amp):
    """Snapshots (n, T) of a static mode and a conjugate pair (the
    reference's test_exact_dmd_recovers_dynamics)."""
    phi0 = rng.normal(size=n)
    phic = rng.normal(size=n) + 1j * rng.normal(size=n)
    phi = np.column_stack([phi0, phic, np.conj(phic)])
    t = np.arange(T)
    return np.real(phi @ (lam[:, None] ** t[None, :] * amp[:, None]))


def _sorted(evals):
    return np.array(sorted(evals, key=lambda z: (round(z.real, 3),
                                                  round(z.imag, 3))))


def test_exact_dmd_matches_reference():
    rng = np.random.default_rng(1)
    lam = np.array([1.0, np.exp(1j * 0.5), np.exp(-1j * 0.5)])
    X = _planted_system(rng, 200, 40, lam, np.array([5.0, 2.0, 2.0]))
    want = jsegment.exact_dmd(X[:, :-1], X[:, 1:], rank=3)
    got = tsegment.exact_dmd(X[:, :-1], X[:, 1:], rank=3, device="cpu")
    np.testing.assert_allclose(_sorted(got[1]), _sorted(want[1]), atol=1e-4)
    np.testing.assert_allclose(_sorted(got[1]), _sorted(lam), atol=1e-3)
    order = [np.argsort(np.angle(e)) for e in (want[1], got[1])]
    wm = want[0][:, order[0]] * want[2][order[0]]
    gm = got[0][:, order[1]] * got[2][order[1]]
    np.testing.assert_allclose(gm, wm, atol=1e-4 * np.abs(wm).max())


@pytest.fixture(scope="module")
def mover(tmp_path_factory):
    """A still 160×120 movie of 20 frames with a block crossing it, and its
    frames as float32 gray (segment_video's input at scale 1)."""
    path = str(tmp_path_factory.mktemp("mover") / "mover.mp4")
    synth.write_mover_movie(path, seed=4, size=(160, 120), n_frames=20,
                            block=(24, 16), speed_px=4.0)
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, fr = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(fr, cv2.COLOR_BGR2GRAY)
                      .astype(np.float32))
    cap.release()
    return path, np.stack(frames)


def test_background_model_matches_reference(mover):
    frames = mover[1]
    want_bg, want_res = jsegment.background_model(frames, rank=6)
    got_bg, got_res = tsegment.background_model(frames, rank=6,
                                                device="cpu")
    span = float(np.ptp(want_bg))
    np.testing.assert_allclose(got_bg, want_bg, atol=1e-3 * span)
    np.testing.assert_allclose(got_res, want_res, atol=1e-3 * span)


def test_segment_video_matches_reference(mover):
    want_bg, want_masks = jsegment.segment_video(mover[0], rank=6, scale=1.0)
    got_bg, got_masks = tsegment.segment_video(mover[0], rank=6, scale=1.0,
                                               device="cpu")
    assert got_masks.shape == want_masks.shape == (20, 120, 160)
    assert np.abs(got_bg.astype(int) - want_bg).max() <= 1
    assert (got_masks != want_masks).mean() <= 1e-3
    assert want_masks.sum() > 0


def _full(m, which):
    Qx, Qy, A, Gx, Gy = (np.asarray(getattr(m, k), np.float64)
                         for k in ("Qx", "Qy", "A", "Gx", "Gy"))
    return {"x": Qx @ Gx @ Qx.T, "y": Qy @ Gy @ Qy.T,
            "A": Qy @ A @ Qx.T}[which]


def test_streaming_dmd_from_a_carried_state_matches_reference():
    rng = np.random.default_rng(3)
    lam = np.array([0.98, np.exp(1j * 0.3), np.exp(-1j * 0.3)])
    X = _planted_system(rng, 100, 25, lam, np.ones(3))
    X = X + 1e-3 * rng.normal(size=X.shape)      # rank beyond the budget
    first = tsdmd.StreamingDMD(max_rank=6, device="cpu")
    for k in range(16):
        first.update(X[:, k], X[:, k + 1])
    state = [first.__dict__[k].numpy() for k in ("Qx", "Qy", "A", "Gx",
                                                  "Gy")]
    port = tsdmd.StreamingDMD.from_arrays(*state, max_rank=6, device="cpu")
    ref = jsdmd.StreamingDMD(max_rank=6)
    ref.Qx, ref.Qy, ref.A, ref.Gx, ref.Gy = (jnp.asarray(m) for m in state)
    for k in range(16, 24):
        ref.update(X[:, k], X[:, k + 1])
        port.update(X[:, k], X[:, k + 1])
        for which in ("x", "y", "A"):
            w = _full(ref, which)
            np.testing.assert_allclose(_full(port, which), w,
                                       atol=1e-4 * np.abs(w).max())
    assert port.Qx.shape == ref.Qx.shape == (100, 6)
    (wm, we), (gm, ge) = ref.compute_modes(), port.compute_modes()
    np.testing.assert_allclose(_sorted(ge), _sorted(we), atol=1e-4)
    assert any(abs(e - 0.98) < 0.05 for e in ge)
    assert any(abs(e - np.exp(1j * 0.3)) < 0.05 for e in ge)


def test_sparse_lk_matches_reference():
    rng = np.random.default_rng(4)
    base = cv2.GaussianBlur(rng.uniform(0, 255, (300, 400))
                            .astype(np.float32), (0, 0), 2)
    base = cv2.normalize(base, None, 0, 255, cv2.NORM_MINMAX) \
        .astype(np.uint8)
    H_true = np.array([[1.0, 0.0, 6.0], [0.0, 1.0, -4.0], [0, 0, 1.0]])
    warped = cv2.warpPerspective(base, H_true, (400, 300))
    out = []
    for tracker in (jflow.SparseLK(), tflow.SparseLK(device="cpu")):
        assert tracker.update(base) == (None, 0)
        out.append(tracker.update(warped))
    (Hw, nw), (Hg, ng) = out
    assert nw > 50 and abs(ng - nw) <= 0.02 * nw
    np.testing.assert_allclose(Hg[:2, 2], Hw[:2, 2], atol=0.05)
    np.testing.assert_allclose(Hg[:2, 2], [6.0, -4.0], atol=0.5)
    K = np.array([[400.0, 0, 200], [0, 400.0, 150], [0, 0, 1]])
    Rw, _, _ = jflow.decompose_homography(Hw, K)
    Rg, _, _ = tflow.decompose_homography(Hg, K)
    np.testing.assert_allclose(Rg, Rw, atol=1e-3)


def test_lens_estimate_matches_reference():
    rng = np.random.default_rng(5)
    K = np.array([[600.0, 0, 480], [0, 600.0, 360], [0, 0, 1]], np.float32)
    dist = torch.tensor([-0.22, 0.0, 0.0, 0.0, 0.0])
    pairs = []
    for _ in range(8):
        pa = rng.uniform([-0.6, -0.45], [0.6, 0.45], (80, 2)) \
            .astype(np.float32)
        th = rng.normal(0, 0.05)
        R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        pb = (pa @ R.T + rng.normal(0, 0.05, 2)).astype(np.float32)
        pairs.append(tuple(tcamera.normalized_to_pixels(
            tcamera.distort_normalized(torch.from_numpy(p), dist),
            torch.from_numpy(K)).numpy() for p in (pa, pb)))
    wk1, wk2, wh = jlens.estimate_k1_k2(pairs, K, iters=40)
    gk1, gk2, gh = tlens.estimate_k1_k2(pairs, K, iters=40, device="cpu")
    np.testing.assert_allclose(gh, wh, rtol=1e-3)
    np.testing.assert_allclose([gk1, gk2], [wk1, wk2], atol=1e-4)
    assert gh[-1] < gh[0] / 2


@pytest.mark.parametrize("call", [
    lambda: tframe_motion.estimate_motion("x.mp4", device="meta"),
    lambda: tcorrelate.cross_correlate_full([1.0], [1.0], device="meta"),
    lambda: tcorrelate.sync_clocks([0, 1], [0, 1], [0, 1], [0, 1],
                                   device="meta"),
    lambda: tflow.SparseLK(device="meta"),
    lambda: tsegment.exact_dmd(np.eye(3), np.eye(3), device="meta"),
    lambda: tsegment.segment_video("x.mp4", device="meta"),
    lambda: tsdmd.StreamingDMD(device="meta"),
    lambda: tlens.estimate_k1_k2([(np.zeros((4, 2)),) * 2], np.eye(3),
                                 device="meta"),
    lambda: tlens.estimate_from_video("x.mp4", np.eye(3), device="meta"),
    lambda: tstabilize.stabilize_video("x.mp4", "y.mp4", device="meta"),
    lambda: tvideo_app.main(["est-gyro-rates", "x.mp4"], device="meta"),
], ids=["estimate_motion", "cross_correlate_full", "sync_clocks", "SparseLK",
        "exact_dmd", "segment_video", "StreamingDMD", "estimate_k1_k2",
        "estimate_from_video", "stabilize_video", "apps.video.main"])
def test_entry_point_raises_on_another_device(call, monkeypatch):
    monkeypatch.delenv("IMGTPU_PLATFORM", raising=False)
    with pytest.raises(ValueError, match="meta"):
        call()


def test_unreadable_movie_raises(tmp_path):
    missing = str(tmp_path / "missing.mp4")
    for call in (lambda: tframe_motion.estimate_motion(missing, device="cpu"),
                 lambda: tsegment.segment_video(missing, device="cpu")):
        with pytest.raises(FileNotFoundError):
            call()

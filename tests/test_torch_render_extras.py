"""Port parity: the ``--geotiff`` and ``--histogram`` render stages.

The torch pieces against the OpenCV calls and the reference functions
they replace, on the CPU:

- the geotiff warp (``render/geotiff.warp_frame``) bit-exact with
  ``cv2.warpPerspective`` (u8 BGR and the float32 mask of ones) on three
  homographies; the feathering (``feather_mask``: erode 3 × 3, then the
  50 × 50 box) bit-exact with ``cv2.erode`` + ``cv2.blur`` on the whole
  canvas, from a frame's box alone, in the middle of the canvas and at
  its edge;
- the native GeoTIFF bytes equal the reference's for the same mosaic;
- HSV: ``bgr_to_hsv`` bit-exact with COLOR_BGR2HSV; ``hsv_to_bgr``
  within one level of COLOR_HSV2BGR (OpenCV rounds on its scalar path
  and truncates on its vector path; the port rounds);
- the display filters against the reference's on one image: the hue
  emphasis and red/green ratio bit-exact, the shader within one level
  (float32 products in another order, truncated), CLAHE on B, G, R
  within one level (the port's ops/clahe against cv2's), CLAHE on V
  within two (that, plus HSV → BGR);
- ``match_to_template`` bit-exact.

Step 5's outputs as a whole (mosaic, histograms, textures) are held
against the reference in tests/test_torch_process.py.
"""

import cv2
import numpy as np
import pytest
import torch

from imageanalysis_tpu.render import geotiff as jgeotiff
from imageanalysis_tpu.render import histogram as jhistogram
from imageanalysis_tpu.render import texture as jtexture
from imageanalysis_tpu_torch.render import geotiff as tgeotiff
from imageanalysis_tpu_torch.render import histogram as thistogram
from imageanalysis_tpu_torch.render import texture as ttexture

CANVAS = (380, 420)              # (H, W)
_HM = [np.array([[0.9, 0.12, -30.0], [-0.1, 1.05, -20.0],
                 [2e-4, -1e-4, 1.0]]),
       np.array([[0.5, 0.0, 10.0], [0.0, 0.5, 5.0], [0.0, 0.0, 1.0]]),
       np.array([[0.70, -0.70, 200.0], [0.70, 0.70, -150.0],
                 [1e-4, 3e-4, 1.0]])]


@pytest.fixture(scope="module")
def frame():
    rng = np.random.default_rng(8)
    return cv2.GaussianBlur(rng.integers(0, 256, (240, 320, 3),
                                         dtype=np.uint8), (0, 0), 1.5)


@pytest.mark.parametrize("k", range(3), ids=["tilted", "scaled", "rotated"])
def test_warp_frame_bit_exact_with_cv2(frame, k):
    Hc, Wc = CANVAS
    Minv = np.linalg.inv(_HM[k])
    want = cv2.warpPerspective(frame, Minv, (Wc, Hc),
                               flags=cv2.INTER_LINEAR)
    want_mask = cv2.warpPerspective(np.ones(frame.shape[:2], np.float32),
                                    Minv, (Wc, Hc))
    got, mask = tgeotiff.warp_frame(torch.from_numpy(frame),
                                    np.linalg.inv(Minv), (0, Hc, 0, Wc))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(mask.numpy(), want_mask)


# canvas → frame maps that put the 320×240 frame at half size in the
# canvas's middle, and against its top-left corner
_BOXED = {"middle": np.array([[2.0, 0.1, -280.0], [-0.05, 2.0, -250.0],
                              [1e-4, -2e-4, 1.0]]),
          "edge": np.array([[2.0, 0.0, -20.0], [0.0, 2.0, -30.0],
                            [1e-4, 0.0, 1.0]])}


@pytest.mark.parametrize("where", ["middle", "edge"])
def test_feather_mask_from_the_box_bit_exact_with_cv2(frame, where):
    """The frame's box plus the feather margin, zero-padded inside the
    canvas and reflected at its edge, gives cv2's whole-canvas result."""
    Hc, Wc = CANVAS
    M = np.linalg.inv(np.linalg.inv(_BOXED[where]))
    _, full = tgeotiff.warp_frame(torch.from_numpy(frame), M,
                                  (0, Hc, 0, Wc))
    want = cv2.blur(cv2.erode(full.numpy(), np.ones((3, 3)), iterations=1),
                    (50, 50))
    np.testing.assert_array_equal(
        tgeotiff.feather_mask(full, (0, Hc, 0, Wc), CANVAS, 50).numpy(),
        want)
    box = tgeotiff._frame_box(M, 320, 240, CANVAS, 52)
    r0, r1, c0, c1 = box
    assert (r1 - r0) * (c1 - c0) < Hc * Wc
    assert (where == "edge") == (r0 == 0 or c0 == 0 or r1 == Hc
                                   or c1 == Wc)
    _, mask = tgeotiff.warp_frame(torch.from_numpy(frame), M, box)
    got = np.zeros_like(want)
    got[r0:r1, c0:c1] = tgeotiff.feather_mask(mask, box, CANVAS, 50).numpy()
    np.testing.assert_array_equal(got, want)


def test_write_geotiff_bytes_equal_reference(tmp_path, frame):
    extent = (-40.0, -55.5, 30.25, 60.0)
    ref = (44.97, -93.26, 0.0)
    jgeotiff.write_geotiff(str(tmp_path / "j.tif"), frame, extent, ref)
    tgeotiff.write_geotiff(str(tmp_path / "t.tif"),
                           torch.from_numpy(frame), extent, ref)
    assert (tmp_path / "t.tif").read_bytes() == \
        (tmp_path / "j.tif").read_bytes()


def test_hsv_conversions_match_cv2(frame):
    want = cv2.cvtColor(frame, cv2.COLOR_BGR2HSV)
    hsv = ttexture.bgr_to_hsv(torch.from_numpy(frame))
    np.testing.assert_array_equal(hsv.numpy(), want)
    back = ttexture.hsv_to_bgr(hsv).numpy().astype(int)
    assert np.abs(back - cv2.cvtColor(want, cv2.COLOR_HSV2BGR)).max() <= 1


@pytest.mark.parametrize("mode,tol", [
    ("equalize_value", 2), ("equalize_rgb", 1), ("equalize_red", 0),
    ("equalize_green", 0), ("red/green", 0), ("shader", 1)])
def test_filters_match_reference(frame, mode, tol):
    img = np.ascontiguousarray(frame[:232, :312])   # divisible by 8 tiles
    want = jtexture.apply_filter(img, mode).astype(int)
    got = ttexture.apply_filter(torch.from_numpy(img), mode).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol


def test_match_to_template_matches_reference(frame):
    rng = np.random.default_rng(1)
    own = tuple(np.bincount(frame[..., c].ravel(), minlength=256)
                .astype(np.float32) for c in range(3))
    quants = tuple(np.cumsum(rng.uniform(0, 1, 256)) for _ in range(3))
    quants = tuple(q / q[-1] for q in quants)
    want = jhistogram.match_to_template(frame, own, quants)
    got = thistogram.match_to_template(torch.from_numpy(frame), own, quants)
    np.testing.assert_array_equal(got.numpy(), want)

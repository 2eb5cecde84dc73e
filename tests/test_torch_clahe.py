"""Port parity: CLAHE (``ops/clahe.py``).

Seeded uint8 images go through the JAX package's device CLAHE on the CPU
and through imageanalysis_tpu_torch. Tolerance: ≥ 99.9% of pixels equal,
none off by more than 1 — the LUT blend is f32 sums in another order, so
a value on a .5 boundary may round the other way.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageanalysis_tpu.ops import clahe as jclahe
from imageanalysis_tpu_torch.features import sift as tsift
from imageanalysis_tpu_torch.ops import clahe as tclahe


@pytest.mark.parametrize("shape,smooth", [((256, 320), False),
                                          ((240, 320), True),
                                          ((250, 333), False)])
def test_clahe_matches_reference(rng, shape, smooth):
    img = rng.integers(0, 256, (2,) + shape).astype(np.float32)
    if smooth:
        img = tsift.blur_plain(torch.from_numpy(img),
                               tsift._gauss_kernel(4.0)).numpy()
    img = img.astype(np.uint8)
    want = np.asarray(jclahe.clahe(jnp.asarray(img))).astype(int)
    got = tclahe.clahe(torch.from_numpy(img)).numpy().astype(int)
    d = np.abs(got - want)
    assert d.max() <= 1
    assert (d == 0).mean() >= 0.999

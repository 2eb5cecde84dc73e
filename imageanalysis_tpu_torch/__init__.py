"""imageanalysis_tpu_torch — the PyTorch/CUDA port of ``imageanalysis_tpu``.

The JAX package beside this one is the reference; this package holds the
same modules in PyTorch, with the Pallas kernels rewritten as CUDA C++ for
Hopper (``csrc/``, built at first use by ``_build.py`` and bound through
``ctypes``). Module paths mirror the reference, so each counterpart is found
by its path:

- ``core/rotations.py``, ``core/camera.py``, ``core/geodesy.py``,
  ``core/transforms.py``     ← the same paths under ``imageanalysis_tpu/core``
- ``io/logger.py``, ``io/props.py``, ``io/state.py``, ``io/camera_db.py``
  (less ``estimate_from_exif``), ``io/project.py`` (``ImageRecord``,
  ``ProjectMgr``; the same on-disk workspace)
                             ← the same paths under ``imageanalysis_tpu/io``
- ``ops/knn.py``             ← ``imageanalysis_tpu/ops/knn.py`` (kernel K1,
                               ``csrc/knn_packed.cu``, in its int8, bf16, f32
                               and gated modes; kernel K3,
                               ``csrc/knn_wide.cu``; both share
                               ``csrc/knn_common.cuh``; kernel K4, the fused
                               match epilogue, ``csrc/match_epilogue.cu``)
- ``ops/ransac.py``          ← ``imageanalysis_tpu/ops/ransac.py``
- ``ops/clahe.py``           ← ``imageanalysis_tpu/ops/clahe.py``
- ``ops/triangulate.py``     ← ``imageanalysis_tpu/ops/triangulate.py``
- ``features/sift.py``       ← ``imageanalysis_tpu/features/sift_tpu.py``
                               (kernel K2, ``csrc/gauss_blur.cu``) — the one
                               module whose name differs
- ``match/worklist.py``, ``match/store.py``, ``match/matcher.py``
  (``BatchMatcher``, ``find_matches``), ``match/smart.py``,
  ``match/cleanup.py``, ``match/groups.py``
                             ← the same paths under ``imageanalysis_tpu/match``
- ``ba/bundle.py`` (less the calibration path), ``ba/setup.py``
                             ← the same paths under ``imageanalysis_tpu/ba``
- ``testing/synthetic.py``   ← part of ``imageanalysis_tpu/testing/synthetic.py``
                               (a mission generator that needs no OpenCV,
                               a writer of its project workspace, and the
                               synthetic BA graphs of ``scripts_dev``)

Conventions:

- functions take tensors and run on the device of the tensors they get;
  entry points that take a ``device`` default to ``"cuda"`` (the CPU only
  when asked); there is no global device choice and no fallback between
  devices;
- a kernel wrapper takes its plain PyTorch version for a CPU tensor and
  launches its CUDA kernel for a CUDA tensor, or raises;
- randomness comes from an explicit ``torch.Generator``;
- ``vmap`` becomes a written-out batch dimension, ``lax.scan`` a loop.

This package imports neither ``jax`` nor ``imageanalysis_tpu``.
"""

__version__ = "0.1.0"

import torch as _torch

# Full-f32 products for geometry (RANSAC's DLT normal equations, CLAHE's
# LUT blend): the counterpart of the reference's
# jax_default_matmul_precision=float32. TF32 keeps ~3 decimal digits.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

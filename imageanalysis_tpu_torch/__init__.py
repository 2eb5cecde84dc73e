"""imageanalysis_tpu_torch — the PyTorch/CUDA port of ``imageanalysis_tpu``.

The JAX package beside this one is the reference; this package holds the
same modules in PyTorch, with the Pallas kernels rewritten as CUDA C++ for
Hopper (``csrc/``, built at first use by ``_build.py`` and bound through
``ctypes``). Module paths mirror the reference, so each counterpart is found
by its path:

- ``core/rotations.py``, ``core/camera.py``, ``core/geodesy.py``,
  ``core/transforms.py``     ← the same paths under ``imageanalysis_tpu/core``
- ``io/logger.py``, ``io/props.py``, ``io/state.py``, ``io/camera_db.py``,
  ``io/project.py`` (``ImageRecord``, ``ProjectMgr``; the same on-disk
  workspace), ``io/pose.py``, ``io/exif.py`` (a host parser of the Exif
  APP1 in place of PIL)
                             ← the same paths under ``imageanalysis_tpu/io``
- ``io/jpeg.py``             ← the reference's host image I/O: PIL's draft
                               and cv2.imread in ``features/detect.py``,
                               cv2.imread / resize / imwrite in
                               ``render/build_map.py`` and
                               ``testing/synthetic.py`` (nvJPEG on the card,
                               ``csrc/jpeg_codec.cu``; PIL and cv2 on the
                               CPU; cv2's two resizes in torch)
- ``surface/srtm.py``        ← ``imageanalysis_tpu/surface/srtm.py`` (less
                               ``download_tile``)
- ``ops/knn.py``             ← ``imageanalysis_tpu/ops/knn.py`` (kernel K1,
                               ``csrc/knn_packed.cu``, in its int8, bf16, f32
                               and gated modes; kernel K3,
                               ``csrc/knn_wide.cu``; both share
                               ``csrc/knn_common.cuh``; kernel K4, the fused
                               match epilogue, ``csrc/match_epilogue.cu``)
- ``ops/ransac.py``, ``ops/essential5.py`` (host numpy, a copy)
                             ← the same paths under ``imageanalysis_tpu/ops``
- ``ops/clahe.py``           ← ``imageanalysis_tpu/ops/clahe.py``
- ``ops/triangulate.py``     ← ``imageanalysis_tpu/ops/triangulate.py``
- ``features/sift.py``       ← ``imageanalysis_tpu/features/sift_tpu.py``
                               (kernel K2, ``csrc/gauss_blur.cu``) — the one
                               module whose name differs
- ``features/detect.py``     ← ``imageanalysis_tpu/features/detect.py`` (the
                               device backend; the OpenCV ones raise)
- ``match/worklist.py``, ``match/store.py``, ``match/matcher.py``
  (``BatchMatcher``, ``find_matches``), ``match/smart.py``,
  ``match/cleanup.py``, ``match/groups.py``
                             ← the same paths under ``imageanalysis_tpu/match``
- ``ba/bundle.py``, ``ba/setup.py``, ``ba/calibrate.py``
                             ← the same paths under ``imageanalysis_tpu/ba``
- ``render/build_map.py``, ``render/ac3d.py``, ``render/geotiff.py``,
  ``render/histogram.py``, ``render/texture.py``
                             ← the same paths under ``imageanalysis_tpu/render``
- ``apps/process.py``        ← ``imageanalysis_tpu/apps/process.py`` (one
                               process, Steps 1→5; the OpenCV detectors and
                               a run across hosts raise)
- ``testing/synthetic.py``   ← part of ``imageanalysis_tpu/testing/synthetic.py``
                               (a mission generator that needs no OpenCV,
                               writers of its project workspace and of its
                               folder of JPEGs + pix4d.csv or EXIF, and the
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

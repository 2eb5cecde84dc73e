"""Build the CUDA kernels of ``csrc/`` at first use and bind them by ctypes.

Every ``csrc/*.cu`` compiles in its own ``nvcc`` process, all started
together, and one more ``nvcc`` links the objects into one shared library
with a plain C interface under ``<repo>/build/``; the file name carries a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads the library already built. No PyTorch headers are
compiled, which keeps the build to seconds.

Every C entry point returns the ``cudaError_t`` of its launch (0 = ok) and
takes every pointer, the stream included, as ``void*``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")
# the default toolkit location, searched after PATH and CUDA_HOME
CUDA_DEFAULT = "/usr/local/cuda"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# name → argtypes of every C entry point
_SIGNATURES = {
    # a, b, row_p, col_p, n_pairs, n_a, n_b, stream
    "knn_packed_i8": [_P, _P, _P, _P, _I, _I, _I, _P],
    # a, b, uv_a, pred_b, radius2, row_p, col_p, n_pairs, n_a, n_b, stream
    "knn_packed_i8_gated": [_P, _P, _P, _P, _F, _P, _P, _I, _I, _I, _P],
    # a, b, na2, nb2, uv_a, pred_b, radius2, row_p, col_p, n_pairs, n_a,
    # n_b, bf16, stream
    "knn_packed_float": [_P, _P, _P, _P, _P, _P, _F, _P, _P, _I, _I, _I, _I,
                         _P],
    # a, b, na2, nb2, row_k, col_k, n_pairs, n_a, n_b, bf16, stream
    "knn_wide": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # in, out, taps (host float*), n_img, H, W, radius, stream
    "gauss_blur_f32": [_P, _P, _P, _I, _I, _I, _I, _P],
}

_lib = None
build_log = ""      # nvcc's output of the last build (ptxas resource usage)
build_seconds = 0.0


def find_nvcc():
    """Path of nvcc from PATH, $CUDA_HOME or CUDA_DEFAULT; None if absent."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), CUDA_DEFAULT):
        if home:
            cand = os.path.join(home, "bin", "nvcc")
            if os.access(cand, os.X_OK):
                return cand
    return None


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def build():
    """Compile csrc/*.cu into BUILD_DIR if the hashed library is missing;
    return its path. Raises RuntimeError when nvcc is missing or fails."""
    global build_log, build_seconds
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + f.read())
    lib = os.path.join(BUILD_DIR, f"libimageanalysis_{h.hexdigest()[:16]}.so")
    if os.path.isfile(lib):
        return lib
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME, " + CUDA_DEFAULT + "): the "
            "CUDA kernels of imageanalysis_tpu_torch need the CUDA toolkit")
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(s) + ".o") for s in srcs]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, s],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(srcs, objs)]
        logs = [p.communicate()[0] for p in procs]
        build_log = "".join(logs)
        failed = [s for s, p in zip(srcs, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        out = os.path.join(tmp, "lib.so")
        proc = subprocess.run([nvcc, "-shared", "-o", out, *objs],
                              capture_output=True, text=True)
        build_log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{build_log}")
        os.replace(out, lib)
    build_seconds = time.perf_counter() - t0
    return lib


def load():
    """The bound kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err, name):
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed, cudaError_t {err}")

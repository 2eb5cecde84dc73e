"""Build the CUDA kernels of ``csrc/`` at first use and bind them by ctypes.

Every ``csrc/*.cu`` compiles in its own ``nvcc`` process, all started
together, and one more ``nvcc`` links the objects into one shared library
with a plain C interface under ``<repo>/build/``; the file name carries a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads the library already built. Processes that start
together (the ranks of a run across processes, on a fresh checkout)
build once: the first takes a file lock on the build directory and
builds, the others wait for the lock and load its library. No PyTorch
headers are
compiled, which keeps the build to seconds. The library links nvJPEG
(``csrc/jpeg_codec.cu``, the port's JPEG decode and encode).

Every kernel's C entry point returns the ``cudaError_t`` of its launch
(0 = ok); the nvJPEG entry points return 0, a positive
``nvjpegStatus_t`` or a negated ``cudaError_t``. Every pointer, the
stream included, is a ``void*``.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import fcntl
import glob
import hashlib
import os
import re
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
_S = ctypes.c_size_t
# name → argtypes of every C entry point
_SIGNATURES = {
    # a, b, na2, nb2 (f32 scratch), row_p, col_p, n_pairs, n_a, n_b, dim
    # (128 or 256 values a row), stream
    "knn_packed_i8": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # a, b, na2, nb2, uv_a, pred_b, radius2, row_p, col_p, n_pairs, n_a,
    # n_b, dim, stream
    "knn_packed_i8_gated": [_P, _P, _P, _P, _P, _P, _F, _P, _P, _I, _I, _I,
                            _I, _P],
    # a, b, na2, nb2, uv_a, pred_b, radius2, row_p, col_p, split_a,
    # split_b (f32's bf16 planes), n_pairs, n_a, n_b, bf16, dim, stream
    "knn_packed_float": [_P, _P, _P, _P, _P, _P, _F, _P, _P, _P, _P, _I, _I,
                         _I, _I, _I, _P],
    # x, out, rows, dim, stream
    "split_bf16x3": [_P, _P, _I, _I, _P],
    # a, b, na2, nb2, row_k, col_k, split_a, split_b (f32's bf16 planes),
    # n_pairs, n_a, n_b, bf16, dim, stream
    "knn_wide": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # in, out, taps (host float*), n_img, H, W, radius, stream
    "gauss_blur_f32": [_P, _P, _P, _I, _I, _I, _I, _P],
    "gauss_blur_loop_f32": [_P, _P, _P, _I, _I, _I, _I, _P],
    # row_p, col_p, uv_b, ratio2, best_j, ok, pb, n_pairs, n_a, n_b, stream
    "match_epilogue": [_P, _P, _P, _F, _P, _P, _P, _I, _I, _I, _P],
    # probes (probes/): a, b, na2, nb2, row_p, col_p, n_pairs, n_a, n_b,
    # bf16, stage, ta, tb, stream
    "knn_probe": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # a, b, na2, nb2, uv_a, pred_b, radius2, row_p, col_p, row_k, col_k,
    # n_pairs, n_a, n_b, wide, stream
    "knn_ffma_bf16": [_P, _P, _P, _P, _P, _P, _F, _P, _P, _P, _P, _I, _I, _I,
                      _I, _P],
    # a, b, na2, nb2, uv_a, pred_b, radius2, row_p, col_p, row_k, col_k,
    # n_pairs, n_a, n_b, wide, stream
    "knn_ffma_f32": [_P, _P, _P, _P, _P, _P, _F, _P, _P, _P, _P, _I, _I, _I,
                     _I, _P],
    # a, b, uv_a, pred_b, radius2, row_p, col_p, n_pairs, n_a, n_b, stream
    "knn_dp4a_i8": [_P, _P, _P, _P, _F, _P, _P, _I, _I, _I, _P],
    # a, b, split_a, split_b, row_p, n_pairs, n_a, n_b, dtype (0 int8,
    # 1 bf16, 2 f32), stream
    "knn_tc_row_sum": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # a, b, na2, nb2, uv_a, pred_b, radius2, row_p, col_p, row_k, col_k,
    # n_pairs, n_a, n_b, mode (0 K1, 2 K3, 3 product + row sum), body (0
    # mma.sync, 1 wgmma), stream
    "knn_bf16_d256": [_P, _P, _P, _P, _P, _P, _F, _P, _P, _P, _P, _I, _I, _I,
                      _I, _I, _P],
    # a, b, na2, nb2, uv_a, pred_b, radius2, row_p, col_p, row_k, col_k,
    # split_a, split_b (the planes' scratch), n_pairs, n_a, n_b, mode (0 K1,
    # 2 K3, 3 product + row sum; at 128 no K1), body (0 mma.sync, 1
    # wgmma), stream
    "knn_f32_d256": [_P, _P, _P, _P, _P, _P, _F, _P, _P, _P, _P, _P, _P, _I,
                     _I, _I, _I, _I, _P],
    "knn_f32_d128": [_P, _P, _P, _P, _P, _P, _F, _P, _P, _P, _P, _P, _P, _I,
                     _I, _I, _I, _I, _P],
    # a, b, na2, nb2 (the norms' scratch), uv_a, pred_b, radius2, row_p,
    # col_p, n_pairs, n_a, n_b, mode (0 K1, 3 product + row sum), body (0
    # mma.sync, 1 wgmma), stream
    "knn_i8_d256": [_P, _P, _P, _P, _P, _P, _F, _P, _P, _I, _I, _I, _I, _I,
                    _P],
    # rows of 128 values, as knn_i8_d256 (int8) and knn_bf16_d256 (bf16)
    "knn_i8_d128": [_P, _P, _P, _P, _P, _P, _F, _P, _P, _I, _I, _I, _I, _I,
                    _P],
    "knn_bf16_d128": [_P, _P, _P, _P, _P, _P, _F, _P, _P, _P, _P, _I, _I,
                      _I, _I, _I, _P],
    # a, b, row_p, n_pairs, n_a, n_b, bf16, bm, bn, stages, stream
    "knn_tc_row_min": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # bf16, bm, bn, stages
    "knn_tc_row_min_blocks": [_I, _I, _I, _I],
    # a, b, na2, nb2, row_p, col_p, n_pairs, n_a, n_b, dtype (0 int8,
    # 1 bf16), stage, stream
    "knn_tc_stage": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # a, b, uv_b, row_p, col_p, counter, bj, ok, pb, norms, n_pairs, n,
    # tile_a, epi_threads, do_main, do_epi, do_pb, body (1 tensor cores,
    # 0 __dp4a), stream
    "knn_fused_probe": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                        _I, _I, _I, _I, _I, _P],
    # tile_a
    "knn_fused_probe_blocks": [_I],
    # a, b, out, batch, M, N, K, bm, bn, n_split, stream
    "mm_rowsum_bf16_wg": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "mm_rowsum_bf16": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # bm, bn, K, plan (int[5])
    "mm_rowsum_wg_plan": [_I, _I, _I, _P],
    # j, vals (f32; v0: bf16), out, T, N, stream
    "onehot_gather_bf16": [_P, _P, _P, _I, _I, _P],
    "onehot_gather_bf16_v0": [_P, _P, _P, _I, _I, _P],
    # nvJPEG (jpeg_codec.cu): data, length, components, width, height
    "jpeg_info": [_P, _S, _P, _P, _P],
    # data, length, bgr, out, pitch, stream
    "jpeg_decode": [_P, _S, _I, _P, _S, _P],
    # bgr, width, height, pitch, quality, stream, length (size_t*)
    "jpeg_encode": [_P, _I, _I, _S, _I, _P, _P],
    # out, length (size_t*), stream
    "jpeg_encode_fetch": [_P, _P, _P],
}
# libraries the shared library links against
LINK_LIBS = ["-lnvjpeg"]

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
    """Compile csrc/*.cu into BUILD_DIR if the hashed library is missing
    (one process at a time: _build_lock); return its path. Raises
    RuntimeError when nvcc is missing or fails."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_LIBS).encode())
    for s in srcs + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + f.read())
    lib = os.path.join(BUILD_DIR, f"libimageanalysis_{h.hexdigest()[:16]}.so")
    if os.path.isfile(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    with _build_lock():
        if not os.path.isfile(lib):     # else another process built it
            _compile(srcs, lib)
    return lib


@contextlib.contextmanager
def _build_lock():
    """An exclusive lock on BUILD_DIR/build.lock (flock: released when its
    holder exits, however it exits)."""
    with open(os.path.join(BUILD_DIR, "build.lock"), "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _compile(srcs, lib):
    """nvcc every source into an object, all at once, and link them into
    lib (atomically)."""
    global build_log, build_seconds
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME, " + CUDA_DEFAULT + "): the "
            "CUDA kernels of imageanalysis_tpu_torch need the CUDA toolkit")
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
        proc = subprocess.run([nvcc, "-shared", "-o", out, *objs,
                               *LINK_LIBS],
                              capture_output=True, text=True)
        build_log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{build_log}")
        os.replace(out, lib)
    build_seconds = time.perf_counter() - t0


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


def ptxas_usage(log=None):
    """ptxas's report (-Xptxas -v) of each kernel in log (default: the
    last build's): {mangled name: (registers, spill stores, spill loads)
    in bytes for the spills}. Empty when the library was already built."""
    usage, spills, cur = {}, {}, None
    for ln in (build_log if log is None else log).splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)", ln)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and cur:
            spills[cur] = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur:
            usage[cur] = (int(m.group(1)), *spills.get(cur, (0, 0)))
    return usage


# knn_tc_kernel<T, MODE, BM, BN, STAGES> (csrc/knn_tc.cuh) as mangled: T
# "t" bf16 bits, "a" int8, "NS_6Bf16x3E" f32's three bf16 planes, each
# also as D256<T> (rows of 256 values, "NS_4D256I...EE"); BN and STAGES
# absent from builds whose kernel had no such parameters
_TC_KERNEL = re.compile(r"knn_tc_kernelI(t|a|NS_6Bf16x3E|NS_4D256I(?:t|a|"
                        r"NS_6Bf16x3E)EE)Li(\d+)ELi(\d+)E"
                        r"(?:Li(\d+)ELi(\d+)E)?E")
_TC_TYPES = {"t": "bf16", "a": "int8", "NS_6Bf16x3E": "f32",
             "NS_4D256ItEE": "bf16_d256", "NS_4D256IaEE": "int8_d256",
             "NS_4D256INS_6Bf16x3EEE": "f32_d256"}


# knn_wg_kernel<T, MODE> (csrc/knn_wg.cuh): bf16 ("t"), int8 ("a") and f32
# ("NS_6Bf16x3E") at 128 values a row, bf16 ("NS_4D256ItEE"), int8
# ("NS_4D256IaEE") and f32 ("NS_4D256INS_6Bf16x3EEE") at 256 on wgmma; T
# absent from builds whose body took bf16 at 256 only
_WG_KNN_KERNEL = re.compile(r"knn_wg_kernelI(t|a|NS_6Bf16x3E|NS_4D256I(?:t|"
                            r"a|NS_6Bf16x3E)EE)?Li(\d+)EE")


def tc_kernel_usage(usage=None):
    """ptxas_usage() of the tensor-core bodies' instantiations, keyed
    "type mode BM[ BN STAGES]" (e.g. "bf16 0 128 128 2"; at 256 values a
    row the type is suffixed, e.g. "int8_d256 0 128 128 2"); the wgmma
    body as "type mode wg": "bf16 mode wg", "int8 mode wg" and "f32 mode
    wg" at 128, "bf16_d256 mode wg", "int8_d256 mode wg" and "f32_d256
    mode wg" at 256."""
    out = {}
    for name, u in (ptxas_usage() if usage is None else usage).items():
        m = _TC_KERNEL.search(name)
        if m:
            key = [_TC_TYPES[m.group(1)], *(g for g in m.groups()[1:] if g)]
            out[" ".join(key)] = u
        m = _WG_KNN_KERNEL.search(name)
        if m:
            kind = _TC_TYPES[m.group(1)] if m.group(1) else "bf16_d256"
            out[f"{kind} {m.group(2)} wg"] = u
    return out


def ptxas_warnings(log=None):
    """The build's warnings in log (default: the last build's): the
    compilers' warnings and ptxas's performance notes (e.g. C7518, wgmma
    serialized), each line with the kernel or source it names."""
    return [ln.strip() for ln in (build_log if log is None else log)
            .splitlines()
            if "warning" in ln.lower() or "Performance Loss" in ln]


# mm_rowsum_wg_kernel<BM, BN> (csrc/mma_probe.cu) as mangled
_WG_KERNEL = re.compile(r"mm_rowsum_wg_kernelILi(\d+)ELi(\d+)E")


def wg_kernel_usage(usage=None):
    """ptxas_usage() of P5's wgmma kernel's instantiations, keyed by their
    tile (BM, BN)."""
    out = {}
    for name, u in (ptxas_usage() if usage is None else usage).items():
        m = _WG_KERNEL.search(name)
        if m:
            out[(int(m.group(1)), int(m.group(2)))] = u
    return out


def opcode_counts(lines):
    """Opcode counts of one kernel's SASS lines (sass()'s, e.g. "/*0a30*/
    @P0 IMNMX R1, ..."), the predicate and the opcode's suffixes dropped
    (HGMMA.64x128x16.F32.BF16 counts as HGMMA)."""
    c = collections.Counter()
    for ln in lines:
        words = ln.split("*/", 1)[1].split()
        if words and words[0].startswith("@"):
            words = words[1:]
        if words:
            c[words[0].split(".")[0]] += 1
    return c


def sass(lib=None):
    """{mangled kernel name: its SASS lines} of the built library (default:
    this package's), from cuobjdump beside nvcc. Needs the CUDA toolkit."""
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError("cuobjdump not found: needs the CUDA toolkit")
    out = subprocess.run(
        [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass",
         lib or build()], check=True, capture_output=True, text=True).stdout
    kernels = {}
    for part in out.split("Function : ")[1:]:
        name, body = part.split("\n", 1)
        # whitespace collapsed: cuobjdump pads its columns to the widest
        # instruction of the file, so a kernel's lines would change with
        # what else is compiled beside it
        kernels[name.strip()] = [" ".join(ln.split())
                                 for ln in body.splitlines()
                                 if "/*" in ln and ";" in ln]
    return kernels


def check(err, name):
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed, cudaError_t {err}")

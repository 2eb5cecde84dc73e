"""K1 + K4 in one launch, parts switched off (P2).

Counterpart of ``scripts_dev/fused_vmem_probe.py:26`` (``kern`` in
``make``): the packed int8 2-NN of each pair and its match epilogue (ratio
0.75, so ratio² = 0.5625, and the mutual check) in a single kernel,
``csrc/knn_fused_probe.cu``. The port runs them as two launches (K1, then
K4: ``ops/knn.py::knn_match_fused``), because K4 needs the column minimum
that only K1's last A tile completes; here the last block of each pair to
finish runs that pair's epilogue, found by a self-resetting per-pair
counter. Returns (bj (B, n) int32, ok (B, n) int32 0/1, pb (B, n, 2) f32):
with every part on they equal ``knn_match_fused(a, b, uv_b, 0.75)`` on
int8 ungated inputs (ok as int32).

Three bodies (``body``): ``"wg"``, the default, is the ``wgmma`` body K1
int8 runs (``csrc/knn_wg.cuh``, mode ``kFused`` at K1's tile: K1's norm
pre-pass, then one kernel; the row's pb picked from its keys in
registers; the tail met at a named barrier of the consumer warpgroups);
``"tc"`` is the ``mma.sync`` body K1 ran before (``csrc/knn_tc.cuh``,
mode ``kFused``), and ``"old"`` the first body on ``__dp4a``
(``knn_fused_probe_v0`` in ``LAUNCHES``), both kept as yardsticks. The
variants map to each body by the TPU probe's cases:

==========  ===================================  =============  ============
variant     TPU (tile_a, tile_e, main, epi, pb)  "tc", "old"    "wg"
==========  ===================================  =============  ============
``full``    (128, 64, on, on, on)                TA 128, 256    384 A rows,
                                                 threads        384 threads
``nopb``    (128, 64, on, on, off)               pb not written  (same)
``noepi``   (128, 64, on, off, on)               bj, ok not      (same)
                                                 written
``nomain``  (128, 64, off, on, on)               K1 part         (same)
                                                 skipped
``epi32``   (128, 32, on, on, on)                epilogue on     tail on 192
                                                 128 threads     threads
``t64``     (64, 64, on, on, on)                 TA 64          192 A rows,
                                                                one m64 half
                                                                a warpgroup
==========  ===================================  =============  ============

TA is a block's A rows, the threads those that run the epilogue (on
``"wg"`` the three consumer warpgroups' 384: the producer warpgroup has
left the block by then); epi32 halves them and t64 halves the A tile, as
on the TPU.

``noepi`` and ``nomain`` leave outputs undefined on the card (the TPU's
scratch was uninitialised there too): they are timed, not compared; their
plain versions return zeros for what they skip.
"""

from __future__ import annotations

import torch

from .. import _build
from ..ops import knn
from . import check_device, check_launchable

RATIO = 0.75                        # ratio² = 0.5625, as the TPU probe
VARIANTS = {
    "full": dict(tile_a=128, epi_threads=256, main=True, epi=True, pb=True),
    "nopb": dict(tile_a=128, epi_threads=256, main=True, epi=True, pb=False),
    "noepi": dict(tile_a=128, epi_threads=256, main=True, epi=False,
                  pb=True),
    "nomain": dict(tile_a=128, epi_threads=256, main=False, epi=True,
                   pb=True),
    "epi32": dict(tile_a=128, epi_threads=128, main=True, epi=True, pb=True),
    "t64": dict(tile_a=64, epi_threads=256, main=True, epi=True, pb=True),
}
# what each variant's outputs are held to: (bj, ok, pb)
COMPARED = {"full": (True, True, True), "nopb": (True, True, False),
            "noepi": (False, False, False), "nomain": (False, False, False),
            "epi32": (True, True, True), "t64": (True, True, True)}

# body → (the C entry's selector, its count in LAUNCHES)
BODIES = {"wg": (2, "knn_fused_probe"), "tc": (1, "knn_fused_probe_tc"),
          "old": (0, "knn_fused_probe_v0")}
LAUNCHES = {count: 0 for _, count in BODIES.values()}
# per-pair completion counters, by (device, pairs): zeroed once, and left
# at zero by every launch that runs the epilogue
_COUNTERS = {}


def _check(a, b, uv_b, variant, name):
    dev = check_device((a, b, uv_b), name)
    if variant not in VARIANTS:
        raise ValueError(f"{name}: variant is one of {sorted(VARIANTS)}")
    if (a.dtype != torch.int8 or b.dtype != torch.int8 or a.dim() != 3
            or a.shape != b.shape or a.shape[2] != 128):
        raise ValueError(f"{name}: need int8 a and b (B, n, 128), got "
                         f"{a.dtype} {tuple(a.shape)}, {b.dtype} "
                         f"{tuple(b.shape)}")
    if uv_b.shape != (*a.shape[:2], 2) or uv_b.dtype != torch.float32:
        raise ValueError(f"{name}: need f32 uv_b (B, n, 2)")
    n = a.shape[1]
    if n % VARIANTS[variant]["tile_a"] or n % 64 or n > 8192:
        raise ValueError(f"{name}: n={n} must be a multiple of "
                         f"{VARIANTS[variant]['tile_a']} and 64, ≤ 8192")
    return dev


def fused_probe_plain(a, b, uv_b, variant="full"):
    """Plain version: K1's plain version, then pb = uv_b[best j] (pb on)
    and K4's plain version at ratio 0.75 (epilogue on); zeros for the
    parts a variant skips."""
    dev = _check(a, b, uv_b, variant, "fused_probe_plain")
    cfg = VARIANTS[variant]
    B, n, _ = a.shape
    bj = torch.zeros((B, n), dtype=torch.int32, device=dev)
    ok = torch.zeros((B, n), dtype=torch.int32, device=dev)
    pb = torch.zeros((B, n, 2), dtype=torch.float32, device=dev)
    if not cfg["main"]:
        return bj, ok, pb
    row_p, col_p = knn.knn_packed_plain(a, b)
    j, good, gathered = knn.match_epilogue_plain(row_p, col_p, uv_b, RATIO)
    if cfg["pb"]:
        pb = gathered
    if cfg["epi"]:
        bj, ok = j, good.int()
    return bj, ok, pb


def fused_probe_raw(a, b, uv_b, variant="full", body="wg"):
    """The single-launch kernel (body "wg", "tc" or "old") on a CUDA
    tensor, fused_probe_plain on a CPU tensor; raises on any other
    device."""
    if body not in BODIES:
        raise ValueError(f"fused_probe_raw: body is one of {sorted(BODIES)}")
    dev = _check(a, b, uv_b, variant, "fused_probe_raw")
    if dev.type == "cpu":
        return fused_probe_plain(a, b, uv_b, variant)
    check_launchable((a, b, uv_b), "fused_probe_raw")
    cfg = VARIANTS[variant]
    selector, count = BODIES[body]
    B, n, _ = a.shape
    key = (dev, B)
    if key not in _COUNTERS:
        _COUNTERS[key] = torch.zeros(B, dtype=torch.int32, device=dev)
    lib = _build.load()
    row_p = torch.empty((B, n, 2), dtype=torch.int32, device=dev)
    col_p = torch.full((B, n), knn._KEY_MAX, dtype=torch.int32, device=dev)
    bj, ok = torch.empty((2, B, n), dtype=torch.int32, device=dev)
    pb = torch.empty((B, n, 2), dtype=torch.float32, device=dev)
    # the tensor-core bodies' squared norms of a and b (K1's pre-pass)
    norms = torch.empty((2, B, n) if body != "old" else 0,
                        dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.knn_fused_probe(
            a.data_ptr(), b.data_ptr(), uv_b.data_ptr(), row_p.data_ptr(),
            col_p.data_ptr(), _COUNTERS[key].data_ptr(), bj.data_ptr(),
            ok.data_ptr(), pb.data_ptr(), norms.data_ptr(), B, n,
            cfg["tile_a"], cfg["epi_threads"], int(cfg["main"]),
            int(cfg["epi"]), int(cfg["pb"]), selector,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "knn_fused_probe")
    LAUNCHES[count] += 1
    return bj, ok, pb


def fused_probe_blocks(variant="full", body="wg"):
    """Blocks of a tensor-core body's kernel ("wg" or "tc") for the
    variant's tile that one SM of the current card holds at once (the CUDA
    occupancy calculator's count, after the kernel's shared-memory
    opt-in). Needs a card."""
    if variant not in VARIANTS or body not in ("wg", "tc"):
        raise ValueError(f"fused_probe_blocks: variant is one of "
                         f"{sorted(VARIANTS)}, body 'wg' or 'tc'")
    n = _build.load().knn_fused_probe_blocks(VARIANTS[variant]["tile_a"],
                                             BODIES[body][0])
    _build.check(max(0, -n), "knn_fused_probe_blocks")
    return n

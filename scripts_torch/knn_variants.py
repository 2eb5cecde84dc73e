"""Copy the package into ``build/<name>/`` with one of the 2-NN kernel's
design variants, for ``scripts_torch/knn_versions.py`` to time in turns
with the shipped kernel on one card:

    python3 scripts_torch/knn_variants.py NAME [NAME ...]

Each NAME below is a set of edits of ``csrc/knn_wg.cuh``'s design lines
(a ``Body<T>`` line, a ``constexpr`` or a line of the epilogue); the
script fails where a line is not found, so a variant never runs as the
shipped kernel. The copies build into their own ``build/<name>/build/``
(git ignores ``build/``). ``base`` is the package as it is.

K3 at 128 values a row (``--k3-d128``; the f32 variants edit
``F32Rows128``, the structure of K3 f32 and of f32's product-only stage
at 128):
- ``k3_256``: K3's epilogue as the 256 body had it before: d2 as (na +
  nb) - 2 dot by FADD, FMUL, FSUB and a -0 fix-up FADD, one pass over the
  columns;
- ``k3_pass1``: bf16's 16 columns a thread in one pass (``kWidePasses``
  1; two shipped: the same exchanges, 8 fewer keys live);
- ``bf16_wg3``: bf16 at 128 on three consumer warpgroups of 128 rows
  (384 A rows a block, 152 registers a consumer thread), K1's too;
- ``f32_wg3``: f32 at 128 on three consumer warpgroups of 64 rows (192
  A rows a block);
- ``f32_bm64``: f32 at 128 on the 256 body's structure: 64 A rows a
  block, the warpgroups on alternate B tiles, a ring of four stages;
- ``f32_ring4``: f32 at 128 with 128 A rows and a ring of four stages
  (six shipped).

K1 f32 at 128 values a row (``--k1-f32-d128``; shipped on ``F32Rows64``,
64 A rows a block, the warpgroups on alternate B tiles):
- ``k1_f32_bm128``: K1 f32 on ``F32Rows128`` as K3 f32 (128 A rows, each
  warpgroup its own 64, in ping-pong, a ring of six plane stages);
- ``k1_f32_wg3``: K1 f32 on ``F32Rows128`` with three consumer
  warpgroups of 64 rows (192 A rows a block), K3 f32's too.
"""

import os
import shutil
import sys

ROOT = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), ".."))
PKG = "imageanalysis_tpu_torch"
WG = os.path.join(PKG, "csrc", "knn_wg.cuh")

_F32 = ("  static constexpr int kRows = 128, kHalves = 1, kPlanes = 3, "
        "kAPlanes = 2;\n  static constexpr int kChunks = 2, kRing = 6, "
        "kEmpty = 8, kConsumers = 2;")
_BF16 = ("struct Body<uint16_t, MODE> {       // bf16 at 128 values a row\n"
         "  using Acc = float;\n  static constexpr int kRows = 256, "
         "kHalves = 2, kPlanes = 1, kAPlanes = 1;\n  static constexpr int "
         "kChunks = 2, kRing = 2, kEmpty = 8, kConsumers = 2;")
_D2 = ("              const float d2 =\n"
       "                  __fmaf_rn(-2.f, dot, __fadd_rn(na[h][hh], nbv));\n"
       "              // a thread meets")
_K1_F32 = ("    : std::conditional_t<MODE == kPacked || MODE == kPackedGated, "
           "F32Rows64,\n                         F32Rows128> {};")
_WG3 = (_F32, _F32.replace("kRows = 128", "kRows = 192")
        .replace("kEmpty = 8, kConsumers = 2", "kEmpty = 12, kConsumers = 3"))
VARIANTS = {
    "base": [],
    "k3_256": [(_D2, "              const float d2 = __fadd_rn(__fsub_rn(\n"
                "                  __fadd_rn(na[h][hh], nbv), "
                "__fmul_rn(2.f, dot)), 0.f);\n"
                "              // a thread meets"),
               ("constexpr int kWidePasses = 2;",
                "constexpr int kWidePasses = 1;")],
    "k3_pass1": [("constexpr int kWidePasses = 2;",
                  "constexpr int kWidePasses = 1;")],
    "bf16_wg3": [(_BF16, _BF16.replace("kRows = 256", "kRows = 384")
                  .replace("kEmpty = 8, kConsumers = 2",
                           "kEmpty = 12, kConsumers = 3"))],
    "f32_wg3": [_WG3],
    "f32_bm64": [(_F32, _F32.replace("kRows = 128", "kRows = 64")
                  .replace("kRing = 6, kEmpty = 8", "kRing = 4, kEmpty = 4"))],
    "f32_ring4": [(_F32, _F32.replace("kRing = 6", "kRing = 4"))],
    "k1_f32_bm128": [(_K1_F32, "    : F32Rows128 {};")],
    "k1_f32_wg3": [(_K1_F32, "    : F32Rows128 {};"), _WG3],
}


def make(name):
    """build/<name>/imageanalysis_tpu_torch: the package with the
    variant's edits (an old copy and its build are replaced)."""
    dst = os.path.join(ROOT, "build", name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, PKG), os.path.join(dst, PKG),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(dst, WG)
    with open(path) as f:
        src = f.read()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            sys.exit(f"{name}: the line to edit is not in {WG}: {old!r}")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)
    return dst


def main():
    names = sys.argv[1:]
    bad = [n for n in names if n not in VARIANTS]
    if not names or bad:
        sys.exit(f"usage: knn_variants.py NAME ...; names: "
                 f"{', '.join(VARIANTS)}")
    for name in names:
        print(make(name))


if __name__ == "__main__":
    main()

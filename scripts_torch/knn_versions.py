"""Time K1's int8, bf16 and f32 modes (plain and gated) and K3's bf16
and f32 modes at the main path's shapes, from the package under ROOT,
and print one JSON line with the registers and spills ptxas reports for
the tensor-core body's instantiations of that copy.

Run it once per copy of the package, each in its own process, in turns
(old, new, new, old), to compare two versions of the 2-NN kernels on one
card; each copy builds its kernels into ROOT/build/:

    python3 scripts_torch/knn_versions.py [ROOT] [--f32-d256]

Shapes: the store's 256 pairs × 4096, bench.py's 64 × 6144 (int8 rows,
value − 128 of 0..99, a quarter planted; bf16 and f32 as 0..255 with f32
norms), f32 and the gated modes at the store's shape with ~65% of the
candidates gated out, K3 at 64 × 10240; at 256 values a row (ORB's bits
as 0/1 bf16, a quarter planted with 8 bits flipped) K1 bf16 plain and
gated at 64 × 6144, K3 bf16 at 64 × 10240, K1 f32 plain and gated at
256 × 4096 and K3 f32 at 64 × 10240 (``*_d256``), and, where the copy
has ``knn_stages.bf16_d256_raw`` (``f32_d256_raw``), the product-only
stage there on both of its bodies (``row_sum_<body>_d256_*``,
``row_sum_<body>_f32_d256_*``). ``--f32-d256`` times the f32 cases at
256 alone. Times: median of CUDA events after warm-up. Registers: "type mode BM[ BN STAGES]" → [registers, spill
stores, spill loads], read with this checkout's _build.tc_kernel_usage
from the copy's build log (empty when its library was already built).
SASS: the same keys → the first 12 hex digits of the sha256 of each
tensor-core instantiation's machine code (cuobjdump -sass of the copy's
library), so two copies' kernels can be seen to be the same code.
"""

import hashlib
import importlib.util
import json
import os
import sys

_ARGS = [a for a in sys.argv[1:] if not a.startswith("--")]
ONLY_F32_D256 = "--f32-d256" in sys.argv[1:]
ROOT = os.path.abspath(_ARGS[0] if _ARGS else os.path.join(
    os.path.dirname(os.path.abspath(__file__)), ".."))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from imageanalysis_tpu_torch import _build, probes  # noqa: E402
from imageanalysis_tpu_torch.ops import knn  # noqa: E402
from imageanalysis_tpu_torch.probes import knn_stages  # noqa: E402


def planted(gen, pairs, n):
    a = torch.randint(0, 100, (pairs, n, 128), generator=gen, device="cuda",
                      dtype=torch.int16)
    b = torch.randint(0, 100, (pairs, n, 128), generator=gen, device="cuda",
                      dtype=torch.int16)
    b[:, :n // 4] = (a[:, :n // 4] + 2).clamp(0, 255)
    return (a - 128).to(torch.int8), (b - 128).to(torch.int8)


def orb_bits(gen, pairs, n):
    """int8 rows of 256 values as the store holds ORB's bits (−128/−127),
    B's first quarter A's with 8 bits flipped."""
    a = torch.randint(0, 2, (pairs, n, 256), generator=gen, device="cuda",
                      dtype=torch.int16)
    b = torch.randint(0, 2, (pairs, n, 256), generator=gen, device="cuda",
                      dtype=torch.int16)
    b[:, :n // 4] = a[:, :n // 4]
    b[:, :n // 4, :8] = 1 - b[:, :n // 4, :8]
    return (a - 128).to(torch.int8), (b - 128).to(torch.int8)


def as_float(a, b, dtype=torch.bfloat16):
    af, bf = a.float() + 128, b.float() + 128
    return af.to(dtype), bf.to(dtype), (af * af).sum(-1), (bf * bf).sum(-1)


def product_only(f, tag, probe="bf16_d256_raw"):
    """The product-only stage (product + row sum) of bf16 (or, probe
    "f32_d256_raw", f32) at 256 values a row on both bodies of a copy that
    has them: {"row_sum_<body>_d256_<tag>": ms}."""
    fn = getattr(knn_stages, probe)
    return {f"row_sum_{body}_d256_{tag}": probes.time_ms(
        lambda: fn(f[0], f[1], mode="row_sum", body=body), "cuda", 3, 2)
        for body in ("wg", "mma")}


def f32_d256(gen, out):
    """K1 f32 plain and gated at 256 × 4096 and K3 f32 at 64 × 10240, at
    256 values a row (ORB's bits as f32), and the product-only stage on
    both bodies where the copy has knn_stages.f32_d256_raw."""
    split = hasattr(knn_stages, "f32_d256_raw")
    f = as_float(*orb_bits(gen, 256, 4096), torch.float32)
    gate = (torch.rand((256, 4096, 2), generator=gen, device="cuda") * 1000,
            torch.rand((256, 4096, 2), generator=gen, device="cuda") * 1000,
            400.0 ** 2)
    out["f32_d256_store"] = probes.time_ms(lambda: knn.knn_packed_raw(*f),
                                           "cuda", 3, 2)
    out["gated_f32_d256_store"] = probes.time_ms(
        lambda: knn.knn_packed_raw(*f, *gate), "cuda", 3, 2)
    if split:
        out.update(product_only(f, "f32_store", "f32_d256_raw"))
    del f, gate
    f = as_float(*orb_bits(gen, 64, 10240), torch.float32)
    out["k3_f32_d256"] = probes.time_ms(lambda: knn.knn_wide_raw(*f),
                                        "cuda", 3, 2)
    if split:
        out.update(product_only(f, "k3_f32", "f32_d256_raw"))
    del f


def own_build_module():
    """This checkout's _build.py (stdlib only), for its log parsers."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "imageanalysis_tpu_torch", "_build.py")
    spec = importlib.util.spec_from_file_location("own_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sass_digests(own):
    """{"type mode BM BN STAGES": sha256[:12] of its SASS} for the
    tensor-core body's instantiations in the copy's library."""
    return own.tc_kernel_usage({
        name: hashlib.sha256("\n".join(lines).encode()).hexdigest()[:12]
        for name, lines in own.sass(_build.build()).items()})


def main():
    if not os.path.abspath(_build.__file__).startswith(ROOT + os.sep):
        sys.exit(f"imageanalysis_tpu_torch came from {_build.__file__}, "
                 f"not {ROOT}")
    gen = torch.Generator(device="cuda").manual_seed(2)
    _build.load()

    def t(fn, reps=5):
        return probes.time_ms(fn, "cuda", reps, 2)

    out = {}
    if ONLY_F32_D256:
        f32_d256(gen, out)
        return report(out)
    for name, pairs, n in (("store", 256, 4096), ("bench", 64, 6144)):
        a, b = planted(gen, pairs, n)
        f = as_float(a, b)
        out[f"i8_{name}"] = t(lambda: knn.knn_packed_raw(a, b))
        out[f"bf16_{name}"] = t(lambda: knn.knn_packed_raw(*f))
        if name == "store":
            f32 = as_float(a, b, torch.float32)
            out["f32"] = t(lambda: knn.knn_packed_raw(*f32), 3)
            gate = (torch.rand((pairs, n, 2), generator=gen, device="cuda")
                    * 1000,
                    torch.rand((pairs, n, 2), generator=gen, device="cuda")
                    * 1000, 400.0 ** 2)
            out["gated_i8"] = t(lambda: knn.knn_packed_raw(a, b, None, None,
                                                           *gate))
            out["gated_bf16"] = t(lambda: knn.knn_packed_raw(*f, *gate))
            out["gated_f32"] = t(lambda: knn.knn_packed_raw(*f32, *gate), 3)
            del gate, f32
        del a, b, f
    a, b = planted(gen, 64, 10240)
    f = as_float(a, b)
    out["k3_bf16"] = t(lambda: knn.knn_wide_raw(*f), 3)
    del f
    f = as_float(a, b, torch.float32)
    out["k3_f32"] = t(lambda: knn.knn_wide_raw(*f), 3)
    del a, b, f
    f = as_float(*orb_bits(gen, 64, 6144))
    gate = (torch.rand((64, 6144, 2), generator=gen, device="cuda") * 1000,
            torch.rand((64, 6144, 2), generator=gen, device="cuda") * 1000,
            400.0 ** 2)
    out["bf16_d256_bench"] = t(lambda: knn.knn_packed_raw(*f))
    out["gated_bf16_d256_bench"] = t(lambda: knn.knn_packed_raw(*f, *gate))
    split = hasattr(knn_stages, "bf16_d256_raw")
    if split:
        out.update(product_only(f, "bench"))
    del f, gate
    f = as_float(*orb_bits(gen, 64, 10240))
    out["k3_bf16_d256"] = t(lambda: knn.knn_wide_raw(*f), 3)
    if split:
        out.update(product_only(f, "k3"))
    del f
    f32_d256(gen, out)
    report(out)


def report(out):
    """Print the JSON line: times, this copy's registers and SASS."""
    own = own_build_module()
    regs = own.tc_kernel_usage(own.ptxas_usage(_build.build_log))
    print(json.dumps({"root": ROOT, "device": torch.cuda.get_device_name(0),
                      "ms": {k: round(v, 4) for k, v in out.items()},
                      "tc_registers": regs, "tc_sass": sass_digests(own)}),
          flush=True)


if __name__ == "__main__":
    main()

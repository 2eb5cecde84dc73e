"""Port parity: int8, bf16 and f32 rows of 128 values (SIFT's) through
``probes.knn_stages.i8_d128_raw``, ``bf16_d128_raw`` and ``f32_d128_raw``
(K1's mode plain and gated, K3's, the product-only stage), and the build
log's parser for the ``wgmma`` body of ``csrc/knn_wg.cuh`` at 128 values
a row.

On the CPU the wrapper takes its plain version whatever the body, so
these tests hold that plain version once: K1's mode bit-exact against the JAX
package's Pallas K1 (interpret mode) on the same rows (bf16 rows hold
the int8 rows plus 128: the integer distances, and so the keys, are the
same; f32 rows go to the Pallas K1 as f32, its Precision.HIGHEST arm),
K3's against ``ops.knn.knn_wide_plain`` (itself held against the JAX
package's Pallas K3 by ``tests/test_torch_knn.py``), the gated and
product-only modes against ``ops.knn``'s plain version and numpy. The
kernels themselves run in ``tests/test_torch_cuda.py`` on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageanalysis_tpu.ops import knn as jknn
from imageanalysis_tpu_torch import _build
from imageanalysis_tpu_torch.ops import knn as tknn
from imageanalysis_tpu_torch.probes import knn_stages
from torch_threads import one_torch_thread  # noqa: F401


def _rows(rng, pairs, n_a, n_b, full):
    """int8 rows (value − 128): SIFT-like 0..99, or (full) the whole
    −128..127 with an all −128 and an all 127 row on each side (the
    largest d2, 128·255², and the extreme norms); B's first quarter A's
    plus small noise."""
    hi = 256 if full else 100
    a = rng.integers(0, hi, (pairs, n_a, 128))
    b = rng.integers(0, hi, (pairs, n_b, 128))
    k = min(n_a, n_b) // 4
    b[:, :k] = np.clip(a[:, :k] + rng.integers(-4, 5, (pairs, k, 128)), 0,
                       255)
    if full:
        a[:, 1], a[:, 2] = 0, 255
        b[:, 3], b[:, 4] = 0, 255
    return (a - 128).astype(np.int8), (b - 128).astype(np.int8)


def _bf16(a, b, dtype=torch.bfloat16):
    """The int8 rows as bf16 (or dtype) 0..255 with their f32 squared
    norms."""
    x, y = (torch.from_numpy(v.astype(np.float32) + 128) for v in (a, b))
    return x.to(dtype), y.to(dtype), (x * x).sum(-1), (y * y).sum(-1)


def _args(kind, a, b):
    """The int8 rows as kind's arguments: int8 without norms, bf16 or f32
    0..255 with their norms."""
    if kind == "i8":
        return torch.from_numpy(a), torch.from_numpy(b), None, None
    return _bf16(a, b, torch.bfloat16 if kind == "bf16" else torch.float32)


def _pallas(a, b, f32=False):
    """The JAX package's Pallas K1 (interpret mode on the CPU), pair by
    pair, on the int8 rows, or (f32) on them as f32 0..255 with f32
    norms: (row_p (B, n_a, 2), col_p (B, n_b)) as numpy."""
    rows, cols = [], []
    kind = jnp.float32 if f32 else jnp.int32
    for x, y in zip(a, b):
        ja, jb = jnp.asarray(x), jnp.asarray(y)
        if f32:
            ja, jb = (v.astype(jnp.float32) + 128 for v in (ja, jb))
        na2 = jnp.sum(jnp.square(ja.astype(kind)), -1, keepdims=True)
        nb2 = jnp.sum(jnp.square(jb.astype(kind)), -1, keepdims=True)
        rp, cp = jknn._knn_packed_raw(ja, jb, na2, nb2, 128, y.shape[0])
        rows.append(np.asarray(rp))
        cols.append(np.asarray(cp)[0])
    return np.stack(rows), np.stack(cols)


@pytest.mark.parametrize("full", [False, True], ids=["sift", "full_range"])
@pytest.mark.parametrize("kind", ["i8", "bf16", "f32"])
def test_d128_packed_bit_exact_vs_pallas(rng, kind, full):
    """K1 int8, bf16 and f32 at 128 values a row through i8_d128_raw,
    bf16_d128_raw and f32_d128_raw (on the CPU their plain version,
    uncounted), bit-exact against the JAX package's Pallas K1 in
    interpret mode on the same rows (f32: as f32 0..255 with f32 norms,
    the Pallas K1's Precision.HIGHEST arm), 2 pairs × 256 rows."""
    a, b = _rows(rng, 2, 256, 256, full)
    rp, cp = _pallas(a, b, f32=kind == "f32")
    entry = f"knn_{kind}_d128"
    before = knn_stages.LAUNCHES[entry]
    got = getattr(knn_stages, f"{kind}_d128_raw")(*_args(kind, a, b),
                                                  mode="packed")
    assert knn_stages.LAUNCHES[entry] == before
    np.testing.assert_array_equal(got[0].numpy(), rp)
    np.testing.assert_array_equal(got[1].numpy(), cp)


def _gate(rng, pairs, n_a, n_b):
    return (torch.from_numpy(rng.uniform(0, 100, (pairs, n_a, 2))
                             .astype(np.float32)),
            torch.from_numpy(rng.uniform(0, 100, (pairs, n_b, 2))
                             .astype(np.float32)), 5.0 ** 2)


@pytest.mark.parametrize("kind,mode", [
    ("i8", "gated"), ("i8", "row_sum"), ("bf16", "gated"),
    ("bf16", "row_sum"), ("f32", "gated"), ("f32", "row_sum")])
def test_d128_modes_on_cpu_are_plain(rng, kind, mode):
    """The gated and product-only modes of i8_d128_raw, bf16_d128_raw and
    f32_d128_raw on the CPU are their plain versions: K1's gated keys
    (knn_packed_plain, some candidates gated out), each A row's wrapping
    sum of its dots against numpy; uncounted."""
    a, b = _rows(rng, 2, 128, 192, True)
    args = _args(kind, a, b)
    raw = getattr(knn_stages, f"{kind}_d128_raw")
    entry = f"knn_{kind}_d128"
    before = knn_stages.LAUNCHES[entry]
    if mode == "row_sum":
        dots = np.einsum("pik,pjk->pij", args[0].double().numpy(),
                         args[1].double().numpy()).sum(-1)
        want = ((dots.astype(np.int64) + 2**31) % 2**32 - 2**31)
        row, col = raw(args[0], args[1], mode="row_sum")
        assert np.array_equal(row[..., 0].numpy(), want)
        assert torch.equal(row[..., 0], row[..., 1])
        assert bool((col == 0x7FFFFFFF).all())
    else:
        gate = _gate(rng, 2, 128, 192)
        got = raw(*args, *gate)
        want = tknn.knn_packed_plain(*args, *gate)
        assert bool(((got[0] & ~0x1FFF) == 0x7FFFE000).any())
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert knn_stages.LAUNCHES[entry] == before


@pytest.mark.parametrize("full", [False, True], ids=["sift", "full_range"])
@pytest.mark.parametrize("kind", ["bf16", "f32"])
def test_d128_wide_on_cpu_is_knn_wide_plain(rng, kind, full):
    """K3's mode of bf16_d128_raw and f32_d128_raw (on the CPU their plain
    version, whatever the body; uncounted) equals knn_wide_plain on the
    same rows bit for bit, 2 pairs × 192 A rows × 320 B rows, with
    duplicate rows so that values tie."""
    a, b = _rows(rng, 2, 192, 320, full)
    a[:, 1::2], b[:, 1::2] = a[:, ::2], b[:, ::2]
    args = _args(kind, a, b)
    raw = getattr(knn_stages, f"{kind}_d128_raw")
    entry = f"knn_{kind}_d128"
    before = knn_stages.LAUNCHES[entry]
    want = tknn.knn_wide_plain(*args)
    for body in ("mma", "wg"):
        got = raw(*args, mode="wide", body=body)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert knn_stages.LAUNCHES[entry] == before


@pytest.mark.parametrize("kind", ["i8", "bf16", "f32"])
def test_d128_raw_rejects_what_it_does_not_take(rng, kind):
    a, b = _rows(rng, 1, 64, 64, False)
    args = _args(kind, a, b)
    raw = getattr(knn_stages, f"{kind}_d128_raw")
    with pytest.raises(ValueError, match="no mode"):
        raw(*args, mode="top2")
    with pytest.raises(ValueError, match="no mode"):
        raw(*args, body="ffma")
    if kind == "i8":                  # K3 takes no int8
        with pytest.raises(ValueError, match="no mode 'wide'"):
            raw(*args, mode="wide", body="mma")
    else:                             # K3 without its norms
        with pytest.raises(ValueError, match="norms"):
            raw(*args[:2], mode="wide")
    if kind != "i8":                  # K1's float modes without norms
        with pytest.raises(ValueError, match="norms"):
            raw(*args[:2], mode="packed")
    with pytest.raises(ValueError, match="128"):
        raw(torch.cat([args[0]] * 2, -1), torch.cat([args[1]] * 2, -1),
            *args[2:])
    with pytest.raises(ValueError, match="int8" if kind == "i8"
                       else "bfloat16" if kind == "bf16" else "float32"):
        raw(args[0].double(), args[1].double(), *args[2:])
    gate = (torch.zeros((1, 64, 2)), torch.zeros((1, 64, 2)), 1.0)
    for mode in ("row_sum",) + (() if kind == "i8" else ("wide",)):
        with pytest.raises(ValueError, match="gate"):
            raw(*args, *gate, mode=mode)
    with pytest.raises(ValueError, match="no kernel"):
        raw(*(None if x is None else x.to("meta") for x in args),
            body="wg", mode="packed" if kind == "i8" else "wide")


def test_build_log_reads_the_wgmma_body_at_128():
    """The build log's parser on ptxas's lines of the wgmma body at 128
    values a row (int8_t mangled "a", bf16 bits "t", f32's planes
    "NS_6Bf16x3E") in its plain, gated, wide and product-only modes (f32's
    K1 modes among them),
    beside the mma.sync bodies at 128 it replaced (K3's yardsticks among
    them) and the wgmma body at 256."""
    wg = "_ZN3knn2wg13knn_wg_kernelI{}Li{}EEEv14CUtensorMap_stS2_PKjPKf"
    mma = "_ZN3knn2tc13knn_tc_kernelI{}Li{}ELi128ELi{}ELi2EEEvPKT_S4_PKf"
    kernels = [(wg.format(t, m), regs, spill)
               for t in ("a", "t") for m, regs, spill in
               ((0, 168, 0), (1, 168, 8), (3, 154, 0))]
    kernels += [(wg.format("t", 2), 168, 4), (wg.format("NS_6Bf16x3E", 2),
                                              168, 0),
                (wg.format("NS_6Bf16x3E", 3), 160, 0),
                (wg.format("NS_6Bf16x3E", 0), 168, 0),
                (wg.format("NS_6Bf16x3E", 1), 166, 0)]
    kernels += [(mma.format("a", 0, 128), 126, 0),
                (mma.format("t", 0, 128), 128, 0),
                (mma.format("t", 2, 128), 128, 0),
                (mma.format("NS_6Bf16x3E", 2, 64), 255, 0),
                (wg.format("NS_4D256IaEE", 0), 168, 0),
                (wg.format("NS_4D256INS_6Bf16x3EEE", 2), 168, 0)]
    lines = []
    for name, regs, spill in kernels:
        lines += [
            f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
            f"ptxas info    : Function properties for {name}",
            f"    0 bytes stack frame, {spill} bytes spill stores, "
            f"{spill} bytes spill loads",
            f"ptxas info    : Used {regs} registers, used 16 barriers"]
    usage = _build.tc_kernel_usage(_build.ptxas_usage("\n".join(lines)))
    assert usage == {"int8 0 wg": (168, 0, 0), "int8 1 wg": (168, 8, 8),
                     "int8 3 wg": (154, 0, 0), "bf16 0 wg": (168, 0, 0),
                     "bf16 1 wg": (168, 8, 8), "bf16 3 wg": (154, 0, 0),
                     "bf16 2 wg": (168, 4, 4), "f32 2 wg": (168, 0, 0),
                     "f32 3 wg": (160, 0, 0), "f32 0 wg": (168, 0, 0),
                     "f32 1 wg": (166, 0, 0),
                     "int8 0 128 128 2": (126, 0, 0),
                     "bf16 0 128 128 2": (128, 0, 0),
                     "bf16 2 128 128 2": (128, 0, 0),
                     "f32 2 128 64 2": (255, 0, 0),
                     "int8_d256 0 wg": (168, 0, 0),
                     "f32_d256 2 wg": (168, 0, 0)}

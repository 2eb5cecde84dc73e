"""Port parity: bf16 and f32 rows of 256 values (ORB's bits) on either
tensor-core body through ``probes.knn_stages.bf16_d256_raw`` and
``f32_d256_raw`` (K1's mode plain and gated, K3's, the product-only
stage), and the build log's parsers for the ``wgmma`` body of
``csrc/knn_wg.cuh`` at both types.

On the CPU the wrapper takes its plain version whatever the body, so
these tests hold that plain version: K1's mode bit-exact against the JAX
package's Pallas K1 (interpret mode) on the same ORB bits (as int8
there: the integer distances, and so the keys, are the same), K3's and
the gated mode against ``ops.knn``'s plain versions, the product-only
stage against numpy. The kernels themselves run in
``tests/test_torch_cuda.py`` on the card.
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


def _bits(rng, pairs, n_a, n_b):
    """ORB's bits as 0/1: B's first quarter A's with 8 bits flipped."""
    a = rng.integers(0, 2, (pairs, n_a, 256))
    b = rng.integers(0, 2, (pairs, n_b, 256))
    k = min(n_a, n_b) // 4
    b[:, :k] = a[:, :k]
    b[:, :k, :8] = 1 - b[:, :k, :8]
    return a, b


def _bf16(a, b):
    x, y = (torch.from_numpy(v.astype(np.float32)) for v in (a, b))
    return x.bfloat16(), y.bfloat16(), (x * x).sum(-1), (y * y).sum(-1)


@pytest.mark.parametrize("body", ["mma", "wg"])
def test_bf16_d256_packed_bit_exact_vs_pallas(rng, body):
    a, b = _bits(rng, 1, 192, 320)
    ja, jb = (jnp.asarray((v[0] - 128).astype(np.int8)) for v in (a, b))
    na2 = jnp.sum(jnp.square(ja.astype(jnp.int32)), -1, keepdims=True)
    nb2 = jnp.sum(jnp.square(jb.astype(jnp.int32)), -1, keepdims=True)
    rp, cp = jknn._knn_packed_raw(ja, jb, na2, nb2, 64, 320)
    before = knn_stages.LAUNCHES["knn_bf16_d256"]
    trp, tcp = knn_stages.bf16_d256_raw(*_bf16(a, b), body=body)
    assert knn_stages.LAUNCHES["knn_bf16_d256"] == before
    np.testing.assert_array_equal(trp[0].numpy(), np.asarray(rp))
    np.testing.assert_array_equal(tcp[0].numpy(), np.asarray(cp)[0])


@pytest.mark.parametrize("mode", ["gated", "wide", "row_sum"])
def test_bf16_d256_modes_on_cpu_are_plain(rng, mode):
    a, b = _bits(rng, 2, 128, 192)
    x, y, na2, nb2 = _bf16(a, b)
    if mode == "row_sum":
        row, col = knn_stages.bf16_d256_raw(x, y, mode="row_sum", body="wg")
        dots = np.einsum("pik,pjk->pij", a, b).sum(-1)
        assert np.array_equal(row[..., 0].numpy(), dots)
        assert torch.equal(row[..., 0], row[..., 1])
        assert bool((col == 0x7FFFFFFF).all())
        return
    if mode == "wide":
        got = knn_stages.bf16_d256_raw(x, y, na2, nb2, mode="wide")
        want = tknn.knn_wide_plain(x, y, na2, nb2)
    else:
        gate = (torch.from_numpy(rng.uniform(0, 100, (2, 128, 2))
                                 .astype(np.float32)),
                torch.from_numpy(rng.uniform(0, 100, (2, 192, 2))
                                 .astype(np.float32)), 5.0 ** 2)
        got = knn_stages.bf16_d256_raw(x, y, na2, nb2, *gate)
        want = tknn.knn_packed_plain(x, y, na2, nb2, *gate)
        assert bool(((got[0] & ~0x1FFF) == 0x7FFFE000).any())
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_bf16_d256_raw_rejects_what_it_does_not_take(rng):
    x, y, na2, nb2 = _bf16(*_bits(rng, 1, 64, 64))
    with pytest.raises(ValueError, match="no mode"):
        knn_stages.bf16_d256_raw(x, y, na2, nb2, mode="top2")
    with pytest.raises(ValueError, match="no mode"):
        knn_stages.bf16_d256_raw(x, y, na2, nb2, body="ffma")
    with pytest.raises(ValueError, match="256"):
        knn_stages.bf16_d256_raw(x[..., :128], y[..., :128], na2, nb2)
    with pytest.raises(ValueError, match="256"):
        knn_stages.bf16_d256_raw(x.float(), y.float(), na2, nb2)
    with pytest.raises(ValueError, match="gate"):
        knn_stages.bf16_d256_raw(x, y, na2, nb2, torch.zeros((1, 64, 2)),
                                 torch.zeros((1, 64, 2)), 1.0, mode="wide")


def test_build_log_reads_the_wgmma_body():
    log = "\n".join([
        "ptxas info    : (C7518) Potential Performance Loss: wgmma."
        "mma_async instructions are serialized in the function "
        "'_ZN3knn2wg13knn_wg_kernelILi2EEEv14CUtensorMap_st'",
        "ptxas info    : Compiling entry function "
        "'_ZN3knn2wg13knn_wg_kernelILi2EEEv14CUtensorMap_st' for 'sm_90a'",
        "ptxas info    : Function properties for "
        "_ZN3knn2wg13knn_wg_kernelILi2EEEv14CUtensorMap_st",
        "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 168 registers, used 16 barriers",
        "ptxas info    : Compiling entry function "
        "'_ZN3knn2tc13knn_tc_kernelINS_4D256ItEELi0ELi128ELi128ELi2EEEvPKT_'"
        " for 'sm_90a'",
        "ptxas info    : Used 163 registers",
        "a.cu(3): warning #177-D: variable \"x\" was declared but never "
        "referenced"])
    usage = _build.tc_kernel_usage(_build.ptxas_usage(log))
    assert usage == {"bf16_d256 2 wg": (168, 8, 12),
                     "bf16_d256 0 128 128 2": (163, 0, 0)}
    lines = log.splitlines()
    assert _build.ptxas_warnings(log) == [lines[0], lines[-1]]


def _f32(a, b, frac=False, rng=None):
    """ORB's bits as f32 rows (frac: plus seeded noise in [0, 0.5), so that
    the mid and lo planes are set) with the f32 squared norms."""
    x, y = (torch.from_numpy(v.astype(np.float32)) for v in (a, b))
    if frac:
        x = x + torch.from_numpy(rng.uniform(0, 0.5, x.shape)
                                 .astype(np.float32))
        y = y + torch.from_numpy(rng.uniform(0, 0.5, y.shape)
                                 .astype(np.float32))
    return x, y, (x * x).sum(-1), (y * y).sum(-1)


@pytest.mark.parametrize("mode", ["packed", "gated", "wide", "row_sum"])
def test_f32_d256_modes_on_cpu_are_plain(rng, mode):
    """f32 at 256 values a row on either body takes its plain version on
    the CPU, uncounted: K1's (plain and gated) and K3's on rows whose mid
    and lo planes are set, the product-only stage on ORB's bits."""
    a, b = _bits(rng, 2, 128, 192)
    x, y, na2, nb2 = _f32(a, b, frac=mode != "row_sum", rng=rng)
    before = knn_stages.LAUNCHES["knn_f32_d256"]
    if mode == "row_sum":
        row, col = knn_stages.f32_d256_raw(x, y, mode="row_sum", body="wg")
        dots = np.einsum("pik,pjk->pij", a, b).sum(-1)
        assert np.array_equal(row[..., 0].numpy(), dots)
        assert torch.equal(row[..., 0], row[..., 1])
        assert bool((col == 0x7FFFFFFF).all())
    else:
        gate = ()
        if mode == "gated":
            gate = (torch.from_numpy(rng.uniform(0, 100, (2, 128, 2))
                                     .astype(np.float32)),
                    torch.from_numpy(rng.uniform(0, 100, (2, 192, 2))
                                     .astype(np.float32)), 5.0 ** 2)
        kw = dict(mode="wide") if mode == "wide" else {}
        for body in ("mma", "wg"):
            got = knn_stages.f32_d256_raw(x, y, na2, nb2, *gate, body=body,
                                          **kw)
            want = (tknn.knn_wide_plain(x, y, na2, nb2) if mode == "wide"
                    else tknn.knn_packed_plain(x, y, na2, nb2, *gate))
            for g, w in zip(got, want):
                assert torch.equal(g, w)
            assert all(torch.equal(g, w) for g, w in zip(
                got, knn_stages.f32_d256_plain(x, y, na2, nb2, *gate, **kw)))
    assert knn_stages.LAUNCHES["knn_f32_d256"] == before


def test_f32_d256_raw_rejects_what_it_does_not_take(rng):
    x, y, na2, nb2 = _f32(*_bits(rng, 1, 64, 64))
    with pytest.raises(ValueError, match="no mode"):
        knn_stages.f32_d256_raw(x, y, na2, nb2, mode="top2")
    with pytest.raises(ValueError, match="no mode"):
        knn_stages.f32_d256_raw(x, y, na2, nb2, body="ffma")
    with pytest.raises(ValueError, match="256"):
        knn_stages.f32_d256_raw(x[..., :128], y[..., :128], na2, nb2)
    with pytest.raises(ValueError, match="float32"):
        knn_stages.f32_d256_raw(x.bfloat16(), y.bfloat16(), na2, nb2)
    with pytest.raises(ValueError, match="gate"):
        knn_stages.f32_d256_raw(x, y, na2, nb2, torch.zeros((1, 64, 2)),
                                torch.zeros((1, 64, 2)), 1.0, mode="wide")
    with pytest.raises(ValueError, match="norms"):
        knn_stages.f32_d256_plain(x, y, mode="wide")


def test_build_log_reads_both_wgmma_bodies():
    """The build log's parser on ptxas's lines of the wgmma body templated
    on its operand: bf16 (D256<uint16_t>) and f32 (D256<Bf16x3>) at 256
    values a row, beside the f32 mma.sync body it replaced."""
    wg = "_ZN3knn2wg13knn_wg_kernelI{}Li{}EEEv14CUtensorMap_stS2_PKjPKf"
    bf16 = wg.format("NS_4D256ItEE", 1)
    f32 = wg.format("NS_4D256INS_6Bf16x3EEE", 2)
    mma = ("_ZN3knn2tc13knn_tc_kernelINS_4D256INS_6Bf16x3EEELi2ELi64ELi64"
           "ELi1EEEvPKT_")
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{bf16}' for 'sm_90a'",
        f"ptxas info    : Function properties for {bf16}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 16 barriers",
        f"ptxas info    : Compiling entry function '{f32}' for 'sm_90a'",
        f"ptxas info    : Function properties for {f32}",
        "    0 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 168 registers, used 16 barriers",
        f"ptxas info    : Compiling entry function '{mma}' for 'sm_90a'",
        "ptxas info    : Used 255 registers",
        "ptxas info    : (C7518) Potential Performance Loss: wgmma.mma_async"
        f" instructions are serialized in the function '{f32}'"])
    usage = _build.tc_kernel_usage(_build.ptxas_usage(log))
    assert usage == {"bf16_d256 1 wg": (168, 0, 0),
                     "f32_d256 2 wg": (168, 4, 8),
                     "f32_d256 2 64 64 1": (255, 0, 0)}
    assert _build.ptxas_warnings(log) == [log.splitlines()[-1].strip()]

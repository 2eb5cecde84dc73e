"""Port parity: the on-card probes P1–P6 (``imageanalysis_tpu_torch/probes``)
against the TPU dev probes of ``scripts_dev/``.

The dev scripts run their benchmarks when imported, so they are not
imported: each is parsed, and only its imports, its function definitions
and its ``_IDX_MASK``/``_KEY_MAX`` run, in a namespace that sets small
shapes (n = 256, TA = 64, two pairs) and a ``pl`` whose ``pallas_call``
adds ``interpret=True`` and records each kernel with its specs. A test
then calls the recorded kernel on one pair at a time (the scripts vmap it)
and compares arrays with the port's plain version on the same seeded numpy
inputs. Integer-valued descriptors make every dot, distance and key exact,
so the comparisons are bit-exact; P5's normal inputs are held to a stated
relative tolerance (f32 sums in another order).
"""

import ast
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as real_pl

from imageanalysis_tpu_torch import probes
from imageanalysis_tpu_torch.ops import knn as tknn
from imageanalysis_tpu_torch.probes import fused, knn_stages, mma
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, TA, PAIRS = 256, 64, 2


class _Pallas:
    """pl with pallas_call in interpret mode, recording (kernel, specs)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return getattr(real_pl, name)

    def pallas_call(self, kernel, **kw):
        self.calls.append((kernel, kw))
        return real_pl.pallas_call(kernel, interpret=True, **kw)

    def rerun(self, *args):
        """The last recorded kernel on args (one pair, unbatched)."""
        kernel, kw = self.calls[-1]
        return real_pl.pallas_call(kernel, interpret=True, **kw)(*args)


def _load(script, **consts):
    """A dev script's imports, functions and _IDX_MASK/_KEY_MAX, run in a
    namespace holding consts; returns (namespace, its pl)."""
    path = os.path.join(REPO, "scripts_dev", script)
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    keep = [n for n in tree.body
            if isinstance(n, (ast.Import, ast.ImportFrom, ast.FunctionDef))
            or (isinstance(n, ast.Assign)
                and all(isinstance(t, ast.Name)
                        and t.id in ("_IDX_MASK", "_KEY_MAX")
                        for t in n.targets))]
    ns = dict(consts)
    exec(compile(ast.Module(body=keep, type_ignores=[]), path, "exec"), ns)
    ns["pl"] = _Pallas()
    return ns, ns["pl"]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _int8_pairs(seed, planted=64):
    """Two pairs of int8 rows (value − 128 of 0..255), the first planted B
    rows near their A rows, as the scripts draw them."""
    rng = np.random.default_rng(seed)
    a8 = rng.integers(0, 256, (PAIRS, N, 128))
    b8 = rng.integers(0, 256, (PAIRS, N, 128))
    b8[:, :planted] = np.clip(a8[:, :planted]
                              + rng.integers(-3, 4, (PAIRS, planted, 128)),
                              0, 255)
    return ((a8 - 128).astype(np.int8), (b8 - 128).astype(np.int8),
            a8.astype(np.uint8), b8.astype(np.uint8))


def _norms(x):
    return np.square(x.astype(np.int32)).sum(-1, keepdims=True)


def _reference_rows(pl, fn, ai, bi, with_col):
    """Trace fn (records the kernel), then run the kernel pair by pair:
    (row (P, N, 2), col (P, N) or None)."""
    na2, nb2 = _norms(ai), _norms(bi)
    jax.eval_shape(fn, ai, bi, na2, nb2)
    rows, cols = [], []
    for p in range(PAIRS):
        out = pl.rerun(ai[p], bi[p], na2[p], nb2[p])
        out = out if isinstance(out, (list, tuple)) else [out]
        rows.append(np.asarray(out[0]))
        if with_col:
            cols.append(np.asarray(out[1])[0])
    return np.stack(rows), (np.stack(cols) if with_col else None)


@pytest.mark.parametrize("stage", [0, 1, 2, 3, "tc_row_sum"])
def test_p4_stage_plain_equals_reference(stage):
    """knn_stage_cost's stages (TA = 64, TB = n) against the port's
    stages row_sum, top1, top2 and full on both routes: the old bodies'
    (P4_STAGES, knn_probe_plain) and the tensor-core body's (P4_TC_STAGES:
    tc_row_sum_plain, tc_stage_plain); stage 0 also against the
    tensor-core body's product-only stage (its wrapper on the CPU)."""
    tc = stage == "tc_row_sum"
    stage = 0 if tc else stage
    ns, pl = _load("knn_stage_cost.py", N_PAD=N, DIM=128, BATCH=PAIRS,
                   TA=TA, TB=N)
    ai, bi, _, _ = _int8_pairs(stage)
    row, col = _reference_rows(pl, ns["make"](stage), ai, bi, stage == 3)
    if tc:
        routes = [knn_stages.tc_row_sum_raw(_t(ai), _t(bi))]
    else:
        routes = [knn_stages.knn_probe_plain(
            _t(ai), _t(bi), stage=knn_stages.P4_STAGES[stage])] + [
            knn_stages.p4_stage_plain(_t(ai), _t(bi), stage=stage,
                                      body=body)
            for body in knn_stages.P4_BODIES]
        card, route = knn_stages.P4_TC_STAGES[stage]
        want = (knn_stages.tc_row_sum_plain(_t(ai), _t(bi))
                if route == "tc_row_sum" else knn_stages.tc_stage_plain(
                    _t(ai), _t(bi), stage=card))
        assert all(torch.equal(g, w) for g, w in zip(routes[1], want))
    for got_row, got_col in routes:
        np.testing.assert_array_equal(got_row.numpy(), row)
        if stage == 3:
            np.testing.assert_array_equal(got_col.numpy(), col)


@pytest.mark.parametrize("body", ["old", "tc"])
@pytest.mark.parametrize("variant", [0, 1, 2, 3, 4])
def test_p3_variant_plain_equals_reference(variant, body):
    """knn_culprit_bisect's v0–v4 against the port's stages: the old
    bodies' (knn_probe_plain at their B tile of 64 rows) and the
    tensor-core body's (tc_stage_plain, B tiles of 128). v0 and v1 run
    with one B tile (TB = n); v2–v4 with the card body's B tile (TB = 64
    or 128), so v2's restarted top-2 is the last tile's and v3's running
    merge is the whole row's."""
    tb = N if variant < 2 else {"old": 64, "tc": knn_stages.TC_BN}[body]
    ns, pl = _load("knn_culprit_bisect.py", N_PAD=N, DIM=128, BATCH=PAIRS,
                   TA=TA, TB=tb)
    ai, bi, _, _ = _int8_pairs(10 + variant)
    row, col = _reference_rows(pl, ns["make"](variant), ai, bi,
                               variant == 4)
    stage = knn_stages.P3_VARIANTS[variant]
    got_row, got_col = (
        knn_stages.knn_probe_plain(_t(ai), _t(bi), stage=stage,
                                   tile=(64, 64)) if body == "old"
        else knn_stages.tc_stage_plain(_t(ai), _t(bi), stage=stage))
    np.testing.assert_array_equal(got_row.numpy(), row)
    if variant == 4:
        np.testing.assert_array_equal(got_col.numpy(), col)


@pytest.mark.parametrize("body", ["old", "tc", "wg"])
@pytest.mark.parametrize("dtype,ic", [("int8", 0), ("int8", 128),
                                      ("bf16", 0), ("bf16", 128)])
def test_p6_plain_equals_reference(dtype, ic, body):
    """knn_overhead_sweep's product + row min (ta 64, tb n, with and
    without an inner column chunk) against the port's row_min stage (the
    old bodies' plain version), tc_row_min_plain (the mma.sync body's, at
    its K1 tile) and wg_row_min_plain (the wgmma body's, at the dtype's K1
    tile), on int8 rows and on 0..255 rows in bf16."""
    ns, pl = _load("knn_overhead_sweep.py", N_PAD=N, DIM=128, BATCH=PAIRS)
    ai, bi, a8, b8 = _int8_pairs(20 + ic)
    if dtype == "int8":
        x, y, jdt = ai, bi, jnp.int8
    else:
        x, y, jdt = a8.astype(np.float32), b8.astype(np.float32), \
            jnp.bfloat16
    fn, _ = ns["make_fn"](TA, N, jdt, ic)
    jx, jy = jnp.asarray(x, jdt), jnp.asarray(y, jdt)
    jax.eval_shape(fn, jx, jy)
    want = np.stack([np.asarray(pl.rerun(jx[p], jy[p]))[:, 0]
                     for p in range(PAIRS)])
    tx, ty = _t(x), _t(y)
    if dtype == "bf16":
        tx, ty = tx.bfloat16(), ty.bfloat16()
    if body == "old":
        row, col = knn_stages.knn_probe_plain(
            tx, ty, stage=knn_stages.ROW_MIN, tile=(64, 64))
    elif body == "tc":
        row, col = knn_stages.tc_row_min_plain(tx, ty)
    else:
        row, col = knn_stages.wg_row_min_plain(tx, ty)
    assert (col == tknn._KEY_MAX).all()
    np.testing.assert_array_equal(row[..., 0].float().numpy(), want)
    np.testing.assert_array_equal(row[..., 1], row[..., 0])


def test_row_sum_wraps_modulo_2_32():
    """P4's stage 0 is an int32 jnp.sum, which wraps; at 8192 columns of
    dots of 2,080,768 it does, and the plain version wraps the same."""
    a = torch.full((1, 64, 128), -128, dtype=torch.int8)
    b = torch.full((1, 8192, 128), -127, dtype=torch.int8)
    row, _ = knn_stages.knn_probe_plain(a, b, stage=knn_stages.ROW_SUM)
    dots = np.full(8192, 128 * 128 * 127, np.int32)
    want = np.sum(dots, dtype=np.int32)
    assert int(want) == -134217728
    assert (row.numpy() == want).all()


@pytest.mark.parametrize("kind,K", [("normal", 128), ("integer", 512)])
def test_p5_plain_equals_reference(kind, K):
    """matmul_shape_probe's product + row sum (ta 64, tb n) against
    mm_rowsum_plain: integer values in [-2, 2] at K = 512 keep every sum
    below 2²⁴ (bit-exact); normal values within 1e-5 of the largest |sum|
    (f32 sums in another order)."""
    rng = np.random.default_rng(30 + K)
    ns, pl = _load("matmul_shape_probe.py", M=N, N=N, STEPS=1, rng=rng)
    ns["make_pallas"](K, TA, N, jnp.bfloat16)()
    if kind == "normal":
        a, b = rng.normal(0, 1, (N, K)), rng.normal(0, 1, (N, K))
    else:
        a, b = rng.integers(-2, 3, (N, K)), rng.integers(-2, 3, (N, K))
    ja = jnp.asarray(a, jnp.bfloat16)
    jb = jnp.asarray(b, jnp.bfloat16)
    want = np.asarray(pl.rerun(ja, jb))[:, 0]
    got = mma.mm_rowsum_plain(_t(a.astype(np.float32)).bfloat16()[None],
                              _t(b.astype(np.float32)).bfloat16()[None])[0]
    if kind == "integer":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_p5_tiles_keep_the_tpu_points_order_of_area():
    """The TPU probe's four (ta, tb) points land on the wgmma kernel's
    four tiles in the same order of growing area (ties kept in order); the
    first body keeps its own map onto its tiles; mm_rowsum_raw takes the
    plain version on the CPU at each tile."""
    def area(t):
        return t[0] * t[1]
    tpu = sorted(mma.P5_TILES, key=area)
    assert [mma.P5_TILES[t] for t in tpu] == sorted(mma.TILES, key=area)
    assert sorted(mma.P5_TILES.values()) == sorted(mma.TILES)
    assert set(mma.P5_V0_TILES) == set(mma.P5_TILES)
    assert sorted(mma.P5_V0_TILES.values()) == sorted(mma.V0_TILES)
    assert mma.DEFAULT_TILE in mma.TILES
    rng = np.random.default_rng(5)
    x = _t(rng.integers(-2, 3, (2, 256, 64)).astype(np.float32)).bfloat16()
    y = _t(rng.integers(-2, 3, (2, 512, 64)).astype(np.float32)).bfloat16()
    want = mma.mm_rowsum_plain(x, y)
    for tile in mma.TILES:
        assert torch.equal(mma.mm_rowsum_raw(x, y, tile), want)


@pytest.mark.parametrize("blocks,n_tiles,a_tiles,want", [
    (1536, 48, 2, 1), (24, 48, 2, 5), (48, 48, 1, 8), (24, 24, 1, 5)])
def test_p5_split_fills_the_card_by_waves(blocks, n_tiles, a_tiles, want):
    """mm_rowsum_raw's default split on 132 SMs: none at bench's batch
    (1536 blocks of (256, 128)); one matrix (24 or 48 A blocks) split so
    that waves × (B tiles a block + A's load in B tiles) is least."""
    assert mma.best_split(blocks, n_tiles, 132, a_tiles) == want
    cost = [-(-blocks * s // 132) * (-(-n_tiles // s) + a_tiles)
            for s in range(1, n_tiles + 1)]
    assert cost[want - 1] == min(cost)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_p1_plain_equals_reference(precision):
    """epilogue_dot_probe's one-hot dot (T = 32, N = 256) on the hi/mid/lo
    limbs of uniform values. JAX's interpret mode computes the DEFAULT-
    precision dot in exact f32: the plain "f32" version equals it on the
    limbs, the plain "bf16" version equals it on limbs rounded to bf16."""
    T = 32
    ns, pl = _load("epilogue_dot_probe.py", N=N, T=T)
    rng = np.random.default_rng(1)
    j = rng.integers(0, N, (T,)).astype(np.int32)
    u = rng.uniform(0, 4100, (N,)).astype(np.float32)
    vals = mma.limbs(_t(u))
    # the split recombines exactly, as the script prints
    assert torch.equal((vals[0] + vals[1]) + vals[2], _t(u))
    if precision == "f32":      # the limbs are bf16-exact: perturb lo
        vals[2] += 1e-3 * _t(rng.uniform(0, 1, N).astype(np.float32))
    ref_vals = vals.numpy() if precision == "f32" else \
        vals.bfloat16().float().numpy()
    want = np.asarray(pl.pallas_call(
        ns["kern"],
        in_specs=[real_pl.BlockSpec((T, 1), lambda: (0, 0)),
                  real_pl.BlockSpec((3, N), lambda: (0, 0))],
        out_specs=real_pl.BlockSpec((T, 3), lambda: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((T, 3), jnp.float32),
    )(jnp.asarray(j)[:, None], jnp.asarray(ref_vals)))
    got = mma.onehot_gather_plain(_t(j), vals, precision)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("variant", ["full", "nopb", "epi32", "t64"])
def test_p2_plain_equals_reference(variant):
    """fused_vmem_probe's single-launch 2-NN + epilogue (n = 256) against
    fused_probe_plain: bj, ok, and pb where the variant writes it."""
    rng = np.random.default_rng(40)
    a = rng.integers(-128, 128, (N, 128)).astype(np.int8)
    b = rng.integers(-128, 128, (N, 128)).astype(np.int8)
    b[:64] = np.clip(a[:64].astype(int) + rng.integers(-3, 4, (64, 128)),
                     -128, 127)
    uv = rng.uniform(0, 4000, (N, 2)).astype(np.float32)
    ns, _ = _load("fused_vmem_probe.py", n=N, d=128, a=jnp.asarray(a),
                  b=jnp.asarray(b), uv=jnp.asarray(uv))
    cfg = {"full": dict(tile_a=128, tile_e=64),
           "nopb": dict(tile_a=128, tile_e=64, do_pb=False),
           "epi32": dict(tile_a=128, tile_e=32),
           "t64": dict(tile_a=64, tile_e=64)}[variant]
    cfg = dict(dict(do_main=True, do_epi=True, do_pb=True), **cfg)
    bj, ok, pb = (np.asarray(x) for x in ns["make"](**cfg)())
    got = fused.fused_probe_plain(_t(a)[None], _t(b)[None], _t(uv)[None],
                                  variant)
    np.testing.assert_array_equal(got[0][0].numpy(), bj[:, 0])
    np.testing.assert_array_equal(got[1][0].numpy(), ok[:, 0])
    assert ok.sum() >= 60                 # the planted rows survive
    if fused.COMPARED[variant][2]:
        np.testing.assert_array_equal(got[2][0].numpy(), pb)


def test_p2_full_equals_knn_match_fused():
    """Every part on, the probe is the port's two launches (K1, then K4 at
    ratio 0.75) in one: equal bit for bit on int8 ungated pairs."""
    ai, bi, _, _ = _int8_pairs(50)
    uv = _t(np.random.default_rng(50).uniform(0, 4000, (PAIRS, N, 2))
            .astype(np.float32))
    got = fused.fused_probe_raw(_t(ai), _t(bi), uv)
    want = tknn.knn_match_fused(_t(ai), _t(bi), uv, ratio=0.75)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].bool(), want[1])
    assert torch.equal(got[2], want[2])


def test_p2_bodies_take_the_plain_version_on_cpu():
    """Either body routes a CPU tensor to fused_probe_plain, in every
    variant, and launches nothing; an unknown body raises."""
    ai, bi, _, _ = _int8_pairs(51)
    a, b = _t(ai), _t(bi)
    uv = _t(np.random.default_rng(51).uniform(0, 4000, (PAIRS, N, 2))
            .astype(np.float32))
    before = dict(fused.LAUNCHES)
    for variant in fused.VARIANTS:
        want = fused.fused_probe_plain(a, b, uv, variant)
        for body in fused.BODIES:
            got = fused.fused_probe_raw(a, b, uv, variant, body)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="body"):
        fused.fused_probe_raw(a, b, uv, "full", "dp4a")
    assert dict(fused.LAUNCHES) == before


def test_full_stage_is_k1_and_stages_build_up():
    """The full stage is K1's plain version; the running top-2 is the
    full stage's rows; the top-1 its first key; the restarted top-2 the
    last B tile's."""
    ai, bi, _, _ = _int8_pairs(60)
    a, b = _t(ai), _t(bi)
    full = knn_stages.knn_probe_plain(a, b, stage=knn_stages.FULL)
    k1 = tknn.knn_packed_plain(a, b)
    assert all(torch.equal(x, y) for x, y in zip(full, k1))
    top2, col = knn_stages.knn_probe_plain(a, b, stage=knn_stages.TOP2)
    assert torch.equal(top2, k1[0]) and (col == tknn._KEY_MAX).all()
    top1, _ = knn_stages.knn_probe_plain(a, b, stage=knn_stages.TOP1)
    assert torch.equal(top1[..., 0], k1[0][..., 0])
    last, _ = knn_stages.knn_probe_plain(a, b, stage=knn_stages.TOP2_TILE)
    tail, _ = tknn.knn_packed_plain(a, b[:, -64:].contiguous())
    assert torch.equal(last, tail + (N - 64))


@pytest.mark.parametrize("mode", ["k1", "k1_gated", "k3", "dp4a_gated",
                                  "k3_f32"])
def test_ffma_yardstick_is_k1_and_k3_on_cpu(mode):
    """The FFMA bf16 body's wrapper on a CPU tensor is K1's (gated) or
    K3's plain version, which test_torch_knn holds against the reference;
    it refuses int8 and a gate in K3's mode. The __dp4a int8 body's
    wrapper is K1's gated int8 plain version; the FFMA f32 body's in K3's
    mode is K3's f32 plain version, and it refuses bf16."""
    ai, bi, _, _ = _int8_pairs(61)
    a, b = (_t(x).float() + 128.0 for x in (ai, bi))
    args = (a.bfloat16(), b.bfloat16(), (a * a).sum(-1), (b * b).sum(-1))
    rng = np.random.default_rng(62)
    gate = (torch.from_numpy(rng.uniform(0, 100, (PAIRS, N, 2))
                             .astype(np.float32)),
            torch.from_numpy(rng.uniform(0, 100, (PAIRS, N, 2))
                             .astype(np.float32)), 900.0)
    before = dict(knn_stages.LAUNCHES)
    if mode == "dp4a_gated":
        got = knn_stages.dp4a_i8_raw(_t(ai), _t(bi), *gate)
        want = tknn.knn_packed_plain(_t(ai), _t(bi), None, None, *gate)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        with pytest.raises(ValueError, match="int8"):
            knn_stages.dp4a_i8_raw(*args[:2])
        assert dict(knn_stages.LAUNCHES) == before
        return
    if mode == "k3_f32":
        fargs = (a, b, *args[2:])
        got = knn_stages.ffma_f32_raw(*fargs, wide=True)
        want = tknn.knn_wide_plain(*fargs)
        assert got[0].dtype == torch.int64
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        with pytest.raises(ValueError, match="float32"):
            knn_stages.ffma_f32_raw(*args, wide=True)
        assert dict(knn_stages.LAUNCHES) == before
        return
    gate = gate if mode == "k1_gated" else ()
    got = knn_stages.ffma_bf16_raw(*args, *gate, wide=mode == "k3")
    want = (tknn.knn_wide_plain(*args) if mode == "k3"
            else tknn.knn_packed_plain(*args, *gate))
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    with pytest.raises(ValueError, match="bf16"):
        knn_stages.ffma_bf16_raw(_t(ai), _t(bi), *args[2:])
    with pytest.raises(ValueError, match="gate"):
        knn_stages.ffma_bf16_raw(*args, args[2][..., None].expand(
            -1, -1, 2).contiguous(), args[3][..., None].expand(
            -1, -1, 2).contiguous(), 1.0, wide=True)
    assert dict(knn_stages.LAUNCHES) == before


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16],
                         ids=["int8", "bf16"])
def test_tc_row_min_wrapper_rules(dtype):
    """tc_row_min_raw and wg_row_min_raw: a CPU tensor takes the plain
    version (the old row_min stage's result at every tile of each sweep);
    any other device, a tile off the sweep, n_a off the tile's BM (the
    wgmma body's: off 64), n_b off the wgmma tile's BN, f32 and mixed
    types raise ValueError; nothing is launched."""
    ai, bi, _, _ = _int8_pairs(70)
    a, b = _t(ai), _t(bi)
    if dtype == torch.bfloat16:
        a, b = ((x.float() + 128.0).bfloat16() for x in (a, b))
    want = knn_stages.knn_probe_plain(a, b, stage=knn_stages.ROW_MIN)
    before = dict(knn_stages.LAUNCHES)
    assert len(knn_stages.TC_TILES) == len(knn_stages.P6_SWEEP)
    assert knn_stages.K1_TC_TILE in knn_stages.TC_TILES
    for tile in knn_stages.TC_TILES:
        got = knn_stages.tc_row_min_raw(a, b, tile)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), tile
    m = torch.empty((1, 256, 128), dtype=dtype, device="meta")
    with pytest.raises(ValueError, match="meta"):
        knn_stages.tc_row_min_raw(m, m)
    for tile in ((64, 64), (64, 64, 4), (32, 128, 2)):
        with pytest.raises(ValueError, match="tile"):
            knn_stages.tc_row_min_raw(a, b, tile)
        with pytest.raises(ValueError, match="tile"):
            knn_stages.tc_row_min_plain(a, b, tile)
    with pytest.raises(ValueError, match="multiple"):
        knn_stages.tc_row_min_raw(a[:, :192], b, (128, 64, 2))
    with pytest.raises(ValueError, match="multiple"):
        knn_stages.tc_row_min_raw(a.float(), b.float())
    with pytest.raises(ValueError, match="multiple"):
        knn_stages.tc_row_min_raw(a, b.float())
    # the wgmma body's sweep: every tile, and K1's (the default), takes
    # the plain version on the CPU, n_a a multiple of 64 (320 is of no
    # tile's A rows), n_b of the tile's BN
    assert len(knn_stages.WG_TILES) == len(knn_stages.P6_SWEEP)
    assert knn_stages.K1_WG_TILE[dtype] in knn_stages.WG_TILES
    assert {t[1] for t in knn_stages.WG_TILES} == {64, 128, 256}
    a5 = torch.cat([a, a[:, :64]], 1)
    want5 = knn_stages.knn_probe_plain(a5, b, stage=knn_stages.ROW_MIN)
    for tile in knn_stages.WG_TILES + (None,):
        got = knn_stages.wg_row_min_raw(a5, b, tile)
        assert all(torch.equal(g, w) for g, w in zip(got, want5)), tile
    with pytest.raises(ValueError, match="meta"):
        knn_stages.wg_row_min_raw(m, m)
    for tile in ((128, 64, 2), (128, 64, 2, 4), knn_stages.TC_TILES[0]):
        for fn in (knn_stages.wg_row_min_raw, knn_stages.wg_row_min_plain):
            with pytest.raises(ValueError, match="tile"):
                fn(a, b, tile)
        with pytest.raises(ValueError, match="tile"):
            knn_stages.wg_row_min_blocks(dtype, tile)
    with pytest.raises(ValueError, match="BN"):
        knn_stages.wg_row_min_raw(a, b[:, :192], (128, 256, 2, 2))
    with pytest.raises(ValueError, match="multiple"):
        knn_stages.wg_row_min_raw(a[:, :96], b)
    with pytest.raises(ValueError, match="multiple"):
        knn_stages.wg_row_min_raw(a.float(), b.float())
    assert dict(knn_stages.LAUNCHES) == before


def test_probe_wrappers_refuse_what_they_do_not_take():
    """Other devices, tiles, stages and precisions raise; nothing runs."""
    before = (dict(knn_stages.LAUNCHES), dict(mma.LAUNCHES),
              dict(fused.LAUNCHES))
    m8 = torch.empty((1, 64, 128), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="meta"):
        knn_stages.knn_probe_raw(m8, m8)
    c8 = torch.zeros((1, 128, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match="tile"):
        knn_stages.knn_probe_raw(c8, c8, stage=knn_stages.TOP1,
                                 tile=(128, 64))
    with pytest.raises(ValueError, match="tile"):
        knn_stages.knn_probe_raw(c8, c8, stage=knn_stages.ROW_MIN,
                                 tile=(16, 64))
    with pytest.raises(ValueError, match="stage"):
        knn_stages.knn_probe_raw(c8, c8, stage=6)
    with pytest.raises(ValueError, match="norms"):
        knn_stages.knn_probe_raw(c8.bfloat16(), c8.bfloat16(),
                                 stage=knn_stages.TOP1)
    mb = torch.empty((1, 64, 128), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="meta"):
        mma.mm_rowsum_raw(mb, mb)
    with pytest.raises(ValueError, match="bf16"):
        mma.mm_rowsum_raw(c8.float(), c8.float())
    # the wgmma wrapper's rules hold on the CPU too: a tile of the first
    # body only, K off 64, M off BM, a type other than bf16
    x = torch.zeros((1, 256, 128), dtype=torch.bfloat16)
    for tile in set(mma.V0_TILES) - set(mma.TILES):
        with pytest.raises(ValueError, match="tile"):
            mma.mm_rowsum_raw(x, x, tile)
        assert torch.equal(mma.mm_rowsum_v0_raw(x, x, tile),
                           mma.mm_rowsum_plain(x, x))
    with pytest.raises(ValueError, match="multiple of 64"):
        mma.mm_rowsum_raw(x[:, :, :96], x[:, :, :96])
    with pytest.raises(ValueError, match="tile"):
        mma.mm_rowsum_raw(x[:, :128], x, (256, 128))
    with pytest.raises(ValueError, match="bf16"):
        mma.mm_rowsum_raw(x.half(), x.half())
    with pytest.raises(ValueError, match="P4 stage"):
        knn_stages.p4_stage_raw(c8, c8, stage=4)
    with pytest.raises(ValueError, match="P4 stage"):
        knn_stages.p4_stage_raw(c8, c8, stage=0, body="dp4a")
    with pytest.raises(ValueError, match="precision"):
        mma.onehot_gather_raw(torch.zeros(16, dtype=torch.int32),
                              torch.zeros((3, 64)), "f16")
    j16, v64 = torch.arange(16, dtype=torch.int32), torch.rand((3, 64))
    for gather in (mma.onehot_gather_raw, mma.onehot_gather_v0_raw):
        assert torch.equal(gather(j16, v64), mma.onehot_gather_plain(j16,
                                                                     v64))
        with pytest.raises(ValueError, match="precision"):
            gather(j16, v64, "f16")
        with pytest.raises(ValueError, match="meta"):
            gather(j16.to("meta"), v64.to("meta"))
        with pytest.raises(ValueError, match="f32"):
            gather(j16, v64.bfloat16())
    # tc_stage_raw: the plain version on the CPU (top2_tile's last tile
    # is half a tile at n_b = 192); n_a off 128, f32, row_sum and stage 6
    # (not P3's), bf16 without norms and the meta device raise
    x8 = torch.from_numpy(np.random.default_rng(71).integers(
        -128, 128, (1, 128, 128)).astype(np.int8))
    y8 = torch.from_numpy(np.random.default_rng(72).integers(
        -128, 128, (1, 192, 128)).astype(np.int8))
    for stage in knn_stages.P3_VARIANTS.values():
        got = knn_stages.tc_stage_raw(x8, y8, stage=stage)
        want = knn_stages.tc_stage_plain(x8, y8, stage=stage)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    tail, _ = knn_stages.tc_stage_plain(x8, y8, stage=knn_stages.TOP2_TILE)
    assert torch.equal(tail, tknn.knn_packed_plain(
        x8, y8[:, 128:].contiguous())[0] + 128)
    with pytest.raises(ValueError, match="multiple"):
        knn_stages.tc_stage_raw(c8[:, :64], c8)
    with pytest.raises(ValueError, match="multiple"):
        knn_stages.tc_stage_raw(c8.float(), c8.float())
    for stage in (knn_stages.ROW_SUM, 6):
        with pytest.raises(ValueError, match="stage"):
            knn_stages.tc_stage_raw(c8, c8, stage=stage)
    with pytest.raises(ValueError, match="norms"):
        knn_stages.tc_stage_raw(c8.bfloat16(), c8.bfloat16(),
                                stage=knn_stages.TOP1)
    with pytest.raises(ValueError, match="meta"):
        knn_stages.tc_stage_raw(m8, m8)
    uv = torch.zeros((1, 128, 2))
    with pytest.raises(ValueError, match="variant"):
        fused.fused_probe_raw(c8, c8, uv, "half")
    with pytest.raises(ValueError, match="multiple"):
        fused.fused_probe_raw(c8[:, :64], c8[:, :64], uv[:, :64], "full")
    with pytest.raises(ValueError, match="meta"):
        fused.fused_probe_raw(m8, m8, torch.empty((1, 64, 2),
                                                  device="meta"), "t64")
    assert (dict(knn_stages.LAUNCHES), dict(mma.LAUNCHES),
            dict(fused.LAUNCHES)) == before


def test_probe_scripts_and_smoke_import_no_jax():
    """The probe scripts and chip_smoke.py import neither JAX nor the JAX
    package (they run where neither is installed)."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|imageanalysis_tpu)\b",
                         re.M)
    paths = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(REPO, "scripts_torch", f)
        for f in sorted(os.listdir(os.path.join(REPO, "scripts_torch")))
        if f.endswith(".py")]
    assert len(paths) >= 8
    for path in paths:
        with open(path) as f:
            assert not pattern.search(f.read()), path


@pytest.mark.parametrize("empty", [2, 3], ids=["recovers", "gives_up"])
def test_device_kernels_retries_empty_profiles(monkeypatch, empty):
    """A profile that comes back without device events (late in a long
    process on the card) is taken again just after torch.cuda.empty_cache(),
    up to three times in all; then device_kernels raises."""
    from torch.autograd import DeviceType
    tries, freed = [], []

    class Event:
        key, device_type = "kern", DeviceType.CUDA
        self_device_time_total, count = 2000.0, 4

    class Profile:
        def __init__(self, activities):
            tries.append(len(freed))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return [] if len(tries) <= empty else [Event()]

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: freed.append(1))
    monkeypatch.setattr(torch.profiler, "profile", Profile)
    calls = []
    if empty < 3:
        got = probes.device_kernels(lambda: calls.append(1), reps=4)
        assert got == {"kern": 0.5}
    else:
        with pytest.raises(AssertionError, match="no device time"):
            probes.device_kernels(lambda: calls.append(1), reps=4)
    # each retry comes after one empty_cache, the first try after none
    assert tries == list(range(min(empty + 1, 3)))
    assert len(calls) == 1 + 4 * len(tries)

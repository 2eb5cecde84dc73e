"""Port parity: parallel/ (multihost.py, sharded.py) and the pipeline
across processes.

On the CPU, against the JAX package on tests/test_parallel.py's problem
(test_ba.synth_problem with 9 cameras and 200 points, its seed 5):

- PointPartition's fields equal to the reference's, bit for bit, at 2,
  3 and 8 shards; process_shard equal to the reference's over a grid of
  (n, rank, world);
- solve_sharded on a LocalMesh of 8 CPU shards against the reference's
  solve_sharded on 8 virtual devices and against the port's bundle.solve
  in one process, with test_parallel.py's tolerances (mre rtol 0.02,
  cameras 0.3 m: the shards sum in another order, and the LM path wanders
  in the gauge-flat valley); the reference's runs in a child of its own,
  started with the module;
- the observation-sharded step on a LocalMesh against bundle.lm_step;
  sharded_match_pair_batch and sharded_detect equal to the unsharded
  calls; RANSAC's draws keyed by pair; the smart state's shard merge
  equal to the reference's; the kernel build's file lock (one build for
  concurrent callers, without nvcc);

and one launch of 2 gloo ranks (tests/torch_multihost_child.py, with a
one-process run beside it), started when the module starts, each child
with a timeout and a finite process-group timeout. Each of the children's
checks is a case of test_two_ranks: agree and barrier; the
observation-sharded step against one process, its outputs alike on both
ranks; sharded_match_pair_batch over the ranks against the unsharded
call; solve_sharded over the ranks; apps/process.py with the smart
strategy (the match lists equal to the one-process run's, smart.json's
yaw pairs the same, every image's size kept, the cameras within 0.05 m,
models/ the same files, each egg written once); apps/stages.py optimize
--refine (cameras within 0.05 m).
"""

import json
import os
import socket
import subprocess
import sys
import threading
import types

import numpy as np
import pytest
import test_ba
import torch

from imageanalysis_tpu.ba import bundle as jb
from imageanalysis_tpu.parallel import multihost as jmh
from imageanalysis_tpu.parallel import sharded as jsh
from imageanalysis_tpu_torch import _build
from imageanalysis_tpu_torch.ba import bundle as tb
from imageanalysis_tpu_torch.core import camera as tcam
from imageanalysis_tpu_torch.parallel import multihost as tmh
from imageanalysis_tpu_torch.parallel import sharded as tsh
from imageanalysis_tpu_torch.testing.synthetic import (CAMERA_KEY,
                                                       make_mission,
                                                       write_mission)
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "torch_multihost_child.py")
REFERENCE_CHILD = os.path.join(REPO, "tests", "jax_solve_sharded_child.py")
CHILD_TIMEOUT_S = 150       # a child's wall at most; a hang fails the test
GROUP_TIMEOUT_S = "60"      # the process group's own (IMGTPU_DIST_TIMEOUT)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def problem():
    """tests/test_parallel.py's problem as numpy. Its generator projects
    one observation at a time; the port's f32 projections (the camera
    poses memoized) stand in for the reference's eager calls to keep
    that quick."""
    poses = {}

    def rt(ned, quat):
        key = np.asarray(ned).tobytes() + np.asarray(quat).tobytes()
        if key not in poses:
            poses[key] = tcam.ned_quat_to_rt(
                *(torch.from_numpy(np.array(x)) for x in (ned, quat)))
        return poses[key]

    def project(p, R, t, K, dist):
        u, z = tcam.project_points(torch.from_numpy(np.array(p)), R, t,
                                   torch.from_numpy(np.array(K)),
                                   torch.from_numpy(np.array(dist)))
        return u.numpy(), z.numpy()

    fast = types.SimpleNamespace(ned_quat_to_rt=rt, project_points=project)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(test_ba, "cam", fast)
        ct, _, c0, p0, obs = test_ba.synth_problem(
            np.random.default_rng(5), n_cam=9, n_pt=200)
    return (ct, c0, p0, tb.BAObservations(*(np.asarray(x) for x in obs)),
            test_ba.K, test_ba.DIST)


def _start(argv, env, stdin=None):
    return subprocess.Popen(
        [sys.executable] + argv, env=env, cwd=REPO, stdin=stdin,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _result(p, name):
    """Wait for a child (CHILD_TIMEOUT_S at most: killed and failed past
    it); its output."""
    try:
        text, _ = p.communicate(timeout=CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        p.kill()
        text, _ = p.communicate()
        pytest.fail(f"{name} timed out:\n{text[-3000:]}")
    assert p.returncode == 0, f"{name} failed:\n{text[-4000:]}"
    return text


@pytest.fixture(scope="module", autouse=True)
def launch(tmp_path_factory, request):
    """Before the module's other tests run, start the two ranks and the
    one-process run (each on its own copy of an 8-frame 320×240 mission),
    and the reference's sharded solve of the BA problem (8 virtual CPU
    devices), which loads JAX while this process builds the problem; the
    tests that need them wait for them. The one-process run detects the 8
    frames that the ranks split, on two intra-op threads to the ranks'
    one, so it ends with them."""
    root = tmp_path_factory.mktemp("ranks")
    m = make_mission(strips=2, per_strip=4, size=(320, 240), seed=3,
                     device="cpu")
    db = str(root / "db")
    base = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                IMGTPU_DIST_TIMEOUT=GROUP_TIMEOUT_S)
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
              "JAX_COORDINATOR", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        base.pop(k, None)
    port = _free_port()
    out = str(root / "reference.npz")
    procs = {"reference": _start(
        [REFERENCE_CHILD, out],
        dict(base, JAX_PLATFORMS="cpu",
             XLA_FLAGS="--xla_force_host_platform_device_count=8"),
        stdin=subprocess.PIPE)}
    for name in ("single", "rank0", "rank1"):
        d = str(root / ("single" if name == "single" else "multi"))
        if not os.path.isdir(d):
            write_mission(d, m, db)
        cfg = {"mode": "single" if name == "single" else "ranks",
               "mission": d, "db": db, "camera": CAMERA_KEY,
               "threads": 2 if name == "single" else 1}
        env = dict(base)
        if name != "single":
            env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       WORLD_SIZE="2", RANK=name[-1], LOCAL_RANK=name[-1])
        procs[name] = _start([CHILD, json.dumps(cfg)], env)
    _, c0, p0, obs, K, dist = request.getfixturevalue("problem")
    np.savez(root / "problem.npz", cams0=c0, pts0=p0, K=K, dist=dist,
             **obs._asdict())
    procs["reference"].stdin.write(str(root / "problem.npz") + "\n")
    procs["reference"].stdin.flush()
    yield procs, out
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def ranks(launch):
    """{name: the child's RESULT} of the ranks and the one-process run."""
    out = {}
    for name in ("single", "rank0", "rank1"):
        text = _result(launch[0][name], name)
        line = [ln for ln in text.splitlines() if ln.startswith("RESULT ")]
        assert line, f"{name} printed no result:\n{text[-3000:]}"
        out[name] = json.loads(line[-1][len("RESULT "):])
    return out


@pytest.mark.parametrize("shards", [2, 3, 8])
def test_point_partition_matches_reference(problem, shards):
    _, _, pts0, obs, _, _ = problem
    want = jsh.PointPartition(jb.BAObservations(*obs), len(pts0), shards)
    got = tsh.PointPartition(obs, len(pts0), shards)
    for k in ("L", "M", "n_pt_pad"):
        assert getattr(got, k) == getattr(want, k), k
    for k in ("cam_idx", "ptl_idx", "uv", "weight", "pt_off", "m_pts"):
        a, b = getattr(got, k), np.asarray(getattr(want, k))
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


def test_process_shard_matches_reference():
    for n in (0, 1, 5, 37, 103):
        items = list(range(n))
        for world in (1, 2, 3, 4, 8):
            got = []
            for rank in range(world):
                mine = tmh.process_shard(items, rank, world)
                assert mine == jmh.process_shard(items, rank, world)
                got += mine
            assert got == items


def test_observation_sharded_step_matches_one_process(problem):
    _, cams0, pts0, obs, K, dist = problem
    mesh = tsh.LocalMesh(["cpu"] * 3)
    step = tsh.sharded_lm_step(mesh, cg_iters=5)
    args = [torch.from_numpy(x) for x in (cams0, pts0, K, dist)]
    dc, dp, pred = step(args[0], args[1], tsh.shard_observations(obs, mesh),
                        args[2], args[3], 1e-3)
    o = tb.observations_on(obs, "cpu")
    dc1, dp1, pred1 = tb.lm_step(args[0], args[1], o, args[2], args[3], 1e-3,
                                 len(cams0), len(pts0), cg_iters=5)
    # the same step with the sums taken in another order (f32)
    assert float((dc - dc1).abs().max()) <= 1e-3 * float(dc1.abs().max())
    assert float((dp - dp1).abs().max()) <= 1e-3 * float(dp1.abs().max())
    assert abs(float(pred) - float(pred1)) <= 1e-3 * abs(float(pred1))


@pytest.mark.parametrize("given_pick", [True, False])
def test_sharded_match_pair_batch_equals_unsharded(given_pick):
    """With a pick, or with draws keyed by each pair's index in the
    whole batch: the unsharded call's result."""
    from imageanalysis_tpu_torch.match.matcher import match_pair_batch
    from imageanalysis_tpu_torch.ops.ransac import PairDraws

    rng = np.random.default_rng(1)
    B, npad, d, n_hyp = 8, 256, 64, 64
    desc_a = rng.uniform(0, 360, (B, npad, d)).astype(np.float32)
    desc_b = rng.uniform(0, 360, (B, npad, d)).astype(np.float32)
    desc_b[:, :100] = desc_a[:, :100] + rng.normal(0, 2, (B, 100, d))
    uv_a = rng.uniform(0, 1000, (B, npad, 2)).astype(np.float32)
    uv_b = (uv_a + rng.normal(0, 0.5, uv_a.shape)).astype(np.float32)
    n = np.full(B, 200, np.int32)
    # minimal sets from the first 64 of each pair's ~100 survivors
    pick = rng.integers(0, 64, (B, n_hyp, 4))
    args = [torch.from_numpy(x) for x in (desc_a, desc_b, uv_a, uv_b, n, n,
                                          pick)]
    kw = dict(transform="homography", n_hyp=n_hyp, use_pallas=False,
              bf16=False)
    pick = args[6] if given_pick else None
    single = match_pair_batch(*args[:6], PairDraws(0).keyed(torch.arange(B)),
                              pick=pick, **kw)
    fn = tsh.sharded_match_pair_batch(tsh.LocalMesh(["cpu"] * 4), **kw)
    multi = fn(*args[:6], pick=pick)
    assert int(single[1].sum()) > 8 * 90
    for a, b in zip(single, multi):
        assert torch.equal(a, b)


def test_pair_draws_follow_the_pair_not_the_batch():
    """RANSAC's draws in BatchMatcher are keyed by the pair, so a pair
    keeps its matches in any batch and on any rank (the reference draws
    per batch): a pair's uniforms alone equal its row in a batch, and
    the store path's result for a pair alone equals its row when matched
    with others."""
    from imageanalysis_tpu_torch.match.matcher import (
        match_pair_batch_store_scan)
    from imageanalysis_tpu_torch.ops.ransac import PairDraws

    d = PairDraws(42)
    both = d.keyed(torch.tensor([7, 3])).rand((2, 64, 4), "cpu")
    alone = d.keyed(torch.tensor([3])).rand((1, 64, 4), "cpu")
    assert torch.equal(both[1], alone[0])
    assert 0.0 <= float(both.min()) and float(both.max()) < 1.0
    rng = np.random.default_rng(4)
    n_img, npad = 4, 256
    desc = rng.integers(0, 100, (n_img, npad, 128))
    desc[1:, :120] = desc[0, :120]          # every image sees image 0's
    desc = torch.from_numpy((desc + rng.integers(-3, 4, desc.shape)
                             - 128).clip(-128, 127).astype(np.int8))
    uv = torch.from_numpy(rng.uniform(0, 900, (n_img, npad, 2)).astype(
        np.float32))
    uv[1:, :120] = uv[0, :120] + 5.0        # a shift, and noise elsewhere
    counts = torch.full((n_img,), 200)
    kw = dict(thresh=3.0, n_hyp=32, use_pallas=False)

    def run(pairs):
        ia = torch.tensor([[p[0] for p in pairs]])
        ib = torch.tensor([[p[1] for p in pairs]])
        return match_pair_batch_store_scan(desc, uv, counts, ia, ib,
                                           PairDraws(42), **kw)[0]

    together = run([(0, 1), (0, 2), (1, 3)])
    for k, pair in enumerate([(0, 1), (0, 2), (1, 3)]):
        assert torch.equal(run([pair])[0], together[k])
    assert int((together >= 0).sum()) >= 3 * 100


def test_smart_shard_merge_matches_reference(tmp_path):
    """SmartState.save_shard and merge_shard_data against the reference's
    on the same two ranks' evidence: the merged smart.json equal."""
    from imageanalysis_tpu.match import smart as jsmart
    from imageanalysis_tpu_torch.match import smart as tsmart

    def evidence(state, rank):
        for i in range(4):
            a, b = f"IMG_{i}", f"IMG_{i + 1 + rank}"
            state.update_surface_pair(a, b, 10.0 + i + rank, 2.0 + rank,
                                      30.0 + i)
            state.update_yaw_pair(a, b, 1.5 * (i - rank), 20.0 + i, 90.0,
                                  0.5 + i)
        state.node("IMG_0")["srtm_surface_m"] = 7.0 + rank

    merged = {}
    for pkg in (jsmart, tsmart):
        d = tmp_path / pkg.__name__
        d.mkdir()
        states = [pkg.SmartState(str(d)) for _ in range(2)]
        for rank, st in enumerate(states):
            evidence(st, rank)
        states[1].save_shard(str(d / "smart_rank1.json"))
        with open(d / "smart_rank1.json") as f:
            states[0].merge_shard_data(json.load(f))
        states[0].save()
        with open(d / "smart.json") as f:
            merged[pkg.__name__] = json.load(f)
    want = merged[jsmart.__name__]
    assert merged[tsmart.__name__] == want
    assert len(want["IMG_0"]["yaw_pairs"]) == 2


def test_sharded_detect_equals_unsharded():
    from imageanalysis_tpu_torch.features import sift

    rng = np.random.default_rng(2)
    imgs = torch.from_numpy(rng.uniform(0, 1, (2, 64, 64)).astype(
        np.float32))
    fn = tsh.sharded_detect(tsh.LocalMesh(["cpu"] * 2), 32, 2)
    got = fn(imgs)
    want = sift._detect_batch(imgs, 32, 2)
    assert bool(want[3].any())
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_build_lock_builds_once(tmp_path, monkeypatch):
    """Callers that find no library at once build it once: the others wait
    for the lock and load it. A fake nvcc counts its calls."""
    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> {calls}\n'
        'while [ $# -gt 0 ]; do [ "$1" = "-o" ] && out="$2"; shift; done\n'
        'sleep 0.3\n: > "$out"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    paths = [None] * 3

    def call(i):
        paths[i] = _build.build()

    threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    lines = calls.read_text().splitlines()
    assert len({*paths}) == 1 and os.path.isfile(paths[0])
    assert sum("-shared" in ln for ln in lines) == 1
    assert len(lines) == len(_build._sources()) + 1


def test_distributed_env_reads_both_spellings(monkeypatch):
    for k in ("JAX_COORDINATOR", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
              "WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT",
              "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert tmh.distributed_env() is None
    assert tmh.maybe_initialize_distributed("cpu") is False
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="RANK"):
        tmh.distributed_env()
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1234")
    assert tmh.distributed_env() == dict(rank=1, world=2, local_rank=1,
                                         local_world=2, addr="10.0.0.1",
                                         port=1234)
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.setenv("JAX_COORDINATOR", "host0:4321")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
    monkeypatch.setenv("JAX_PROCESS_ID", "3")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    assert tmh.distributed_env() == dict(rank=3, world=4, local_rank=0,
                                         local_world=1, addr="host0",
                                         port=4321)
    assert tmh.choose_backend("cpu", 1) == "gloo"


def test_solve_sharded_matches_reference_and_one_process(problem, launch):
    """The port's solve_sharded on a LocalMesh of 8 CPU shards against
    the reference's on 8 virtual devices (tests/jax_solve_sharded_child.py,
    beside the module's other tests) and against the port's bundle.solve
    in one process. On this problem the port's sharded solve lies 6 mm
    from its bundle.solve, the reference's 0.29 m from the reference's own
    bundle.solve: the gauge-flat valley."""
    cams_true, cams0, pts0, obs, K, dist = problem
    cfg = tb.BAConfig(max_iters=8)
    mesh = tsh.LocalMesh(["cpu"] * 8)
    got = tsh.solve_sharded(cams0, pts0, obs, K, dist, mesh, cfg,
                            verbose=False)
    one = tb.solve(cams0, pts0, obs, K, dist, cfg, verbose=False,
                   device="cpu")
    procs, out = launch
    _result(procs["reference"], "reference")
    rj = np.load(out)
    for mre, cams in ((float(rj["mre"]), rj["cams"]), (one.mre, one.cams)):
        np.testing.assert_allclose(got.mre, mre, rtol=0.02)
        np.testing.assert_allclose(got.cams[:, :3], cams[:, :3], atol=0.3)
        e8 = np.abs(got.cams[:, :3] - cams_true[:, :3]).max()
        eo = np.abs(cams[:, :3] - cams_true[:, :3]).max()
        assert abs(e8 - eo) < 0.3, (e8, eo)
    # every CG iteration is one (n_cam, 7) sum
    assert mesh.stats["calls"] > 8
    assert got.cost_history[-1] < got.cost_history[0]


def _close_cams(a, b, tol=0.05):
    return max(np.linalg.norm(np.subtract(a[k], b[k])) for k in b) <= tol


CASES = ("agree_barrier", "observation_step", "sharded_matching",
         "solve_sharded", "process_matches", "process_smart",
         "process_outputs", "optimize_refine")


@pytest.mark.parametrize("case", CASES)
def test_two_ranks(ranks, case):
    r0, r1, one = ranks["rank0"], ranks["rank1"], ranks["single"]
    assert r0["backend"] == r1["backend"] == "gloo"
    if case == "agree_barrier":
        for r in (r0, r1):
            assert r["agree"] == [True, False]
        assert r0["shard"] + r1["shard"] == list(range(37))
    elif case == "observation_step":
        # replicated: bitwise alike on both ranks; the one-process step
        # within f32 summation order
        assert r0["step"]["digest"] == r1["step"]["digest"]
        for k in ("dc_err", "dp_err", "pred_err"):
            assert r0["step"][k] <= 1e-3, (k, r0["step"])
    elif case == "sharded_matching":
        # the pair axis split over the ranks and gathered
        assert r0["match"] and r1["match"]
    elif case == "solve_sharded":
        s = r0["solve"]
        assert s["digest"] == r1["solve"]["digest"]
        np.testing.assert_allclose(s["mre"], s["mre_one"], rtol=0.02)
        assert s["cams_m"] <= 0.3 and s["calls"] > 8
    elif case == "process_matches":
        assert r0["process_rc"] == r1["process_rc"] == one["process_rc"] == 0
        got, want = r0["process"], one["process"]
        assert got["step5"] and want["step5"]
        # each rank detected and matched its own share
        assert [r["detected"] for r in (r0, r1)] == [["4/8"], ["4/8"]]
        n0, n1 = (int(r["matched"][0].split("/")[0]) for r in (r0, r1))
        assert n0 > 0 and n1 > 0
        assert got["matches"] == want["matches"]
    elif case == "process_smart":
        got, want = r0["process"]["yaw_pairs"], one["process"]["yaw_pairs"]
        assert got == want and sum(len(v) for v in got.values()) > 0
        assert r0["process"]["sizes"] == one["process"]["sizes"]
        assert all(s == [320, 240] for s in one["process"]["sizes"].values())
    elif case == "process_outputs":
        got, want = r0["process"], one["process"]
        assert got["models"] == want["models"]
        assert sum(r0["eggs_written"] + r1["eggs_written"]) \
            == sum(one["eggs_written"])
        assert _close_cams(got["cams"], want["cams"])
    elif case == "optimize_refine":
        assert r0["optimize_rc"] == r1["optimize_rc"] == 0
        assert _close_cams(r0["optimize"], one["optimize"])

"""A rank of tests/test_torch_parallel.py's run across processes (gloo on
the CPU), or, with mode "single", the one-process run it is held to.
The config's "threads" is the process's torch intra-op threads.

    python tests/torch_multihost_child.py '<json config>'

The parent sets MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE and
IMGTPU_DIST_TIMEOUT for the ranks. Each rank joins the group through
parallel/multihost.py, runs the checks below and prints one line
"RESULT <json>" with what it found; it exits nonzero on any failure.

- agree and barrier (ranks only);
- the observation-sharded LM step over the ranks against bundle.lm_step
  in one process, and its replicated outputs' digest (ranks only);
- sharded_match_pair_batch over the ranks against the unsharded call
  (ranks only);
- solve_sharded over the ranks (ranks only);
- apps/process.py (with --match-strategy smart) on the mission folder of
  the config, then apps/stages.py optimize --refine: the match lists'
  digests, smart.json's yaw pairs, each image's size, the cameras after
  each command and the models/ written, which the parent compares with
  the one-process run's.
"""

import contextlib
import hashlib
import io
import json
import os
import re
import sys

import numpy as np
import torch

from imageanalysis_tpu_torch.apps import process, stages
from imageanalysis_tpu_torch.ba import bundle
from imageanalysis_tpu_torch.io.project import ProjectMgr
from imageanalysis_tpu_torch.parallel import multihost, sharded
from imageanalysis_tpu_torch.testing.synthetic import make_ba_grid_graph


def collective_checks(out):
    rank = multihost.rank()
    out["agree"] = [multihost.agree(rank == 0, "yes"),
                    multihost.agree(rank != 0, "no")]
    multihost.barrier("checks")
    out["shard"] = multihost.process_shard(list(range(37)))

    g = make_ba_grid_graph(n_cam=9, n_pt=150, device="cpu")
    mesh = sharded.ProcessMesh("cpu")
    step = sharded.sharded_lm_step(mesh, cg_iters=5)
    dc, dp, pred = step(g.cams0, g.pts0, sharded.shard_observations(g.obs,
                                                                   mesh),
                        g.K, g.dist, 1e-3)
    o = bundle.observations_on(g.obs, "cpu")
    dc1, dp1, pred1 = bundle.lm_step(g.cams0, g.pts0, o, g.K, g.dist, 1e-3,
                                     len(g.cams0), len(g.pts0), cg_iters=5)
    out["step"] = {
        "digest": hashlib.sha1(b"".join(
            x.numpy().tobytes() for x in (dc, dp, pred))).hexdigest(),
        "dc_err": float((dc - dc1).abs().max() / dc1.abs().max()),
        "dp_err": float((dp - dp1).abs().max() / dp1.abs().max()),
        "pred_err": float(abs(pred - pred1) / abs(pred1))}

    # matching split by pair over the ranks, gathered: the unsharded
    # call's result
    from imageanalysis_tpu_torch.match.matcher import match_pair_batch

    gen = np.random.default_rng(1)
    desc = gen.uniform(0, 360, (2, 4, 256, 64)).astype(np.float32)
    desc[1, :, :100] = desc[0, :, :100] + gen.normal(0, 2, (4, 100, 64))
    uv = gen.uniform(0, 1000, (2, 4, 256, 2)).astype(np.float32)
    args = [torch.from_numpy(x) for x in (desc[0], desc[1], uv[0],
                                          uv[0] + 0.5)] + [
        torch.full((4,), 200), torch.full((4,), 200)]
    pick = torch.from_numpy(gen.integers(0, 64, (4, 32, 4)))
    kw = dict(transform="homography", n_hyp=32, use_pallas=False,
              bf16=False)
    got = sharded.sharded_match_pair_batch(mesh, **kw)(*args, pick=pick)
    want = match_pair_batch(*args, pick=pick, **kw)
    out["match"] = all(torch.equal(a, b) for a, b in zip(got, want)) \
        and int(want[1].sum()) > 4 * 90

    cfg = bundle.BAConfig(max_iters=5)
    r = sharded.solve_sharded(g.cams0, g.pts0, g.obs, g.K, g.dist, mesh,
                              cfg, verbose=False)
    r1 = bundle.solve(g.cams0, g.pts0, g.obs, g.K, g.dist, cfg,
                      verbose=False, device="cpu")
    out["solve"] = {
        "digest": hashlib.sha1(r.cams.tobytes()).hexdigest(),
        "mre": r.mre, "mre_one": r1.mre,
        "cams_m": float(np.abs(r.cams[:, :3] - r1.cams[:, :3]).max()),
        "calls": mesh.stats["calls"]}


def workspace_state(d):
    """What the parent compares of a finished workspace."""
    proj = ProjectMgr(d)
    proj.load_images_info()
    matches, sizes, cams = {}, {}, {}
    for im in proj.image_list:
        im.load_matches()
        matches[im.name] = {k: np.asarray(v).tolist()
                            for k, v in sorted(im.match_list.items())}
        sizes[im.name] = list(im.get_size())
        cams[im.name] = list(im.get_camera_pose(opt=im.has_opt_pose())[0])
    with open(os.path.join(proj.analysis_dir, "smart.json")) as f:
        smart = json.load(f)
    return {"step5": proj.state.check("STEP5"), "matches": matches,
            "sizes": sizes, "cams": cams,
            "yaw_pairs": {k: sorted(v.get("yaw_pairs", {}))
                          for k, v in smart.items()},
            "models": sorted(os.listdir(proj.models_dir))}


def main():
    cfg = json.loads(sys.argv[1])
    torch.set_num_threads(cfg["threads"])
    out = {"rank": 0}
    if cfg["mode"] == "ranks":
        if not multihost.maybe_initialize_distributed("cpu"):
            sys.exit("the process group did not start")
        out.update(rank=multihost.rank(), backend=multihost.backend())
        collective_checks(out)
    d = cfg["mission"]
    argv = [d, "--camera", cfg["camera"], "--camera-db", cfg["db"],
            "--scale", "1.0", "--ground", "0.0", "--batch-size", "8",
            "--min-chain-len", "2", "--detector", "TPU", "--max-features",
            "512", "--match-strategy", "smart"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = process.main(argv, device="cpu")
    text = buf.getvalue()
    out["process_rc"] = rc
    out["eggs_written"] = [int(n) for n in re.findall(
        r"build_map: wrote (\d+) egg models", text)]
    out["detected"] = re.findall(r"detecting (\d+/\d+) images", text)
    out["matched"] = re.findall(r"matching (\d+/\d+) pairs", text)
    multihost.barrier("process")
    if multihost.is_rank0():
        out["process"] = workspace_state(d)
    multihost.barrier("snapshot")
    out["optimize_rc"] = stages.main(["optimize", d, "--refine"],
                                     device="cpu")
    if multihost.is_rank0():
        out["optimize"] = workspace_state(d)["cams"]
    multihost.shutdown()
    print("RESULT " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

"""Port parity: Steps 3b–4 of apps/process.py whole, and the entry points'
device defaults.

A 10-frame synthetic mission (testing/synthetic.make_mission's poses at
320×240) is written as a project workspace whose keypoints are the exact
projections of points on the ground plane (0.3 px noise) and whose
.match files hold every pair's shared points. Copies of it go through
both packages in process.py's order (process.py:275-417): link_matches →
save_matches_grouped → triangulate_ground on the flat ground → groups
compute/save → setup_from_matches on group 0 → bundle.solve → refit onto
the start positions → write_back → the re-triangulation of the stale
chains with the optimized poses. Compared: the chains and their group
tags (exact), the groups (exact), the BA mre (2e-3 relative) and the
optimized poses both packages write to meta/ (after refit the gauge is
the GPS one: positions within 1 mm, quaternions within 1e-5, about
0.001°).
"""

import inspect
import shutil

import numpy as np
import pytest
import torch

from imageanalysis_tpu.ba import bundle as jbundle
from imageanalysis_tpu.ba import setup as jsetup
from imageanalysis_tpu.io.project import ProjectMgr as JProject
from imageanalysis_tpu.match import cleanup as jcleanup
from imageanalysis_tpu.match import groups as jgroups
from imageanalysis_tpu_torch.apps import process as tprocess
from imageanalysis_tpu_torch.ba import bundle as tbundle
from imageanalysis_tpu_torch.ba import setup as tsetup
from imageanalysis_tpu_torch.core.camera import project_ned_quat
from imageanalysis_tpu_torch.features import detect as tdetect
from imageanalysis_tpu_torch.io import jpeg
from imageanalysis_tpu_torch.io.project import ProjectMgr as TProject
from imageanalysis_tpu_torch.match import cleanup as tcleanup
from imageanalysis_tpu_torch.match import groups as tgroups
from imageanalysis_tpu_torch.match import matcher, smart, store
from imageanalysis_tpu_torch.render import build_map as tbuild_map
from imageanalysis_tpu_torch.surface import srtm as tsrtm
from imageanalysis_tpu_torch.testing import synthetic
from torch_threads import one_torch_thread  # noqa: F401

SIZE = (320, 240)
N_POINTS = 1500


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    m = synthetic.make_mission(strips=2, per_strip=5, size=SIZE,
                               strip_gap=1.0, seed=9, device="cpu")
    rng = np.random.default_rng(9)
    lo = m.ned[:, :2].min(0) - 40.0
    hi = m.ned[:, :2].max(0) + 40.0
    ground = np.c_[rng.uniform(lo, hi, (N_POINTS, 2)), np.zeros(N_POINTS)]
    n_img = len(m.ned)
    pts = torch.from_numpy(np.repeat(ground[None], n_img, 0))
    ned = torch.from_numpy(np.repeat(m.ned[:, None], N_POINTS, 1))
    quat = torch.from_numpy(np.repeat(m.cam_quat[:, None], N_POINTS, 1))
    uv, z = project_ned_quat(pts, ned, quat, torch.from_numpy(m.K),
                             torch.zeros(5, dtype=torch.float64))
    uv, z = uv.numpy(), z.numpy()
    seen = ((z > 0) & (uv[..., 0] >= 0) & (uv[..., 0] < SIZE[0])
            & (uv[..., 1] >= 0) & (uv[..., 1] < SIZE[1]))
    kp_of = np.full(seen.shape, -1)
    dets = []
    for i in range(n_img):
        idx = np.nonzero(seen[i])[0]
        kp_of[i, idx] = np.arange(len(idx))
        kp = uv[i, idx] + rng.normal(0, 0.3, (len(idx), 2))
        dets.append((kp.astype(np.float32), np.zeros((len(idx), 4)),
                     np.zeros((len(idx), 128))))
    root = str(tmp_path_factory.mktemp("ws") / "template")
    proj = synthetic.write_workspace(root, m, dets)
    il = proj.image_list
    for i in range(n_img):
        for j in range(i + 1, n_img):
            both = seen[i] & seen[j]
            if both.sum() >= 25:
                pairs = np.c_[kp_of[i, both], kp_of[j, both]].astype(np.int32)
                il[i].match_list[il[j].name] = pairs
                il[j].match_list[il[i].name] = pairs[:, ::-1].copy()
    for im in il:
        im.save_matches()
    return root, m


def _steps_3b_4(pkgs, project_dir, kw):
    """process.py:275-417 with --ground 0 and one process."""
    project, cleanup, groups, setup, bundle = pkgs
    proj = project(project_dir)
    proj.load_images_info()
    for im in proj.image_list:
        im.load_features()
        im.load_matches()
    matches = cleanup.link_matches(proj)
    proj.save_matches_grouped(matches)
    chains = [m[2:] for m in matches]

    def base(image):
        return 0.0

    cleanup.triangulate_ground(proj, matches, get_base_elev=base, **kw)
    proj.save_matches_grouped(matches)
    grps = groups.compute(proj.image_list, matches, min_chain_len=3)
    groups.save(proj.analysis_dir, grps)
    proj.save_matches_grouped(matches)
    grps = groups.load(proj.analysis_dir)
    cams0, pts0, obs, cam_names, match_map = setup.setup_from_matches(
        proj, matches, group_images=grps[0], min_chain_len=3)
    model = proj.camera_model()
    result = bundle.solve(cams0, pts0, obs, model.K, model.dist,
                          bundle.BAConfig(), verbose=False, **kw)
    new_cams, new_pts, _ = bundle.refit(result.cams, result.pts,
                                        cams0[:, :3], **kw)
    result = result._replace(cams=new_cams, pts=new_pts)
    setup.write_back(proj, matches, result, cam_names, match_map)
    active = set(int(mi) for mi in match_map)
    by_name = {im.name: i for i, im in enumerate(proj.image_list)}
    opt_imgs = {by_name[n] for n in cam_names if n in by_name}
    stale = [mi for mi, mm in enumerate(matches)
             if mi not in active and any(o[0] in opt_imgs for o in mm[2:])]
    if stale:
        cleanup.triangulate_ground(proj, matches, get_base_elev=base,
                                   subset=stale, optimized=True, **kw)
    proj.save_matches_grouped(matches)
    return chains, matches, grps, result, stale


def test_steps_3b_4_match_reference(workspace, tmp_path):
    template, m = workspace
    out = {}
    for name, pkgs, kw in (
            ("jax", (JProject, jcleanup, jgroups, jsetup, jbundle), {}),
            ("torch", (TProject, tcleanup, tgroups, tsetup, tbundle),
             {"device": "cpu"})):
        shutil.copytree(template, str(tmp_path / name))
        out[name] = _steps_3b_4(pkgs, str(tmp_path / name), kw)
    (jc, jm, jg, jr, js), (tc, tm, tg, tr, ts) = out["jax"], out["torch"]
    assert tc == jc and len(tc) > 500
    assert tg == jg and len(tg[0]) == len(m.ned)
    assert [x[1] for x in tm] == [x[1] for x in jm]
    assert ts == js and len(ts) > 0
    np.testing.assert_allclose(tr.mre, jr.mre, rtol=2e-3)
    assert tr.mre < 0.5
    # the stale chains' refresh, with the optimized poses, ran in both
    for mi in ts:
        np.testing.assert_allclose(tm[mi][0], jm[mi][0], atol=0.05)
    # what both packages wrote to meta/, read back by each other's loader
    tp, jp = TProject(str(tmp_path / "torch")), JProject(str(tmp_path /
                                                              "jax"))
    for p in (tp, jp):
        p.load_images_info()
    for ti, ji in zip(tp.image_list, jp.image_list):
        assert ti.has_opt_pose() and ji.has_opt_pose()
        t_ned, t_ypr, t_q = ti.get_camera_pose(opt=True)
        j_ned, j_ypr, j_q = ji.get_camera_pose(opt=True)
        np.testing.assert_allclose(t_ned, j_ned, atol=1e-3)
        # unit quaternions (sign-free): 1e-5 ≈ 0.001°
        dq = min(np.abs(np.subtract(t_q, j_q)).max(),
                 np.abs(np.add(t_q, j_q)).max())
        assert dq < 1e-5, (ti.name, t_q, j_q)
        np.testing.assert_allclose(t_ned, m.ned[tp.image_list.index(ti)],
                                   atol=0.5)


# every entry point of the port that takes a device: the card unless the
# caller asks for the CPU
_ENTRY_POINTS = [
    matcher.BatchMatcher.__init__, matcher.find_matches,
    smart.pair_surface_stats_batched, smart.requalify_pairs,
    smart.update_pairs_batched, store.DescriptorStore.from_project,
    store.DescriptorStore.from_numpy, store.DescriptorStore.from_arrays,
    tcleanup.triangulate_ground, tbundle.solve, tbundle.solve_culled,
    tbundle.refit, tbundle.reweight_huber, tbundle.cull_outliers,
    tbundle.observations_on, synthetic.make_mission,
    synthetic.make_ground_texture, synthetic.make_tiled_texture,
    synthetic.make_ba_mission_graph, synthetic.make_ba_grid_graph,
    jpeg.decode_gray, jpeg.decode_bgr, tdetect.load_scaled_gray,
    tdetect.detect_project_features, tsrtm.Terrain.__init__,
    tsrtm.project_terrain, tbuild_map.make_textures, tbuild_map.build,
    tprocess.run, tprocess.main]


@pytest.mark.parametrize("fn", _ENTRY_POINTS,
                         ids=[f.__qualname__ for f in _ENTRY_POINTS])
def test_entry_point_defaults_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"

"""Port parity: Steps 3b–3d and the BA problem assembly.

``link_matches``, ``groups.compute`` and ``setup_from_matches`` are host
numpy in both packages and are compared exactly, on the generators of
tests/test_cleanup_chains.py and tests/test_groups.py (plus duplicate
keypoints and a link that puts two keypoints of one image in a chain).
``triangulate_ground`` runs its rays through each package's camera model
in f32 (the port's on a CPU tensor here): chain points agree within
1e-4 m, for the whole set, a subset and the optimized poses. A
``matches_grouped`` file written by one package loads in the other.
"""

import copy
import filecmp
import pickle

import numpy as np
import pytest

from imageanalysis_tpu.ba import setup as jsetup
from imageanalysis_tpu.io.project import ProjectMgr as JProject
from imageanalysis_tpu.match import cleanup as jcleanup
from imageanalysis_tpu.match import groups as jgroups
from imageanalysis_tpu_torch.ba import setup as tsetup
from imageanalysis_tpu_torch.io.project import ProjectMgr as TProject
from imageanalysis_tpu_torch.match import cleanup as tcleanup
from imageanalysis_tpu_torch.match import groups as tgroups
from test_cleanup_chains import _Img, _make_proj
from test_groups import _Img as _GroupImg
from test_groups import _random_chains
from torch_threads import one_torch_thread  # noqa: F401


# NED→body quaternion of a nadir camera (pitch −90°): the generator's own
# [1, 0, 0, 0] looks at the horizon, where ground hits lie kilometres out
# and f32 rounding alone moves them by millimetres
_NADIR = np.array([np.sqrt(0.5), 0.0, -np.sqrt(0.5), 0.0])


class _NadirImg(_Img):
    """A nadir image whose optimized pose (valid when opt_valid) sits
    0.8 m off its raw one, with a small attitude change."""

    opt_valid = False

    def has_opt_pose(self):
        return self.opt_valid

    def get_camera_pose(self, opt=False):
        ned, _, _ = super().get_camera_pose()
        if not opt:
            return ned, None, _NADIR
        return ned + np.array([0.5, -0.3, 0.5]), None, \
            _NADIR + np.array([0.003, 0.01, -0.005, 0.004])


def _proj(seed, n_img=5, n_kp=30, dup=False, opt=False):
    """tests/test_cleanup_chains.py's chains, seen by nadir cameras;
    dup=True adds keypoints at identical uv and an extra link that gives
    one chain two keypoints of one image (the reference keeps the lowest
    index); opt=True gives every image a valid optimized pose."""
    proj = _make_proj(np.random.default_rng(seed), n_img, n_kp)
    for im in proj.image_list:
        im.__class__ = _NadirImg
        im.opt_valid = opt
    if dup:
        il = proj.image_list
        for im in il:
            im.kp[5] = im.kp[4]
        # kp 7 chains through every image; link image 0's kp 7 to image
        # 2's kp 8 as well
        il[0].match_list[il[2].name] = [[7, 8]]
        il[2].match_list[il[0].name] = [[8, 7]]
    return proj


@pytest.mark.parametrize("seed,dup", [(0, False), (1, False), (2, True)])
def test_link_matches_equals_reference(seed, dup):
    proj = _proj(seed, dup=dup)
    want = jcleanup.link_matches(proj)
    got = tcleanup.link_matches(proj)
    assert isinstance(got, tcleanup.MatchList)
    assert list(got) == list(want)
    for attr in ("obs_img", "obs_uv", "obs_match"):
        w, g = getattr(want, attr), getattr(got, attr)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _base(image):
    """A terrain elevation per image; image 3's lies above its camera (100
    m up), so the 'never above the camera' clamp acts."""
    return {"im1": 2.5, "im3": 150.0}.get(image.name, -4.0)


@pytest.mark.parametrize("mode", ["all", "subset", "optimized"])
def test_triangulate_ground_matches_reference(mode):
    proj = _proj(3, opt=mode == "optimized")
    want = jcleanup.link_matches(proj)
    got = tcleanup.link_matches(proj)
    kw = {}
    if mode == "subset":
        kw["subset"] = [0, 2, 5, len(got) - 1]
    elif mode == "optimized":
        kw["optimized"] = True
    jcleanup.triangulate_ground(proj, want, get_base_elev=_base, **kw)
    tcleanup.triangulate_ground(proj, got, get_base_elev=_base,
                                device="cpu", **kw)
    n_set = 0
    for mi, (g, w) in enumerate(zip(got, want)):
        assert (g[0] is None) == (w[0] is None), mi
        if w[0] is not None:
            np.testing.assert_allclose(g[0], w[0], rtol=0, atol=1e-4)
            n_set += 1
        assert g[1:] == w[1:]
    assert n_set == (4 if mode == "subset" else len(want))


def test_triangulate_ground_rebuilds_stale_flat_arrays():
    """A cull-style edit leaves the attached arrays stale; the port then
    flattens the chains anew, as the reference."""
    proj = _proj(4)
    want = jcleanup.link_matches(proj)
    got = tcleanup.link_matches(proj)
    for m in (want, got):
        del m[0][2]
    jcleanup.triangulate_ground(proj, want)
    tcleanup.triangulate_ground(proj, got, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0], w[0], rtol=0, atol=1e-4)


@pytest.mark.parametrize("seed,min_chain_len,two", [
    (0, 2, False), (1, 3, False), (7, 3, True)])
def test_groups_compute_equals_reference(seed, min_chain_len, two):
    rng = np.random.default_rng(seed)
    n_images = 24 if two else 40
    image_list = [_GroupImg(i) for i in range(n_images)]
    matches = _random_chains(rng, n_images, 800 if two else 600,
                             two_clusters=two)
    m_j, m_t = copy.deepcopy(matches), copy.deepcopy(matches)
    kw = dict(min_chain_len=min_chain_len, min_group=3, min_connections=5)
    want = jgroups.compute(image_list, m_j, **kw)
    got = tgroups.compute(image_list, m_t, **kw)
    assert got == want and len(got) >= (2 if two else 1)
    assert [m[1] for m in m_t] == [m[1] for m in m_j]


def test_groups_json_is_one_file_for_both(tmp_path):
    groups = [["img0001", "img0003"], ["img0002"]]
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    tgroups.save(str(tmp_path / "t"), groups)
    jgroups.save(str(tmp_path / "j"), groups)
    assert filecmp.cmp(tmp_path / "t" / "groups.json",
                       tmp_path / "j" / "groups.json", shallow=False)
    assert jgroups.load(str(tmp_path / "t")) == groups
    assert tgroups.load(str(tmp_path / "j")) == groups
    assert tgroups.load(str(tmp_path)) == []


@pytest.mark.parametrize("flat", [True, False], ids=["flat", "lists"])
@pytest.mark.parametrize("group", [None, "subset"])
def test_setup_from_matches_equals_reference(flat, group):
    """The same chains (with two untriangulated ones) through both
    packages' assembly: every array equal, on the flat-array path and on
    the per-observation loop."""
    proj = _proj(5, n_img=6, n_kp=24)
    matches = jcleanup.link_matches(proj)
    jcleanup.triangulate_ground(proj, matches)
    matches[1][0] = None
    matches[-2][0] = None
    if not flat:
        matches = pickle.loads(pickle.dumps(matches))
    names = (None if group is None
             else [im.name for im in proj.image_list[1:5]])
    want = jsetup.setup_from_matches(proj, matches, group_images=names)
    got = tsetup.setup_from_matches(proj, matches, group_images=names)
    assert got[3] == want[3]
    for g, w in zip((got[0], got[1], got[4], *got[2]),
                    (want[0], want[1], want[4], *want[2])):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_matches_grouped_loads_in_either_package(tmp_path):
    """Both MatchLists pickle as plain lists: a matches_grouped file that
    one package writes, the other loads as the same list."""
    proj = _proj(6)
    t = tcleanup.link_matches(proj)
    tcleanup.triangulate_ground(proj, t, device="cpu")
    j = jcleanup.link_matches(proj)
    jcleanup.triangulate_ground(proj, j)
    tp = TProject(str(tmp_path / "t"), create=True)
    jp = JProject(str(tmp_path / "j"), create=True)
    tp.save_matches_grouped(t)
    jp.save_matches_grouped(j)
    from_t = JProject(str(tmp_path / "t")).load_matches_grouped()
    from_j = TProject(str(tmp_path / "j")).load_matches_grouped()
    assert type(from_t) is list and type(from_j) is list
    assert from_t == list(t) and from_j == list(j)

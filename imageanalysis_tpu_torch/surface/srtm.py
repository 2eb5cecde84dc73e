"""SRTM terrain: tile parsing, an NED elevation grid, ray intersection.

Port of ``imageanalysis_tpu/surface/srtm.py``: parse the 1201×1201 (SRTM3)
or 3601×3601 (SRTM1) big-endian int16 ``.hgt`` grid of each tile under the
mission, sample it bilinearly onto a grid around the NED reference
(6000 × 6000 m at 30 m by default), and intersect view rays with it
iteratively. The grid is sampled from the tiles in one vectorised numpy
pass (the reference loops over its points; the values are the same), and
held as a tensor on the device for ``interp`` and ``intersect_vectors``.

Tiles are read from the caches of ``cache_dirs()`` only; downloading
(``download_tile``, reference srtm.py:38-66) is not ported. Without the
tiles under the mission the grid is flat at ``fallback_elev``, as in the
reference.
"""

from __future__ import annotations

import os
import zipfile

import numpy as np
import torch

from ..io.logger import log


def cache_dirs():
    """Tile caches, searched in order: $SRTM_CACHE, then the one the
    reference package downloads into."""
    dirs = []
    if os.environ.get("SRTM_CACHE"):
        dirs.append(os.environ["SRTM_CACHE"])
    dirs.append(os.path.expanduser("~/.cache/imageanalysis_tpu/srtm"))
    return dirs


def tile_name(lat, lon):
    """SRTM tile naming, e.g. N44W094 covers [44, 45) × [−94, −93)."""
    lat_i = int(np.floor(lat))
    lon_i = int(np.floor(lon))
    ns = f"N{lat_i:02d}" if lat_i >= 0 else f"S{-lat_i:02d}"
    ew = f"E{lon_i:03d}" if lon_i >= 0 else f"W{-lon_i:03d}"
    return ns + ew


def _parse_hgt(path):
    if path.endswith(".zip"):
        with zipfile.ZipFile(path) as z:
            inner = [n for n in z.namelist() if n.endswith(".hgt")]
            raw = z.read(inner[0])
    else:
        with open(path, "rb") as f:
            raw = f.read()
    data = np.frombuffer(raw, dtype=">i2").astype(np.float32)
    dim = int(round(np.sqrt(data.size)))
    if dim * dim != data.size or dim not in (1201, 3601):
        raise ValueError(f"not an SRTM1/SRTM3 .hgt file: {path} "
                         f"({data.size} samples)")
    return data.reshape((dim, dim))


def load_tile(name):
    """<name>.hgt(.zip) from the caches → (dim, dim) float32 elevation,
    row 0 = north edge; None when no cache holds it."""
    for d in cache_dirs():
        for ext in (".hgt", ".hgt.zip"):
            path = os.path.join(d, name + ext)
            if os.path.isfile(path):
                return _parse_hgt(path)
    return None


def _sample_tiles(lla, tiles):
    """Bilinear elevation of each lla row from its tile, in float64 with
    the reference's order of operations (srtm.py:166-177)."""
    vals = np.zeros(len(lla), np.float32)
    lat_f = np.floor(lla[:, 0])
    lon_f = np.floor(lla[:, 1])
    for la, lo in {(a, b) for a, b in zip(lat_f, lon_f)}:
        sel = np.nonzero((lat_f == la) & (lon_f == lo))[0]
        t = tiles[tile_name(la, lo)]
        dim = t.shape[0]
        fr = (lla[sel, 0] - np.floor(lla[sel, 0])) * (dim - 1)
        fc = (lla[sel, 1] - np.floor(lla[sel, 1])) * (dim - 1)
        r = (dim - 1) - fr
        r0 = r.astype(np.int64)
        c0 = fc.astype(np.int64)
        r1 = np.minimum(r0 + 1, dim - 1)
        c1 = np.minimum(c0 + 1, dim - 1)
        ar, ac = r - r0, fc - c0
        t64 = t.astype(np.float64)
        vals[sel] = (t64[r0, c0] * (1 - ar) * (1 - ac)
                     + t64[r1, c0] * ar * (1 - ac)
                     + t64[r0, c1] * (1 - ar) * ac
                     + t64[r1, c1] * ar * ac)
    return vals


class Terrain:
    """NED elevation grid around a reference lla.

    ``grid`` (numpy) and ``tgrid`` (a tensor on device) hold elevation
    (m, positive up) sampled at ``step`` m over [−height/2, +height/2] ×
    [−width/2, +width/2] NED metres.
    """

    def __init__(self, ref_lla, width_m=6000.0, height_m=6000.0, step_m=30.0,
                 fallback_elev=0.0, device="cuda"):
        from ..core import geodesy

        self.ref_lla = list(ref_lla)
        self.step = float(step_m)
        self.n0 = -height_m / 2.0
        self.e0 = -width_m / 2.0
        nn = int(height_m / step_m) + 1
        ne = int(width_m / step_m) + 1
        self.flat = False

        n_coords = self.n0 + np.arange(nn) * self.step
        e_coords = self.e0 + np.arange(ne) * self.step
        NN, EE = np.meshgrid(n_coords, e_coords, indexing="ij")
        ned = np.stack([NN.ravel(), EE.ravel(), np.zeros(NN.size)], axis=1)
        lla = geodesy.ned2lla(ned, *self.ref_lla)
        tiles = {}
        for la, lo in {(float(np.floor(p[0])), float(np.floor(p[1])))
                       for p in lla}:
            nm = tile_name(la, lo)
            tiles[nm] = load_tile(nm)
        missing = sorted(nm for nm, t in tiles.items() if t is None)
        if missing or not tiles:
            log("SRTM tiles not cached:", missing,
                f"— using flat terrain at {fallback_elev:.1f} m")
            self.grid = np.full((nn, ne), fallback_elev, np.float32)
            self.flat = True
        else:
            grid = _sample_tiles(lla, tiles).reshape(nn, ne)
            grid[grid < -32000] = fallback_elev  # voids
            self.grid = grid
        self.tgrid = torch.from_numpy(self.grid).to(device)

    # -- queries ----------------------------------------------------------
    def interp(self, n, e):
        """Bilinear elevation at NED (n, e), batched, on tgrid's device."""
        g = self.tgrid
        nn, ne = g.shape
        n = torch.as_tensor(n, dtype=g.dtype, device=g.device)
        e = torch.as_tensor(e, dtype=g.dtype, device=g.device)
        r = ((n - self.n0) / self.step).clamp(0.0, nn - 1.001)
        c = ((e - self.e0) / self.step).clamp(0.0, ne - 1.001)
        r0 = torch.floor(r).long()
        c0 = torch.floor(c).long()
        ar = r - r0
        ac = c - c0
        return (g[r0, c0] * (1 - ar) * (1 - ac)
                + g[r0 + 1, c0] * ar * (1 - ac)
                + g[r0, c0 + 1] * (1 - ar) * ac
                + g[r0 + 1, c0 + 1] * ar * ac)

    def ned_interp(self, pos):
        """Elevation at [n, e] as a float."""
        return float(self.interp(pos[0], pos[1]))

    def intersect_vectors(self, cam_ned, vectors, iters=25):
        """Iterative ray-terrain intersection (reference srtm.py:208-234):
        cam_ned (3,) or (N, 3), vectors (N, 3) NED unit view vectors, on
        tgrid's device, float32. A fixed number of steps; one on flat
        terrain. Skyward rays return the camera position."""
        g = self.tgrid
        v = torch.as_tensor(vectors, dtype=torch.float32, device=g.device)
        cam = torch.as_tensor(cam_ned, dtype=torch.float32,
                              device=g.device).expand(v.shape)
        down_ok = v[..., 2] > 1e-8
        vz = torch.where(down_ok, v[..., 2], 1.0)

        def step(p):
            d_proj = -(cam[..., 2] + self.interp(p[..., 0], p[..., 1]))
            factor = d_proj / vz
            return torch.stack([cam[..., 0] + v[..., 0] * factor,
                                cam[..., 1] + v[..., 1] * factor,
                                cam[..., 2] + d_proj], dim=-1)

        p = step(cam)
        if not self.flat:
            for _ in range(iters - 1):
                p = step(p)
        return torch.where(down_ok[..., None], p, cam)

    def interp_host(self, n, e):
        """Bilinear elevation in numpy on the host, for per-image queries."""
        g = self.grid
        nn, ne = g.shape
        r = np.clip((np.asarray(n) - self.n0) / self.step, 0.0, nn - 1.001)
        c = np.clip((np.asarray(e) - self.e0) / self.step, 0.0, ne - 1.001)
        r0 = np.floor(r).astype(int)
        c0 = np.floor(c).astype(int)
        ar = r - r0
        ac = c - c0
        return (g[r0, c0] * (1 - ar) * (1 - ac) + g[r0 + 1, c0] * ar * (1 - ac)
                + g[r0, c0 + 1] * (1 - ar) * ac + g[r0 + 1, c0 + 1] * ar * ac)

    def base_elevation(self, image):
        """Terrain elevation under an image's camera (Step 3c prior)."""
        ned, _, _ = image.get_camera_pose()
        return float(self.interp_host(ned[0], ned[1]))


def project_terrain(proj, width_m=6000.0, height_m=6000.0, step_m=30.0,
                    fallback_elev=None, device="cuda"):
    """The mission's Terrain around the project's NED reference. Without
    fallback_elev, missing tiles fall back to flat ground 100 m below the
    cameras' median altitude."""
    ref = proj.ned_reference_lla()
    if fallback_elev is None:
        alts = []
        for im in proj.image_list:
            n = im.node.node("aircraft_pose", create=False)
            if n and n.has("alt_m"):
                alts.append(n.get("alt_m"))
        fallback_elev = float(np.median(alts) - 100.0) if alts else 0.0
    return Terrain(ref, width_m, height_m, step_m, fallback_elev=fallback_elev,
                   device=device)

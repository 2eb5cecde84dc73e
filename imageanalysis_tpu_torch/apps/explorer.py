"""Interactive map explorer — the reference's panda3d viewer, rebuilt.

Reference scripts/explorer.py + scripts/explore/ (L7): loads the Step-5
models (per-image textured meshes + surface.bin), renders the "pile of
original images" orthomosaic, lets the user pan/zoom, inspect elevation
under the cursor, and place/edit/persist annotations (json/csv/kml).

panda3d is not available in this environment, so the viewer is built on
matplotlib: each image's projected grid is drawn as a texture warped onto
its ground quad (the same models/*.egg geometry + models/*.JPG textures the
panda3d viewer would load — the artifacts stay panda3d-compatible). Usable
both interactively (``python -m imageanalysis_tpu.apps.explorer <dir>``)
and headless (``render_to(path)`` for tests/reports).

Texture handling matches the reference explorer: base 512² textures get
histogram matching / vignette / CLAHE at load (explorer.py:229-307); the
"top" image nearest the view center (metric dist + 0.1·span,
explorer.py:423-447) is paged in at FULL resolution through an LRU cache
of 10 (explorer.py:476-689) and warped per-quad onto its ground mesh; the
shader filters (explore/myshader.frag + the filter_by family) run as
numpy texture filters (render/texture.py); a center reticle + measurement
scale bar track the view (explore/reticle.py).

Keys: scroll = zoom, drag = pan, 'a' + click = add annotation,
'd' + click = delete nearest annotation, 's' = save annotations,
'r' = toggle reticle, 'f' = cycle display filter, ','/'.' = cycle the
top (full-res) image.

Port of ``imageanalysis_tpu/apps/explorer.py``. The textures are device
tensors from the port's ``TextureManager`` (decode, histogram matching,
CLAHE on the device); ``draw`` downloads each 512² base texture for
matplotlib. ``_warp_full`` warps the top image's quads on the device, in
OpenCV's float32 arithmetic (render/geotiff.py): the pixel that the
reference's loop of cv2.warpPerspective calls writes last is found quad
by quad from the last one, among the pixels no later quad took, and
each pixel is then sampled once through its quad's map. The surface
interpolation (scipy), the top-image choice and the matplotlib drawing
are host code, the same as the reference's. Usage: ``python -m
imageanalysis_tpu_torch.apps.explorer <project_dir> [--screenshot
out.png]``; it runs on the CUDA card, ``IMGTPU_PLATFORM=cpu`` asks for
the CPU.
"""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np
import torch

from ..core.device import checked
from ..io.logger import log
from ..io.project import ProjectMgr
from ..render.annotations import Annotations
from ..render.geotiff import bilinear_taps, lerp2, sample, source_coords
from ..render.texture import FILTERS, TextureManager
from .process import main_device


def load_egg_grid(path):
    """Parse the vertex/uv grid back out of a models/*.egg file.

    Returns (verts (n,3) [e,n,up], uvs (n,2) texture coords, quads (m,4))."""
    verts, uvs, quads = [], [], []
    with open(path) as f:
        lines = f.read().splitlines()
    i = 0
    while i < len(lines):
        ln = lines[i].strip()
        if ln.startswith("<Vertex>"):
            xyz = [float(v) for v in lines[i + 1].split()]
            uv_ln = lines[i + 2].strip()
            uv = [float(v) for v in
                  uv_ln.replace("<UV> {", "").replace("}", "").split()]
            verts.append(xyz)
            uvs.append(uv)
            i += 3
        elif ln.startswith("<VertexRef>"):
            ids = [int(v) for v in ln.split("{")[1].split("<")[0].split()]
            quads.append([v - 1 for v in ids])
            i += 1
        else:
            i += 1
    return np.asarray(verts), np.asarray(uvs), np.asarray(quads, int)


class Explorer:
    def __init__(self, project_dir, filter_mode="equalize_value",
                 device="cuda"):
        self.device = checked(device, "the explorer")
        self.proj = ProjectMgr(project_dir)
        self.proj.load_images_info()
        self.models_dir = self.proj.models_dir
        ref = self.proj.ned_reference_lla()
        self.annotations = Annotations(self.proj.analysis_dir, ref).load()
        self.surface = self._load_surface()
        self.mode = None
        self.textures = TextureManager(self.proj, filter_mode=filter_mode,
                                       device=self.device)
        self.draw_reticle = True
        self.top_offset = 0          # reference explorer.py top_image cycling
        self._grids = {}             # egg geometry cache: name -> (v, uv, q)

    def _load_surface(self):
        path = os.path.join(self.models_dir, "surface.bin")
        if not os.path.isfile(path):
            return None
        with open(path, "rb") as f:
            surf = pickle.load(f)
        import scipy.interpolate
        import scipy.spatial

        pts = np.asarray(surf["points"])  # [e, n]
        vals = np.asarray(surf["values"])
        tri = scipy.spatial.Delaunay(pts)
        return scipy.interpolate.LinearNDInterpolator(tri, vals)

    def get_elevation(self, e, n):
        """Surface elevation (m, positive up) under (e, n) — reference
        explore/surface.py:18."""
        if self.surface is None:
            return 0.0
        v = self.surface([[e, n]])[0]
        return 0.0 if np.isnan(v) else float(-v)

    # -- model geometry / top-image selection ------------------------------
    def _grid(self, name):
        if name not in self._grids:
            self._grids[name] = load_egg_grid(
                os.path.join(self.models_dir, name + ".egg"))
        return self._grids[name]

    def _model_names(self, max_images=None):
        eggs = sorted(f[:-4] for f in os.listdir(self.models_dir)
                      if f.endswith(".egg"))
        return eggs[:max_images] if max_images else eggs

    def select_top(self, names, center):
        """Best-covering image under the view center — the reference's
        sortImages metric dist + 0.1·span, +1000 when the view center is
        outside the model bounds (explorer.py:423-457)."""
        scored = []
        for name in names:
            verts, _, _ = self._grid(name)
            good = ~np.all(verts[:, :2] == 0, axis=1)
            if not good.any():
                continue
            v = verts[good]
            lo, hi = v.min(0), v.max(0)
            c = 0.5 * (lo + hi)
            span = float(np.linalg.norm(hi - lo))
            dist = float(np.hypot(c[0] - center[0], c[1] - center[1]))
            metric = dist + span * 0.1
            if not (lo[0] <= center[0] <= hi[0]
                    and lo[1] <= center[1] <= hi[1]):
                metric += 1000.0
            scored.append((metric, name))
        if not scored:
            return None
        scored.sort()
        return scored[min(self.top_offset, len(scored) - 1)][1]

    def _warp_full(self, name, res=1024):
        """Warp the full-resolution texture onto the model's ground mesh,
        quad by quad. Returns (rgba raster, extent [x0,x1,y0,y1]).

        As the reference: each quad's cv2.warpPerspective of the whole
        texture writes the pixels where the warp of a 255 plane exceeds
        128, later quads over earlier ones. On the device: from the last
        quad back, the pixels that no later quad took are tested against
        this one (the 255 plane's warp, rounded as cv2's u8); then every
        taken pixel samples the texture once through its quad's map."""
        import cv2

        tex = self.textures.load_full(name)
        if tex is None:
            return None, None
        verts, uvs, quads = self._grid(name)
        good = ~np.all(verts[:, :2] == 0, axis=1)
        if not good.any() or len(quads) == 0:
            return None, None
        v = verts[good]
        lo, hi = v[:, :2].min(0), v[:, :2].max(0)
        span = np.maximum(hi - lo, 1e-6)
        sx = res / span[0]
        sy = res / span[1]
        th, tw = tex.shape[:2]
        maps = []
        for q in quads:
            if not good[q].all():
                continue
            dst = np.stack([(verts[q, 0] - lo[0]) * sx,
                            (hi[1] - verts[q, 1]) * sy], axis=1
                           ).astype(np.float32)
            src = np.stack([uvs[q, 0] * (tw - 1),
                            (1.0 - uvs[q, 1]) * (th - 1)], axis=1
                           ).astype(np.float32)
            # the inverse map, inverted as cv2.warpPerspective does
            maps.append(cv2.invert(cv2.getPerspectiveTransform(src, dst))[1])
        dev = tex.device
        win = torch.full((res * res,), -1, dtype=torch.long, device=dev)
        if maps:
            M = torch.tensor(np.asarray(maps, np.float32), device=dev)
            todo = torch.arange(res * res, device=dev)
            for q in range(len(maps) - 1, -1, -1):
                y, x = (todo // res).float(), (todo % res).float()
                a, b, taps = bilinear_taps(*source_coords(M[q], y, x), th,
                                           tw)
                plane = lerp2(a, b, *(255.0 * inside.float()
                                      for _, inside in taps))
                sel = torch.round(plane) > 128
                win[todo[sel]] = q
                todo = todo[~sel]
                if not len(todo):
                    break
        taken = win >= 0
        pix = torch.nonzero(taken)[:, 0]
        out = torch.zeros((res * res, 3), dtype=torch.uint8, device=dev)
        if len(pix):
            y, x = (pix // res).float(), (pix % res).float()
            a, b, taps = bilinear_taps(*source_coords(M[win[pix]], y, x),
                                       th, tw)
            flat = tex.reshape(th * tw, -1).float()
            out[pix] = torch.round(sample(flat, a, b, taps)).clamp(0, 255) \
                .to(torch.uint8)
        alpha = taken.to(torch.uint8) * 255
        rgba = torch.cat([out.flip(-1), alpha[:, None]], 1)
        return (rgba.reshape(res, res, 4).cpu().numpy(),
                [lo[0], hi[0], lo[1], hi[1]])

    def draw_reticle_overlay(self, ax):
        """Center reticle + measurement scale bar (explore/reticle.py)."""
        xl, yl = ax.get_xlim(), ax.get_ylim()
        cx, cy = 0.5 * (xl[0] + xl[1]), 0.5 * (yl[0] + yl[1])
        view = abs(yl[1] - yl[0])
        h_size = abs(xl[1] - xl[0])
        a1, a2 = view / 20, view / 5
        kw = dict(color="lime", alpha=0.6, lw=1)
        for sx, sy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            ax.plot([cx + sx * a1, cx + sx * a2],
                    [cy + sy * a1, cy + sy * a2], **kw)
        # measurement marker: power-of-two length near h_size/10
        h = 2.0 ** round(np.log2(max(h_size, 1e-6) / 10.0))
        x0 = cx - 0.48 * h_size
        y0 = cy - 0.48 * view
        ax.plot([x0, x0 + h], [y0, y0], color="lime", alpha=0.6, lw=2)
        ax.plot([x0, x0], [y0, y0 + 0.02 * view], color="lime", alpha=0.6,
                lw=2)
        ax.plot([x0 + h, x0 + h], [y0, y0 + 0.02 * view], color="lime",
                alpha=0.6, lw=2)
        label = f"{h:.0f} m" if h >= 1 else f"{h*100:.0f} cm"
        ax.annotate(label, (x0 + 0.5 * h, y0 + 0.025 * view), color="lime",
                    ha="center", fontsize=8, alpha=0.8)
        ax.set_xlim(xl)
        ax.set_ylim(yl)

    # -- rendering --------------------------------------------------------
    def draw(self, ax, max_images=None, annotate=True, full_res_top=True):
        import matplotlib.tri as mtri

        names = self._model_names(max_images)
        drawn = 0
        for name in names:
            tex = self.textures.load_base(name)
            if tex is None:
                continue
            verts, uvs, quads = self._grid(name)
            if len(quads) == 0:
                continue
            tex = tex.flip(-1).cpu().numpy()  # BGR → RGB, to the host
            th, tw = tex.shape[:2]
            # sample the texture at each vertex and Gouraud-shade triangles
            px = np.clip((uvs[:, 0] * (tw - 1)).astype(int), 0, tw - 1)
            py = np.clip(((1.0 - uvs[:, 1]) * (th - 1)).astype(int), 0, th - 1)
            colors = tex[py, px].astype(float) / 255.0
            tris = np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]])
            good = ~np.all(verts[:, :2] == 0, axis=1)
            tris = tris[np.all(good[tris], axis=1)]
            if len(tris) == 0:
                continue
            t = mtri.Triangulation(verts[:, 0], verts[:, 1], tris)
            lum = colors.mean(axis=1)
            ax.tripcolor(t, lum, cmap="gray", shading="gouraud", vmin=0,
                         vmax=1)
            drawn += 1
        # full-resolution paging for the top image under the view center
        if full_res_top and drawn:
            xl, yl = ax.get_xlim(), ax.get_ylim()
            center = (0.5 * (xl[0] + xl[1]), 0.5 * (yl[0] + yl[1]))
            top = self.select_top(names, center)
            if top is not None:
                rgba, extent = self._warp_full(top)
                if rgba is not None:
                    ax.imshow(rgba, extent=extent, origin="upper",
                              interpolation="bilinear", zorder=2)
        if annotate:
            for m in self.annotations.markers:
                e, n = m["ned"][1], m["ned"][0]
                ax.plot(e, n, "yo", markersize=8, markeredgecolor="red")
                ax.annotate(f'{self.annotations.id_prefix}{m["id"]:03d}',
                            (e, n), color="yellow", fontsize=8,
                            xytext=(5, 5), textcoords="offset points")
        ax.set_aspect("equal")
        ax.set_xlabel("east (m)")
        ax.set_ylabel("north (m)")
        return drawn

    def render_to(self, out_path, dpi=130, max_images=None,
                  full_res_top=True, reticle=None):
        """Headless render of the mosaic view to an image file."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(10, 8))
        drawn = self.draw(ax, max_images=max_images,
                          full_res_top=full_res_top)
        if (reticle if reticle is not None else self.draw_reticle) and drawn:
            self.draw_reticle_overlay(ax)
        fig.savefig(out_path, dpi=dpi, bbox_inches="tight")
        plt.close(fig)
        log(f"explorer: rendered {drawn} image models to {out_path}")
        return drawn

    # -- interactive ------------------------------------------------------
    def run(self):
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(12, 9))
        self.draw(ax)
        if self.draw_reticle:
            self.draw_reticle_overlay(ax)
        status = fig.text(0.01, 0.01, "a+click add, d+click del, s save, "
                          "r reticle, f filter, ,/. top image", fontsize=9)

        def redraw():
            xl, yl = ax.get_xlim(), ax.get_ylim()
            ax.clear()
            ax.set_xlim(xl)
            ax.set_ylim(yl)
            self.draw(ax)
            if self.draw_reticle:
                self.draw_reticle_overlay(ax)
            fig.canvas.draw_idle()

        def on_key(ev):
            if ev.key in ("a", "d"):
                self.mode = ev.key
                status.set_text(f"mode: {self.mode}")
            elif ev.key == "s":
                cams = [im.get_camera_pose(opt=im.has_opt_pose())[0]
                        for im in self.proj.image_list]
                self.annotations.save(np.asarray(cams))
                status.set_text("annotations saved")
            elif ev.key == "r":
                self.draw_reticle = not self.draw_reticle
                redraw()
            elif ev.key == "f":
                i = FILTERS.index(self.textures.filter_mode)
                self.textures.filter_mode = FILTERS[(i + 1) % len(FILTERS)]
                self.textures.tcache.clear()
                status.set_text(f"filter: {self.textures.filter_mode}")
                redraw()
            elif ev.key in (",", "."):
                self.top_offset = max(
                    0, self.top_offset + (1 if ev.key == "," else -1))
                redraw()
            fig.canvas.draw_idle()

        def on_click(ev):
            if ev.inaxes != ax or self.mode is None:
                return
            e, n = ev.xdata, ev.ydata
            if self.mode == "a":
                down = -self.get_elevation(e, n)
                self.annotations.add_marker_ned([n, e, down], comment="")
            elif self.mode == "d" and self.annotations.markers:
                d = [np.hypot(m["ned"][1] - e, m["ned"][0] - n)
                     for m in self.annotations.markers]
                self.annotations.delete_marker(
                    self.annotations.markers[int(np.argmin(d))]["id"])
            self.mode = None
            ax.clear()
            self.draw(ax)
            fig.canvas.draw_idle()

        def on_scroll(ev):
            if ev.inaxes != ax:
                return
            s = 0.8 if ev.button == "up" else 1.25
            xl, yl = ax.get_xlim(), ax.get_ylim()
            ax.set_xlim(ev.xdata + (np.array(xl) - ev.xdata) * s)
            ax.set_ylim(ev.ydata + (np.array(yl) - ev.ydata) * s)
            fig.canvas.draw_idle()

        fig.canvas.mpl_connect("key_press_event", on_key)
        fig.canvas.mpl_connect("button_press_event", on_click)
        fig.canvas.mpl_connect("scroll_event", on_scroll)
        plt.show()


def main(argv=None, device="cuda"):
    """The command line's entry point, on device (IMGTPU_PLATFORM in the
    environment overrides it, as in apps/process.py)."""
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: python -m imageanalysis_tpu_torch.apps.explorer "
              "<project_dir> [--screenshot out.png]")
        return 1
    ex = Explorer(argv[0], device=main_device(device))
    if "--screenshot" in argv:
        out = argv[argv.index("--screenshot") + 1]
        ex.render_to(out)
        return 0
    ex.run()
    return 0


if __name__ == "__main__":
    sys.exit(main())

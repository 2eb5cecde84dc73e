"""Step 5 map build: surface.bin, textures and the .egg and .ac models.

Port of ``imageanalysis_tpu/render/build_map.py``, the same files under
``models/``:

1. the group's optimized 3D points, less > 10σ elevation outliers,
   decimated to cell means past 50,000 points, pickled as ``surface.bin``
   ({points: [[e, n], ...], values: [down, ...]});
2. a Delaunay triangulation of them and a linear interpolator (host
   scipy, as in the reference);
3. per image, an (steps + 1)² uv grid projected through the optimized
   camera pose and walked onto the surface (rays under ~30° above the
   horizon give NaN), and the redistorted grid for texture uv: the view
   vectors of every image's grid in one torch call on the device, the
   surface walk on the host;
4. 512² INTER_AREA textures (decoded and encoded on the device by
   ``io/jpeg``), ``dummy.jpg``, one .egg mesh per image (Z-Up, x = east,
   y = north, z = up) and the AC3D models of ``render/ac3d.py``.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..io import jpeg
from ..io.logger import log

GRID_STEPS = 8
TEXTURE_RES = 512


def intersect_surface(interp, cam_ned, vectors, avg_ground, iters=10):
    """Iteratively walk each ray onto the Delaunay surface (reference
    render_panda3d.py:25-71 intersect2d). cam_ned: (3,) or (n, 3) per-ray
    camera centers — the batched form lets ALL images' grids walk the
    surface in one vectorized pass (one scipy interp call per iteration
    over every ray instead of one per image). vectors: (n, 3) NED. Rays
    more than ~60° from straight down (i.e. <30° above horizon) give NaN."""
    cam_ned = np.asarray(cam_ned, dtype=float)
    if cam_ned.ndim == 1:
        cam_ned = cam_ned[None, :]
    n = vectors.shape[0]
    cam_z = cam_ned[:, 2] if cam_ned.shape[0] > 1 else cam_ned[0, 2]
    ground = np.full(n, avg_ground, dtype=float)  # down-coordinate
    v = vectors
    ok = v[:, 2] > 0.5  # cos(60°): reject grazing/horizon rays
    for _ in range(iters):
        d_proj = -(cam_z + ground)
        factor = np.where(ok, d_proj / np.where(ok, v[:, 2], 1.0), 0.0)
        p = cam_ned + v * factor[:, None]
        z = interp(p[:, [1, 0]])  # interp takes [e, n]
        new_ground = np.where(np.isnan(z), ground, z)
        if np.nanmax(np.abs(new_ground - ground)) < 0.01:
            ground = new_ground
            break
        ground = new_ground
    d_proj = -(cam_z + ground)
    factor = np.where(ok, d_proj / np.where(ok, v[:, 2], 1.0), np.nan)
    pts = cam_ned + v * factor[:, None]
    pts[~ok] = np.nan
    return pts


def decimate_surface(points_en, values, target=50_000):
    """Grid-bin a dense surface point cloud to ~target cell-mean points.

    A 2812-image mission triangulates >1M surface points; Delaunay +
    LinearNDInterpolator over them cost minutes of host time (and the
    surface files hundreds of MB) for a terrain model the 8×8 ray grids and
    the explorer sample at ~meter scale anyway. Cell means keep the terrain
    statistics; the raw convex-hull vertices are appended so the
    interpolation domain (and thus edge-of-map ray coverage) does not
    shrink. Returns (points (m, 2), values (m,)) — the input unchanged when
    already under target."""
    points_en = np.asarray(points_en, float)
    values = np.asarray(values, float)
    n = len(points_en)
    if n <= target:
        return points_en, values
    lo = points_en.min(axis=0)
    span = np.maximum(points_en.max(axis=0) - lo, 1e-6)
    cell = float(np.sqrt(span[0] * span[1] / target))
    ij = np.floor((points_en - lo) / cell).astype(np.int64)
    nx = int(ij[:, 0].max()) + 1
    key = ij[:, 1] * nx + ij[:, 0]
    uniq, inv = np.unique(key, return_inverse=True)
    cnt = np.bincount(inv)
    ce = np.bincount(inv, weights=points_en[:, 0]) / cnt
    cn = np.bincount(inv, weights=points_en[:, 1]) / cnt
    cv = np.bincount(inv, weights=values) / cnt
    out_pts = np.stack([ce, cn], axis=1)
    out_val = cv
    try:
        import scipy.spatial
        hull = scipy.spatial.ConvexHull(points_en).vertices
        out_pts = np.concatenate([out_pts, points_en[hull]])
        out_val = np.concatenate([out_val, values[hull]])
    except Exception:
        pass
    log(f"Surface decimated {n} -> {len(out_pts)} points "
        f"(cell {cell:.1f} m means + hull)")
    return out_pts, out_val


def _cv_size(w, h, fx, fy):
    """cv2.resize's output size for scale factors fx, fy."""
    return int(np.rint(w * fx)), int(np.rint(h * fy))


def make_textures(proj, image_list, resolution=TEXTURE_RES, device="cuda"):
    """resolution² INTER_AREA textures models/<name>.JPG and a 64² dummy.jpg.

    A frame that still oversamples the texture at 1/2 or 1/4 of its size
    is decoded reduced (io/jpeg.decode_bgr), as the reference's
    IMREAD_REDUCED_COLOR_2/4 do; textures already written are kept."""
    dst_dir = proj.models_dir
    os.makedirs(dst_dir, exist_ok=True)
    first_src = None
    for image in image_list:
        src_path = proj.image_path(image)
        if first_src is None:
            first_src = src_path
        dst = os.path.join(dst_dir, image.name + ".JPG")
        if os.path.exists(dst):
            continue
        w0, h0 = image.get_size()
        if not w0 or not h0:
            w0 = int(proj.camera.get("width_px", 0))
            h0 = int(proj.camera.get("height_px", 0))
        reduce = (4 if min(w0, h0) >= 4 * resolution
                  else 2 if min(w0, h0) >= 2 * resolution else 1)
        src = jpeg.decode_bgr(src_path, device, reduce)
        h, w = src.shape[:2]
        size = _cv_size(w, h, resolution / float(w), resolution / float(h))
        jpeg.encode_bgr(jpeg.resize_area(src, size), dst)
    dummy = os.path.join(dst_dir, "dummy.jpg")
    if first_src and not os.path.exists(dummy):
        src = jpeg.decode_bgr(first_src, device)
        h, w = src.shape[:2]
        jpeg.encode_bgr(jpeg.resize_area(
            src, _cv_size(w, h, 64.0 / w, 64.0 / h)), dummy)


def write_egg(path, grid_xyz, distorted_uv, width, height, steps):
    """Panda3d .egg mesh: grid quads, skipping NaN vertices (reference
    panda3d.py:87-144). grid_xyz in [east, north, up]."""
    lines = ["<CoordinateSystem> { Z-Up }", "",
             '<Texture> tex { "dummy.jpg" }', "", "<VertexPool> surface {"]
    nan_set = set()
    n = 1
    for j in range(steps + 1):
        for i in range(steps + 1):
            v = grid_xyz[n - 1]
            if np.any(np.isnan(v)):
                v = [0.0, 0.0, 0.0]
                nan_set.add(j * (steps + 1) + i + 1)
            uv = distorted_uv[n - 1]
            lines.append("  <Vertex> %d {" % n)
            lines.append("    %.2f %.2f %.2f" % (v[0], v[1], v[2]))
            lines.append("    <UV> { %.5f %.5f }" % (uv[0] / float(width),
                                                     1.0 - uv[1] / float(height)))
            lines.append("  }")
            n += 1
    lines += ["}", "", "<Group> surface {"]
    count = 0
    for j in range(steps):
        for i in range(steps):
            c = j * (steps + 1) + i + 1
            d = (j + 1) * (steps + 1) + i + 1
            if {c, d, c + 1, d + 1} & nan_set:
                continue
            lines.append("  <Polygon> {")
            lines.append("   <TRef> { tex }")
            lines.append("   <Normal> { 0 0 1 }")
            lines.append("   <VertexRef> { %d %d %d %d <Ref> { surface } }"
                         % (d, d + 1, c + 1, c))
            lines.append("  }")
            count += 1
    lines.append("}")
    if count == 0:
        return 0
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return count


def build(proj, matches, groups, group_index=0, ground=None,
          grid_steps=GRID_STEPS, texture_resolution=TEXTURE_RES,
          only_images=None, global_outputs=True, device="cuda"):
    """Write the group's render outputs to models/; returns the names of
    the images whose .egg has polygons. only_images / global_outputs are
    for rendering across hosts: each host writes the eggs and textures of
    its own images, and only one writes surface.bin and the AC3D models."""
    import scipy.interpolate
    import scipy.spatial

    from ..core.camera import pixel_vectors_ned, redistort_pixels
    from ..core.rotations import quat_to_matrix

    group = groups[group_index] if groups else [im.name for im in proj.image_list]
    group_set = set(group)

    # ---- elevation stats + surface.bin ----------------------------------
    pts = np.array([m[0] for m in matches
                    if m[1] == group_index and m[0] is not None])
    if len(pts) < 3:
        # ungrouped mini-missions: take every triangulated match
        pts = np.array([m[0] for m in matches if m[0] is not None])
    if len(pts) < 3:
        log("build_map: not enough points to build a surface")
        return None
    avg = -np.mean(pts[:, 2])
    std = max(np.std(pts[:, 2]), 1e-6)
    keep = np.abs(-pts[:, 2] - avg) < 10 * std
    log("Average elevation: %.2f  stddev: %.2f  (%d/%d points kept)"
        % (avg, std, keep.sum(), len(pts)))
    raw_points = pts[keep][:, [1, 0]]          # [e, n]
    raw_values = pts[keep][:, 2]               # down
    # mission-scale surfaces decimate to cell means before triangulation:
    # Delaunay + LinearNDInterpolator over >1M raw points cost minutes of
    # host time for a terrain model sampled at 8×8 grids per image
    raw_points, raw_values = decimate_surface(raw_points, raw_values)
    os.makedirs(proj.models_dir, exist_ok=True)
    if global_outputs:
        with open(os.path.join(proj.models_dir, "surface.bin"), "wb") as f:
            pickle.dump({"points": raw_points.tolist(),
                         "values": raw_values.tolist()}, f)

    tri = scipy.spatial.Delaunay(raw_points)
    interp = scipy.interpolate.LinearNDInterpolator(tri, raw_values)

    # ---- per-image grid projection --------------------------------------
    model = proj.camera_model(optimized=True)
    width = int(proj.camera.get("width_px", 0))
    height = int(proj.camera.get("height_px", 0))
    u = np.linspace(0, width, grid_steps + 1)
    v = np.linspace(0, height, grid_steps + 1)
    UU, VV = np.meshgrid(u, v)                 # row-major: v outer, u inner
    grid_uv = np.stack([UU.ravel(), VV.ravel()], axis=1).astype(np.float32)

    group_images = [im for im in proj.image_list if im.name in group_set]
    write_set = (group_set if only_images is None
                 else group_set & set(only_images))
    if not global_outputs:
        # per-image writes only: skip the grid math for other ranks' images
        group_images = [im for im in group_images if im.name in write_set]
    made = []
    grids = {}
    dist_uvs = {}

    # one device call for every image's ray grid; the redistorted texture
    # uv grid is pose-independent: compute it once
    neds = np.zeros((len(group_images), 3), np.float32)
    quats = np.zeros((len(group_images), 4), np.float32)
    for i, image in enumerate(group_images):
        ned, _, quat = image.get_camera_pose(opt=image.has_opt_pose())
        neds[i] = np.asarray(ned, np.float32)
        quats[i] = np.asarray(quat, np.float32)
    dev = torch.device(device)
    guv = torch.from_numpy(grid_uv).to(dev)
    K = model.K.to(dev)
    vecs_all = pixel_vectors_ned(
        guv, quat_to_matrix(torch.from_numpy(quats).to(dev))[:, None],
        K).cpu().numpy() if group_images else np.zeros((0, 0, 3))
    dist_uv = redistort_pixels(guv, K, model.dist.to(dev)).cpu().numpy()

    # batched surface walk: all rays of all images in one vectorized pass
    G = grid_uv.shape[0]
    cams_flat = np.repeat(neds.astype(float), G, axis=0)
    pts_flat = intersect_surface(
        interp, cams_flat, vecs_all.reshape(-1, 3),
        avg_ground=(-avg if ground is None else -ground)) \
        if group_images else np.zeros((0, 3))
    pts_all = pts_flat.reshape(len(group_images), G, 3)

    for i, image in enumerate(group_images):
        pts_ned = pts_all[i]
        grid_xyz = np.stack([pts_ned[:, 1], pts_ned[:, 0], -pts_ned[:, 2]],
                            axis=1)           # [e, n, up]
        grids[image.name] = grid_xyz
        dist_uvs[image.name] = dist_uv
        if image.name not in write_set:
            continue
        egg_path = os.path.join(proj.models_dir, image.name + ".egg")
        count = write_egg(egg_path, grid_xyz, dist_uv, width, height, grid_steps)
        if count:
            made.append(image.name)
        else:
            log("Warning: no polygons fully on surface:", image.name)

    make_textures(proj, [im for im in group_images if im.name in write_set],
                  resolution=texture_resolution, device=device)

    if global_outputs:
        from . import ac3d
        ac3d.write_surface_ac(os.path.join(proj.models_dir,
                                           "surface-global.ac"),
                              raw_points, raw_values)
        ac3d.generate_textured(proj, [im.name for im in group_images], grids,
                               dist_uvs)
    log(f"build_map: wrote {len(made)} egg models + textures to {proj.models_dir}")
    return made

"""Top-down orthomosaic compositing and GeoTIFF export (``--geotiff``).

Port of ``imageanalysis_tpu/render/geotiff.py``: each frame is warped into
a metres-per-pixel north-up raster through the ground-plane homography of
its (optimized) pose, and blended with feathered masks; the GeoTIFF is
written natively, byte for byte as the reference writes it, beside a
``gdalscript.sh`` for post-processing with gdal.

The frames decode with ``io/jpeg.decode_bgr`` (nvJPEG on the card) and
the warp, the feathering and the accumulation run on the device, in the
reference's frame order, reproducing what its OpenCV calls compute:

- ``cv2.warpPerspective(img, inv(Hm))`` samples src(Hm·x), in float32
  as the vector kernel of the reference's OpenCV (5.0) computes it: the
  source coordinate unrounded, bilinear lerps as fused multiply-adds, the
  u8 result rounded to nearest, outside samples 0 (BORDER_CONSTANT); the
  mask is a warped float32 plane of ones, so its edges are fractional.
  (Older OpenCV rounded the coordinate to 1/32 px with 15-bit integer
  weights; the reference's tests run 5.0, and the port is bit-exact with
  it);
- ``cv2.erode`` with a 3 × 3 kernel does not erode at the border (its
  border value is +max): ``-max_pool2d(-x)`` with padding 1;
- ``cv2.blur`` with (feather, feather) is an even box with its anchor at
  feather // 2 (window [x − 25, x + 24] for 50), reflecting at the canvas
  border (BORDER_REFLECT_101); its sums run in float64, scaled by
  1/feather² and rounded to float32, as cv2's box filter does;
- ``acc += warped · mask`` and ``wacc += mask`` in float32, and the final
  ``.astype(np.uint8)`` truncates.

Where the reference warps every frame onto the whole canvas, each frame
here is warped onto its footprint's box plus the feather margin only: the
mask is zero beyond it, so the sums are the same. The box reflects where
it meets the canvas edge and pads with zeros elsewhere.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch
import torch.nn.functional as F

from ..core import geodesy
from ..core.camera import BODY2CAM
from ..core.rotations import quat_to_matrix
from ..io import jpeg
from ..io.logger import log

def ground_homography(K, body2ned, cam_ned, ground_down):
    """Homography mapping NED ground-plane (n, e) → image pixels for a
    camera at cam_ned: uv ~ K [R_col_n, R_col_e, R·(p0 − c)] with
    p0 = (0, 0, ground_down). numpy, float64."""
    R = np.asarray(BODY2CAM) @ np.asarray(body2ned).T
    t = R @ (np.array([0.0, 0.0, ground_down]) - np.asarray(cam_ned))
    return np.asarray(K) @ np.column_stack([R[:, 0], R[:, 1], t])


def _body2ned(im):
    """The image's (optimized, where it has one) pose: (ned, body→NED
    matrix from the float32 quaternion, as the reference computes it)."""
    ned, _, quat = im.get_camera_pose(opt=im.has_opt_pose())
    B = quat_to_matrix(torch.tensor(np.asarray(quat), dtype=torch.float32))
    return ned, B.numpy()


def _fma(a, b, c):
    """float32 a·b + c rounded once, as a fused multiply-add: the product
    is exact in float64."""
    return (a.double() * b.double() + c.double()).float()


def source_coords(M, y, x):
    """The source pixel (sx, sy) that cv2.warpPerspective's inverse map M
    samples for canvas rows y and columns x, in OpenCV's float32
    arithmetic: per row M[k,1]·y + M[k,2], then fma(x, M[k,0], ·), the
    source coordinate X / W. M (..., 3, 3) float32 whose leading dims
    broadcast against y and x (one matrix, one a quad, one a pixel). A
    pixel on the camera's horizon (W = 0) samples nothing: −4."""
    def row_col(k):
        return _fma(x, M[..., k, 0], M[..., k, 1] * y + M[..., k, 2])

    w = row_col(2)
    sx, sy = row_col(0) / w, row_col(1) / w
    bad = ~(torch.isfinite(sx) & torch.isfinite(sy))
    return sx.masked_fill(bad, -4.0), sy.masked_fill(bad, -4.0)


def bilinear_taps(sx, sy, Hs, Ws):
    """The bilinear weights (a, b) and, for each of the four taps (dx, dy)
    in (0, 0), (1, 0), (0, 1), (1, 1), (flat index into the H·W source,
    inside) of source coordinates sx, sy; outside taps read 0
    (BORDER_CONSTANT)."""
    fx, fy = torch.floor(sx), torch.floor(sy)
    a, b = sx - fx, sy - fy
    x0 = fx.clamp(-2, Ws).long()
    y0 = fy.clamp(-2, Hs).long()
    taps = []
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        xs, ys = x0 + dx, y0 + dy
        inside = (xs >= 0) & (xs < Ws) & (ys >= 0) & (ys < Hs)
        taps.append((torch.where(inside, ys * Ws + xs, 0), inside))
    return a, b, taps


def lerp2(a, b, p00, p01, p10, p11):
    """OpenCV's float32 bilinear blend of four taps, lerps as fmas."""
    v0 = _fma(a, p01 - p00, p00)
    v1 = _fma(a, p11 - p10, p10)
    return _fma(b, v1 - v0, v0)


def sample(flat, a, b, taps):
    """Bilinear samples (..., C) float32 of flat (H·W, C) float32 at the
    taps of bilinear_taps."""
    p = [flat[i.reshape(-1)].reshape(i.shape + (-1,)) * inside[..., None]
         for i, inside in taps]
    return lerp2(a[..., None], b[..., None], *p)


def warp_frame(img, M, box):
    """cv2.warpPerspective(img, inv(M), INTER_LINEAR, BORDER_CONSTANT 0)
    on the canvas rows r0:r1 and columns c0:c1 (box), and the same warp
    of a float32 plane of ones: (warped (h, w, C) uint8, mask (h, w)
    float32). img (H, W, C) uint8; M (3, 3) maps canvas (col, row, 1) to
    the source pixel. In float32 as OpenCV's vector kernel
    (source_coords), bilinear weights from the coordinate's fraction,
    lerps as fmas, the u8 result rounded to nearest. Runs on img's
    device."""
    r0, r1, c0, c1 = box
    dev = img.device
    Hs, Ws = img.shape[:2]
    Mf = torch.tensor(np.asarray(M, np.float32), device=dev)
    y = torch.arange(r0, r1, dtype=torch.float32, device=dev)[:, None]
    x = torch.arange(c0, c1, dtype=torch.float32, device=dev)[None, :]
    sx, sy = source_coords(Mf, y, x.expand(r1 - r0, -1))
    a, b, taps = bilinear_taps(sx, sy, Hs, Ws)
    flat = img.reshape(Hs * Ws, -1).float()
    ones = torch.ones(Hs * Ws, 1, dtype=torch.float32, device=dev)
    warped = torch.round(sample(flat, a, b, taps)).clamp(0, 255) \
        .to(torch.uint8)
    return warped, sample(ones, a, b, taps)[..., 0]


def feather_mask(mask, box, canvas, feather):
    """cv2.blur(cv2.erode(mask, 3 × 3), (feather, feather)) of a mask that
    is zero beyond the box: erode without eroding at the border, then the
    box filter reflected (BORDER_REFLECT_101) at the canvas edge and
    zero-padded where the box lies inside the canvas."""
    r0, r1, c0, c1 = box
    Hc, Wc = canvas
    e = -F.max_pool2d(-mask[None, None], 3, stride=1, padding=1)[0, 0]
    a, b = feather // 2, feather - 1 - feather // 2

    def pad(x, dim, before, after, at_start, at_end):
        n = x.shape[dim]
        parts = []
        if before:
            parts.append(x.narrow(dim, 1, before).flip(dim) if at_start
                         else x.new_zeros(_sized(x, dim, before)))
        parts.append(x)
        if after:
            parts.append(x.narrow(dim, n - 1 - after, after).flip(dim)
                         if at_end else x.new_zeros(_sized(x, dim, after)))
        return torch.cat(parts, dim)

    e = e.double()
    e = pad(e, 0, a, b, r0 == 0, r1 == Hc)
    e = pad(e, 1, a, b, c0 == 0, c1 == Wc)
    c = F.pad(e.cumsum(0).cumsum(1), (1, 0, 1, 0))
    k = feather
    s = c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]
    return (s * (1.0 / (k * k))).float()


def _sized(x, dim, n):
    shape = list(x.shape)
    shape[dim] = n
    return shape


def _frame_box(M, w_px, h_px, canvas, margin):
    """Canvas (r0, r1, c0, c1) holding every pixel whose source lies in
    (−1, w_px) × (−1, h_px), plus margin; the whole canvas when a corner
    maps behind the plane."""
    Hc, Wc = canvas
    corners = np.array([[-1, -1, 1], [w_px, -1, 1], [w_px, h_px, 1],
                        [-1, h_px, 1]], np.float64)
    ch = corners @ np.linalg.inv(M).T
    wz = ch[:, 2]
    if not (np.all(wz > 0) or np.all(wz < 0)) or not np.isfinite(ch).all():
        return 0, Hc, 0, Wc
    cr = ch[:, :2] / ch[:, 2:]
    lo = np.floor(cr.min(axis=0)) - margin
    hi = np.ceil(cr.max(axis=0)) + margin + 1
    c0, r0 = (int(max(v, 0)) for v in lo)
    c1, r1 = int(min(hi[0], Wc)), int(min(hi[1], Hc))
    return r0, max(r1, r0), c0, max(c1, c0)


def _canvas(proj, images, K, ground, resolution):
    """Mission extent and raster size: the image corners on the ground
    plane, 2 m around them. Returns (footprint homographies, n_min, e_min,
    n_max, e_max, W, H)."""
    w_px = int(proj.camera.get("width_px", 0))
    h_px = int(proj.camera.get("height_px", 0))
    corners = np.array([[0, 0], [w_px, 0], [w_px, h_px], [0, h_px]], float)
    hs, footprints = [], []
    for im in images:
        ned, B = _body2ned(im)
        H = ground_homography(K, B, ned, -ground)
        ch = np.c_[corners, np.ones(4)] @ np.linalg.inv(H).T
        footprints.append(ch[:, :2] / ch[:, 2:3])
        hs.append(H)
    fp = np.concatenate(footprints)
    n_min, e_min = fp.min(axis=0) - 2
    n_max, e_max = fp.max(axis=0) + 2
    W = int((e_max - e_min) / resolution)
    Hh = int((n_max - n_min) / resolution)
    return hs, n_min, e_min, n_max, e_max, W, Hh


def composite(proj, group_images=None, resolution=0.25, ground=None,
              feather=50, device="cuda"):
    """Composite the mission into one top-down raster on device.

    resolution: metres/pixel. Returns (mosaic (H, W, 3) uint8 BGR tensor
    on device, extent (n_min, e_min, n_max, e_max))."""
    dev = torch.device(device)
    images = [im for im in (proj.image_list if group_images is None else
                            [proj.image_by_name(n) for n in group_images])
              if im is not None]
    K = proj.camera_model(optimized=True).K.numpy()
    w_px = int(proj.camera.get("width_px", 0))
    h_px = int(proj.camera.get("height_px", 0))
    ground = 0.0 if ground is None else ground
    hs, n_min, e_min, n_max, e_max, W, Hh = _canvas(proj, images, K, ground,
                                                    resolution)
    if W * Hh > 120_000_000:
        raise ValueError(f"mosaic {W}x{Hh} too large; raise resolution")
    log(f"Orthomosaic {W}x{Hh} px at {resolution} m/px")

    acc = torch.zeros((Hh, W, 3), dtype=torch.float32, device=dev)
    wacc = torch.zeros((Hh, W), dtype=torch.float32, device=dev)
    # raster (col, row, 1) → NED (n, e, 1): north up
    S = np.array([[0.0, -resolution, n_max],
                  [resolution, 0.0, e_min],
                  [0.0, 0.0, 1.0]])
    margin = feather + 2 if feather > 0 else 1
    for im, H in zip(images, hs):
        Hm = H @ S
        # cv2.warpPerspective inverts the matrix it is given back
        M = np.linalg.inv(np.linalg.inv(Hm))
        img = jpeg.decode_bgr(proj.image_path(im), dev)
        if img.dim() == 2:
            img = img[..., None].expand(-1, -1, 3)
        box = _frame_box(M, w_px, h_px, (Hh, W), margin)
        r0, r1, c0, c1 = box
        if r1 <= r0 or c1 <= c0:
            continue
        warped, mask = warp_frame(img, M, box)
        if feather > 0:
            mask = feather_mask(mask, box, (Hh, W), feather)
        acc[r0:r1, c0:c1] += warped.float() * mask[..., None]
        wacc[r0:r1, c0:c1] += mask
    mosaic = (acc / wacc.clamp_min(1e-6)[..., None]).clamp(0, 255) \
        .to(torch.uint8)
    mosaic[wacc < 1e-6] = 0
    return mosaic, (float(n_min), float(e_min), float(n_max), float(e_max))


# ---------------------------------------------------------------------------
# native GeoTIFF writer
# ---------------------------------------------------------------------------

_T_SHORT, _T_LONG, _T_RATIONAL, _T_DOUBLE, _T_ASCII = 3, 4, 5, 12, 2


def write_geotiff(path, mosaic_bgr, extent_ned, ned_ref):
    """Write an EPSG:4326 GeoTIFF (uncompressed, one strip).

    mosaic_bgr: (H, W, 3) uint8 north-up raster, numpy or a tensor;
    extent_ned = (n_min, e_min, n_max, e_max) in project NED metres;
    ned_ref = reference lla. Pixel scale and tiepoint GeoKeys per the
    GeoTIFF 1.1 spec."""
    if isinstance(mosaic_bgr, torch.Tensor):
        mosaic_bgr = mosaic_bgr.cpu().numpy()
    H, W = mosaic_bgr.shape[:2]
    n_min, e_min, n_max, e_max = extent_ned
    # corner lla (north-up: row 0 = n_max)
    ul = geodesy.ned2lla([n_max, e_min, 0.0], *ned_ref)
    lr = geodesy.ned2lla([n_min, e_max, 0.0], *ned_ref)
    lon0, lat0 = ul[1], ul[0]
    dlon = (lr[1] - ul[1]) / W
    dlat = (ul[0] - lr[0]) / H

    rgb = mosaic_bgr[..., ::-1].tobytes()  # BGR→RGB

    # GeoKeyDirectory: version, rev, minor, count, then keys:
    # GTModelType=2 (geographic), GTRasterType=1 (pixel-is-area),
    # GeographicType=4326
    geokeys = [1, 1, 0, 3,
               1024, 0, 1, 2,
               1025, 0, 1, 1,
               2048, 0, 1, 4326]
    pixel_scale = [dlon, dlat, 0.0]
    tiepoint = [0.0, 0.0, 0.0, lon0, lat0, 0.0]

    entries = []  # (tag, type, count, value_or_bytes)
    entries.append((256, _T_LONG, 1, W))             # ImageWidth
    entries.append((257, _T_LONG, 1, H))             # ImageLength
    entries.append((258, _T_SHORT, 3, struct.pack("<3H", 8, 8, 8)))
    entries.append((259, _T_SHORT, 1, 1))            # no compression
    entries.append((262, _T_SHORT, 1, 2))            # RGB
    entries.append((277, _T_SHORT, 1, 3))            # samples/pixel
    entries.append((278, _T_LONG, 1, H))             # rows/strip (single)
    entries.append((279, _T_LONG, 1, len(rgb)))      # strip byte count
    entries.append((284, _T_SHORT, 1, 1))            # chunky
    entries.append((33550, _T_DOUBLE, 3, struct.pack("<3d", *pixel_scale)))
    entries.append((33922, _T_DOUBLE, 6, struct.pack("<6d", *tiepoint)))
    entries.append((34735, _T_SHORT, len(geokeys),
                    struct.pack("<%dH" % len(geokeys), *geokeys)))

    n_dir = len(entries) + 1  # + StripOffsets
    header_size = 8
    ifd_size = 2 + 12 * n_dir + 4
    # external data area after the IFD
    ext = b""
    ext_offsets = {}
    data_start = header_size + ifd_size
    for i, (tag, typ, cnt, val) in enumerate(entries):
        if isinstance(val, bytes) and len(val) > 4:
            ext_offsets[i] = data_start + len(ext)
            ext += val + (b"\x00" if len(val) % 2 else b"")
    strip_offset = data_start + len(ext)

    def pack_entry(tag, typ, cnt, val, idx):
        if isinstance(val, bytes):
            if len(val) <= 4:
                return struct.pack("<HHI4s", tag, typ, cnt,
                                   val.ljust(4, b"\x00"))
            return struct.pack("<HHII", tag, typ, cnt, ext_offsets[idx])
        return struct.pack("<HHII", tag, typ, cnt, int(val))

    with open(path, "wb") as f:
        f.write(struct.pack("<2sHI", b"II", 42, header_size))
        f.write(struct.pack("<H", n_dir))
        all_entries = entries + [(273, _T_LONG, 1, strip_offset)]
        all_entries.sort(key=lambda e: e[0])
        idx_of = {id(e): i for i, e in enumerate(entries)}
        for e in all_entries:
            f.write(pack_entry(e[0], e[1], e[2], e[3],
                               idx_of.get(id(e), -1)))
        f.write(struct.pack("<I", 0))  # next IFD
        f.write(ext)
        f.write(rgb)
    log("Wrote GeoTIFF:", path,
        f"({W}x{H}, ul={lat0:.6f},{lon0:.6f}, {dlat:.2e}°/px)")


def write_gdal_script(analysis_dir, tif_name="mosaic.tif"):
    """The reference's post-processing script: tiles for web maps."""
    script = os.path.join(analysis_dir, "models", "gdalscript.sh")
    os.makedirs(os.path.dirname(script), exist_ok=True)
    with open(script, "w") as f:
        f.write("#!/bin/sh\n"
                "# post-process the orthomosaic with gdal (run where gdal "
                "is installed)\n"
                f"gdal_translate -of GTiff -co COMPRESS=JPEG {tif_name} "
                "mosaic_compressed.tif\n"
                f"gdal2tiles.py -z 16-22 {tif_name} tiles\n")
    os.chmod(script, 0o755)
    return script


def build_geotiff(proj, group_images=None, resolution=0.25, ground=0.0,
                  device="cuda"):
    """Composite on device, then write models/mosaic.tif and
    gdalscript.sh; returns the GeoTIFF's path."""
    mosaic, extent = composite(proj, group_images, resolution=resolution,
                               ground=ground, device=device)
    os.makedirs(proj.models_dir, exist_ok=True)
    out = os.path.join(proj.models_dir, "mosaic.tif")
    write_geotiff(out, mosaic, extent, proj.ned_reference_lla())
    write_gdal_script(proj.analysis_dir)
    return out

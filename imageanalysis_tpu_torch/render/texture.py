"""Explorer texture pipeline: corrections, display filters, LRU paging.

Port of ``imageanalysis_tpu/render/texture.py`` on tensors, on the
device of the image:

- base 512² textures get histogram matching (``render/histogram``),
  vignette correction and CLAHE 'value' equalization at load;
- the full-resolution "top" image is paged in from the project's
  originals, run through the same corrections, and kept in an LRU cache
  of 10;
- the display filters are the explorer's ``filter_by`` modes and
  explore/myshader.frag's red emphasis.

OpenCV's parts, in torch: ``io/jpeg.decode_bgr`` and ``resize_linear``
for ``cv2.imread`` and ``cv2.resize``; the port's ``ops/clahe.clahe``
(clip 1.0, 8 × 8 tiles) for ``cv2.createCLAHE``; ``bgr_to_hsv``, cv2's
8-bit COLOR_BGR2HSV with its integer division tables (bit-exact), and
``hsv_to_bgr``, cv2's COLOR_HSV2BGR in float32 (within one level where
cv2's build contracts its float products).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..io import jpeg
from ..ops.clahe import clahe
from . import histogram

FILTERS = ("none", "equalize_value", "equalize_rgb", "equalize_red",
           "equalize_green", "equalize_blue", "red/green", "shader")

_HSV_SHIFT = 12
# cv2's RGB2HSV_b tables: round((255 << 12) / v), round((180 << 12) / 6d)
_SDIV = np.r_[0, np.rint((255 << _HSV_SHIFT) / np.arange(1.0, 256))]
_HDIV = np.r_[0, np.rint((180 << _HSV_SHIFT) / (6.0 * np.arange(1.0, 256)))]
# HSV2RGB's (b, g, r) picks from [v, v(1−s), v(1−sh), v(1−s(1−h))]
_SECTORS = ((1, 3, 0), (1, 0, 2), (3, 0, 1), (0, 2, 1), (0, 1, 3),
            (2, 1, 0))


def bgr_to_hsv(bgr):
    """cv2.cvtColor(bgr, COLOR_BGR2HSV) of an (H, W, 3) uint8 tensor: hue
    0..179, saturation and value 0..255, in cv2's integer arithmetic."""
    b, g, r = (bgr[..., k].long() for k in range(3))
    v = torch.maximum(torch.maximum(b, g), r)
    diff = v - torch.minimum(torch.minimum(b, g), r)
    sdiv = torch.from_numpy(_SDIV.astype(np.int64)).to(bgr.device)
    hdiv = torch.from_numpy(_HDIV.astype(np.int64)).to(bgr.device)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * sdiv[v] + half) >> _HSV_SHIFT
    h = torch.where(v == r, g - b,
                    torch.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff] + half) >> _HSV_SHIFT
    h = torch.where(h < 0, h + 180, h)
    return torch.stack([h, s, v], -1).to(torch.uint8)


def hsv_to_bgr(hsv):
    """cv2.cvtColor(hsv, COLOR_HSV2BGR) of an (H, W, 3) uint8 tensor, in
    float32 as cv2: s and v scaled by 1/255, the hue's sector from h·6/180,
    the result ·255 rounded to nearest."""
    f32 = torch.float32
    h, s, v = (hsv[..., k].to(f32) for k in range(3))
    inv255 = torch.tensor(1.0 / 255.0, dtype=f32)
    s = s * inv255
    v = v * inv255
    h = h * torch.tensor(6.0 / 180.0, dtype=f32)
    h = torch.where(h >= 6, h - 6, h)
    sector = torch.floor(h)
    h = h - sector
    sector = sector.long().clamp(0, 5)
    one = torch.tensor(1.0, dtype=f32)
    tab = torch.stack([v, v * (one - s), v * (one - s * h),
                       v * (one - s * (one - h))], -1)
    pick = torch.tensor(_SECTORS, device=hsv.device)[sector]
    out = torch.gather(tab, -1, pick)
    out = torch.where((s == 0)[..., None], v[..., None], out)
    return torch.round(out * torch.tensor(255.0, dtype=f32)) \
        .clamp(0, 255).to(torch.uint8)


def equalize_value(bgr, clip=1.0):
    """CLAHE on the HSV value channel (the explorer's 'equalize_value')."""
    hsv = bgr_to_hsv(bgr)
    v = clahe(hsv[..., 2].contiguous(), clip_limit=clip)
    return hsv_to_bgr(torch.stack([hsv[..., 0], hsv[..., 1], v], -1))


def equalize_rgb(bgr, clip=1.0):
    """CLAHE on each of B, G and R."""
    return clahe(bgr.permute(2, 0, 1).contiguous(),
                 clip_limit=clip).permute(1, 2, 0).contiguous()


def equalize_channel(bgr, channel):
    """Hue-distance channel emphasis (the explorer's equalize_red, green,
    blue): the pixel's hue distance from the target hue, scaled by its
    saturation, written into that output channel (float64, truncated)."""
    hsv = bgr_to_hsv(bgr)
    hue, sat = hsv[..., 0].double(), hsv[..., 1].double()
    target = {"red": 0.0, "green": 60.0, "blue": 120.0}[channel]
    diff = torch.remainder(hue - target + 90.0, 180.0)
    diff = 1.0 - (diff - 90.0).abs() / 90.0
    chan = (diff * sat).to(torch.uint8)
    out = torch.zeros_like(bgr)
    out[..., {"blue": 0, "green": 1, "red": 2}[channel]] = chan
    return out


def red_green_ratio(bgr, max_ratio=4.0):
    """The explorer's 'red/green': r/g and g/r ratio channels."""
    b, g, r = (bgr[..., k].double() for k in range(3))
    ratio = (r / (g + 1.0)).clamp(0, max_ratio)
    inv = (g / (r + 1.0)).clamp(0, max_ratio)
    return torch.stack([torch.zeros_like(bgr[..., 0]),
                        (inv * (255.0 / max_ratio)).to(torch.uint8),
                        (ratio * (255.0 / max_ratio)).to(torch.uint8)], -1)


def _smoothstep(e0, e1, x):
    t = ((x - e0) / (e1 - e0)).clamp(0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def shader_red_emphasis(bgr):
    """explore/myshader.frag's active branch: emphasize dominant-red
    pixels, luminance-gated against basement noise (float32)."""
    f = bgr.float() / 255.0
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    red = r / g.clamp_min(0.01)
    green = g / r.clamp_min(0.01)
    lum = 0.21 * r + 0.72 * g + 0.07 * b
    lum_factor = _smoothstep(0.0, 0.2, lum)
    out = torch.zeros_like(f)
    out[..., 2] = _smoothstep(0.9, 3.0, red * lum_factor)
    out[..., 1] = _smoothstep(0.5, 2.5, green)
    return (out * 255.0).to(torch.uint8)


def apply_filter(bgr, mode):
    if mode in (None, "none"):
        return bgr
    if mode == "equalize_value":
        return equalize_value(bgr)
    if mode == "equalize_rgb":
        return equalize_rgb(bgr)
    if mode in ("equalize_red", "equalize_green", "equalize_blue"):
        return equalize_channel(bgr, mode.split("_")[1])
    if mode == "red/green":
        return red_green_ratio(bgr)
    if mode == "shader":
        return shader_red_emphasis(bgr)
    raise ValueError(f"unknown filter {mode}")


def _ensure_bgr(img):
    """(H, W) gray or (H, W, 4) BGRA → (H, W, 3) BGR."""
    if img.dim() == 2:
        return img[..., None].expand(-1, -1, 3).contiguous()
    return img[..., :3].contiguous()


class TextureManager:
    """Loads corrected textures, the full-resolution ones through an LRU
    cache. Corrections in the reference's order: histogram matching →
    vignette → filter (CLAHE value-equalize by default). Textures are
    (H, W, 3) uint8 tensors on device."""

    CACHE_SIZE = 10          # the explorer's cachesize
    MAX_TEXTURE_DIM = 4096   # stand-in for the GPU max texture query

    def __init__(self, proj, filter_mode="equalize_value", device="cuda"):
        self.proj = proj
        self.models_dir = proj.models_dir
        self.filter_mode = filter_mode
        self.device = torch.device(device)
        self.tcache = {}     # name -> [bgr, timestamp]
        self.histograms, self.templates = histogram.load(proj.analysis_dir)
        self.vignette_full = None
        self.vignette_small = None
        vfile = os.path.join(proj.analysis_dir, "vignette-mask.jpg")
        if os.path.isfile(vfile):
            self.vignette_full = _ensure_bgr(jpeg.decode_bgr(vfile,
                                                             self.device))
            self.vignette_small = jpeg.resize_linear(self.vignette_full,
                                                     (512, 512))

    def _correct(self, bgr, name, vignette):
        if self.templates and name in self.templates:
            own = (self.histograms.get(name)
                   or histogram.image_histogram_rgb(
                       self.proj, self.proj.image_by_name(name),
                       device=self.device))
            bgr = histogram.match_to_template(bgr, own, self.templates[name])
        if vignette is not None:
            if vignette.shape[:2] != bgr.shape[:2]:
                vignette = jpeg.resize_linear(vignette,
                                              (bgr.shape[1], bgr.shape[0]))
            bgr = (bgr.int() + vignette.int()).clamp(0, 255) \
                .to(torch.uint8)
        return apply_filter(bgr, self.filter_mode)

    def load_base(self, name):
        """The 512² model texture with corrections."""
        for ext in (".JPG", ".jpg"):
            p = os.path.join(self.models_dir, name + ext)
            if os.path.isfile(p):
                bgr = _ensure_bgr(jpeg.decode_bgr(p, self.device))
                return self._correct(bgr, name, self.vignette_small)
        return None

    def load_full(self, name):
        """The full-resolution texture through the LRU cache."""
        if name in self.tcache:
            entry = self.tcache[name]
            entry[1] = time.time()
            return entry[0]
        image_file = None
        search = [self.proj.project_dir,
                  os.path.join(self.proj.project_dir, "images")]
        for d in search:
            for ext in (".JPG", ".jpg"):
                p = os.path.join(d, name + ext)
                if os.path.isfile(p):
                    image_file = p
        if image_file is None:
            return None
        bgr = _ensure_bgr(jpeg.decode_bgr(image_file, self.device))
        h, w = bgr.shape[:2]
        m = self.MAX_TEXTURE_DIM
        if h > m or w > m:
            s = m / max(h, w)
            bgr = jpeg.resize_linear(bgr, (int(w * s), int(h * s)))
        bgr = self._correct(bgr, name, self.vignette_full)
        self.tcache[name] = [bgr, time.time()]
        while len(self.tcache) > self.CACHE_SIZE:
            oldest = min(self.tcache, key=lambda k: self.tcache[k][1])
            del self.tcache[oldest]
        return bgr


def build_histograms(proj, dist_cutoff=40.0, self_weight=0.1,
                     device="cuda"):
    """Compute and save the neighbourhood histogram-match tables
    (histogram.pickle); returns (histograms, templates)."""
    hists = histogram.make_histograms(proj, device=device)
    templates = histogram.make_templates(proj, hists,
                                         dist_cutoff=dist_cutoff,
                                         self_weight=self_weight)
    histogram.save(proj.analysis_dir, hists, templates)
    return hists, templates

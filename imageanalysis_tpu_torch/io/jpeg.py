"""JPEG decode and encode, and the two resizes of the image path.

The counterpart of the reference's host image I/O:

- ``features/detect.py:69-119`` decodes frames for detection with PIL's
  DCT-domain ``draft("L")`` (scale ≤ 0.5) or ``cv2.imread`` and resizes
  them with ``cv2.resize`` (INTER_LINEAR);
- ``render/build_map.py:107-146`` decodes textures with ``cv2.imread``
  (``IMREAD_REDUCED_COLOR_2/4``), resizes them with INTER_AREA and writes
  them with ``cv2.imwrite``;
- ``testing/synthetic.py:217-228`` writes its frames with ``cv2.imwrite``
  at quality 95.

On a CUDA device, decode and encode go through nvJPEG
(``csrc/jpeg_codec.cu``): decode to luma (``NVJPEG_OUTPUT_Y``) or to
interleaved BGR (``NVJPEG_OUTPUT_BGRI``) straight into a tensor on the
current stream, encode from an (H, W, 3) BGR tensor as baseline JPEG with
4:2:0 chroma, which is what ``cv2.imwrite`` writes by default. nvJPEG has
no DCT-domain reduction: a reduced decode is a full decode followed by a
box mean over ratio × ratio blocks (``box_reduce``). On the CPU, the plain
path, each function calls PIL or cv2 exactly as the reference does, so the
CPU's images are the reference's bytes; it exists for the tests. Any
other device raises, and a failure of nvJPEG raises: there is no fallback
from one path to the other.

``resize_linear`` and ``resize_area`` are torch on whatever device the
image lies on: cv2's INTER_LINEAR taps (cv2's 11-bit fixed point weights
make them differ by ±1 gray level) and cv2's INTER_AREA weights (the
fractional overlap of each output cell with the input pixels when both
axes shrink, cv2's area-linear weights otherwise).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build


def _device(device):
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"JPEG I/O runs on the CPU or a CUDA card, not "
                         f"{dev}")
    return dev


def _check(err, name):
    if err > 0:
        raise RuntimeError(f"{name}: nvJPEG status {err}")
    if err < 0:
        raise RuntimeError(f"{name}: cudaError_t {-err}")


def _read(path):
    with open(path, "rb") as f:
        data = np.frombuffer(f.read(), np.uint8)
    if not len(data):
        raise ValueError(f"{path}: empty file")
    return data


def _info(data, path):
    """(components, width, height) of a JPEG's bytes (a uint8 array), from
    nvJPEG's header parse; raises for what nvJPEG cannot read."""
    lib = _build.load()
    out = [ctypes.c_int() for _ in range(3)]
    _check(lib.jpeg_info(data.ctypes.data, len(data),
                         *(ctypes.byref(o) for o in out)),
           f"{path}: not a JPEG nvJPEG reads, jpeg_info")
    return tuple(o.value for o in out)


def _nvjpeg_decode(path, dev, bgr):
    data = _read(path)
    comps, w, h = _info(data, path)
    lib = _build.load()
    # a one-component JPEG decodes to its luma, then repeats it as B, G, R
    as_bgr = bgr and comps > 1
    out = torch.empty((h, w, 3) if as_bgr else (h, w), dtype=torch.uint8,
                      device=dev)
    with torch.cuda.device(dev):
        err = lib.jpeg_decode(data.ctypes.data, len(data), int(as_bgr),
                              out.data_ptr(), out.stride(0),
                              torch.cuda.current_stream(dev).cuda_stream)
    _check(err, f"jpeg_decode({path})")
    if bgr and not as_bgr:
        out = out[..., None].expand(h, w, 3).contiguous()
    return out


def decode_gray(path, device="cuda"):
    """A JPEG's gray image, (H, W) uint8 on device. CUDA: nvJPEG's luma.
    CPU: cv2.imread + BGR2GRAY, as the reference's full-scale load
    (detect.py:108-114)."""
    dev = _device(device)
    if dev.type == "cuda":
        return _nvjpeg_decode(path, dev, bgr=False)
    import cv2

    img = cv2.imread(path, flags=cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH
                     | cv2.IMREAD_IGNORE_ORIENTATION)
    if img is None:
        raise FileNotFoundError(path)
    if img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    return torch.from_numpy(img)


def decode_bgr(path, device="cuda", reduce=1):
    """A JPEG as (H, W, 3) uint8 BGR on device, reduced by reduce (1, 2, 4
    or 8) to ceil(W / reduce) × ceil(H / reduce). CUDA: nvJPEG's BGR, then
    box_reduce. CPU: cv2.imread with the reference's texture flags and
    IMREAD_REDUCED_COLOR_<reduce> (build_map.py:127-136); a one-component
    JPEG read without reduction comes back (H, W), as cv2 gives it."""
    if reduce not in (1, 2, 4, 8):
        raise ValueError(f"reduce must be 1, 2, 4 or 8, not {reduce}")
    dev = _device(device)
    if dev.type == "cuda":
        return box_reduce(_nvjpeg_decode(path, dev, bgr=True), reduce)
    import cv2

    flags = (cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH
             | cv2.IMREAD_IGNORE_ORIENTATION)
    flags |= {1: 0, 2: cv2.IMREAD_REDUCED_COLOR_2,
              4: cv2.IMREAD_REDUCED_COLOR_4,
              8: cv2.IMREAD_REDUCED_COLOR_8}[reduce]
    img = cv2.imread(path, flags=flags)
    if img is None:
        raise FileNotFoundError(path)
    return torch.from_numpy(img)


def encode_bgr(img, path, quality=95):
    """Write an (H, W, 3) uint8 BGR image as a JPEG at quality. CUDA:
    nvJPEG, 4:2:0. CPU: cv2.imwrite with IMWRITE_JPEG_QUALITY."""
    if img.dtype != torch.uint8:
        raise ValueError(f"encode_bgr needs uint8, not {img.dtype}")
    dev = _device(img.device)
    if dev.type == "cpu":
        import cv2

        if not cv2.imwrite(path, np.ascontiguousarray(img.numpy()),
                           [cv2.IMWRITE_JPEG_QUALITY, int(quality)]):
            raise OSError(f"cv2.imwrite failed: {path}")
        return
    if img.dim() != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_bgr needs (H, W, 3), not "
                         f"{tuple(img.shape)}")
    img = img.contiguous()
    h, w, _ = img.shape
    lib = _build.load()
    length = ctypes.c_size_t()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _check(lib.jpeg_encode(img.data_ptr(), w, h, img.stride(0),
                               int(quality), stream, ctypes.byref(length)),
               "jpeg_encode")
        out = np.empty(length.value, np.uint8)
        _check(lib.jpeg_encode_fetch(out.ctypes.data, ctypes.byref(length),
                                     stream), "jpeg_encode_fetch")
    with open(path, "wb") as f:
        f.write(out[:length.value].tobytes())


def _as_nchw(img):
    """(H, W) or (H, W, C) → float32 (1, C, H, W) and the inverse."""
    x = img.float()
    if x.dim() == 2:
        return x[None, None], lambda y: y[0, 0]
    return x.permute(2, 0, 1)[None], lambda y: y[0].permute(1, 2, 0)


def _like(y, img):
    if img.dtype == torch.uint8:
        return torch.round(y).clamp(0, 255).to(torch.uint8).contiguous()
    return y.to(img.dtype).contiguous()


def box_reduce(img, ratio):
    """Mean over ratio × ratio blocks of an (H, W) or (H, W, C) image →
    ceil(H / ratio) × ceil(W / ratio), the edge blocks over the pixels they
    hold: the size and, near enough, the values of a JPEG decoded at
    1/ratio in the DCT domain (PIL draft, IMREAD_REDUCED_*)."""
    if ratio == 1:
        return img
    x, back = _as_nchw(img)
    y = F.avg_pool2d(x, ratio, stride=ratio, ceil_mode=True)
    return _like(back(y), img)


def _linear_taps(n_in, n_out, scale, device):
    """cv2 INTER_LINEAR's two taps on one axis for the scale factor scale
    (output / input): output pixel d samples (d + 0.5)/scale − 0.5,
    clamped to the first and last input pixel → (lo, hi, weight of hi)."""
    f = ((np.arange(n_out) + 0.5) / scale - 0.5).astype(np.float32)
    lo = np.floor(f).astype(np.int64)
    a = f - lo
    a[lo < 0] = 0.0
    lo[lo < 0] = 0
    top = lo >= n_in - 1
    a[top] = 0.0
    lo[top] = n_in - 1
    hi = np.minimum(lo + 1, n_in - 1)
    return (torch.from_numpy(lo).to(device), torch.from_numpy(hi).to(device),
            torch.from_numpy(a).to(device))


def resize_linear(img, size, scale=None):
    """cv2.resize(img, size, fx, fy, interpolation=INTER_LINEAR) of an
    (H, W) or (H, W, C) image, size = (width, height). scale = (fx, fy)
    when the caller's cv2.resize was given its scale factors: cv2 then
    maps output pixels by 1/fx, which can differ from the size ratio by a
    fraction of a pixel across the frame; without it the size ratio.
    Half-pixel centres, edge samples clamped. Returns img's dtype (uint8
    rounded)."""
    w, h = size
    H, W = img.shape[:2]
    fx, fy = scale if scale is not None else (w / W, h / H)
    if (h, w) == (H, W) and fx == fy == 1:
        return img
    y0, y1, ay = _linear_taps(H, h, fy, img.device)
    x0, x1, ax = _linear_taps(W, w, fx, img.device)
    x = img.float()
    ay = ay.view(-1, *[1] * (x.dim() - 1))
    ax = ax.view(-1, *[1] * (x.dim() - 2))
    rows = x[y0] * (1 - ay) + x[y1] * ay
    return _like(rows[:, x0] * (1 - ax) + rows[:, x1] * ax, img)


def _area_weights(n_in, n_out):
    """(n_out, n_in) weights of cv2's INTER_AREA on a shrinking axis
    (computeResizeAreaTab): output cell dx covers [dx·s, dx·s + s) input
    pixels, s = n_in / n_out, each weighted by its overlap over the cell."""
    s = n_in / n_out
    m = np.zeros((n_out, n_in))
    for dx in range(n_out):
        f1 = dx * s
        f2 = f1 + s
        cell = min(s, n_in - f1)
        s1 = int(np.ceil(f1))
        s2 = min(int(np.floor(f2)), n_in - 1)
        s1 = min(s1, s2)
        if s1 - f1 > 1e-3:
            m[dx, s1 - 1] = (s1 - f1) / cell
        m[dx, s1:s2] = 1.0 / cell
        if f2 - s2 > 1e-3:
            m[dx, s2] = min(min(f2 - s2, 1.0), cell) / cell
    return m


def _area_linear_weights(n_in, n_out):
    """(n_out, n_in) weights of cv2's INTER_AREA when an axis grows: the
    two-tap interpolation of cv2's resize with area_mode (sx = floor(dx·s),
    fx = (dx + 1) − (sx + 1)/s, less its floor, zero if ≤ 0)."""
    s = n_in / n_out
    inv = n_out / n_in
    m = np.zeros((n_out, n_in))
    for dx in range(n_out):
        sx = int(np.floor(dx * s))
        fx = np.float32((dx + 1) - (sx + 1) * inv)
        fx = 0.0 if fx <= 0 else float(fx - np.floor(fx))
        if sx < 0:
            sx, fx = 0, 0.0
        if sx >= n_in - 1:
            sx, fx = n_in - 1, 0.0
        m[dx, sx] += 1.0 - fx
        if fx:
            m[dx, sx + 1] += fx
    return m


def resize_area(img, size):
    """cv2.resize(img, size, interpolation=INTER_AREA) of an (H, W) or
    (H, W, C) image, size = (width, height), as Wy @ img @ Wxᵀ with
    per-axis weights: the overlap weights when neither axis grows, cv2's
    area-linear weights on both axes otherwise. Returns img's dtype
    (uint8 rounded)."""
    w, h = size
    H, W = img.shape[:2]
    if (h, w) == (H, W):
        return img
    weights = (_area_weights if W >= w and H >= h
               else _area_linear_weights)
    wy = torch.from_numpy(weights(H, h)).float().to(img.device)
    wx = torch.from_numpy(weights(W, w)).float().to(img.device)
    x = img.float()
    y = (torch.einsum("oh,hwc,pw->opc", wy, x, wx) if x.dim() == 3
         else wy @ x @ wx.T)
    return _like(y, img)

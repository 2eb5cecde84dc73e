"""SIFT detector/descriptor over a batch of frames on the device.

Port of ``imageanalysis_tpu/features/sift_tpu.py`` (the one module of the
port whose name differs from its reference). The algorithm is the
reference's:

- a 2× bilinear upsample (cv2 firstOctave=-1);
- a separable Gaussian pyramid; every blur is kernel K2
  (``csrc/gauss_blur.cu``, both passes fused), whose plain version is
  ``blur_plain``;
- difference-of-Gaussians, 26-neighbour extrema, a fixed top-k candidate
  list per level, a 3-step quadratic subpixel refine with contrast and
  edge rejection, and on-device twin removal;
- orientation histograms and 4×4×8 descriptors computed densely on one
  patch per keypoint, with cv2's clone rule for secondary peaks.

Where the reference keeps a TPU workaround beside a CPU arm, the port
follows the CPU arm: ``x[:, ::2, ::2]`` for the downsample and a batched
product for the descriptor bins. The transport codec, the output packing
and the detect-batch wedge policy exist for the TPU's link and are not
ported; ``detect_dispatch`` returns the detect tensors on the device.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from ..ops.clahe import clahe

N_SCALES = 3           # scales per octave (cv2 nOctaveLayers)
SIGMA0 = 1.6
CONTRAST_THRESH = 0.04
EDGE_THRESH = 10.0
ORI_BINS = 36
ORI_SIG_FCTR = 1.5     # cv2 SIFT_ORI_SIG_FCTR
ORI_RADIUS = 4.5       # cv2 SIFT_ORI_RADIUS = 3 * ORI_SIG_FCTR
ORI_PEAK_RATIO = 0.8   # cv2 SIFT_ORI_PEAK_RATIO
DESC_WIDTH = 4         # 4×4 spatial bins
DESC_ORI = 8
DESC_SCL_FCTR = 3.0    # cv2 SIFT_DESCR_SCL_FCTR (hist bin width = 3σ)
PATCH = 64             # per-keypoint patch (covers max desc radius 30)
REFINE_STEPS = 3

_BLUR_RMAX = 15        # K2 takes up to 31 taps
BLUR_LAUNCHES = 0      # K2 launches (not plain-version calls)


def _gauss_kernel(sigma):
    radius = max(int(math.ceil(3.0 * sigma)), 1)
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def blur_plain(img, taps):
    """Plain version of K2: the reference _blur's jnp arm. img (B, H, W)
    f32; taps (2r+1,) f32. Reflect-101 borders; the row pass, then the
    column pass, each summing its taps in order j = 0..2r as separate
    multiply and add ops."""
    k = [float(v) for v in taps]
    r = (len(k) - 1) // 2
    H, W = img.shape[1], img.shape[2]
    x = F.pad(img, (r, r), mode="reflect")
    out = None
    for j, kj in enumerate(k):
        term = x[:, :, j:j + W] * kj
        out = term if out is None else out + term
    x = F.pad(out, (0, 0, r, r), mode="reflect")
    out = None
    for j, kj in enumerate(k):
        term = x[:, j:j + H, :] * kj
        out = term if out is None else out + term
    return out


def _blur(img, sigma):
    """K2: separable Gaussian blur of img (B, H, W) f32 with reflect-101
    borders. A CUDA tensor launches csrc/gauss_blur.cu; a CPU tensor takes
    blur_plain; any other device raises."""
    global BLUR_LAUNCHES
    taps = _gauss_kernel(sigma)
    r = (len(taps) - 1) // 2
    if img.dim() != 3 or img.dtype != torch.float32:
        raise ValueError(f"_blur: need (B, H, W) float32, got "
                         f"{tuple(img.shape)} {img.dtype}")
    dev = img.device
    if dev.type == "cpu":
        return blur_plain(img, taps)
    if dev.type != "cuda":
        raise ValueError(f"_blur: no kernel for device {dev}")
    B, H, W = img.shape
    if r > _BLUR_RMAX or r >= H or r >= W:
        raise ValueError(f"_blur: radius {r} needs r <= {_BLUR_RMAX} and "
                         f"r < H, W (got {H}x{W})")
    if not img.is_contiguous():
        raise ValueError("_blur: input must be contiguous")
    lib = _build.load()
    out = torch.empty_like(img)
    with torch.cuda.device(dev):
        err = lib.gauss_blur_f32(
            img.data_ptr(), out.data_ptr(), taps.ctypes.data, B, H, W, r,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "gauss_blur_f32")
    BLUR_LAUNCHES += 1
    return out


def _downsample2(x):
    """Every-other-pixel downsample (cv2's next-octave rule), (B, H, W)."""
    return x[:, ::2, ::2].contiguous()


def _octave_stack(img, sigma_base):
    """Gaussian levels (N_SCALES+3) and DoG levels of one octave, as lists
    of (B, H, W) tensors."""
    k = 2.0 ** (1.0 / N_SCALES)
    gs = [img]
    sig_prev = sigma_base
    for i in range(1, N_SCALES + 3):
        sig_total = sigma_base * (k ** i)
        sig_extra = math.sqrt(max(sig_total**2 - sig_prev**2, 1e-6))
        gs.append(_blur(gs[-1], sig_extra))
        sig_prev = sig_total
    dogs = [gs[i + 1] - gs[i] for i in range(N_SCALES + 2)]
    return gs, dogs


def _win3_max(x):
    """3×3 max over the spatial dims of (B, H, W), borders excluded."""
    return F.max_pool2d(x[:, None], 3, stride=1, padding=1)[:, 0]


def _extrema_mask_level(dogs, lvl, thresh):
    """26-neighbour min/max test for one DoG level: a maximum attains its
    own level's 3×3 max and strictly exceeds the adjacent levels' 3×3
    maxima (minima likewise)."""
    center = dogs[lvl]
    B, H, W = center.shape
    own_max = _win3_max(center)
    own_min = -_win3_max(-center)
    adj_max = torch.maximum(_win3_max(dogs[lvl - 1]),
                            _win3_max(dogs[lvl + 1]))
    adj_min = torch.minimum(-_win3_max(-dogs[lvl - 1]),
                            -_win3_max(-dogs[lvl + 1]))
    is_max = (center >= own_max) & (center > adj_max)
    is_min = (center <= own_min) & (center < adj_min)
    mask = (is_max | is_min) & (center.abs() > thresh)
    border = 8
    yy = torch.arange(H, device=center.device)
    xx = torch.arange(W, device=center.device)
    mask &= ((yy >= border) & (yy < H - border))[None, :, None]
    mask &= ((xx >= border) & (xx < W - border))[None, None, :]
    return mask


def _fit3(dog3, bi, y, x):
    """One quadratic fit of the 3×3×3 DoG neighbourhood at integer (y, x)
    for a (B, P) batch of candidates: returns (off (B, P, 3) [s, y, x],
    contrast (B, P), edge_ok (B, P))."""
    def g(ds_, dy_, dx_):
        return dog3[ds_ + 1][bi, y + dy_, x + dx_]

    d_s = 0.5 * (g(1, 0, 0) - g(-1, 0, 0))
    d_y = 0.5 * (g(0, 1, 0) - g(0, -1, 0))
    d_x = 0.5 * (g(0, 0, 1) - g(0, 0, -1))
    c = g(0, 0, 0)
    h_ss = g(1, 0, 0) + g(-1, 0, 0) - 2 * c
    h_yy = g(0, 1, 0) + g(0, -1, 0) - 2 * c
    h_xx = g(0, 0, 1) + g(0, 0, -1) - 2 * c
    h_sy = 0.25 * (g(1, 1, 0) - g(1, -1, 0) - g(-1, 1, 0) + g(-1, -1, 0))
    h_sx = 0.25 * (g(1, 0, 1) - g(1, 0, -1) - g(-1, 0, 1) + g(-1, 0, -1))
    h_yx = 0.25 * (g(0, 1, 1) - g(0, 1, -1) - g(0, -1, 1) + g(0, -1, -1))
    Hm = torch.stack([torch.stack([h_ss, h_sy, h_sx], -1),
                      torch.stack([h_sy, h_yy, h_yx], -1),
                      torch.stack([h_sx, h_yx, h_xx], -1)], -2)
    grad = torch.stack([d_s, d_y, d_x], -1)
    eye = torch.eye(3, dtype=Hm.dtype, device=Hm.device)
    # solve_ex: a singular system gives inf/nan (rejected below) instead of
    # a host sync for the error check
    sol, _ = torch.linalg.solve_ex(Hm + 1e-8 * eye, grad[..., None])
    off = -sol[..., 0]
    contrast = c + 0.5 * (grad * off).sum(-1)
    tr = h_yy + h_xx
    det = h_yy * h_xx - h_yx * h_yx
    r = EDGE_THRESH
    edge_ok = (det > 0) & (tr * tr * r < (r + 1.0) ** 2 * det)
    return off, contrast, edge_ok


def _refine(dog3, bi, y, x):
    """Iterative quadratic subpixel fit (cv2 adjustLocalExtrema): while a
    fit's spatial offset exceeds 0.5 px, move the integer centre by the
    rounded offset and refit (REFINE_STEPS unrolled steps). Scale moves are
    clipped to ±0.5.

    Returns (ds, dy, dx, contrast, edge_ok, yc, xc), each (B, P), with
    dy/dx relative to the original (y, x) and (yc, xc) the final integer
    centre."""
    H, W = dog3[1].shape[1:]
    border = 5
    yc, xc = y, x
    for it in range(REFINE_STEPS):
        off, contrast, edge_ok = _fit3(dog3, bi, yc, xc)
        if it < REFINE_STEPS - 1:
            # a nan offset (singular fit) stays put; the fit is rejected
            my = torch.nan_to_num(torch.round(off[..., 1])).clamp(-H, H).long()
            mx = torch.nan_to_num(torch.round(off[..., 2])).clamp(-W, W).long()
            yc = (yc + my).clamp(border, H - 1 - border)
            xc = (xc + mx).clamp(border, W - 1 - border)
    off = off.clamp(-0.5, 0.5)
    dy = (yc - y).float() + off[..., 1]
    dx = (xc - x).float() + off[..., 2]
    return off[..., 0], dy, dx, contrast, edge_ok, yc, xc


# ---------------------------------------------------------------------------
# Dense patch-based orientation + descriptor
# ---------------------------------------------------------------------------

def _patch_for_level(lvl):
    """Per-level patch size: the descriptor window radius is
    round(3σ·√2·2.5) with σ = 1.6·2^((lvl−1+ds)/3). Level 1 keeps the
    reference's 40 (one short for radius-19 samples) for parity."""
    return {1: 40, 2: 52}.get(lvl, PATCH)


def _extract_patches(img, bi, yc, xc, patch=PATCH):
    """One patch×patch window per keypoint of img (B, H, W) at centres
    (yc, xc) (B, P), clamped to the image. Returns (patches (B, P, patch,
    patch), y0 (B, P), x0 (B, P))."""
    H, W = img.shape[1:]
    if H < patch or W < patch:
        img = F.pad(img, (0, max(patch - W, 0), 0, max(patch - H, 0)))
    y0 = (yc - patch // 2).clamp(0, max(H - patch, 0))
    x0 = (xc - patch // 2).clamp(0, max(W - patch, 0))
    off = torch.arange(patch, device=img.device)
    rows = (y0[..., None] + off)[..., :, None]
    cols = (x0[..., None] + off)[..., None, :]
    return img[bi[..., None, None], rows, cols], y0, x0


def _patch_grads(patches, y0, x0, yc, xc, H, W):
    """Gradients and integer offsets of flattened patches (N, S, S):
    cv2-convention dx = I(r,c+1)−I(r,c−1), dy = I(r−1,c)−I(r+1,c), angle in
    degrees [0, 360); pixels outside the image's gradient region
    (rows/cols 1..n−2) get zero magnitude. Returns (mag, ang, di, dj),
    each (N, S²)."""
    S = patches.shape[-1]
    gx = torch.zeros_like(patches)
    gx[:, :, 1:-1] = patches[:, :, 2:] - patches[:, :, :-2]
    gy = torch.zeros_like(patches)
    gy[:, 1:-1, :] = patches[:, :-2, :] - patches[:, 2:, :]
    gx = gx.reshape(-1, S * S)
    gy = gy.reshape(-1, S * S)
    idx = torch.arange(S, device=patches.device)
    row = idx.repeat_interleave(S)
    col = idx.repeat(S)
    yabs = y0[:, None] + row[None, :]
    xabs = x0[:, None] + col[None, :]
    inb = (yabs >= 1) & (yabs <= H - 2) & (xabs >= 1) & (xabs <= W - 2)
    mag = torch.sqrt(gx * gx + gy * gy) * inb
    ang = torch.remainder(torch.atan2(gy, gx) * (180.0 / math.pi), 360.0)
    di = (yabs - yc[:, None]).to(patches.dtype)   # row offset
    dj = (xabs - xc[:, None]).to(patches.dtype)   # col offset
    return mag, ang, di, dj


def _orientation_hist(mag, ang, di, dj, sigma):
    """cv2 calcOrientationHist, dense: 36-bin Gaussian-weighted histogram
    over the square window of radius round(4.5σ), smoothed with cv2's
    [1,4,6,4,1]/16 circular kernel. Args (N, P²) except sigma (N,).
    Returns (N, 36)."""
    radius = torch.round(ORI_RADIUS * sigma)[:, None]
    w_sig = ORI_SIG_FCTR * sigma[:, None]
    inwin = (di.abs() <= radius) & (dj.abs() <= radius)
    w = torch.exp(-(di * di + dj * dj) / (2.0 * w_sig * w_sig))
    mw = mag * w * inwin
    bins = torch.round(ang * (ORI_BINS / 360.0)).long() % ORI_BINS
    h = torch.stack([torch.where(bins == b, mw, 0.0).sum(-1)
                     for b in range(ORI_BINS)], -1)
    return ((torch.roll(h, 2, -1) + torch.roll(h, -2, -1)) * (1.0 / 16.0)
            + (torch.roll(h, 1, -1) + torch.roll(h, -1, -1)) * (4.0 / 16.0)
            + h * (6.0 / 16.0))


def _orientation_peaks(hist):
    """Dominant and strongest secondary (≥ 0.8·max) orientation peaks:
    returns (angles_deg (N, 2), valid (N, 2)), angles in cv2's convention
    (360 − interpolated bin·10)."""
    n = ORI_BINS
    left = torch.roll(hist, 1, -1)
    right = torch.roll(hist, -1, -1)
    hmax = hist.max(-1, keepdim=True).values
    is_peak = (hist > left) & (hist > right) & (hist >= ORI_PEAK_RATIO * hmax)
    b1 = hist.argmax(-1)
    iota = torch.arange(n, device=hist.device)[None, :]
    second = torch.where(is_peak & (iota != b1[:, None]), hist, -1.0)
    b2 = second.argmax(-1)
    v2 = torch.gather(second, 1, b2[:, None])[:, 0] > 0

    def interp(b):
        l = torch.gather(hist, 1, ((b - 1) % n)[:, None])[:, 0]
        c = torch.gather(hist, 1, b[:, None])[:, 0]
        r = torch.gather(hist, 1, ((b + 1) % n)[:, None])[:, 0]
        denom = l - 2 * c + r
        off = torch.where(denom.abs() > 1e-12, 0.5 * (l - r) / denom, 0.0)
        binf = torch.remainder(b + off, n)
        ang = 360.0 - binf * (360.0 / n)
        return torch.where((ang - 360.0).abs() < 1e-5, 0.0, ang)

    valid = torch.stack([torch.ones_like(v2), v2], -1)
    return torch.stack([interp(b1), interp(b2)], -1), valid


def _descriptors_dense(mag, ang, di, dj, angle_deg, sigma):
    """cv2 calcSIFTDescriptor, dense over patches: 4×4×8 trilinear binning
    of rotated integer-pixel offsets. mag/ang/di/dj (N, P²); angle_deg,
    sigma (N,). Returns (N, 128) uint8."""
    d = DESC_WIDTH
    nb = DESC_ORI
    ori = 360.0 - angle_deg
    ori = torch.where((ori - 360.0).abs() < 1e-5, 0.0, ori)
    hist_w = DESC_SCL_FCTR * sigma
    rad = ori * (math.pi / 180.0)
    ct = (torch.cos(rad) / hist_w)[:, None]
    st = (torch.sin(rad) / hist_w)[:, None]
    radius = torch.round(hist_w * math.sqrt(2.0) * (d + 1) * 0.5)[:, None]

    c_rot = dj * ct - di * st
    r_rot = dj * st + di * ct
    rbin = r_rot + (d / 2 - 0.5)
    cbin = c_rot + (d / 2 - 0.5)
    obin = (ang - ori[:, None]) * (nb / 360.0)
    w = torch.exp(-(c_rot * c_rot + r_rot * r_rot) / (d * d * 0.5))
    ok = ((rbin > -1) & (rbin < d) & (cbin > -1) & (cbin < d)
          & (di.abs() <= radius) & (dj.abs() <= radius))
    m = mag * w * ok

    mo = []
    for o in range(nb):
        t = torch.remainder(obin - o, nb)
        mo.append(m * torch.clamp_min(1.0 - torch.minimum(t, nb - t), 0.0))
    mo = torch.stack(mo, 1)                              # (N, 8, P²)
    wc = torch.stack([torch.clamp_min(1.0 - (cbin - c).abs(), 0.0)
                      for c in range(d)], 1)             # (N, 4, P²)
    rows = []
    for r in range(d):
        wr = torch.clamp_min(1.0 - (rbin - r).abs(), 0.0)[:, None, :]
        rows.append(torch.bmm(wc * wr, mo.transpose(1, 2)))   # (N, 4, 8)
    desc = torch.stack(rows, 1).reshape(-1, d * d * nb)

    nrm = torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
    desc = torch.minimum(desc, 0.2 * nrm)
    nrm2 = torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
    desc = desc * (512.0 / nrm2.clamp_min(1e-12))
    return torch.round(desc.clamp(max=255.0)).to(torch.uint8)


def _detect_batch(imgs, per_octave, n_octaves, upsample=True,
                  out_slots=None):
    """imgs: (B, H, W) f32 in [0, 1] or uint8. Returns padded results with
    two orientation slots per candidate: kp (B, K, 2) full-res uv, meta
    (B, K, 4) [size, angle, response, octave], desc (B, K, 128) uint8,
    valid (B, K) bool, with K = out_slots (or every slot when None)."""
    if imgs.dtype != torch.float32:
        imgs = imgs.float() / 255.0
    B = imgs.shape[0]
    dev = imgs.device
    bi = torch.arange(B, device=dev)[:, None]
    thresh = 0.5 * CONTRAST_THRESH / N_SCALES
    # candidate budgets: 50/50 blend of area weighting and uniform (the
    # reference's rule; see sift_tpu._detect_batch)
    total = per_octave * n_octaves
    area = [4.0 ** -o for o in range(n_octaves)]
    sa = sum(area)
    wts = [0.5 * a / sa + 0.5 / n_octaves for a in area]
    per_level_oct = [max(int(round(total * wi / N_SCALES)), 32)
                     for wi in wts]

    if upsample:
        Hb, Wb = imgs.shape[1] * 2, imgs.shape[2] * 2
        base = F.interpolate(imgs[:, None], size=(Hb, Wb), mode="bilinear",
                             align_corners=False)[:, 0]
        sig_init = math.sqrt(max(SIGMA0**2 - 1.0, 0.01))
    else:
        base = imgs.contiguous()
        sig_init = math.sqrt(max(SIGMA0**2 - 0.25, 0.01))

    all_kp, all_meta, all_desc, all_valid = [], [], [], []
    octave_img = _blur(base, sig_init)
    for o in range(n_octaves):
        gs, dogs = _octave_stack(octave_img, SIGMA0)
        H, W = gs[0].shape[1:]
        scale_factor = float(2 ** o) * (0.5 if upsample else 1.0)
        per_level = per_level_oct[o]

        for lvl in range(1, N_SCALES + 1):
            mask = _extrema_mask_level(dogs, lvl, thresh)
            score = torch.where(mask, dogs[lvl].abs(), 0.0).reshape(B, -1)
            vals, flat = torch.topk(score, per_level, dim=1)
            y_idx = flat // W
            x_idx = flat % W
            cand_valid = vals > 0
            # zero-score slots are invalid; keep their 3×3×3 reads in range
            y_fit = y_idx.clamp(1, H - 2)
            x_fit = x_idx.clamp(1, W - 2)
            dog3 = (dogs[lvl - 1], dogs[lvl], dogs[lvl + 1])
            ds, dy, dx, contrast, edge_ok, yc, xc = _refine(
                dog3, bi, y_fit, x_fit)
            dy = dy + (y_fit - y_idx).float()
            dx = dx + (x_fit - x_idx).float()
            ok = cand_valid & edge_ok & (contrast.abs()
                                         > CONTRAST_THRESH / N_SCALES)
            sigma = SIGMA0 * (2.0 ** ((lvl - 1 + ds) / N_SCALES))

            # drop candidates that re-centred onto the same pixel (cv2
            # removeDuplicatedSorted); invalid slots get unique negative
            # keys so they cannot collide a valid one away
            P = y_idx.shape[1]
            iota = torch.arange(P, device=dev)[None, :]
            key = torch.where(ok, yc * W + xc, -1 - iota)
            order = torch.sort(key, dim=1, stable=True).indices
            sk = torch.gather(key, 1, order)
            dup_sorted = torch.cat(
                [torch.zeros((B, 1), dtype=torch.bool, device=dev),
                 sk[:, 1:] == sk[:, :-1]], 1)
            dup = torch.zeros_like(dup_sorted).scatter_(1, order, dup_sorted)
            ok &= ~dup

            # dense patch stage over N = B·P candidates, centred on the
            # refined integer location (cv2's cvRound'ed pt)
            patch = _patch_for_level(lvl)
            patches, y0, x0 = _extract_patches(gs[lvl], bi, yc, xc, patch)
            N = B * P
            mag, ang, di, dj = _patch_grads(
                patches.reshape(N, patch, patch), y0.reshape(N),
                x0.reshape(N), yc.reshape(N), xc.reshape(N), H, W)
            sig_f = sigma.reshape(N)
            hist = _orientation_hist(mag, ang, di, dj, sig_f)
            angles, ori_valid = _orientation_peaks(hist)       # (N, 2)

            # one descriptor per orientation slot: fold slots into N
            desc2 = _descriptors_dense(
                torch.cat([mag, mag]), torch.cat([ang, ang]),
                torch.cat([di, di]), torch.cat([dj, dj]),
                torch.cat([angles[:, 0], angles[:, 1]]),
                torch.cat([sig_f, sig_f]))                     # (2N, 128)
            desc = torch.stack([desc2[:N], desc2[N:]], 1)      # (N, 2, 128)

            yf = y_idx.reshape(N).float() + dy.reshape(N)
            xf = x_idx.reshape(N).float() + dx.reshape(N)
            kp1 = torch.stack([xf, yf], -1) * scale_factor     # (N, 2)
            size1 = sig_f * scale_factor * 2.0
            resp = contrast.reshape(N).abs()
            kp = kp1[:, None, :].expand(N, 2, 2)
            meta = torch.stack([
                size1[:, None].expand(N, 2),
                angles,
                resp[:, None].expand(N, 2),
                torch.full((N, 2), float(o) - (1.0 if upsample else 0.0),
                           device=dev),
            ], -1)                                             # (N, 2, 4)
            valid = ok.reshape(N)[:, None] & ori_valid         # (N, 2)

            all_kp.append(kp.reshape(B, P * 2, 2))
            all_meta.append(meta.reshape(B, P * 2, 4))
            all_desc.append(desc.reshape(B, P * 2, 128))
            all_valid.append(valid.reshape(B, P * 2))

        # next octave: every other pixel of level N_SCALES
        octave_img = _downsample2(gs[N_SCALES])

    kp = torch.cat(all_kp, 1)
    meta = torch.cat(all_meta, 1)
    desc = torch.cat(all_desc, 1)
    valid = torch.cat(all_valid, 1)
    if out_slots is not None and out_slots < kp.shape[1]:
        # keep the strongest by response (cv2 retainBest); a stable sort
        # breaks ties by slot order, as the reference's top_k does
        score = torch.where(valid, meta[..., 2], -1.0)
        idx = torch.sort(score, dim=1, descending=True,
                         stable=True).indices[:, :out_slots]
        kp = torch.gather(kp, 1, idx[..., None].expand(-1, -1, 2))
        meta = torch.gather(meta, 1, idx[..., None].expand(-1, -1, 4))
        desc = torch.gather(desc, 1, idx[..., None].expand(-1, -1, 128))
        valid = torch.gather(valid, 1, idx)
    return kp, meta, desc, valid


def _octave_plan(H, W, max_features, upsample):
    base_min = min(H, W) * (2 if upsample else 1)
    n_octaves = max(int(math.log2(base_min / 32.0)), 1)
    per_octave = max(max_features // n_octaves, 64)
    return per_octave, n_octaves


def detect_dispatch(grays, max_features=4096, upsample=True,
                    equalize=False):
    """Detect one frame or a batch of same-shape frames.

    grays: a (H, W) or (B, H, W) tensor, or a list of (H, W) tensors, uint8
    (or float 0..255), on the device to run on. equalize=True runs CLAHE
    first (uint8 only). Returns the device tensors (kp, meta, desc, valid)
    of _detect_batch, with max_features slots per frame; the caller syncs
    when it reads them (detect_finalize_batch)."""
    if isinstance(grays, (list, tuple)):
        chunk = torch.stack([torch.as_tensor(g) for g in grays])
    else:
        chunk = torch.as_tensor(grays)
    if chunk.dim() == 2:
        chunk = chunk[None]
    if chunk.dtype not in (torch.uint8, torch.float32):
        chunk = chunk.float()
    if equalize and chunk.dtype != torch.uint8:
        raise ValueError("CLAHE needs uint8 input")
    per_octave, n_octaves = _octave_plan(*chunk.shape[-2:], max_features,
                                         upsample)
    if chunk.dtype == torch.float32:
        chunk = chunk / 255.0
    if equalize:
        chunk = clahe(chunk)
    return _detect_batch(chunk, per_octave, n_octaves, upsample=upsample,
                         out_slots=int(max_features))


def detect_finalize_batch(outs):
    """A detect_dispatch result → [(kp (n, 2), meta (n, 4), desc (n, 128)
    f32), ...] numpy arrays, one tuple per frame, valid slots only."""
    kp, meta, desc, valid = (t.cpu().numpy() for t in outs)
    return [(kp[b][valid[b]], meta[b][valid[b]],
             desc[b][valid[b]].astype(np.float32))
            for b in range(kp.shape[0])]


def detect_and_compute_batch(grays, max_features=4096, max_chunk=None,
                             upsample=True):
    """Batched detection of (B, H, W) uint8/float frames (a tensor on the
    device to run on, or a numpy array, which runs on the CPU), max_chunk
    frames per dispatch. Returns numpy (kp, meta, desc f32, valid), padded
    to max_features slots per frame."""
    imgs = torch.as_tensor(grays)
    if imgs.dim() == 2:
        imgs = imgs[None]
    step = max_chunk or len(imgs)
    outs = [detect_dispatch(imgs[s:s + step], max_features, upsample)
            for s in range(0, len(imgs), step)]
    kp, meta, desc, valid = (torch.cat([o[i] for o in outs]).cpu().numpy()
                             for i in range(4))
    return kp, meta, desc.astype(np.float32), valid

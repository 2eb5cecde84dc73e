"""Neighbourhood histogram matching for seamless mosaics (``--histogram``).

Port of ``imageanalysis_tpu/render/histogram.py``: per-image BGR
histograms (the frame decoded with ``io/jpeg.decode_bgr``, scaled by
``resize_linear`` at cv2's fx = fy = 0.25, one ``torch.bincount`` a
channel, on the frame's device); for each image a template = the
1/distance-weighted mean of its neighbours' histograms within 40 m (itself
at 10% of the neighbour mass), as quantiles; a texture is remapped onto
its template by a per-channel lookup table at load. The pickle the
explorer reads is the reference's: numpy float32 histograms and float64
quantiles.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..io import jpeg
from .build_map import _cv_size


def image_histogram_rgb(proj, image, scale=0.25, device="cuda"):
    """(b, g, r) 256-bin float32 numpy histograms of the image scaled by
    scale, computed on device."""
    bgr = jpeg.decode_bgr(proj.image_path(image), device)
    if bgr.dim() == 2:
        bgr = bgr[..., None].expand(-1, -1, 3)
    h, w = bgr.shape[:2]
    scaled = jpeg.resize_linear(bgr, _cv_size(w, h, scale, scale),
                                (scale, scale))
    return tuple(torch.bincount(scaled[..., c].reshape(-1).long(),
                                minlength=256).float().cpu().numpy()
                 for c in range(3))


def make_histograms(proj, image_list=None, device="cuda"):
    image_list = image_list if image_list is not None else proj.image_list
    return {im.name: image_histogram_rgb(proj, im, device=device)
            for im in image_list}


def make_templates(proj, histograms, dist_cutoff=40.0, self_weight=0.1):
    """Per-image quantile templates (host numpy)."""
    image_list = [im for im in proj.image_list if im.name in histograms]
    poses = np.array([im.get_camera_pose()[0] for im in image_list])
    templates = {}
    for i, i1 in enumerate(image_list):
        acc = None
        wsum = 0.0
        d = np.linalg.norm(poses - poses[i], axis=1)
        for j, i2 in enumerate(image_list):
            if i == j or d[j] > dist_cutoff:
                continue
            w = 1.0 if d[j] <= 1 else 1.0 / d[j]
            h = histograms[i2.name]
            acc = ([c * w for c in h] if acc is None
                   else [a + c * w for a, c in zip(acc, h)])
            wsum += w
        w = self_weight * wsum if wsum > 0 else 1.0
        h = histograms[i1.name]
        acc = ([c * w for c in h] if acc is None
               else [a + c * w for a, c in zip(acc, h)])
        wsum += w
        quants = []
        for c in acc:
            q = np.cumsum(c / wsum)
            quants.append(q / q[-1])
        templates[i1.name] = tuple(quants)
    return templates


def match_to_template(img_bgr, own_hists, template_quants):
    """Quantile-map each channel of an (H, W, 3) uint8 tensor onto the
    template: a 256-entry table a channel (host numpy), gathered on the
    image's device."""
    out = img_bgr.clone()
    for ch in range(3):
        own_q = np.cumsum(own_hists[ch])
        own_q = own_q / own_q[-1]
        lut = np.searchsorted(template_quants[ch], own_q).clip(0, 255)
        lut = torch.from_numpy(lut.astype(np.uint8)).to(img_bgr.device)
        out[..., ch] = lut[img_bgr[..., ch].long()]
    return out


def save(analysis_dir, histograms, templates):
    with open(os.path.join(analysis_dir, "histogram.pickle"), "wb") as f:
        pickle.dump({"histograms": histograms, "templates": templates}, f)


def load(analysis_dir):
    path = os.path.join(analysis_dir, "histogram.pickle")
    if not os.path.isfile(path):
        return None, None
    with open(path, "rb") as f:
        d = pickle.load(f)
    return d["histograms"], d["templates"]

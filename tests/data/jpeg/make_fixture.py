"""Write the JPEG fixture of tests/test_torch_cuda.py's nvJPEG tests.

    python tests/data/jpeg/make_fixture.py

colour.jpg: a 402×298 BGR image (smooth colour fields plus blurred noise)
written by cv2.imwrite at quality 95 (4:2:0 chroma, cv2's default).
gray.jpg: a 401×299 single-channel image written by PIL at quality 95.
gray.npz: for each, PIL's luma decode at full size (draft("L") at the
image's own size, the Y plane libjpeg decodes) as "<name>_1.0", and the
reference's detection load at scale 0.4 (features/detect.py
load_scaled_gray without CLAHE: PIL draft("L") at 1/2, then cv2.resize) as
"<name>_0.4". Needs numpy, cv2 and PIL; seeded, so a rerun writes the
same pixels.
"""

import os

import cv2
import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))


def texture(rng, h, w, channels):
    y, x = np.mgrid[0:h, 0:w] / max(h, w)
    noise = cv2.GaussianBlur(rng.uniform(0, 255, (h, w, channels)),
                             (0, 0), 1.5).reshape(h, w, channels)
    base = np.stack([128 + 100 * np.sin(6 * x + 2 * c) * np.cos(4 * y - c)
                     for c in range(channels)], axis=-1)
    return np.clip(0.6 * base + 0.4 * noise, 0, 255).astype(np.uint8)


def scaled_gray(path, scale):
    with Image.open(path) as im:
        full = im.size
        im.draft("L", (im.width // 2, im.height // 2))
        gray = np.asarray(im.convert("L"))
    fx = scale * full[0] / gray.shape[1]
    fy = scale * full[1] / gray.shape[0]
    return cv2.resize(gray, (0, 0), fx=fx, fy=fy)


def full_gray(path):
    with Image.open(path) as im:
        im.draft("L", im.size)
        return np.asarray(im.convert("L"))


def main():
    rng = np.random.default_rng(7)
    colour = os.path.join(HERE, "colour.jpg")
    gray = os.path.join(HERE, "gray.jpg")
    cv2.imwrite(colour, texture(rng, 298, 402, 3),
                [cv2.IMWRITE_JPEG_QUALITY, 95])
    Image.fromarray(texture(rng, 299, 401, 1)[..., 0]).save(gray, quality=95)
    arrays = {}
    for name, path in (("colour", colour), ("gray", gray)):
        arrays[f"{name}_1.0"] = full_gray(path)
        arrays[f"{name}_0.4"] = scaled_gray(path, 0.4)
    np.savez_compressed(os.path.join(HERE, "gray.npz"), **arrays)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Writes the seeded JPEG fixtures of ``tools/fixtures/jpeg/``.

    python3 tools/make_jpeg_fixtures.py

``chip_smoke.py``'s data_pipeline phase decodes them over and over (the
machine it runs on has no PIL to write JPEGs, and writes its PNGs with the
standard library's zlib). Eight images of ImageNet-like sizes (256-500
pixels a side), smooth seeded colour fields with a few blobs, so that each
file stays a few KB at quality 75; two of them grayscale. Needs numpy and
PIL.
"""

import os

import numpy as np
from PIL import Image

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                   "jpeg")
SIZES = ((375, 500), (500, 333), (256, 256), (480, 360), (300, 450),
         (333, 500), (400, 400), (256, 384))


def field(rng, h, w):
    """A smooth RGB field in [0, 255]: low-frequency sinusoids plus a few
    Gaussian blobs."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    for c in range(3):
        fy, fx = rng.uniform(0.5, 3.0, 2) * np.pi / np.array([h, w])
        ph = rng.uniform(0, 2 * np.pi, 2)
        img[..., c] = 128 + 60 * np.sin(yy * fy + ph[0]) * np.cos(
            xx * fx + ph[1])
    for _ in range(4):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        r = rng.uniform(20, 80)
        amp = rng.uniform(-90, 90, 3)
        g = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
        img += g[..., None] * amp
    return np.clip(img, 0, 255).astype(np.uint8)


def main():
    os.makedirs(OUT, exist_ok=True)
    rng = np.random.default_rng(12345)
    for i, (h, w) in enumerate(SIZES):
        img = Image.fromarray(field(rng, h, w))
        if i in (2, 6):
            img = img.convert("L")
        img.save(os.path.join(OUT, f"fixture_{i}.jpg"), "JPEG", quality=75)


if __name__ == "__main__":
    main()

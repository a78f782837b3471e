"""Writing display images (counterpart of `io/image.py::save_image` for
uint8 pixels): binary PPM with numpy alone, PNG through Pillow; and the
ASCII preview of `io/image.py::to_ascii`. The port keeps its own copy: it
imports nothing of the JAX package."""
from __future__ import annotations

import os

import numpy as np


def save_image(path: str, pixels: np.ndarray) -> None:
    """Save uint8 RGB(A) pixels [H, W, C] as .ppm (RGB) or, through Pillow,
    any format it writes by extension."""
    pixels = np.asarray(pixels)
    if pixels.dtype != np.uint8:
        raise TypeError(f"save_image takes uint8 pixels, got {pixels.dtype} "
                        f"(film.make_color encodes a film)")
    if os.path.splitext(path)[1].lower() == ".ppm":
        h, w = pixels.shape[:2]
        with open(path, "wb") as f:
            f.write(b"P6\n%d %d\n255\n" % (w, h))
            f.write(np.ascontiguousarray(pixels[..., :3]).tobytes())
        return
    from PIL import Image
    Image.fromarray(pixels).save(path)


ASCII_RAMP = " .:-=+*#%@"


def to_ascii(rgb: np.ndarray, width: int = 96) -> str:
    """Luminance-mapped ASCII art of an image (uint8, or float in [0, 1]),
    `width` characters wide."""
    img = np.asarray(rgb, np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    h, w = img.shape[:2]
    ch = max(1, int(round(width * h / w * 0.5)))
    ys = np.linspace(0, h - 1, ch).astype(int)
    xs = np.linspace(0, w - 1, width).astype(int)
    lum = img[..., :3] @ np.array([0.2126, 0.7152, 0.0722], np.float32)
    idx = np.clip((lum[np.ix_(ys, xs)] * (len(ASCII_RAMP) - 1)).round()
                  .astype(int), 0, len(ASCII_RAMP) - 1)
    return "\n".join("".join(ASCII_RAMP[v] for v in row) for row in idx)

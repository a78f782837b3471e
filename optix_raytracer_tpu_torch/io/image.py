"""Writing display images (counterpart of `io/image.py::save_image` for
uint8 pixels): binary PPM with numpy alone, PNG through Pillow. The port
keeps its own copy: it imports nothing of the JAX package."""
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

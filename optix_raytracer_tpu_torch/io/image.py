"""Image read / write and the ASCII preview (counterpart of `io/image.py`):
binary PPM with numpy alone, PNG through Pillow, float layers as EXR
(`io/exr.py`, the port's copy of the codec) or NPZ. The port keeps its own
copy: it imports nothing of the JAX package."""
from __future__ import annotations

import os

import numpy as np
import torch


def save_image(path: str, pixels: np.ndarray) -> None:
    """Save uint8 RGB(A) [H, W, C] or float [H, W, C] pixels, by extension
    (io/image.py:17-44): .exr and .npz keep float pixels raw; .ppm and
    .png take uint8, and float pixels are sRGB-encoded first (the port's
    `linear_to_srgb`, clipped, x 255.99999)."""
    pixels = np.asarray(pixels)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npz":
        np.savez_compressed(path, image=pixels.astype(np.float32))
        return
    if ext == ".exr":
        from .exr import write_exr
        write_exr(path, pixels.astype(np.float32))
        return
    if pixels.dtype != np.uint8:
        from ..core.film import linear_to_srgb
        srgb = linear_to_srgb(torch.as_tensor(pixels, dtype=torch.float32))
        pixels = (np.clip(srgb.numpy(), 0, 1) * 255.99999).astype(np.uint8)
    if ext == ".ppm":
        h, w = pixels.shape[:2]
        with open(path, "wb") as f:
            f.write(b"P6\n%d %d\n255\n" % (w, h))
            f.write(np.ascontiguousarray(pixels[..., :3]).tobytes())
        return
    from PIL import Image
    Image.fromarray(pixels).save(path)


def load_image(path: str) -> np.ndarray:
    """Load an image (io/image.py:47-60): float32 [H, W, C] from .exr and
    .npz, uint8 from .ppm and, through Pillow, anything else."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npz":
        with np.load(path) as z:
            return z["image"]
    if ext == ".exr":
        from .exr import read_exr
        return read_exr(path)
    if ext == ".ppm":
        return _load_ppm(path)
    from PIL import Image
    return np.asarray(Image.open(path))


def _load_ppm(path: str) -> np.ndarray:
    """Binary PPM (P6, maxval 255) with comments skipped."""
    with open(path, "rb") as f:
        data = f.read()
    tokens, i = [], 0
    while len(tokens) < 4:
        while i < len(data) and data[i:i + 1].isspace():
            i += 1
        if data[i:i + 1] == b"#":
            while i < len(data) and data[i:i + 1] != b"\n":
                i += 1
            continue
        j = i
        while j < len(data) and not data[j:j + 1].isspace():
            j += 1
        tokens.append(data[i:j])
        i = j
    if tokens[0] != b"P6":
        raise ValueError(f"{path}: only binary PPM (P6) is read")
    w, h = int(tokens[1]), int(tokens[2])
    i += 1  # the single whitespace after maxval
    return np.frombuffer(data, np.uint8, count=w * h * 3,
                         offset=i).reshape(h, w, 3)


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

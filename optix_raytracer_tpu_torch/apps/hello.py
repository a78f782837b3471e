"""The minimal bring-up path (counterpart of `apps/hello.py`, the
`optixHello` sample): one raygen program writing a solid colour into the
framebuffer (`draw_solid_color.cu:39`).

    python -m optix_raytracer_tpu_torch.apps.hello --file hello.ppm

The frame is one broadcast of the launch's colour and the sRGB encode
(`core/film.make_color`) on the device; it launches no kernel of the port.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..core import film
from ..io.image import save_image, to_ascii
from ._cli import parse_dim


def render(width=512, height=384, color=(0.462, 0.725, 0.0), device="cuda"):
    """The solid-colour frame → uint8 RGBA [H, W, 4] on `device`. The
    default colour is the reference's launch parameter (RGB 0.462, 0.725,
    0)."""
    c = torch.as_tensor(color, dtype=torch.float32, device=device)
    return film.make_color(c.expand(height, width, 3))


def main(argv=None):
    p = argparse.ArgumentParser(description="solid-color raygen (optixHello)")
    p.add_argument("--file", default="hello.png", help="output image path")
    p.add_argument("--dim", default="512x384", help="WxH")
    p.add_argument("--ascii", action="store_true", help="print ASCII preview")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    w, h = parse_dim(args.dim)
    t0 = time.perf_counter()
    img = render(w, h, device=torch.device(args.device)).cpu().numpy()
    dt = time.perf_counter() - t0
    save_image(args.file, img)
    if args.ascii:
        print(to_ascii(img))
    print(f"wrote {args.file} ({w}x{h}, {dt:.3f}s, on {args.device})")


if __name__ == "__main__":
    main()

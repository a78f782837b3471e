"""A fixed 96x64 headless render printed as ASCII art (counterpart of
`apps/console.py`, the `optixConsole` sample, `optixConsole.cpp:121-122,
686-760`): one deterministic launch of the Cornell box, its luminance
mapped to characters on standard output.

    python -m optix_raytracer_tpu_torch.apps.console --samples 4

The launch is `render_accumulate` with impl "auto": on a CUDA device the
fused path-trace kernel (kernel 3, `csrc/pt_fused.cu`), on the CPU its
plain version.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core import film as film_mod
from ..io.image import to_ascii
from ..scene.builtins import cornell_box, cornell_camera
from ..wavefront.engine import render_accumulate

WIDTH, HEIGHT = 96, 64


def render(samples=4, max_depth=3, device="cuda"):
    """The Cornell box at 96x64 → linear radiance [64, 96, 3] (numpy)."""
    scene = cornell_box(device)
    cam = cornell_camera(WIDTH, HEIGHT).params(device)
    film = film_mod.Film.create(HEIGHT, WIDTH, device)
    film, _ = render_accumulate(scene, cam, film, WIDTH, HEIGHT,
                                samples_per_launch=samples,
                                max_depth=max_depth, chunk_size=None)
    return film.accum.cpu().numpy()


def ascii_art(img) -> str:
    """The sample's luminance scale: the 97th percentile maps to white."""
    img = img / max(float(np.percentile(img, 97)), 1e-6)
    return to_ascii(np.clip(img, 0, 1), width=WIDTH)


def main(argv=None):
    p = argparse.ArgumentParser(description="headless ASCII render "
                                            "(optixConsole)")
    p.add_argument("--samples", type=int, default=4)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    print(ascii_art(render(samples=args.samples,
                           device=torch.device(args.device))))


if __name__ == "__main__":
    main()

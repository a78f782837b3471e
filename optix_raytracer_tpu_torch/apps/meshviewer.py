"""The mesh viewer (counterpart of `apps/meshviewer.py`): a host Scene
framed by its bounding box, lit by a headlight rig (a directional light from
the eye toward the look-at point and an ambient light) and rendered
progressively by the Whitted integrator.

    python -m optix_raytracer_tpu_torch.apps.meshviewer --knot 200x63 \\
        --file knot.ppm --dim 768x768 --samples 8

`--model` loads a model through `Scene.load`, which is not ported yet
(ROADMAP.md Queue 1 item 13) and raises; so does `--animate`, which poses a
glTF model. `--knot SEGMENTSxSIDES` renders the trefoil-knot scene instead
(`builtins.knot_host_scene`; 200x63 is the 25,202-triangle knot). Past 512
triangles the scene has a cluster table, and on a CUDA device its queries run
kernels 4-6 (kernels 7-8 for any-hit under ORT_QWALK=1).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core import film as film_mod
from ..io.image import save_image, to_ascii
from ..scene.builtins import knot_host_scene
from ..scene.scene import Scene
from ..shade.lights import AMBIENT, DIRECTIONAL
from ..wavefront.whitted import render_whitted
from ._cli import parse_dim


def headlight_rig(cam):
    """The meshviewer's lights for camera `cam`: a directional light of
    color 0.9 from the eye toward the look-at point and an ambient 0.25."""
    direction = np.asarray(cam.lookat) - np.asarray(cam.eye)
    direction = direction / max(np.linalg.norm(direction), 1e-9)
    return [{"kind": DIRECTIONAL, "direction": tuple(direction),
             "color": (0.9, 0.9, 0.9)},
            {"kind": AMBIENT, "color": (0.25, 0.25, 0.25)}]


def render(path, width=768, height=768, samples=4, max_depth=3, scene=None,
           device="cuda"):
    """Render the model at `path` (or the host Scene `scene`) on `device`
    → (linear radiance [H, W, 3], Film, rays_traced)."""
    scene_h = scene if scene is not None else Scene.load(path)
    cam_obj = scene_h.default_camera(width, height)
    device_scene = scene_h.finalize(device, lights=headlight_rig(cam_obj))
    film, rays = render_whitted(device_scene,
                                cam_obj.params(device_scene.device), width,
                                height, samples, max_depth=max_depth)
    return film.accum, film, rays


def main(argv=None):
    p = argparse.ArgumentParser(description="mesh viewer")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--model", "-m", help=".gltf/.glb/.obj/.ply path")
    src.add_argument("--knot", metavar="SEGMENTSxSIDES",
                     help="render the trefoil-knot scene instead")
    p.add_argument("--file", default="meshviewer.png")
    p.add_argument("--dim", default="768x768")
    p.add_argument("--samples", type=int, default=8)
    p.add_argument("--depth", type=int, default=3)
    p.add_argument("--ascii", action="store_true")
    p.add_argument("--animate", type=int, default=0, metavar="N",
                   help="render N frames of a glTF model's animation")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    w, h = parse_dim(args.dim)
    if args.animate > 0:
        raise NotImplementedError("--animate poses a glTF model, and the "
                                  "loaders are not ported yet (ROADMAP.md "
                                  "Queue 1 item 13)")
    scene = None
    if args.knot:
        segments, sides = (int(x) for x in args.knot.lower().split("x"))
        scene = knot_host_scene(segments, sides)
    device = torch.device(args.device)
    t0 = time.perf_counter()
    accum, film, rays = render(args.model, w, h, samples=args.samples,
                               max_depth=args.depth, scene=scene,
                               device=device)
    img = film_mod.make_color(accum).cpu().numpy()   # synchronises
    dt = time.perf_counter() - t0
    save_image(args.file, img)
    if args.ascii:
        print(to_ascii(img))
    print(f"wrote {args.file} ({w}x{h}, {int(film.subframe)} spp, "
          f"{dt:.2f}s, {int(rays) / dt / 1e6:.2f} Mrays/s, on {device})")


if __name__ == "__main__":
    main()

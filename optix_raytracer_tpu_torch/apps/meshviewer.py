"""The mesh viewer (counterpart of `apps/meshviewer.py`): a host Scene
(its glTF camera, else framed by its bounding box), lit by a headlight rig
(a directional light from the eye toward the look-at point and an ambient
light) and rendered progressively by the Whitted integrator.

    python -m optix_raytracer_tpu_torch.apps.meshviewer --model model.glb \
        --file model.ppm --dim 768x768 --samples 8
    python -m optix_raytracer_tpu_torch.apps.meshviewer --model model.glb \
        --animate 24 --fps 24 --file frame.ppm      # frame_000.ppm ...
    python -m optix_raytracer_tpu_torch.apps.meshviewer --knot 200x63 \
        --file knot.ppm

`--model` loads a .gltf / .glb / .obj / .ply through `Scene.load`; `--time T`
poses a glTF model's animations, skins and morph targets at T seconds, and
`--animate N` renders N frames over the animation's duration (at `--fps`
when it has none), as `apps/meshviewer.py:51-85`. `--knot SEGMENTSxSIDES`
renders the trefoil-knot scene instead (`builtins.knot_host_scene`; 200x63
is the 25,202-triangle knot). Past 512 triangles the scene has a cluster
table, and on a CUDA device its queries run kernels 4-6 (kernels 7-8 for
any-hit under ORT_QWALK=1); below it kernels 1-2.
"""
from __future__ import annotations

import argparse
import os
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


def render_animation(path, frames, out, width=768, height=768, samples=8,
                     max_depth=3, fps=24.0, device="cuda"):
    """`frames` frames of the glTF model at `path`, evenly over its longest
    animation (at `fps` when it has none), each written to
    <stem>_<frame:03d><ext> of `out` → (paths, duration in seconds)."""
    from ..scene.gltf import load_gltf
    g = load_gltf(path)
    dur = max((a.duration for a in g.animations), default=0.0)
    stem, ext = os.path.splitext(out)
    paths = []
    for f in range(frames):
        t = (f / fps if dur == 0.0 else dur * f / max(frames - 1, 1))
        accum, _, _ = render(path, width, height, samples=samples,
                             max_depth=max_depth,
                             scene=Scene.load(path, time=t), device=device)
        paths.append(f"{stem}_{f:03d}{ext}")
        save_image(paths[-1], film_mod.make_color(accum).cpu().numpy())
    return paths, dur


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
    p.add_argument("--time", type=float, default=None,
                   help="pose glTF animations and skins at this second")
    p.add_argument("--animate", type=int, default=0, metavar="N",
                   help="render N frames over the animation's duration "
                        "(writes <stem>_000<ext> ...)")
    p.add_argument("--fps", type=float, default=24.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    w, h = parse_dim(args.dim)
    device = torch.device(args.device)
    if args.animate > 0:
        if not args.model:
            p.error("--animate needs --model")
        t0 = time.perf_counter()
        paths, dur = render_animation(args.model, args.animate, args.file,
                                      w, h, samples=args.samples,
                                      max_depth=args.depth, fps=args.fps,
                                      device=device)
        dt = time.perf_counter() - t0
        stem, ext = os.path.splitext(args.file)
        print(f"wrote {len(paths)} frames to {stem}_***{ext} (duration "
              f"{dur:.2f}s, {dt:.2f}s, on {device})")
        return
    if args.knot:
        segments, sides = (int(x) for x in args.knot.lower().split("x"))
        scene = knot_host_scene(segments, sides)
    else:
        scene = Scene.load(args.model, time=args.time)
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

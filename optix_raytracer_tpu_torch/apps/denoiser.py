"""The standalone denoiser (counterpart of `apps/denoiser.py`,
`optixDenoiser`).

    python -m optix_raytracer_tpu_torch.apps.denoiser beauty.exr \\
        -a albedo.exr -n normal.exr -o denoised.exr

Beauty (and albedo, normal, flow, AOV and flow-trust layers) in, the
denoised image out, in the HDR, LDR, AOV, temporal, upscale and tiled
modes. `--Frames first-last` runs a sequence: the first run of '+' in a
file name takes the zero-padded frame number, and each frame's output is
the next frame's history. `-z` only applies the flow to the input; `-e`
sets the output's exposure in stops. Float layers travel as .exr (the
port's codec) or .npz; .png and .ppm inputs are read as [0, 1]. Runs on
`--device` (the card by default).
"""
from __future__ import annotations

import argparse
import os
import re

import numpy as np
import torch

from ..api.denoiser import Denoiser, ModelKind
from ..io.image import load_image, save_image


def frame_filename(name: str, frame: int) -> str:
    """The first run of '+' → the zero-padded frame number; a negative
    frame or no '+' leaves the name unchanged (apps/denoiser.py:22-35)."""
    if frame < 0:
        return name
    m = re.search(r"\++", name)
    if m is None:
        return name
    width = m.end() - m.start()
    fn = str(frame)
    if len(fn) > width:
        raise ValueError(
            f"frame number {frame} needs {len(fn)} digits but the '+' "
            f"placeholder in {name!r} is {width} wide")
    return name[:m.start()] + fn.zfill(width) + name[m.end():]


def load_layer(path, device):
    """An image's first three channels as float32 on `device`; uint8
    images are scaled to [0, 1]. None stays None."""
    if path is None:
        return None
    r = load_image(path)
    a = np.asarray(r, np.float32)[..., :3]
    if r.dtype == np.uint8:
        a = a / 255.0
    return torch.as_tensor(a, device=device)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="standalone denoiser (optixDenoiser)")
    p.add_argument("input", help="noisy beauty image (.exr/.npz float or "
                                 ".png); '+' run = frame placeholder")
    p.add_argument("-o", "--out", default="denoised.exr")
    p.add_argument("-a", "--albedo", default=None)
    p.add_argument("-n", "--normal", default=None)
    p.add_argument("-F", "--flow", default=None, help="flow layer (temporal)")
    p.add_argument("-p", "--prev", default=None,
                   help="previous output (temporal)")
    p.add_argument("-A", "--AOV", action="append", default=[],
                   dest="aovs", help="AOV layer to co-denoise (repeatable)")
    p.add_argument("-S", action="append", default=[], dest="spec_aovs",
                   help="specular AOV layer (co-denoised like -A)")
    p.add_argument("-T", default=None, dest="flow_trust",
                   help="flowTrustworthiness layer (temporal confidence)")
    p.add_argument("--Frames", default=None, metavar="FIRST-LAST",
                   help="frame sequence: '+' runs in filenames take the "
                        "frame number; each frame's output feeds the next "
                        "as temporal history")
    p.add_argument("-e", "--exposure", type=float, default=0.0,
                   help="stops of exposure applied to the output")
    p.add_argument("-z", action="store_true", dest="flow_only",
                   help="apply flow to the input (no denoising) and write")
    p.add_argument("-t", "--tile", type=int, default=0,
                   help="tile size (0=off)")
    p.add_argument("-b", "--blend", type=float, default=0.0)
    p.add_argument("-i", "--iterations", type=int, default=5)
    p.add_argument("--ldr", action="store_true")
    p.add_argument("--upscale", action="store_true", help="2x upscale model")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)

    if args.Frames:
        first, last = (int(x) for x in args.Frames.split("-"))
        frames = list(range(first, last + 1))
        if len(frames) > 1 and re.search(r"\++", args.out) is None:
            raise SystemExit(
                f"--Frames {args.Frames} with -o {args.out!r}: the output "
                "name needs a '+' frame placeholder, or every frame would "
                "overwrite the same file")
    else:
        frames = [-1]

    def layer(path, frame):
        return load_layer(None if path is None
                          else frame_filename(path, frame), device)

    gain = np.float32(2.0 ** args.exposure)
    prev = layer(args.prev, frames[0])
    for frame in frames:
        beauty = layer(args.input, frame)
        albedo = layer(args.albedo, frame)
        normal = layer(args.normal, frame)
        fl = (None if args.flow is None else torch.as_tensor(
            np.asarray(load_image(frame_filename(args.flow, frame)),
                       np.float32), device=device))
        aov_imgs = {path: layer(path, frame)
                    for path in args.aovs + args.spec_aovs}
        trust = layer(args.flow_trust, frame)

        if args.flow_only:
            from ..denoise.atrous import warp_by_flow
            if fl is None:
                fl = torch.zeros(beauty.shape[:2] + (2,),
                                 dtype=torch.float32, device=device)
            out = warp_by_flow(beauty, fl)
            kind = "FLOW_APPLY"
        else:
            temporal = prev is not None
            if args.upscale:
                kind = (ModelKind.TEMPORAL_UPSCALE2X if temporal
                        else ModelKind.UPSCALE2X)
            elif aov_imgs:
                kind = (ModelKind.TEMPORAL_AOV if temporal
                        else ModelKind.AOV)
            elif temporal:
                kind = ModelKind.TEMPORAL
            else:
                kind = ModelKind.LDR if args.ldr else ModelKind.HDR
            den = Denoiser(model_kind=kind, guide_albedo=albedo is not None,
                           guide_normal=normal is not None, device=device)
            den.setup(beauty.shape[1], beauty.shape[0], tiled=args.tile > 0,
                      tile=args.tile or 256, iterations=args.iterations)
            res = den.invoke(beauty, albedo=albedo, normal=normal, flow=fl,
                             previous_output=prev, blend_factor=args.blend,
                             aovs=aov_imgs or None, flow_trust=trust)
            den_aovs = {}
            if isinstance(res, tuple):
                res, den_aovs = res
            out = res
            prev = out                    # the next frame's history
            n_aov = len(args.aovs) + len(args.spec_aovs)
            for idx, img in enumerate(den_aovs.values()):
                d, base = os.path.split(args.out)
                tag = "aov" if n_aov == 1 else f"aov{idx}"
                save_image(frame_filename(os.path.join(d, f"{tag}_{base}"),
                                          frame),
                           img.cpu().numpy() * gain)

        out = out.cpu().numpy()
        out_name = frame_filename(args.out, frame)
        save_image(out_name, out * gain)
        print(f"wrote {out_name} {out.shape} ({kind})")


if __name__ == "__main__":
    main()

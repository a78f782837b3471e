"""The standalone optical-flow CLI (counterpart of
`apps/optical_flow.py`, `optixOpticalFlow`).

    python -m optix_raytracer_tpu_torch.apps.optical_flow a.exr b.exr \\
        -o flow.exr

Two frames (or a '+'-placeholder sequence, `--Frames first-last`) in, the
flow from frame N to frame N+1 out, as a 3-channel float image with x and
y in the first two channels and the third zero (the reference's image
buffer has no 2-channel format). The flow is the block matcher of
`denoise/flow.py`, run on `--device` (the card by default).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..io.image import save_image
from .denoiser import frame_filename, load_layer


def flow_image(frame_a, frame_b, levels, radius):
    """Flow from frame_a to frame_b as a host [H, W, 3] (x, y, 0)."""
    from ..denoise.flow import optical_flow
    fl = optical_flow(frame_a, frame_b, levels=levels,
                      radius=radius).cpu().numpy()
    out = np.zeros(fl.shape[:2] + (3,), np.float32)
    out[..., :2] = fl
    return out


def main(argv=None):
    p = argparse.ArgumentParser(
        description="optical flow between two frames (optixOpticalFlow)")
    p.add_argument("frame1", help="first frame (.exr/.npz float or .png); "
                                  "'+' run = frame-number placeholder")
    p.add_argument("frame2", nargs="?", default=None,
                   help="second frame (omitted in --Frames mode: frame N+1 "
                        "comes from frame1's placeholder)")
    p.add_argument("-o", "--out", default="flow.exr",
                   help="flow output (channels: x, y, 0)")
    p.add_argument("-F", "--Frames", default=None, metavar="FIRST-LAST",
                   help="frame sequence: flow is computed between each "
                        "consecutive pair; output filenames take the "
                        "FIRST frame number of the pair")
    p.add_argument("--levels", type=int, default=4,
                   help="pyramid levels (search range ~ radius*(2^levels-1))")
    p.add_argument("--radius", type=int, default=2,
                   help="per-level search radius in pixels")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)

    if args.Frames:
        first, last = (int(x) for x in args.Frames.split("-"))
        if not 0 <= first < last:
            raise SystemExit("error: --Frames wants FIRST-LAST with "
                             "0 <= first < last")
        prev = load_layer(frame_filename(args.frame1, first), device)
        print(f"Optical flow with resolution {prev.shape[1]} x "
              f"{prev.shape[0]}")
        for frame in range(first, last):
            nxt = load_layer(frame_filename(args.frame2 or args.frame1,
                                            frame + 1), device)
            path = frame_filename(args.out, frame)
            save_image(path, flow_image(prev, nxt, args.levels, args.radius))
            print(f"wrote {path}")
            prev = nxt
        return

    if args.frame2 is None:
        raise SystemExit("error: need two frames (or --Frames)")
    a = load_layer(args.frame1, device)
    b = load_layer(args.frame2, device)
    if a.shape != b.shape:
        raise SystemExit(f"error: frame sizes differ: {tuple(a.shape[:2])} "
                         f"vs {tuple(b.shape[:2])}")
    print(f"Optical flow with resolution {a.shape[1]} x {a.shape[0]}")
    save_image(args.out, flow_image(a, b, args.levels, args.radius))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()

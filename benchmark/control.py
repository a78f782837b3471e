"""The check's control: the plain reference put in the program's place and
computed in bfloat16, the precision below the configurations' float32.

For each seed it draws a run's cameras and pixels, works the launches out in
float32 (the reference) and in bfloat16 (the control), and reads the numbers
`check.py` compares, the control's ray total being its own stratified
estimate. The control has to come out not correct: its numbers set the upper
readings of the limits in `limits/<workload>.json`.

    python3 -m benchmark.control --workload cornell-progressive \\
        --launches 2600 --seeds 11 12 13

--launches: as many launches as a run of `run_seconds` makes in the cell.
Runs on the card (CUDA required); `control_numbers` takes any device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import check, scenes, spec as spec_mod
from .traffic import CameraPath, pixels


def control_numbers(root, workload, seed, launches, device):
    """The compared numbers of the bfloat16 control against the float32
    reference, for `launches` launches of a run of `workload` with `seed`."""
    cell = spec_mod.Cell(Path(root), spec_mod.load(root), workload)
    config, traffic = cell.config, cell.traffic
    w, h = config["width"], config["height"]
    path = CameraPath(config["camera"], traffic["orbit"], seed)
    eyes = [path.eye(k) for k in range(launches)]
    sets = traffic["pixel_sets"]
    px, py, area = pixels(w, h, cell.limits["check_pixels"], seed, sets)
    rows = np.arange(launches) % sets
    arrays = scenes.build(config["scene"])
    ref_films, ref_rays = check.reference_films(
        arrays, config, traffic, eyes, px[rows], py[rows], device)
    ctl_films, ctl_rays = check.reference_films(
        arrays, config, traffic, eyes, px[rows], py[rows], device,
        dtype=torch.bfloat16)
    ctl_total = float((ctl_rays * area[rows]).sum())
    return check.numbers(ctl_films, ref_films, ctl_total, ref_rays,
                         area[rows])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--launches", type=int, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent.parent
    for seed in args.seeds:
        t0 = time.perf_counter()
        values = control_numbers(root, args.workload, seed, args.launches,
                                 torch.device("cuda", 0))
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              launches=args.launches,
                              seconds=time.perf_counter() - t0, **values)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

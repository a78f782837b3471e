"""The comparison that decides `correct`.

The window's films at the sampled pixels (one snapshot after every launch)
and its ray count are held to the plain reference (`reference/`), which works
out the same launches again from the scene arrays, the cameras and the
subframes handed to the port:

- `film_rel_l1`: sum |film - reference| / sum |reference| over every
  snapshot, pixel and channel;
- `rays_rel_gap`: |rays / estimate - 1|, where the estimate is the
  reference's rays at each launch's sampled pixels, each weighted by the
  pixels of its stratum.

A cell compares the numbers its `limits/<workload>.json` gives a limit. The
ray estimate spreads by up to a few percent from seed to seed; where that
is as wide as the control moves it (the Cornell cells), no limit could tell
the two apart, and the cell prints the gap without comparing it.
"""
from __future__ import annotations

import numpy as np
import torch

from .reference import pathtracer as ref

NUMBERS = ("film_rel_l1", "rays_rel_gap")


def reference_films(arrays, config, traffic, eyes, px, py, device,
                    dtype=torch.float32):
    """The reference's films after each launch at that launch's pixels
    (px, py [L, P]) → films [L, P, 3] (float64 numpy) and rays [L, P]
    (int64 numpy)."""
    cam = config["camera"]
    w, h = config["width"], config["height"]
    frames = [ref.camera_frame(e, cam["lookat"], cam["up"], cam["fov_y"],
                               w / h) for e in eyes]
    cameras = dict(eye=np.asarray(eyes, np.float32),
                   U=np.stack([f[0] for f in frames]),
                   V=np.stack([f[1] for f in frames]),
                   W=np.stack([f[2] for f in frames]))
    spl = traffic["samples_per_launch"]
    reset = traffic["film"] == "reset"
    subframes = [0 if reset else spl * k for k in range(len(eyes))]
    scene = ref.Scene(arrays, device, dtype)
    sums, rays = ref.render_pixels(scene, cameras, px, py, w, h, subframes,
                                   spl, config["max_depth"])
    films = ref.merge_films(sums, subframes, spl, reset)
    return (films.to(torch.float64).numpy(),
            rays.cpu().numpy().astype(np.int64))


def numbers(films, ref_films, rays_total, ref_rays, area) -> dict:
    """The numbers a cell may compare, from the program's
    films [L, P, 3], its total rays, the reference's films and rays [L, P]
    and each sampled pixel's stratum [L, P]."""
    films = np.asarray(films, np.float64)
    ref_films = np.asarray(ref_films, np.float64)
    denom = np.abs(ref_films).sum()
    l1 = float(np.abs(films - ref_films).sum() / denom) if denom > 0 else (
        0.0 if np.abs(films).sum() == 0 else float("inf"))
    if not np.isfinite(films).all():
        l1 = float("inf")
    estimate = float((np.asarray(ref_rays, np.float64)
                      * np.asarray(area, np.float64)).sum())
    gap = abs(float(rays_total) / estimate - 1.0) if estimate > 0 else float(
        "inf")
    return {"film_rel_l1": l1, "rays_rel_gap": gap}


def verdict(values: dict, limits: dict):
    """→ (correct, {name: {"value", "limit"}}): each number that has a limit
    at or under it, and finite."""
    out = {k: {"value": values[k], "limit": limits[k]} for k in NUMBERS
           if k in limits}
    ok = all(np.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in out.values())
    return bool(ok), out

"""The alpha-cutout path's configurations and probes, shared by
chip_smoke.py, tools/profile_torch_port.py and the tests: the frames the
cutout apps render by default, bench.py's six occlusion cells
(bench.py:477-580) with their ray sets, and the scenes they run on.
"""
from __future__ import annotations

import numpy as np
import torch

from ..apps import cutouts
from ..core.rays import Rays
from ..scene import builtins
from ..shade import materials
from ..wavefront import intersect

# apps/cutouts.py main()'s defaults: 768x768, 32 samples a launch; render()'s
# depth 4
CUTOUTS = dict(width=768, height=768, spl=32, depth=4)
# apps/opacity_micromap.py main()'s defaults: 512x512, 16 samples, level 3;
# render()'s depth 3
OMM = dict(width=512, height=512, spl=16, depth=3, level=3)
# the cutout grid's path trace: a cluster scene at 8 samples a launch goes
# sample-major (engine.render_accumulate)
GRID = dict(width=768, height=768, spl=8, depth=3)
# apps/displaced_micromesh.py main()'s defaults: 512x512, level 4, 4
# samples; render()'s depth 2
MICROMESH = dict(width=512, height=512, level=4, spl=4, depth=2)
# the textured Whitted scene at apps/whitted.py main()'s defaults
TEXTURED_WHITTED = dict(width=768, height=576, spl=16, depth=6)

# bench.py's occlusion sets: 2^21 shadow rays each
OCCLUSION_RAYS = 1 << 21
# bench.py's six cutout cells: key → (scene, query). "omm" is
# intersect._scene_any_alpha_omm, "loop" _scene_any_alpha (no micromaps),
# "scene_any" the dispatch (the micromap path on these scenes).
OCCLUSION_CELLS = {
    "cutout_anyhit_mrays": ("cutout_cornell", "omm"),
    "cutout_anyhit_noomm_mrays": ("cutout_cornell", "loop"),
    "opaque_alpha_anyhit_mrays": ("opaque_alpha", "omm"),
    "opaque_alpha_anyhit_noomm_mrays": ("opaque_alpha", "loop"),
    "cutout_cluster_anyhit_mrays": ("cutout_grid", "scene_any"),
    "cutout_cluster_noomm_mrays": ("cutout_grid", "loop"),
}
OCCLUSION_SCENES = {"cutout_cornell": cutouts.cutout_cornell,
                    "opaque_alpha": cutouts.opaque_alpha_cornell,
                    "cutout_grid": cutouts.cutout_grid}


def circle_grid(device):
    """The cutout grid with a circle hole in every quad (checker_scale 1):
    every grid triangle's summary is unknown, so the micromap loop runs
    kernel 1 on a 2,400-row table, past the 512 rows kernels 1-2 are tuned
    for."""
    parts = list(builtins.cutout_grid_parts())
    mats = [dict(m) for m in parts[3]]
    mats[1]["cutout"] = materials.CUT_CIRCLE
    parts[3] = mats
    return builtins.scene_from_parts(tuple(parts), device)


def occlusion_rays(scene_name, n, seed, device):
    """bench.py's shadow rays (bench.py:490-497, 565-570): origins uniform
    in [50, 500]³, or on the grids in [50, 450] x [50, 250] x [50, 450]
    (below the plane), unit directions from a normal draw, tmin 1e-2, tmax
    1e4."""
    rng = np.random.default_rng(seed)
    hi = ([450, 250, 450] if scene_name in ("cutout_grid", "circle_grid")
          else [500, 500, 500])
    o = rng.uniform([50, 50, 50], hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return Rays(origin=torch.as_tensor(o, device=device),
                direction=torch.as_tensor(d, device=device),
                tmin=torch.full((n,), 1e-2, device=device),
                tmax=torch.full((n,), 1e4, device=device))


def occlusion_query(scene, query, rays, chunk_size=65536):
    """One of OCCLUSION_CELLS' queries → bool [N]; chunk_size bounds the
    plain versions' [chunk, M] planes (the kernels take every ray)."""
    if query == "omm":
        return intersect._scene_any_alpha_omm(scene, rays, chunk_size)
    if query == "loop":
        return intersect._scene_any_alpha(scene, rays, chunk_size)
    return intersect.scene_any(scene, rays, chunk_size)

"""The (slice, rows, samples) mesh (counterpart of `multichip/multislice.py`).

The reference scales past one host with a third mesh axis, "slice": image
rows are split across slices, and no collective crosses that axis while
rendering. Here the rule holds by construction: the only render-time
collectives are the sample mean, over the (slice, row) band's sample
ranks, and the ray count, over the ranks of one slice (`Mesh.groups`
holds no other groups to render with). Pixels cross slices only when the
host gathers the frame (`tiles.gather_film`), and the slices' ray counts
meet in `total_rays`, called at the same time.
"""
from __future__ import annotations

from typing import Optional

from ..core.film import Film
# shard_film splits the rows over (slice, rows) jointly (multislice.py:
# 54-60): band slice * n_rows + row (tiles.band_index)
from .tiles import (ROWS_AXIS, SAMPLES_AXIS, SLICE_AXIS, Mesh,  # noqa: F401
                    _merge, _progressive, all_reduce, build_mesh,
                    sample_mean, shard_film)


def make_multislice_mesh(n_slices: int, n_rows: int, n_samples: int = 1,
                         ranks=None, device=None) -> Mesh:
    """A (slice, rows, samples) mesh (multislice.py:41-51) over `ranks`
    (default: the world's). Ranks run slice-major, so each contiguous run
    of n_rows * n_samples ranks is one slice: on several hosts, one host's
    ranks (`distributed.pod_mesh`)."""
    return build_mesh((SLICE_AXIS, ROWS_AXIS, SAMPLES_AXIS),
                      (n_slices, n_rows, n_samples), ranks=ranks,
                      device=device)


def render_accumulate_multislice(scene, cam_params, film: Film, mesh: Mesh,
                                 width: int, height: int,
                                 samples_per_launch: int = 1,
                                 max_depth: int = 4,
                                 chunk_size: Optional[int] = None):
    """One progressive launch over a (slice, rows, samples) mesh
    (multislice.py:63-116) → (this rank's film band, rays traced in this
    rank's slice). Band (slice, row) renders rows from (slice * n_rows +
    row) * tile_h; the sample mean is reduced inside the slice; no
    collective leaves the slice."""
    bands = mesh.shape[SLICE_AXIS] * mesh.shape[ROWS_AXIS]
    n_samp = mesh.shape[SAMPLES_AXIS]
    if height % bands:
        raise ValueError(f"height {height} does not split into {bands} bands")
    tile_h = height // bands
    c = mesh.coord
    y0 = (c[SLICE_AXIS] * mesh.shape[ROWS_AXIS] + c[ROWS_AXIS]) * tile_h
    local, rays = _progressive(
        scene, cam_params, width, tile_h, height,
        film.subframe + c[SAMPLES_AXIS], n_samp, samples_per_launch,
        max_depth, chunk_size, y0, 1, mesh.device)
    local = sample_mean(mesh, local)
    rays = all_reduce(mesh, rays, (ROWS_AXIS, SAMPLES_AXIS))
    return _merge(film, local, samples_per_launch * n_samp), rays


def total_rays(rays, mesh: Mesh):
    """The slices' ray counts (`render_accumulate_multislice`'s) summed over
    the slice axis: a collective across slices, so called with the frame's
    gather, not while rendering."""
    return all_reduce(mesh, rays, (SLICE_AXIS,))

"""Row and sample tiles over torch.distributed (counterpart of
`multichip/tiles.py`).

The reference drives N devices from one process through a
`jax.sharding.Mesh` and `shard_map`. Here one process is one rank, and a
rank is one cell of the mesh: it renders its own band of rows for its own
share of the subframes, and the ranks meet only in collectives.

- Row tiles: the rank at (row, samp) renders rows [row * tile_h, (row + 1)
  * tile_h) of the frame (`render_sample`'s y0, full_width, full_height).
  The RNG is seeded from the global pixel index and the subframe, so the
  tiled frame draws the single-process frame's paths
  (`WorkDistribution.h:60-81` semantics).
- Sample tiles: the ranks of one row band render subframes
  `subframe + i * n_samp + samp` and meet in one all_reduce over the
  band's sample group, the reference's `pmean`.
- The film stays sharded: each rank holds its band (`shard_film`), and
  `gather_film` assembles the frame only when the host asks for it.

`Mesh` holds the rank grid, this rank's coordinate and the process groups
of the mesh's sub-axes, built once by every rank of the world
(`dist.new_group` is collective over the world). Every collective the
layer runs is logged on the mesh as (op, axes, ranks), so a test can show
which ranks each one joined. With one process there is no process group
and every collective is a no-op.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.film import Film
from ..wavefront.engine import render_sample

ROWS_AXIS = "rows"
SAMPLES_AXIS = "samples"
SLICE_AXIS = "slice"


@dataclasses.dataclass(eq=False)
class Mesh:
    """A grid of ranks with named axes, seen from one rank.

    ranks: int array of global ranks shaped like the mesh; rank: this
    process's global rank; device: the device this rank renders on;
    groups: {axes: (ranks, process group)} for each sub-axis set the layer
    reduces over, this rank's group of ranks that share its coordinates on
    the other axes (group None where it holds one rank); log: (op, axes,
    ranks) of each collective run."""
    axis_names: tuple
    ranks: np.ndarray
    rank: int
    device: torch.device
    groups: dict
    log: list = dataclasses.field(default_factory=list)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    @property
    def coord(self) -> Optional[dict]:
        """This rank's index on each axis (None off the mesh)."""
        where = np.argwhere(self.ranks == self.rank)
        if len(where) == 0:
            return None
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def group_ranks(self, axes) -> tuple:
        return self.groups[tuple(axes)][0]


def _sub_axes(axis_names) -> list:
    """The axis sets the layer reduces or gathers over: each of samples,
    rows and slice alone, the island (every axis but the slice) and the
    whole mesh."""
    sets = [(SAMPLES_AXIS,), (ROWS_AXIS,), (SLICE_AXIS,),
            tuple(a for a in axis_names if a != SLICE_AXIS),
            tuple(axis_names)]
    out = []
    for s in sets:
        if all(a in axis_names for a in s) and s not in out:
            out.append(s)
    return out


def build_mesh(axis_names, sizes, ranks=None, device=None) -> Mesh:
    """A mesh of `sizes` over `ranks` (default: every rank of the world, in
    order). Every rank of the world must call this, in the same order as
    the others, whether or not it is on the mesh."""
    import torch.distributed as dist

    from . import distributed

    multi = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if multi else 1
    rank = dist.get_rank() if multi else 0
    ranks = list(range(world)) if ranks is None else list(ranks)
    need = int(np.prod(sizes))
    if need != len(ranks):
        raise ValueError(f"mesh {'x'.join(map(str, sizes))} needs {need} "
                         f"ranks, got {len(ranks)}")
    grid = np.asarray(ranks, np.int64).reshape(sizes)
    groups = {}
    for axes in _sub_axes(axis_names):
        keep = [i for i, a in enumerate(axis_names) if a in axes]
        other = [i for i in range(len(axis_names)) if i not in keep]
        # rows of `moved` are the groups: the other axes' coordinates fixed
        moved = np.transpose(grid, other + keep).reshape(
            -1, int(np.prod([sizes[i] for i in keep])))
        mine = (tuple(int(r) for r in moved[0]), None)
        for members in moved:
            members = tuple(int(r) for r in members)
            group = (dist.new_group(list(members))
                     if multi and len(members) > 1 else None)
            if rank in members:
                mine = (members, group)
        groups[axes] = mine
    dev = torch.device(device) if device is not None else (
        distributed.initialize().device)
    return Mesh(axis_names=tuple(axis_names), ranks=grid, rank=rank,
                device=dev, groups=groups)


def make_mesh(n_rows: Optional[int] = None, n_samples: int = 1, ranks=None,
              device=None) -> Mesh:
    """A (rows, samples) mesh (tiles.py:39-48) over `ranks` (default: the
    world's); n_rows defaults to the ranks // n_samples."""
    import torch.distributed as dist
    n = (len(ranks) if ranks is not None
         else dist.get_world_size() if dist.is_available()
         and dist.is_initialized() else 1)
    if n_rows is None:
        n_rows = n // n_samples
    return build_mesh((ROWS_AXIS, SAMPLES_AXIS), (n_rows, n_samples),
                      ranks=ranks, device=device)


# --- collectives ---------------------------------------------------------

def _backend(group):
    import torch.distributed as dist
    return dist.get_backend(group)


def all_reduce(mesh: Mesh, t: torch.Tensor, axes) -> torch.Tensor:
    """Sum of `t` over this rank's group on `axes` (in place; returned).
    gloo takes CUDA tensors for all_reduce, so nothing is staged."""
    import torch.distributed as dist
    members, group = mesh.groups[tuple(axes)]
    mesh.log.append(("all_reduce", tuple(axes), members))
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_gather(mesh: Mesh, t: torch.Tensor, axes) -> list:
    """`t` of every rank of this rank's group on `axes`, in the group's
    rank order. gloo's all_gather takes no CUDA tensor, so on gloo a CUDA
    tensor is staged through the host explicitly and the parts come back
    to its device; NCCL gathers on the card."""
    import torch.distributed as dist
    members, group = mesh.groups[tuple(axes)]
    mesh.log.append(("all_gather", tuple(axes), members))
    if group is None:
        return [t]
    staged = t.is_cuda and _backend(group) == "gloo"
    src = t.cpu() if staged else t.contiguous()
    parts = [torch.empty_like(src) for _ in members]
    dist.all_gather(parts, src, group=group)
    return [p.to(t.device) for p in parts] if staged else parts


def barrier(mesh: Mesh, axes=None):
    """Wait for every rank of this rank's group on `axes` (the mesh)."""
    import torch.distributed as dist
    axes = tuple(mesh.axis_names) if axes is None else tuple(axes)
    members, group = mesh.groups[axes]
    mesh.log.append(("barrier", axes, members))
    if group is not None:
        if _backend(group) == "nccl":
            dist.barrier(group=group, device_ids=[mesh.device.index])
        else:
            dist.barrier(group=group)


# --- the film ------------------------------------------------------------

def band_index(mesh: Mesh) -> int:
    """This rank's row band: its row, past n_rows bands per slice."""
    c = mesh.coord
    return c.get(SLICE_AXIS, 0) * mesh.shape[ROWS_AXIS] + c[ROWS_AXIS]


def n_bands(mesh: Mesh) -> int:
    return mesh.shape.get(SLICE_AXIS, 1) * mesh.shape[ROWS_AXIS]


def shard_film(film: Film, mesh: Mesh) -> Film:
    """This rank's band of the film's rows on the rank's device (tiles.py:
    108-113): rows [band * tile_h, (band + 1) * tile_h), the subframe
    count replicated. The interleaved layout keeps rank r's rows in band r
    (deinterleave_rows)."""
    h = film.accum.shape[0]
    bands = n_bands(mesh)
    if h % bands:
        raise ValueError(f"{h} rows do not split into {bands} bands")
    tile_h = h // bands
    b = band_index(mesh)
    return Film(accum=film.accum[b * tile_h:(b + 1) * tile_h].to(
                    mesh.device, copy=True),
                subframe=film.subframe.to(mesh.device, copy=True))


def gather_film(film: Film, mesh: Mesh) -> Film:
    """The whole frame on every rank of the mesh, in band order: the band
    of the first rank of each row band (its sample ranks hold the same
    band after the sample mean). The one collective that moves pixels."""
    parts = all_gather(mesh, film.accum, mesh.axis_names)
    members = mesh.group_ranks(mesh.axis_names)
    first = mesh.ranks.reshape(n_bands(mesh), -1)[:, 0]
    return Film(accum=torch.cat([parts[members.index(int(r))]
                                 for r in first]),
                subframe=film.subframe)


def _progressive(scene, cam_params, width, tile_h, height, first_sub,
                 step, count, max_depth, chunk_size, y0, y_stride, device):
    """`count` samples of one band, subframes first_sub + i * step, as a
    per-rank progressive mean (tiles.py:79-92) → (mean, rays)."""
    local = torch.zeros((tile_h, width, 3), dtype=torch.float32,
                        device=device)
    rays = torch.zeros((), dtype=torch.int64, device=device)
    for i in range(count):
        radiance, r = render_sample(
            scene, cam_params, width, tile_h, first_sub + i * step,
            max_depth=max_depth, chunk_size=chunk_size, y0=y0,
            y_stride=y_stride, full_width=width, full_height=height)
        # t = 1 / (i + 1) in f32, as the reference's int32 counter gives it
        t = float(np.float32(1.0) / np.float32(i + 1))
        local = local + (radiance - local) * t
        rays = rays + r
    return local, rays


def _merge(film: Film, local, new_n: int) -> Film:
    """(accum prev_n + local new_n) / (prev_n + new_n) (tiles.py:94-98)."""
    prev_n = film.subframe.to(torch.float32)
    accum = (film.accum * prev_n + local * float(new_n)) / (prev_n + new_n)
    return Film(accum=accum, subframe=film.subframe + new_n)


def sample_mean(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    """The reference's pmean over the samples axis: the band's sum over its
    sample ranks divided by their count (as a tensor: CUDA divides a tensor
    by a Python scalar through its reciprocal)."""
    n = mesh.shape[SAMPLES_AXIS]
    if n == 1:
        return local
    total = all_reduce(mesh, local.contiguous(), (SAMPLES_AXIS,))
    return total / torch.tensor(float(n), device=total.device)


def render_accumulate_sharded(scene, cam_params, film: Film, mesh: Mesh,
                              width: int, height: int,
                              samples_per_launch: int = 1,
                              max_depth: int = 4,
                              chunk_size: Optional[int] = None):
    """One progressive launch over a (rows, samples) mesh (tiles.py:51-105)
    → (this rank's film band, rays traced by all ranks). The rank at
    (row, samp) renders subframes subframe + i * n_samp + samp of its band
    for i < samples_per_launch and keeps their progressive mean; the band's
    sample ranks average in one all_reduce; the band merges with the prior
    state. The same samples as `samples_per_launch * n_samp` in one process
    (the same RNG streams). The ray count is summed over the mesh."""
    n_rows, n_samp = mesh.shape[ROWS_AXIS], mesh.shape[SAMPLES_AXIS]
    if height % n_rows:
        raise ValueError(f"height {height} does not split into {n_rows} rows")
    tile_h = height // n_rows
    c = mesh.coord
    local, rays = _progressive(
        scene, cam_params, width, tile_h, height,
        film.subframe + c[SAMPLES_AXIS], n_samp, samples_per_launch,
        max_depth, chunk_size, c[ROWS_AXIS] * tile_h, 1, mesh.device)
    local = sample_mean(mesh, local)
    rays = all_reduce(mesh, rays, mesh.axis_names)
    return _merge(film, local, samples_per_launch * n_samp), rays


def render_accumulate_interleaved(scene, cam_params, film: Film, mesh: Mesh,
                                  width: int, height: int,
                                  samples_per_launch: int = 1,
                                  max_depth: int = 4,
                                  chunk_size: Optional[int] = None):
    """Interleaved rows (tiles.py:116-171): the rank of row r owns rows r,
    r + D, r + 2D, ... (D the rows axis, `WorkDistribution.h:60-81`'s
    round robin), y0 = r with y_stride D; its band holds them in order and
    `deinterleave_rows` gives the display order. Sample ranks render the
    same subframes, as in the reference. → (film band, rays summed over
    the rows axis)."""
    n_rows = mesh.shape[ROWS_AXIS]
    if height % n_rows:
        raise ValueError(f"height {height} does not split into {n_rows} rows")
    tile_h = height // n_rows
    local, rays = _progressive(
        scene, cam_params, width, tile_h, height, film.subframe, 1,
        samples_per_launch, max_depth, chunk_size, mesh.coord[ROWS_AXIS],
        n_rows, mesh.device)
    rays = all_reduce(mesh, rays, (ROWS_AXIS,))
    return _merge(film, local, samples_per_launch), rays


def deinterleave_rows(accum, n_shards: int):
    """Interleaved [H, W, ...] (a tensor or an array; band r holds global
    rows r, r + D, ...) → display order: global row g is band g % D, local row g // D
    (tiles.py:174-182)."""
    h = accum.shape[0]
    tile_h = h // n_shards
    return (accum.reshape(n_shards, tile_h, *accum.shape[1:])
            .swapaxes(0, 1).reshape(accum.shape))

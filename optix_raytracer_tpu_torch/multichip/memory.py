"""Texture placement across ranks (counterpart of `multichip/memory.py`):
the optixNVLink policy.

The reference discovers P2P islands, keeps one texture copy per island
spread over its members, and samples it over the link
(`optixNVLink.cpp:1524-1569, 1698-1712`). Here an island is the ranks of
one slice (every mesh axis but "slice"), and the policy is the reference's
decision by size:

- small stacks: replicate, every rank keeps the whole stacks;
- big stacks: shard_island, one copy per island, each rank keeping its
  padded share of the atlas rows at rest;
- huge stacks: shard_global, one copy over the whole mesh (last resort:
  a launch's gather crosses slices).

At rest a rank keeps only its shard (`PlacedScene`). A launch gathers the
full stacks inside the island into a temporary scene and drops it
afterwards (`PlacedScene.gathered`), which is what GSPMD's inserted gathers
do for the reference. The stacks are the atlas and the material bundles;
the port has no quad-row table (the reference's `bundle_quads`, a TPU
gather device), so its byte counts leave that table out.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from .tiles import ROWS_AXIS, SLICE_AXIS, Mesh, all_gather

# Bytes of texture stacks a rank keeps before the policy stops replicating:
# geometry, the film and the wavefront's state come first. The value equals
# the reference's, so both packages take the same decisions.
DEFAULT_TEXTURE_BUDGET = 256 << 20

_STACKS = ("textures", "bundles")


def texture_nbytes(scene) -> int:
    """Bytes of the scene's texture stacks (atlas and bundles)."""
    return int(sum(getattr(scene, k).numel() * getattr(scene, k).element_size()
                   for k in _STACKS))


def plan_texture_placement(nbytes: int, mesh: Mesh,
                           budget_bytes: int = DEFAULT_TEXTURE_BUDGET) -> dict:
    """replicate / shard_island / shard_global from the stacks' size
    (memory.py:49-69) → {mode, island_axes, per_chip_bytes, replicas};
    `replicas` counts the full copies over the mesh (one per island)."""
    shape = mesh.shape
    n_slices = shape.get(SLICE_AXIS, 1)
    island_axes = tuple(a for a in mesh.axis_names if a != SLICE_AXIS)
    n_island = max(1, math.prod(shape[a] for a in island_axes))
    n_total = n_slices * n_island
    if nbytes <= budget_bytes:
        return dict(mode="replicate", island_axes=(),
                    per_chip_bytes=nbytes, replicas=n_total)
    per_island = -(-nbytes // n_island)
    if per_island <= budget_bytes or n_slices == 1:
        return dict(mode="shard_island", island_axes=island_axes,
                    per_chip_bytes=per_island, replicas=n_slices)
    return dict(mode="shard_global",
                island_axes=(SLICE_AXIS,) + island_axes,
                per_chip_bytes=-(-nbytes // n_total), replicas=1)


@dataclasses.dataclass(eq=False)
class PlacedScene:
    """A scene whose texture stacks are placed over a mesh.

    base: the scene with empty stacks; shards: {stack: this rank's rows of
    it (dim 1, padded to a multiple of the island), or the whole stack
    when replicated}; rows: {stack: its unpadded row count}; axes: the
    island's axes, () when replicated."""
    base: object
    shards: dict
    rows: dict
    axes: tuple
    mesh: Mesh

    @contextlib.contextmanager
    def gathered(self):
        """The full scene for one launch: each sharded stack gathered inside
        the island into a temporary buffer, dropped on exit."""
        full = {}
        for k, shard in self.shards.items():
            if self.axes and k in self.rows:
                parts = all_gather(self.mesh, shard, self.axes)
                full[k] = torch.cat(parts, dim=1)[:, :self.rows[k]]
            else:
                full[k] = shard
        scene = dataclasses.replace(self.base, **full)
        try:
            yield scene
        finally:
            del scene, full


def _empty_like(t):
    return torch.empty((0,) + tuple(t.shape[1:]), dtype=t.dtype,
                       device=t.device)


def _place(scene, mesh: Mesh, axes: tuple, stacks) -> PlacedScene:
    """Keep this rank's share of each of `stacks` over `axes` (dim 1, zero
    rows padded to a multiple of the group; the mip tables bound every
    lookup, so pad rows are never read, memory.py:94-98), the others
    whole."""
    members = mesh.group_ranks(axes) if axes else (mesh.rank,)
    n, k = len(members), members.index(mesh.rank)
    shards, rows = {}, {}
    for name in _STACKS:
        t = getattr(scene, name)
        if name not in stacks or not axes or t.shape[0] == 0:
            shards[name] = t
            continue
        per = -(-t.shape[1] // n)
        part = t[:, k * per:(k + 1) * per]
        pad = per - part.shape[1]
        if pad:
            part = torch.cat([part, part.new_zeros(
                (t.shape[0], pad) + tuple(t.shape[2:]))], dim=1)
        shards[name] = part.contiguous().clone()
        rows[name] = t.shape[1]
    base = dataclasses.replace(scene, **{k: _empty_like(getattr(scene, k))
                                         for k in _STACKS})
    return PlacedScene(base=base, shards=shards, rows=rows,
                       axes=tuple(axes) if rows else (), mesh=mesh)


def place_scene_textures(scene, mesh: Mesh,
                         budget_bytes: int = DEFAULT_TEXTURE_BUDGET):
    """The plan applied to the scene's stacks (memory.py:77-116) →
    (PlacedScene, report: the plan and total_bytes). The caller's `scene`
    should be dropped afterwards, or the rank keeps the full stacks too."""
    nbytes = texture_nbytes(scene)
    plan = plan_texture_placement(nbytes, mesh, budget_bytes)
    report = dict(plan, total_bytes=nbytes)
    axes = () if plan["mode"] == "replicate" or nbytes == 0 else (
        plan["island_axes"])
    return _place(scene, mesh, axes, _STACKS), report


def per_chip_texture_bytes(placed) -> int:
    """Bytes of texture stacks this rank keeps at rest (its shards; a plain
    scene's whole stacks)."""
    if isinstance(placed, PlacedScene):
        return int(sum(t.numel() * t.element_size()
                       for t in placed.shards.values()))
    return texture_nbytes(placed)


def shard_scene_textures(scene, mesh: Mesh, axis: str = ROWS_AXIS):
    """The atlas sharded over `axis` whatever its size (memory.py:136-144;
    place_scene_textures is the policy)."""
    return _place(scene, mesh, (axis,), ("textures",))


def replicate_scene(scene, mesh: Mesh) -> PlacedScene:
    """Every rank keeps its whole scene, the optixMultiGPU model
    (memory.py:147-151). Each rank builds its own copy on its device, so
    this only checks the device and places the stacks as replicated."""
    if scene.device != mesh.device:
        raise ValueError(f"the scene is on {scene.device}, the rank renders "
                         f"on {mesh.device}")
    return _place(scene, mesh, (), ())

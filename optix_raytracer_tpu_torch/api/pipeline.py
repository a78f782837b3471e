"""ProgramGroup / Pipeline / ShaderBindingTable / launch (counterpart of
`api/pipeline.py`).

The reference's launch ritual (`optixProgramGroupCreate` →
`optixPipelineCreate` → SBT record packing → `optixLaunch`,
`include/optix_host.h:440-528`):

- a ProgramGroup binds entry points of a Module (kinds at
  `optix_types.h:2072-2094`);
- the ShaderBindingTable's hitgroup records carry the per-geometry material
  data; record order is the SBT index, as `sbtOffset + geometryIndex *
  rayTypeCount + rayType` (`Scene.cpp:1154`);
- "linking" picks one of the framework's integrators, "pathtrace"
  (`wavefront/engine.render_accumulate`: the fused kernel on a small scene,
  the cluster walks on a large mesh, the BVH walk past the cluster cap) or
  "whitted" (`wavefront/whitted.render_whitted_sample`); the stack size is
  `max_trace_depth`, the bounce loop's bound;
- `Pipeline.launch(sbt, handle, cam, width, height)` is `optixLaunch`: it
  assembles the DeviceScene from the SBT and the GAS handle (the handle's
  BVH handed to the scene), runs `samples_per_launch` samples into the film
  and, in validation mode, counts the launch's exceptions
  (`wavefront/exceptions.py`) and logs them through the context.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence

import torch

from ..accel.primitives import CustomPrims
from ..core.film import Film
from ..scene.device_scene import DeviceScene, make_device_scene
from ..shade.lights import ParallelogramLight
from ..shade.materials import make_material_table
from ..wavefront.engine import _merge_launch, render_sum
from ..wavefront.whitted import render_whitted_sample
from .accel import TraversableHandle
from .context import LogLevel


class ProgramGroupKind(enum.Enum):
    RAYGEN = "raygen"
    MISS = "miss"
    HITGROUP = "hitgroup"
    EXCEPTION = "exception"
    CALLABLES = "callables"


@dataclasses.dataclass
class ProgramGroup:
    kind: ProgramGroupKind
    entry: str = ""                 # e.g. "__raygen__pinhole"
    module: object = None           # api.module.Module or None (builtin)

    @property
    def stack_size(self):
        """optixProgramGroupGetStackSize: the path state lives in the bounce
        loop's tensors, so no program has a stack of its own."""
        return {"cssRG": 0, "cssMS": 0, "cssCH": 0, "dssDC": 0}


@dataclasses.dataclass
class SbtRecord:
    """One SBT record: header (program group) and data payload
    (`sutil/Record.h:36-46`)."""
    program_group: ProgramGroup
    data: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ShaderBindingTable:
    """Raygen / miss / hitgroup / callable records (`optix_types.h:
    2293-2331`)."""
    raygen_record: Optional[SbtRecord] = None
    miss_records: Sequence[SbtRecord] = ()
    hitgroup_records: Sequence[SbtRecord] = ()
    callable_records: Sequence[SbtRecord] = ()

    def material_table(self, device):
        """Hitgroup record data → MaterialTable on `device` (record order =
        SBT index)."""
        return make_material_table([r.data for r in self.hitgroup_records]
                                   or [{}], device)

    def miss_color(self):
        if self.miss_records:
            return self.miss_records[0].data.get("color", (0.0, 0.0, 0.0))
        return (0.0, 0.0, 0.0)


class Pipeline:
    def __init__(self, context=None,
                 program_groups: Sequence[ProgramGroup] = (),
                 integrator: str = "pathtrace", max_trace_depth: int = 4,
                 samples_per_launch: int = 1):
        if integrator not in ("pathtrace", "whitted"):
            raise ValueError(f"unknown integrator {integrator!r}")
        self.context = context
        self.program_groups = list(program_groups)
        self.integrator = integrator
        self.max_trace_depth = max_trace_depth
        self.samples_per_launch = samples_per_launch
        self.last_exceptions = None
        if context is not None:
            context.log(LogLevel.PRINT, "PIPELINE",
                        f"linked {integrator} pipeline, depth "
                        f"{max_trace_depth}")

    def set_stack_size(self, *_args, **_kw):
        """optixPipelineSetStackSize: nothing to set (the bounce loop's
        state is its stack, of a size fixed by the integrator)."""

    def _assemble_scene(self, sbt: ShaderBindingTable,
                        handle: TraversableHandle, tri_sbt_index=None,
                        lights=(),
                        area_light: Optional[ParallelogramLight] = None,
                        textures=()) -> DeviceScene:
        """The DeviceScene of a launch on the handle's device
        (pipeline.py:108-130): the GAS's triangles (a degenerate one for a
        custom-prim GAS) with per-triangle SBT indices (0 by default), the
        SBT's material table and miss colour, the lights, the GAS's prims,
        and its BVH."""
        dev = self._device(handle)
        if handle.geom is None:
            verts = torch.zeros((3, 3), dtype=torch.float32, device=dev)
            idx = torch.zeros((1, 3), dtype=torch.int32, device=dev)
        else:
            verts, idx = handle.vertices, handle.indices
        n_tris = idx.shape[0]
        tri_mat = (torch.zeros((n_tris,), dtype=torch.int32)
                   if tri_sbt_index is None
                   else torch.as_tensor(tri_sbt_index, dtype=torch.int32))
        scene = make_device_scene(
            verts, idx, tri_mat.cpu(), sbt.material_table(dev), dev,
            area_light=area_light, lights=lights,
            prims=(handle.prims if handle.prims is not None
                   else CustomPrims.empty(dev)),
            miss_color=sbt.miss_color(), textures=textures)
        if handle.bvh is not None:
            scene = dataclasses.replace(scene, bvh=handle.bvh)
        return scene

    @staticmethod
    def _device(handle: TraversableHandle):
        for part in (handle.indices, handle.prims):
            if part is not None:
                return (part.device if isinstance(part, torch.Tensor)
                        else part.kind.device)
        raise ValueError("an empty TraversableHandle")

    def launch(self, sbt: ShaderBindingTable, handle: TraversableHandle,
               cam_params, width: int, height: int, film=None,
               tri_sbt_index=None, lights=(), area_light=None, textures=()):
        """optixLaunch: `samples_per_launch` progressive samples into
        `film` (None: a new film on the handle's device) → (film,
        rays_traced), the rays an int64 tensor on the device (the Whitted
        integrator's too; the reference's pipeline returns 0 there)."""
        scene = self._assemble_scene(sbt, handle, tri_sbt_index, lights,
                                     area_light, textures)
        if film is None:
            film = Film.create(height, width, scene.device)
        if self.integrator == "pathtrace":
            rad_sum, rays = render_sum(
                scene, cam_params, width, height, film.subframe,
                self.samples_per_launch, max_depth=self.max_trace_depth)
            film = _merge_launch(film, rad_sum, self.samples_per_launch)
        else:
            rays = torch.zeros((), dtype=torch.int64, device=scene.device)
            rad_sum = torch.zeros_like(film.accum)
            for _ in range(self.samples_per_launch):
                radiance, r = render_whitted_sample(
                    scene, cam_params, width, height, film.subframe,
                    max_depth=self.max_trace_depth)
                film = film.accumulate(radiance)
                rad_sum = rad_sum + radiance
                rays = rays + r
        if self.context is not None and self.context.validation_mode:
            self._check_launch(cam_params, rad_sum, width, height)
        return film, rays

    def _check_launch(self, cam_params, rad_sum, width, height):
        """Validation mode's exception surface (pipeline.py:161-177): the
        counters of the launch's own radiance sum to `last_exceptions` and,
        where one fired, an ERROR line "EXCEPTION" through the context's
        log callback; with the context's debug_nans, FloatingPointError on
        a NaN in that sum."""
        from ..wavefront.exceptions import (format_exceptions,
                                            launch_diagnostics)
        diag = {k: int(v) for k, v in launch_diagnostics(
            cam_params, rad_sum, width, height).items()}
        self.last_exceptions = diag
        msg = format_exceptions(diag)
        if msg:
            self.context.log(LogLevel.ERROR, "EXCEPTION", msg)
        if self.context.debug_nans and bool(torch.isnan(rad_sum).any()):
            raise FloatingPointError(f"NaN in the launch's radiance ({msg})")

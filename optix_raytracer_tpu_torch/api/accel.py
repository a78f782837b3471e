"""Acceleration-structure builds: the `optixAccelBuild` surface (counterpart
of `api/accel.py`).

`optixAccelComputeMemoryUsage` / `optixAccelBuild` / `optixAccelCompact` /
`optixAccelRelocate` (`include/optix_host.h:544-694`) become builders over
tensors on a device (the card unless the caller gives another):
- a build makes the triangle tables and, past the brute-force kernels' 512
  triangles, the LBVH on the device (`accel/lbvh.py`); the memory usage is
  the bytes of the handle's tensors;
- compaction saves nothing (the tensors are dense by construction; the
  reference compacts because driver builds over-allocate,
  `optixPathTracer.cpp:622-683`), and relocation is PyTorch's;
- refit (`OPTIX_BUILD_OPERATION_UPDATE`, `optixDynamicGeometry.cpp:
  412-435`) rebuilds the tables from moved vertices and the LBVH with them,
  on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..accel.geometry import TriangleGeometry, build_triangle_geometry
from ..accel.lbvh import LBVH, build_lbvh
from ..accel.primitives import CustomPrims, make_prims

BVH_THRESHOLD_TRIS = 512


def _nbytes(obj) -> int:
    """The bytes of a tensor, or of the tensor fields of a dataclass."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if dataclasses.is_dataclass(obj):
        return sum(_nbytes(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    return 0


@dataclasses.dataclass
class TraversableHandle:
    """What `optixAccelBuild` returns: the build input (vertices [V, 3],
    indices [M, 3]), the geometry tables, the custom prims and the LBVH;
    each part None where the build has none."""
    geom: Optional[TriangleGeometry] = None
    prims: Optional[CustomPrims] = None
    bvh: Optional[LBVH] = None
    vertices: Optional[torch.Tensor] = None
    indices: Optional[torch.Tensor] = None

    @property
    def memory_usage_bytes(self) -> int:
        """The bytes of every tensor the handle holds (the
        optixAccelComputeMemoryUsage role)."""
        return sum(_nbytes(part) for part in (self.geom, self.prims,
                                              self.bvh, self.vertices,
                                              self.indices))

    @property
    def compacted_size_bytes(self) -> int:
        # dense by construction: compaction would save nothing
        return self.memory_usage_bytes


def build_gas(vertices, indices, normals=None, uvs=None,
              allow_update: bool = True, with_bvh: Optional[bool] = None,
              device="cuda") -> TraversableHandle:
    """Triangle GAS build (triangle build input, optix_types.h:632) on
    `device`; with_bvh None builds the LBVH past BVH_THRESHOLD_TRIS
    triangles."""
    verts = torch.as_tensor(vertices, dtype=torch.float32, device=device)
    idx = torch.as_tensor(indices, dtype=torch.int32, device=device)
    geom = build_triangle_geometry(verts, idx, device, normals=normals,
                                   uvs=uvs)
    if with_bvh is None:
        with_bvh = geom.num_triangles > BVH_THRESHOLD_TRIS
    return TraversableHandle(geom=geom,
                             bvh=build_lbvh(geom) if with_bvh else None,
                             vertices=verts, indices=idx)


def build_custom_gas(prim_descs, device="cuda") -> TraversableHandle:
    """Custom-primitive GAS (AABB build input, optix_types.h:925) from the
    analytic prim descriptors (`accel/primitives.make_prims`); the AABBs
    the reference feeds the driver are implied."""
    return TraversableHandle(prims=make_prims(prim_descs, device))


def refit_gas(handle: TraversableHandle, new_vertices) -> TraversableHandle:
    """GAS update (refit): the same triangles over moved vertices, on the
    handle's device; the tables are rebuilt, and the LBVH where the handle
    has one (api/accel.py:73-79; per-vertex normals and uvs are not kept,
    as in the reference)."""
    if handle.geom is None:
        raise ValueError("refit needs a triangle GAS")
    dev = handle.indices.device
    verts = torch.as_tensor(new_vertices, dtype=torch.float32, device=dev)
    geom = build_triangle_geometry(verts, handle.indices, dev)
    bvh = build_lbvh(geom) if handle.bvh is not None else None
    return TraversableHandle(geom=geom, prims=handle.prims, bvh=bvh,
                             vertices=verts, indices=handle.indices)


def build_ias(instances_transforms, sbt_offsets=None, instance_ids=None,
              prim_ranges=None, num_prims=None, device="cuda"):
    """Instance acceleration structure over a shared GAS (the
    `buildInstanceAccel` path, `Scene.cpp:1134-1213`) → the
    `accel/tlas.InstanceTable` a DeviceScene takes."""
    from ..accel.tlas import make_instances
    return make_instances(instances_transforms, device, sbt_offsets,
                          instance_ids, prim_ranges, num_prims)

"""Shared helpers of the port's parity tests: hand the JAX package's scene and
camera over to optix_raytracer_tpu_torch as numpy arrays, so both sides
compute on the same bits."""
import numpy as np
import pytest
import torch

from optix_raytracer_tpu_torch.core.camera import camera_params_from_numpy
from optix_raytracer_tpu_torch.scene.device_scene import device_scene_from_numpy


def scene_fields(jscene):
    """JAX DeviceScene → the numpy field dict of device_scene_from_numpy."""
    g, m, light = jscene.geom, jscene.materials, jscene.area_light
    cl = jscene.clusters
    arrays = dict(
        tri_consts=g.tri_consts, face_normal=g.face_normal, valid=g.valid,
        v0=g.v0, e1=g.e1, e2=g.e2, corner_normal=g.corner_normal,
        cluster_comp=cl.comp, cluster_aabb=cl.aabb,
        cluster_slot_prim=cl.slot_prim, tri_mat=jscene.tri_mat,
        mat_kind=m.kind, mat_base_color=m.base_color,
        mat_emission=m.emission, mat_metallic=m.metallic,
        mat_roughness=m.roughness, mat_ior=m.ior, mat_kr=m.kr,
        light_corner=light.corner, light_v1=light.v1, light_v2=light.v2,
        light_normal=light.normal, light_emission=light.emission,
        miss_color=jscene.miss_color, prim_kind=jscene.prims.kind,
        prim_params=jscene.prims.params, prim_mat_id=jscene.prims.mat_id)
    fields = {k: np.array(v) for k, v in arrays.items()}
    fields["features"] = tuple(jscene.features)
    fields["smooth"] = bool(g.smooth)
    fields["num_clusters"] = int(cl.num_clusters)
    return fields


def jax_prims_scene(with_glass=True):
    """The JAX twin of builtins.prims_scene (bench.py:167-190), from the
    port's copy of the tables."""
    from optix_raytracer_tpu.accel import primitives as jprim
    from optix_raytracer_tpu.scene.device_scene import make_device_scene
    from optix_raytracer_tpu.shade.lights import ParallelogramLight
    from optix_raytracer_tpu_torch.scene import builtins as tb
    verts, idx = tb.prims_floor()
    mats = tb.PRIMS_MATERIALS if with_glass else tb.PRIMS_MATERIALS[:3]
    return make_device_scene(verts, idx, np.zeros(2, np.int32), mats,
                             area_light=ParallelogramLight.make(
                                 *tb.PRIMS_LIGHT),
                             prims=jprim.make_prims(tb.prims_list(
                                 with_glass)))


def jax_pbr_cornell(metallic=0.8, roughness=0.35):
    """The JAX twin of builtins.pbr_cornell (bench.py:432-439)."""
    from optix_raytracer_tpu.scene import builtins as jb
    from optix_raytracer_tpu.scene.device_scene import make_device_scene
    from optix_raytracer_tpu.shade.lights import ParallelogramLight
    from optix_raytracer_tpu_torch.scene import builtins as tb
    verts, idx, tri_mat = jb.quads_to_triangles(jb._CORNELL_QUADS)
    return make_device_scene(
        verts, idx, tri_mat, tb.pbr_cornell_materials(metallic, roughness),
        area_light=ParallelogramLight.make(
            jb.CORNELL_LIGHT_CORNER, jb.CORNELL_LIGHT_V1, jb.CORNELL_LIGHT_V2,
            jb.CORNELL_LIGHT_EMISSION))


def torch_scene(jscene, device="cpu"):
    return device_scene_from_numpy(scene_fields(jscene), device)


def torch_cam(jcam_params, device="cpu"):
    return camera_params_from_numpy(
        {k: np.array(v) for k, v in jcam_params.items()}, device)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one intra-op thread for a module (imported by the modules
    that want it). The suite runs in several worker processes on shared
    cores; each worker's torch threads oversubscribe them, and the plain
    walks' many small ops then run tens of times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

"""Shared helpers of the port's parity tests: hand the JAX package's scene and
camera over to optix_raytracer_tpu_torch as numpy arrays, so both sides
compute on the same bits, and make sure the JAX package's SAH library is
loaded before a test compares a knot build of the two packages."""
import fcntl
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from optix_raytracer_tpu_torch.core.camera import camera_params_from_numpy
from optix_raytracer_tpu_torch.scene.device_scene import device_scene_from_numpy


def scene_fields(jscene):
    """JAX DeviceScene → the numpy field dict of device_scene_from_numpy
    (the instance table too, so both packages trace with the same inverse
    transforms: jnp.linalg.inv and torch.linalg.inv may round apart; and the
    texture bundles, uvs, tangents and uv densities)."""
    g, m, light = jscene.geom, jscene.materials, jscene.area_light
    cl, inst = jscene.clusters, jscene.instances
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
        prim_params=jscene.prims.params, prim_mat_id=jscene.prims.mat_id,
        inst_transform=inst.transform,
        inst_inv_transform=inst.inv_transform,
        inst_sbt_offset=inst.sbt_offset, inst_instance_id=inst.instance_id,
        corner_uv=g.corner_uv, tangent=g.tangent, uv_density=g.uv_density,
        mat_base_tex=m.base_tex, mat_normal_tex=m.normal_tex,
        mat_mr_tex=m.mr_tex, mat_emissive_tex=m.emissive_tex,
        mat_bundle=m.bundle, bundles=jscene.bundles,
        bundle_mip=jscene.bundle_mip)
    fields = {k: np.array(v) for k, v in arrays.items()}
    fields["bundle_meta"] = jscene.bundle_meta
    fields["mat_tex_flags"] = jscene.mat_tex_flags
    fields["num_textures"] = int(jscene.textures.shape[0])
    fields["features"] = tuple(jscene.features)
    fields["smooth"] = bool(g.smooth)
    fields["num_clusters"] = int(cl.num_clusters)
    fields["inst_prim_ranges"] = tuple(inst.prim_ranges)
    fields["inst_row_ids"] = bool(inst.row_ids)
    return fields


# The port's build directory is git-ignored; the lock lives there.
_LOCK = (Path(__file__).resolve().parents[1] / "optix_raytracer_tpu_torch"
         / "_build" / "jax-native.lock")


@pytest.fixture(scope="module")
def jax_native_sah():
    """The JAX package's native SAH library, loaded, for a module that
    compares the port's own knot build with a JAX knot build.

    The reference's binding (optix_raytracer_tpu/accel/native.py:31-65)
    compiles native/libort_native.so in place with `g++ -o` and, on any
    exception, gives up for the life of the process. Test workers that
    build it at once can load a half-written file; that worker then builds
    every JAX knot in morton order while the port (whose binding builds
    atomically) takes the SAH order. So, where g++ and the sources exist,
    under a file lock: reset the binding's state; if the library is
    missing, older than its sources or does not load, build it with the
    reference's flags into a temporary file beside it and move it into
    place with os.replace; then require that it loads. Without g++ both
    packages take morton order, and nothing is done."""
    from optix_raytracer_tpu.accel import native as jnative
    so = jnative._SO_PATH
    srcs = [os.path.join(jnative._NATIVE_DIR, f)
            for f in ("bvh_builder.cpp", "mesh_loader.cpp")]
    cxx = shutil.which("g++")

    def stale():
        return (not os.path.exists(so) or any(
            os.path.getmtime(s) > os.path.getmtime(so) for s in srcs))

    with pytest.MonkeyPatch.context() as mp:
        if jnative._lib is None and cxx and all(map(os.path.exists, srcs)):
            _LOCK.parent.mkdir(parents=True, exist_ok=True)
            with open(_LOCK, "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                try:
                    mp.setattr(jnative, "_lib", None)
                    mp.setattr(jnative, "_lib_failed", False)
                    if stale() or not jnative.available():
                        tmp = f"{so}.{os.getpid()}.tmp"
                        subprocess.run([cxx, "-O3", "-march=native", "-fPIC",
                                        "-std=c++17", "-shared", "-o", tmp]
                                       + srcs, check=True,
                                       capture_output=True, timeout=300)
                        os.replace(tmp, so)
                        jnative._lib, jnative._lib_failed = None, False
                    assert jnative.available(), "the JAX SAH library did not load"
                finally:
                    fcntl.flock(lock, fcntl.LOCK_UN)
        yield


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


def _instanced_cube_parts():
    """The data of tests/test_fused_kernel.py:20-62's _instanced_cube_scene:
    a unit cube (12 triangles) instanced twice (rotated about y, the second
    scaled 0.7 and with sbt offset 1) over a floor instance, three diffuse
    materials, an area light → (cube verts, faces, floor verts, faces,
    [(mesh, transform, sbt)], materials, light args)."""
    h = 0.5
    v = np.array([[x, y, z] for x in (-h, h) for y in (-h, h)
                  for z in (-h, h)], np.float32)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                  [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                  [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)

    def xf(tx, ty, tz, s=1.0, deg=0.0):
        a = np.radians(deg)
        t = np.eye(4, dtype=np.float32)
        t[0, 0] = np.cos(a) * s
        t[0, 2] = np.sin(a) * s
        t[2, 0] = -np.sin(a) * s
        t[2, 2] = np.cos(a) * s
        t[1, 1] = s
        t[:3, 3] = (tx, ty, tz)
        return t

    floor = np.array([[-4, 0, -4], [4, 0, -4], [4, 0, 4], [-4, 0, 4]],
                     np.float32)
    fidx = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    insts = [(0, xf(-1.1, 0.5, 0.0, 1.0, 25.0), 0),
             (0, xf(1.0, 0.35, -0.4, 0.7, -40.0), 1),
             (1, np.eye(4, dtype=np.float32), 0)]
    mats = [{"kind": 0, "base_color": (0.8, 0.3, 0.2)},
            {"kind": 0, "base_color": (0.2, 0.4, 0.8)},
            {"kind": 0, "base_color": (0.7, 0.7, 0.7)}]
    light = ((-1, 4, -1), (2, 0, 0), (0, 0, 2), (12.0, 12.0, 12.0))
    return v, f, floor, fidx, insts, mats, light


def instanced_cube(package, device="cpu", smooth=False):
    """The instanced cube scene built by `package` ("jax" or "torch") with
    its own Scene class. smooth=True gives the cube per-vertex normals
    (its corners' directions) and leaves the floor without any, so its hits
    fall back to the face normal."""
    v, f, floor, fidx, insts, mats, light = _instanced_cube_parts()
    normals = (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(
        np.float32) if smooth else None
    if package == "jax":
        from optix_raytracer_tpu.scene.scene import Scene
        from optix_raytracer_tpu.shade.lights import ParallelogramLight
        lt = ParallelogramLight.make(*light)
    else:
        from optix_raytracer_tpu_torch.scene.scene import Scene
        from optix_raytracer_tpu_torch.shade.lights import ParallelogramLight
        lt = ParallelogramLight.make(*light, device)
    sc = Scene()
    for m in mats:
        sc.add_material(m)
    sc.add_mesh(v, f, normals=normals, material=0)
    sc.add_mesh(floor, fidx, material=2)
    for mi, t, sbt in insts:
        sc.add_instance(mi, t, sbt_offset=sbt)
    if package == "jax":
        return sc.finalize(area_light=lt)
    return sc.finalize(device, area_light=lt)

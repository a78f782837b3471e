"""Shared helpers of the port's parity tests: hand the JAX package's scene and
camera over to optix_raytracer_tpu_torch as numpy arrays, so both sides
compute on the same bits, and make sure the JAX package's SAH library is
loaded before a test compares a knot build of the two packages."""
import fcntl
import os
import shutil
import struct
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from optix_raytracer_tpu_torch.accel.geometry import build_triangle_geometry
from optix_raytracer_tpu_torch.core.camera import camera_params_from_numpy
from optix_raytracer_tpu_torch.core.rays import Rays
from optix_raytracer_tpu_torch.scene.device_scene import device_scene_from_numpy


def scene_fields(jscene):
    """JAX DeviceScene → the numpy field dict of device_scene_from_numpy
    (the instance table too, so both packages trace with the same inverse
    transforms: jnp.linalg.inv and torch.linalg.inv may round apart; and the
    texture bundles and atlas, uvs, tangents and uv densities, the light
    table, the Whitted and cutout material planes, the opacity
    micromaps, whose split the port derives from them, the moving
    triangles and the fog volume)."""
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
        bundle_mip=jscene.bundle_mip, mat_specular=m.specular,
        mat_phong_exp=m.phong_exp, mat_checker1=m.checker1,
        mat_checker_scale=m.checker_scale, lights_kind=jscene.lights.kind,
        lights_position=jscene.lights.position,
        lights_color=jscene.lights.color,
        lights_falloff=jscene.lights.falloff,
        lights_radius=jscene.lights.radius, textures=jscene.textures,
        tex_size=jscene.tex_size, tex_mip=jscene.tex_mip,
        mat_alpha_mode=m.alpha_mode, mat_cutout=m.cutout,
        mat_alpha_cutoff=m.alpha_cutoff, omm_micro=jscene.omm_micro,
        omm_summary=jscene.omm_summary,
        **{f"motion_{k}": getattr(jscene.motion_geom, k)
           for k in ("v0_0", "e1_0", "e2_0", "v0_1", "e1_1", "e2_1")},
        motion_tri_mat=jscene.motion_tri_mat,
        volume_density=jscene.volume.density, volume_lo=jscene.volume.lo,
        volume_hi=jscene.volume.hi, volume_params=jscene.volume_params)
    fields = {k: np.array(v) for k, v in arrays.items()}
    fields["bundle_meta"] = jscene.bundle_meta
    fields["mat_tex_flags"] = jscene.mat_tex_flags
    fields["num_textures"] = int(jscene.textures.shape[0])
    fields["features"] = tuple(jscene.features)
    fields["smooth"] = bool(g.smooth)
    fields["num_clusters"] = int(cl.num_clusters)
    fields["inst_prim_ranges"] = tuple(inst.prim_ranges)
    fields["inst_row_ids"] = bool(inst.row_ids)
    fields["omm_level"] = int(jscene.omm_level)
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
    place with os.replace; then require that it loads. The loaded library
    stays loaded after the module: a worker whose own earlier load failed
    is repaired for its later modules (the reference's tests among them)
    instead of having the failure put back. Without g++ both packages take
    morton order, and nothing is done."""
    from optix_raytracer_tpu.accel import native as jnative
    so = jnative._SO_PATH
    srcs = [os.path.join(jnative._NATIVE_DIR, f)
            for f in ("bvh_builder.cpp", "mesh_loader.cpp")]
    cxx = shutil.which("g++")

    def stale():
        return (not os.path.exists(so) or any(
            os.path.getmtime(s) > os.path.getmtime(so) for s in srcs))

    if jnative._lib is None and cxx and all(map(os.path.exists, srcs)):
        _LOCK.parent.mkdir(parents=True, exist_ok=True)
        with open(_LOCK, "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                jnative._lib, jnative._lib_failed = None, False
                if stale() or not jnative.available():
                    tmp = f"{so}.{os.getpid()}.tmp"
                    subprocess.run([cxx, "-O3", "-march=native", "-fPIC",
                                    "-std=c++17", "-shared", "-o", tmp]
                                   + srcs, check=True, capture_output=True,
                                   timeout=300)
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


def sc_tie_case(device="cpu"):
    """A supercluster-tier table of exact ties (build it with the tier's
    caps lowered: MAX_STREAM_CLUSTERS = 2, SC_CLUSTERS = 2): 6 clusters, 3
    superclusters of 2 members, far filler triangles in every other slot,
    and four unit triangles in the plane z = 0, each placed twice:
    A at member 0 and member 1 of supercluster 0, both slot 5 (the earlier
    visit must win); B at member 1 slot 3 and member 0 slot 9 (the lower
    slot must win over the earlier visit); C twice in one member (cluster
    2, slots 7 and 2: the lower slot); D in superclusters 1 and 2, slot 20
    of each (the earlier list entry). Rays straight down from z = 1 at each
    triangle's interior, at its corners and along its edges, so every pair
    ties at t = 1 → (geom, tri_mat, order, rays [N, 8] f32 numpy,
    expected winning triangle [N] int64 for the interior rays, -1 for
    the others)."""
    from optix_raytracer_tpu_torch.accel.geometry import (
        build_triangle_geometry)
    unit = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    tris = []
    for x in (0.0, 2.0, 4.0, 6.0):            # A, B, C, D: two copies each
        tris += [unit + [x, 0, 0]] * 2
    n_fill = 6 * 128 - len(tris)
    fill = [unit * 0.01 + [0.03 * (i % 40), 0.03 * (i // 40), 100.0]
            for i in range(n_fill)]
    verts = np.concatenate(tris + fill).astype(np.float32)
    idx = np.arange(len(verts), dtype=np.int32).reshape(-1, 3)
    rng = np.random.default_rng(17)
    tri_mat = rng.integers(0, 5, len(idx)).astype(np.int32)
    # slot (cluster * 128 + lane) of each duplicated triangle
    place = {0: 0 * 128 + 5, 1: 1 * 128 + 5,       # A: earlier visit
             3: 1 * 128 + 3, 2: 0 * 128 + 9,       # B: lower slot wins
             5: 2 * 128 + 7, 4: 2 * 128 + 2,       # C: one member
             6: 2 * 128 + 20, 7: 4 * 128 + 20}     # D: two entries
    order = np.full(6 * 128, -1, np.int64)
    for tri, slot in place.items():
        order[slot] = tri
    order[order < 0] = np.arange(8, len(idx))
    geom = build_triangle_geometry(verts, idx, device)
    winner = {0: 0, 2: 3, 4: 4}                # D's winner: list order
    o, expect = [], []
    for k, x in enumerate((0.0, 2.0, 4.0, 6.0)):
        for p in ([0.25, 0.25], [0.1, 0.6], [0.6, 0.1]):
            o.append([x + p[0], p[1], 1.0])
            expect.append(winner.get(2 * k, -2))
        for p in ([0, 0], [1, 0], [0, 1], [0.5, 0], [0, 0.5], [0.5, 0.5]):
            o.append([x + p[0], p[1], 1.0])
            expect.append(-1)
    o = np.asarray(o, np.float32)
    n = len(o)
    rays = np.concatenate([o, np.tile([[0, 0, -1.0]], (n, 1)),
                           np.full((n, 1), 1e-3), np.full((n, 1), 1e16)],
                          axis=1).astype(np.float32)
    return (geom, torch.as_tensor(tri_mat, device=device),
            torch.as_tensor(order, device=device), rays,
            np.asarray(expect, np.int64))


def sc_grazing_rays(geom, cl, member, seed=0, boxes=64):
    """Rays that graze the real member boxes of a supercluster-tier table
    (member [S, 6, M] from `_sc_tables`), on up to `boxes` of them: rays in
    a face's plane (that axis's direction +0.0 or -0.0, the pseudo-inverse's
    +-1e12), rays through corners and edges, rays aimed at the triangle
    vertex that sets a face (it lies on it), axis-parallel rays along a
    face, and windows that end on a face → [N, 8] f32 numpy."""
    rng = np.random.default_rng(seed)
    mem = member.detach().cpu().numpy()
    lo = mem[:, 0:3].transpose(0, 2, 1).reshape(-1, 3)
    hi = mem[:, 3:6].transpose(0, 2, 1).reshape(-1, 3)
    real = np.nonzero((lo <= hi).all(axis=1)
                      & (np.arange(len(lo)) < cl.num_clusters))[0]
    pick = rng.choice(real, min(boxes, len(real)), replace=False)
    sp = cl.slot_prim.detach().cpu().numpy().reshape(-1, 128)
    v0 = geom.v0.detach().cpu().numpy()
    corners = np.stack([v0, v0 + geom.e1.detach().cpu().numpy(),
                        v0 + geom.e2.detach().cpu().numpy()], axis=1)
    out = []

    def unit(d):
        return (d / np.linalg.norm(d)).astype(np.float32)

    def add(o, d, tmax=1e16, tmin=1e-3):
        out.append(np.concatenate([o, d, [tmin, tmax]]).astype(np.float32))

    reps = max(4, -(-400 // (5 * len(pick))))     # at least ~400 rays
    for i in pick:
        l, h = lo[i], hi[i]
        ext = float((h - l).max())
        for _ in range(reps):
            a = rng.integers(3)
            face = (l if rng.integers(2) else h)[a]
            p = rng.uniform(l, h).astype(np.float32)
            p[a] = face
            # in the face's plane, both signs of zero
            d = unit(rng.normal(size=3))
            d[a] = -0.0 if rng.integers(2) else 0.0
            d = unit(d)
            d[a] = -0.0 if rng.integers(2) else 0.0
            dist = np.float32(rng.uniform(0.5, 3.0) * ext)
            o = (p - d * dist).astype(np.float32)
            o[a] = face
            add(o, d, rng.choice([1e16, dist]))
            # through a corner / along an edge
            q = np.where(rng.integers(2, size=3) > 0, l, h).astype(np.float32)
            if rng.integers(2):
                b = rng.integers(3)
                q[b] = rng.uniform(l[b], h[b])
            d = unit(rng.normal(size=3))
            add((q - d * dist).astype(np.float32), d, rng.choice([1e16, dist]))
            # at the vertex that sets the face
            slots = sp[i][sp[i] >= 0]
            vs = corners[slots].reshape(-1, 3)
            v = vs[np.argmin(vs[:, a]) if face == l[a]
                   else np.argmax(vs[:, a])]
            d = unit(rng.normal(size=3))
            add((v - d * dist).astype(np.float32), d, rng.choice([1e16, dist]))
            # axis-parallel along a face, the other components +-0
            d = np.array([-0.0 if rng.integers(2) else 0.0 for _ in range(3)],
                         np.float32)
            b = (a + 1 + rng.integers(2)) % 3
            d[b] = 1.0 if rng.integers(2) else -1.0
            o = rng.uniform(l, h).astype(np.float32)
            o[a] = face
            o[b] = (l[b] - dist) if d[b] > 0 else (h[b] + dist)
            add(o, d)
            # a window that ends on the face
            o = (p + unit(rng.normal(size=3)) * dist).astype(np.float32)
            d = unit(p - o)
            if d[a] != 0:
                add(o, d, np.float32((face - o[a]) / d[a]))
    return np.stack(out)


def sc_lone_grazing_rays(geom, cl, member, seeds=range(4)):
    """Blocks of one live ray each: the grazing rays (sc_grazing_rays) that
    hold an accepted Woop hit in a member box their own slab test misses,
    each alone in its 256-ray block, so that member is outside the block
    union the plain walks test. → [n * 256, 8] f32 numpy (the other rays
    dead: all zero)."""
    from optix_raytracer_tpu_torch.accel import clusters as C
    m = member.shape[2]
    n_sc = cl.comp.shape[0] // m
    r8 = np.concatenate([sc_grazing_rays(geom, cl, member, seed=s, boxes=96)
                         for s in seeds])
    a = torch.as_tensor(r8, device=member.device)[None].expand(n_sc, -1, -1)
    rows = torch.arange(n_sc, device=member.device) * m
    accepted = torch.stack([
        C._pair_ok(cl.comp[rows + c], a, None, False)[0].any(dim=2)
        for c in range(m)], dim=2)
    cross = C._member_cross(a, member[:n_sc])
    lone = torch.nonzero((accepted & ~cross).any(dim=2).any(dim=0))[:, 0]
    out = np.zeros((len(lone) * 256, 8), np.float32)
    out[::256] = r8[lone.cpu().numpy()]
    return out


def lone_gated_rays(geom, cl, seeds=range(4)):
    """Blocks for the gate term of kernels 5 / 6: each holds a grazing ray
    (sc_grazing_rays on the cluster boxes) at lane 0, whose accepted Woop
    hit lies in a cluster X that its own slab test misses, and at lane 32 a
    ray through the middle of X's box, so that the exact cull lists X with
    the gate bit of group 1 set and that of group 0 clear; the other rays
    are dead (all zero). A gated plain walk never tests the grazing ray
    against X; an ungated one does, although the cull's entry bound for X
    comes from the other ray alone. At the supercluster tier X's
    supercluster is listed and X is in the block union. → [n * 256, 8] f32
    numpy."""
    from optix_raytracer_tpu_torch.accel import clusters as C
    boxes = C._entry_boxes(cl.aabb)[:cl.num_clusters]      # [C, 6, 1]
    r8 = np.concatenate([sc_grazing_rays(geom, cl, boxes, seed=s, boxes=96)
                         for s in seeds])
    a = torch.as_tensor(r8, device=boxes.device)[None]
    accepted = torch.stack([
        C._pair_ok(cl.comp[c:c + 1], a, None, False)[0].any(dim=2)[0]
        for c in range(cl.num_clusters)], dim=1)          # [N, C]
    cross = C._member_cross(a.expand(cl.num_clusters, -1, -1),
                            boxes)[:, :, 0].T                # [N, C]
    lone = (accepted & ~cross).cpu().numpy()
    rows = np.nonzero(lone.any(axis=1))[0]
    bx = boxes[:, :, 0].cpu().numpy()
    rng = np.random.default_rng(23)
    out = np.zeros((len(rows) * 256, 8), np.float32)
    for i, n in enumerate(rows):
        x = int(np.argmax(lone[n]))
        lo, hi = bx[x, 0:3], bx[x, 3:6]
        d = rng.normal(size=3)
        d = (d / np.linalg.norm(d)).astype(np.float32)
        o = (0.5 * (lo + hi) - d * (2.0 * float((hi - lo).max()) + 1.0))
        out[256 * i] = r8[n]
        out[256 * i + 32] = np.concatenate([o, d, [1e-3, 1e16]])
    return out


def queue_miss_rays(cl, n_boxes=8, seed=0):
    """Rays [n_boxes * 256, 8] f32 numpy for kernel 8's steps whose rays all
    miss: 256 from the centre of each of the first n_boxes cluster boxes,
    in random directions, with the window [0, 1e-4]. Each crosses its box
    (it starts inside), so the exact cull lists the box for all 32 octets
    and kernel 8 admits every ray of a whole step; no triangle lies within
    1e-4 of a centre, so none hits."""
    from optix_raytracer_tpu_torch.accel import clusters as C
    bx = C._entry_boxes(cl.aabb)[:n_boxes, :, 0].cpu().numpy()
    rng = np.random.default_rng(seed)
    o = np.repeat(0.5 * (bx[:, 0:3] + bx[:, 3:6]), 256, axis=0)
    d = rng.normal(size=o.shape)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    n = len(o)
    return np.concatenate([o, d, np.zeros((n, 1)), np.full((n, 1), 1e-4)],
                          axis=1).astype(np.float32)


def cull_edge_table(seed=0, c_pad=256):
    """A cull table [c_pad / 128, 6, 128] f32 numpy for kernels 4 / 7:
    random boxes in [-2, 2]^3, flat and point boxes (lo == hi on some
    axes), canonical padding boxes (lo = 3e38, hi = -3e38) both
    interleaved and as the table's tail, and two other inverted boxes (lo >
    hi on one axis), which no group box can hold."""
    rng = np.random.default_rng(seed)
    big = np.float32(3.0e38)
    lo = rng.uniform(-2, 2, (c_pad, 3)).astype(np.float32)
    hi = lo + rng.uniform(0, 0.6, (c_pad, 3)).astype(np.float32)
    hi[10:20, 1] = lo[10:20, 1]                       # flat boxes
    hi[20:24] = lo[20:24]                             # points
    pad = np.zeros(c_pad, bool)
    pad[[3, 37, 38, 39, 90, 131]] = True              # interleaved
    pad[c_pad - 40:] = True                           # the tail
    lo[pad], hi[pad] = big, -big
    for c in (45, 170):                               # inverted on x
        lo[c, 0], hi[c, 0] = hi[c, 0], lo[c, 0] - np.float32(0.1)
    boxes = np.concatenate([lo, hi], axis=1)          # [c_pad, 6]
    return np.ascontiguousarray(
        boxes.reshape(c_pad // 128, 128, 6).transpose(0, 2, 1))


def cull_edge_rays(aabb, seed=0, n=4096):
    """Rays [n, 8] f32 numpy (n a multiple of 256) for the exact cull's
    edge cases on a table aabb [rows, 6, 128]: direction components +0.0,
    -0.0, +-1e-12 (the pseudo-inverse's +-1e12) and just above it; rays in
    a real box's face plane along it, through its corners, and starting on
    a face; windows with tmax at 3e38 or inf, and dead lanes (tmax <=
    tmin). Block 2 is all dead; block 5 holds one live ray (lane 77)."""
    rng = np.random.default_rng(seed)
    boxes = aabb.transpose(0, 2, 1).reshape(-1, 6)
    real = np.nonzero((boxes[:, 0:3] <= boxes[:, 3:6]).all(axis=1))[0]
    lo_all, hi_all = boxes[real, 0:3].min(0), boxes[real, 3:6].max(0)
    span = hi_all - lo_all
    o = rng.uniform(lo_all - 0.3 * span, hi_all + 0.3 * span, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    tiny = np.array([0.0, -0.0, 1e-12, -1e-12, 1.5e-12, -1.5e-12],
                    np.float32)
    i = rng.choice(n, n // 6, replace=False)           # one axis tiny
    d[i, rng.integers(0, 3, i.size)] = rng.choice(tiny, i.size)
    i = rng.choice(n, n // 12, replace=False)          # two axes tiny
    ax = rng.integers(0, 3, i.size)
    d[i, ax] = rng.choice(tiny, i.size)
    d[i, (ax + 1) % 3] = rng.choice(tiny, i.size)
    # along a face: in the plane of a real box's face, that axis's
    # direction +-0, aimed at the face's centre
    g = rng.choice(n, n // 6, replace=False)
    b = rng.choice(real, g.size)
    ax = rng.integers(0, 3, g.size)
    side = rng.integers(0, 2, g.size)
    lo, hi = boxes[b, 0:3], boxes[b, 3:6]
    centre = 0.5 * (lo + hi)
    start = centre + rng.uniform(-2, 2, (g.size, 3)).astype(np.float32)
    rows = np.arange(g.size)
    start[rows, ax] = np.where(side == 0, lo[rows, ax], hi[rows, ax])
    aim = centre.copy()
    aim[rows, ax] = start[rows, ax]
    dd = aim - start
    dd /= np.maximum(np.linalg.norm(dd, axis=1, keepdims=True), 1e-6)
    dd[rows, ax] = np.where(rng.integers(0, 2, g.size) == 0, 0.0, -0.0)
    o[g], d[g] = start, dd.astype(np.float32)
    # through a corner, and starting on a face (the entry is +-0)
    c = rng.choice(np.setdiff1d(np.arange(n), g), n // 12, replace=False)
    b = rng.choice(real, c.size)
    corner = np.where(rng.integers(0, 2, (c.size, 3)) == 0, boxes[b, 0:3],
                      boxes[b, 3:6])
    half = c.size // 2
    o[c[:half]] = corner[:half] - 1.5 * d[c[:half]]
    o[c[half:]] = corner[half:]
    tmin = np.where(rng.random(n) < 0.2, 0.0, 1e-3).astype(np.float32)
    tmax = np.full(n, 50.0, np.float32)
    u = rng.random(n)
    tmax[u < 0.1] = 3.0e38
    tmax[(u >= 0.1) & (u < 0.15)] = np.inf
    tmax[(u >= 0.15) & (u < 0.25)] = 0.0                   # dead
    tmax[(u >= 0.25) & (u < 0.28)] = tmin[(u >= 0.25) & (u < 0.28)]  # dead
    tmax[512:768] = 0.0                                     # block 2
    tmax[1280:1536] = 0.0                                   # block 5 ...
    tmax[1280 + 77] = 50.0                                  # ... but one
    return np.concatenate([o, d, tmin[:, None], tmax[:, None]],
                          axis=1).astype(np.float32)


def group_box_table(boxes):
    """Group boxes [G, 8] → the cull's [rows, 6, 128] layout, padded with
    inverted boxes (cull_edge_rays reads the real ones)."""
    b = boxes[:, 0:6].cpu().numpy()
    rows = -(-b.shape[0] // 128)
    pad = np.tile(np.array([3e38, 3e38, 3e38, -3e38, -3e38, -3e38],
                           np.float32), (rows * 128 - b.shape[0], 1))
    return np.concatenate([b, pad]).reshape(rows, 128, 6).transpose(0, 2, 1)


def rays8(r8, device="cpu"):
    """Rays [N, 8] f32 numpy (o, d, tmin, tmax) → flat Rays."""
    r = torch.as_tensor(np.ascontiguousarray(r8, np.float32), device=device)
    return Rays(origin=r[:, 0:3].contiguous(),
                direction=r[:, 3:6].contiguous(), tmin=r[:, 6].contiguous(),
                tmax=r[:, 7].contiguous())


def bf_mesh(m, seed, dup=False, device="cpu"):
    """The brute-force kernels' test meshes: m random triangles in
    [-2, 2]^3 (one degenerate from 9 on); with dup, the second half repeats
    the first (exact ties across groups) and none is degenerate →
    (geometry, tri_mat)."""
    rng = np.random.default_rng(seed)
    k = -(-m // 2) if dup else m
    v0 = rng.uniform(-2, 2, (k, 3))
    e = rng.uniform(-0.8, 0.8, (2, k, 3))
    tris = np.stack([v0, v0 + e[0], v0 + e[1]], axis=1)
    if dup:
        tris = np.concatenate([tris, tris])[:m]
    elif m >= 9:
        tris[m // 2, 2] = tris[m // 2, 1]
    verts = tris.reshape(-1, 3).astype(np.float32)
    idx = np.arange(3 * m, dtype=np.int32).reshape(m, 3)
    geom = build_triangle_geometry(verts, idx, device)
    tri_mat = torch.as_tensor(rng.integers(0, 5, m).astype(np.int32),
                              device=device)
    return geom, tri_mat


def bf_rays(n, seed, dead=0.5, geom=None, device="cpu"):
    """Rays from around a bf_mesh toward it (with `geom`, half of them at
    its triangles' centroids), windows (1e-3 or 0, 2 to 1e16), a `dead`
    share of them with tmax <= tmin."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    tgt = rng.uniform(-1.5, 1.5, (n, 3))
    if geom is not None:
        c = (geom.v0 + (geom.e1 + geom.e2) / 3.0).cpu().numpy()
        half = rng.random(n) < 0.5
        tgt[half] = c[rng.integers(0, len(c), half.sum())]
    d = (tgt - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.where(rng.random(n) < 0.3, 0.0, 1e-3).astype(np.float32)
    tmax = rng.choice([1e16, 6.0, 2.0], n).astype(np.float32)
    gone = rng.random(n) < dead
    tmax[gone] = np.where(rng.random(gone.sum()) < 0.5, 0.0, tmin[gone])
    return rays8(np.concatenate([o, d, tmin[:, None], tmax[:, None]],
                                axis=1), device)


def tie_rays(geom, seed=6, device="cpu"):
    """Rays at a bf_mesh's triangle centroids and first two vertices from
    random points around them (exact ties on a dup mesh, edge crossings)."""
    rng = np.random.default_rng(seed)
    tgt = torch.cat([geom.v0 + (geom.e1 + geom.e2) / 3.0, geom.v0,
                     geom.v0 + geom.e1]).cpu().numpy()
    o = (tgt + rng.normal(size=tgt.shape) * 3.0).astype(np.float32)
    d = (tgt - o) / np.linalg.norm(tgt - o, axis=1, keepdims=True)
    return rays8(np.concatenate([o, d, np.full((len(o), 1), 1e-3),
                                 np.full((len(o), 1), 1e16)], axis=1),
                 device)


def hair_bytes(points, segments=None, thickness=None, default=0.02):
    """A .hair file (cem-yuksel format): flags 1 segments, 2 points, 4
    thickness; the 128-byte header. Both packages' readers take the default
    thickness at byte 40 (curves.py:145), not at the format's byte 20: the
    default goes there (ROADMAP.md Queue 3)."""
    flags = 2 | (1 if segments is not None else 0) | (
        4 if thickness is not None else 0)
    n_strands = len(segments) if segments is not None else 2
    header = struct.pack("<4sIIIIIII", b"HAIR", n_strands, len(points), flags,
                         len(points) // n_strands - 1, 0, 0, 0)
    header += b"\x00" * (40 - len(header)) + struct.pack("<f", default)
    header += b"\x00" * (128 - len(header))
    blob = header
    if segments is not None:
        blob += np.asarray(segments, np.uint16).tobytes()
    blob += np.asarray(points, np.float32).tobytes()
    if thickness is not None:
        blob += np.asarray(thickness, np.float32).tobytes()
    return blob


def assert_image_close(out, ref, what, atol=2e-3, rtol=1e-3):
    """Images (any [..., 3]) within atol / rtol: the pixels outside the bar
    are counted, and none may be (the count and the largest difference in
    the message)."""
    from optix_raytracer_tpu_torch.tools.mcv_probe import outside_bar
    bad, worst = outside_bar(out, ref, atol, rtol)
    assert bad == 0, (f"{what}: {bad} pixels outside atol {atol} / rtol "
                      f"{rtol} (max {worst:.3g})")

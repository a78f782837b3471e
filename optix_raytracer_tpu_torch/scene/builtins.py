"""The Cornell box (flat and instanced), the Whitted scene, the trefoil-knot
scene (and the knot as a host Scene, which the meshviewer lights), the
bench's prims, PBR and textured scenes, the fused kernel's mix scenes, the
alpha-cutout scenes and their cameras (counterpart of
`scene/builtins.py:18-274`, of `apps/cutouts.py:24-89` and of the scenes
`bench.py:153-202, 205-246, 418-450, 517-550` builds inline; the textured
cutout Cornell and the textured Whitted scene are the port's own, made of
the reference's features), and the SPD `tetra` pyramid, the port's own
large-mesh scene from a public benchmark.

The data tables are a copy of the JAX package's (a CPU test holds them
equal): the JAX module cannot be imported without JAX.
"""
from __future__ import annotations

import math

import numpy as np

from ..accel import primitives as prim
from ..core.camera import Camera
from ..shade import materials as mat
from ..shade.lights import AMBIENT, POINT, ParallelogramLight
from .device_scene import DeviceScene, make_device_scene
from .scene import Scene

# Material ids for the Cornell box
WHITE, GREEN, RED, LIGHT = 0, 1, 2, 3

CORNELL_MATERIALS = [
    {"kind": mat.DIFFUSE, "base_color": (0.80, 0.80, 0.80)},                     # white
    {"kind": mat.DIFFUSE, "base_color": (0.05, 0.80, 0.05)},                     # green
    {"kind": mat.DIFFUSE, "base_color": (0.80, 0.05, 0.05)},                     # red
    {"kind": mat.DIFFUSE, "base_color": (0.78, 0.78, 0.78),
     "emission": (15.0, 15.0, 15.0)},                                            # lamp
]

# Quads as (4 corner points, material): the classic Cornell measurement data.
_CORNELL_QUADS = [
    # floor
    ([(552.8, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 559.2), (549.6, 0.0, 559.2)], WHITE),
    # ceiling
    ([(556.0, 548.8, 0.0), (556.0, 548.8, 559.2), (0.0, 548.8, 559.2), (0.0, 548.8, 0.0)], WHITE),
    # back wall
    ([(549.6, 0.0, 559.2), (0.0, 0.0, 559.2), (0.0, 548.8, 559.2), (556.0, 548.8, 559.2)], WHITE),
    # right wall (green)
    ([(0.0, 0.0, 559.2), (0.0, 0.0, 0.0), (0.0, 548.8, 0.0), (0.0, 548.8, 559.2)], GREEN),
    # left wall (red)
    ([(552.8, 0.0, 0.0), (549.6, 0.0, 559.2), (556.0, 548.8, 559.2), (556.0, 548.8, 0.0)], RED),
    # short block
    ([(130.0, 165.0, 65.0), (82.0, 165.0, 225.0), (240.0, 165.0, 272.0), (290.0, 165.0, 114.0)], WHITE),
    ([(290.0, 0.0, 114.0), (290.0, 165.0, 114.0), (240.0, 165.0, 272.0), (240.0, 0.0, 272.0)], WHITE),
    ([(130.0, 0.0, 65.0), (130.0, 165.0, 65.0), (290.0, 165.0, 114.0), (290.0, 0.0, 114.0)], WHITE),
    ([(82.0, 0.0, 225.0), (82.0, 165.0, 225.0), (130.0, 165.0, 65.0), (130.0, 0.0, 65.0)], WHITE),
    ([(240.0, 0.0, 272.0), (240.0, 165.0, 272.0), (82.0, 165.0, 225.0), (82.0, 0.0, 225.0)], WHITE),
    # tall block
    ([(423.0, 330.0, 247.0), (265.0, 330.0, 296.0), (314.0, 330.0, 456.0), (472.0, 330.0, 406.0)], WHITE),
    ([(423.0, 0.0, 247.0), (423.0, 330.0, 247.0), (472.0, 330.0, 406.0), (472.0, 0.0, 406.0)], WHITE),
    ([(472.0, 0.0, 406.0), (472.0, 330.0, 406.0), (314.0, 330.0, 456.0), (314.0, 0.0, 456.0)], WHITE),
    ([(314.0, 0.0, 456.0), (314.0, 330.0, 456.0), (265.0, 330.0, 296.0), (265.0, 0.0, 296.0)], WHITE),
    ([(265.0, 0.0, 296.0), (265.0, 330.0, 296.0), (423.0, 330.0, 247.0), (423.0, 0.0, 247.0)], WHITE),
    # ceiling light (slightly below the ceiling)
    ([(343.0, 548.6, 227.0), (213.0, 548.6, 227.0), (213.0, 548.6, 332.0), (343.0, 548.6, 332.0)], LIGHT),
]

CORNELL_LIGHT_CORNER = (343.0, 548.6, 227.0)
CORNELL_LIGHT_V1 = (-130.0, 0.0, 0.0)
CORNELL_LIGHT_V2 = (0.0, 0.0, 105.0)
CORNELL_LIGHT_EMISSION = (15.0, 15.0, 15.0)


def quads_to_triangles(quads):
    """[(4 points, mat_id)] → (vertices [V,3], indices [2Q,3], tri_mat [2Q])."""
    verts, idx, tri_mat = [], [], []
    for corners, m in quads:
        base = len(verts)
        verts.extend(corners)
        idx.append((base + 0, base + 1, base + 2))
        idx.append((base + 0, base + 2, base + 3))
        tri_mat.extend([m, m])
    return (np.asarray(verts, np.float32), np.asarray(idx, np.int32),
            np.asarray(tri_mat, np.int32))


def cornell_box(device) -> DeviceScene:
    verts, idx, tri_mat = quads_to_triangles(_CORNELL_QUADS)
    light = ParallelogramLight.make(
        CORNELL_LIGHT_CORNER, CORNELL_LIGHT_V1, CORNELL_LIGHT_V2,
        CORNELL_LIGHT_EMISSION, device)
    return make_device_scene(verts, idx, tri_mat, CORNELL_MATERIALS, device,
                             area_light=light, miss_color=(0.0, 0.0, 0.0))


def cornell_box_instanced(device) -> DeviceScene:
    """The Cornell box as a two-level scene (scene/builtins.py:87-133): the
    walls and the light are one instance (12 triangles), the two blocks are
    transformed instances of one shared 10-triangle unit box (no bottom
    face); 22 shared triangles, 3 instances whose ranges sum to 32. The
    block transforms are affine frames of the measured block tops, so the
    image differs from cornell_box()'s by a sliver at the block edges."""
    from .scene import Scene
    sc = Scene()
    sc.miss_color = (0.0, 0.0, 0.0)
    for m in CORNELL_MATERIALS:
        sc.add_material(dict(m))
    verts, idx, tri_mat = quads_to_triangles(_CORNELL_QUADS[:5]
                                             + [_CORNELL_QUADS[15]])
    room = sc.add_mesh(verts, idx, material=tri_mat)
    box_quads = [
        ([(0, 1, 0), (0, 1, 1), (1, 1, 1), (1, 1, 0)], 0),   # top
        ([(1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 0, 1)], 0),
        ([(0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 0, 0)], 0),
        ([(0, 0, 1), (0, 1, 1), (0, 1, 0), (0, 0, 0)], 0),
        ([(1, 0, 1), (1, 1, 1), (0, 1, 1), (0, 0, 1)], 0),
    ]
    bverts, bidx, _ = quads_to_triangles(box_quads)
    box = sc.add_mesh(bverts, bidx, material=WHITE)

    def frame(origin, x, y, z):
        t = np.eye(4, dtype=np.float32)
        t[:3, 0], t[:3, 1], t[:3, 2], t[:3, 3] = x, y, z, origin
        return t

    sc.add_instance(room, np.eye(4, dtype=np.float32))
    sc.add_instance(box, frame((130, 0, 65), (160, 0, 49),
                               (0, 165, 0), (-48, 0, 160)))     # short block
    sc.add_instance(box, frame((423, 0, 247), (49, 0, 159),
                               (0, 330, 0), (-158, 0, 49)))     # tall block
    light = ParallelogramLight.make(
        CORNELL_LIGHT_CORNER, CORNELL_LIGHT_V1, CORNELL_LIGHT_V2,
        CORNELL_LIGHT_EMISSION, device)
    return sc.finalize(device, area_light=light)


def cornell_camera(width, height) -> Camera:
    """The classic Cornell viewpoint: eye in front of the open face, 35°
    vertical field of view."""
    return Camera(eye=(278.0, 273.0, -900.0), lookat=(278.0, 273.0, 330.0),
                  up=(0.0, 1.0, 0.0), fov_y=35.0, aspect=width / height)


def trefoil_mesh(segments: int = 140, sides: int = 45, tube_radius=0.35,
                 scale=1.0):
    """Procedural trefoil-knot tube: 2*segments*sides triangles with smooth
    per-vertex normals → (vertices [V,3] f32, indices [M,3] i32,
    normals [V,3] f32)."""
    t = np.linspace(0.0, 2.0 * np.pi, segments, endpoint=False)
    # Trefoil curve + analytic tangent.
    p = np.stack([np.sin(t) + 2.0 * np.sin(2.0 * t),
                  np.cos(t) - 2.0 * np.cos(2.0 * t),
                  -np.sin(3.0 * t)], axis=1)
    dp = np.stack([np.cos(t) + 4.0 * np.cos(2.0 * t),
                   -np.sin(t) + 4.0 * np.sin(2.0 * t),
                   -3.0 * np.cos(3.0 * t)], axis=1)
    tan = dp / np.linalg.norm(dp, axis=1, keepdims=True)
    # Stable frame: project a fixed up-ish vector out of the tangent.
    ref = np.tile(np.array([0.37, 0.61, 0.71]), (segments, 1))
    n = ref - np.sum(ref * tan, axis=1, keepdims=True) * tan
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    b = np.cross(tan, n)

    phi = np.linspace(0.0, 2.0 * np.pi, sides, endpoint=False)
    ring = (np.cos(phi)[None, :, None] * n[:, None, :]
            + np.sin(phi)[None, :, None] * b[:, None, :])   # [S, sides, 3]
    verts = (p[:, None, :] + tube_radius * ring) * scale
    normals = ring.reshape(-1, 3).astype(np.float32)
    verts = verts.reshape(-1, 3).astype(np.float32)

    ii, jj = np.meshgrid(np.arange(segments), np.arange(sides),
                         indexing="ij")
    i2 = (ii + 1) % segments
    j2 = (jj + 1) % sides
    a = ii * sides + jj
    b_ = ii * sides + j2
    c = i2 * sides + jj
    d = i2 * sides + j2
    tri1 = np.stack([a, b_, d], axis=-1).reshape(-1, 3)
    tri2 = np.stack([a, d, c], axis=-1).reshape(-1, 3)
    idx = np.stack([tri1, tri2], axis=1).reshape(-1, 3)
    return verts, np.asarray(idx, np.int32), normals


KNOT_MATERIALS = [
    {"kind": mat.DIFFUSE, "base_color": (0.75, 0.55, 0.25)},  # knot
    {"kind": mat.DIFFUSE, "base_color": (0.65, 0.65, 0.70)},  # floor
]


def knot_mesh(segments: int = 140, sides: int = 45):
    """knot_scene's geometry: the trefoil tube and a two-triangle floor under
    it → (vertices [V, 3], indices [M, 3], normals [V, 3], tri_mat [M]:
    material 0 on the knot, 1 on the floor, the light's (corner, v1, v2))."""
    verts, idx, normals = trefoil_mesh(segments, sides)
    lo = verts.min(axis=0)
    hi = verts.max(axis=0)
    ext = float(np.max(hi - lo))
    fy = lo[1] - 0.1 * ext
    f0 = len(verts)
    floor = np.array([
        [lo[0] - ext, fy, lo[2] - ext], [hi[0] + ext, fy, lo[2] - ext],
        [hi[0] + ext, fy, hi[2] + ext], [lo[0] - ext, fy, hi[2] + ext]],
        np.float32)
    verts = np.concatenate([verts, floor])
    normals = np.concatenate(
        [normals, np.tile(np.array([[0, 1, 0]], np.float32), (4, 1))])
    idx = np.concatenate([idx, np.array(
        [[f0, f0 + 2, f0 + 1], [f0, f0 + 3, f0 + 2]], np.int32)])
    tri_mat = np.concatenate([
        np.zeros(len(idx) - 2, np.int32), np.ones(2, np.int32)])
    ly = hi[1] + 1.2 * ext
    light = ((lo[0], ly, lo[2]), (hi[0] - lo[0], 0.0, 0.0),
             (0.0, 0.0, hi[2] - lo[2]))
    return verts, idx, normals, tri_mat, light


def knot_scene(segments: int = 140, sides: int = 45, *,
               device, smooth=True) -> DeviceScene:
    """Large-mesh scene: a trefoil-knot tube (2*segments*sides smooth
    triangles) over a two-triangle floor, lit by an overhead parallelogram
    light. smooth=False drops the vertex normals (a flat mesh)."""
    verts, idx, normals, tri_mat, light = knot_mesh(segments, sides)
    light = ParallelogramLight.make(*light, (10.0, 10.0, 10.0), device)
    return make_device_scene(verts, idx, tri_mat, KNOT_MATERIALS, device,
                             area_light=light,
                             normals=normals if smooth else None,
                             miss_color=(0.0, 0.0, 0.0))


def knot_host_scene(segments: int = 140, sides: int = 45) -> Scene:
    """knot_scene's geometry and materials with its smooth normals as a host
    Scene (one mesh, per-triangle materials, no lights): what the
    meshviewer renders in place of a loaded model."""
    verts, idx, normals, tri_mat, _ = knot_mesh(segments, sides)
    sc = Scene()
    for m in KNOT_MATERIALS:
        sc.add_material(m)
    sc.add_mesh(verts, idx, normals=normals, material=tri_mat, name="knot")
    return sc


# The Whitted scene (scene/builtins.py:144-183): a checker parallelogram
# floor, a glass sphere shell and a phong sphere, one point and one ambient
# light, beside one degenerate triangle.
WHITTED_MATERIALS = [
    # 0: checkered phong floor
    {"kind": mat.CHECKER, "base_color": (0.8, 0.3, 0.15),
     "checker1": (0.9, 0.85, 0.05), "checker_scale": 16.0,
     "specular": (0.2, 0.2, 0.2), "phong_exp": 32.0, "kr": (0.1, 0.1, 0.1)},
    # 1: glass sphere shell
    {"kind": mat.GLASS, "ior": 1.4, "kr": (0.9, 0.9, 0.9)},
    # 2: blue phong sphere with a mirror-ish highlight
    {"kind": mat.PHONG, "base_color": (0.1, 0.2, 0.7),
     "specular": (0.5, 0.5, 0.5), "phong_exp": 64.0,
     "kr": (0.25, 0.25, 0.25)},
]
WHITTED_PRIMS = [
    {"kind": prim.PARALLELOGRAM, "mat_id": 0, "anchor": (-16.0, 0.01, -8.0),
     "v1": (32.0, 0.0, 0.0), "v2": (0.0, 0.0, 16.0)},
    {"kind": prim.SPHERE_SHELL, "mat_id": 1, "center": (2.0, 1.5, -2.5),
     "radius_inner": 0.96, "radius_outer": 1.0},
    {"kind": prim.SPHERE, "mat_id": 2, "center": (4.5, 1.0, -4.0),
     "radius": 1.0},
]
WHITTED_LIGHTS = [
    {"kind": POINT, "position": (60.0, 40.0, 0.0), "color": (1.0, 1.0, 1.0),
     "falloff": 0},
    {"kind": AMBIENT, "color": (0.35, 0.35, 0.35)},
]
WHITTED_MISS = (0.34, 0.55, 0.85)


def whitted_scene(device) -> DeviceScene:
    """The Whitted classic: glass sphere shell and phong sphere over a
    checkered floor, a point and an ambient light. Its one triangle is
    degenerate (zero area, never hit)."""
    return make_device_scene(np.zeros((3, 3), np.float32),
                             np.zeros((1, 3), np.int32),
                             np.zeros(1, np.int32), WHITTED_MATERIALS, device,
                             prims=prim.make_prims(WHITTED_PRIMS, device),
                             lights=WHITTED_LIGHTS, miss_color=WHITTED_MISS)


def whitted_camera(width, height) -> Camera:
    return Camera(eye=(8.0, 2.0, 1.0), lookat=(3.0, 1.1, -3.0),
                  up=(0.0, 1.0, 0.0), fov_y=45.0, aspect=width / height)


def knot_camera(width, height) -> Camera:
    return Camera(eye=(0.0, 2.5, -9.0), lookat=(0.0, 0.0, 0.0),
                  up=(0.0, 1.0, 0.0), fov_y=45.0, aspect=width / height)


# bench.py:167-188 (whitted_prims): a floor quad, one prim of each kind 0-3
# and a glass material for the shell, under a parallelogram area light.
PRIMS_FLOOR = 4.0
PRIMS_LIST = [
    {"kind": prim.SPHERE, "center": (-1.2, 0.7, 0.0), "radius": 0.7,
     "mat_id": 1},
    {"kind": prim.SPHERE_SHELL, "center": (0.6, 0.8, 0.5),
     "radius_inner": 0.4, "radius_outer": 0.6, "mat_id": 3},
    {"kind": prim.PARALLELOGRAM, "anchor": (-0.5, 1.8, -1.0),
     "v1": (1.5, 0.0, 0.0), "v2": (0.0, 0.0, 1.2), "mat_id": 2},
    {"kind": prim.CAPSULE, "p0": (1.2, 0.3, -1.2),
     "p1": (2.0, 1.2, -0.8), "radius": 0.25, "mat_id": 2},
]
PRIMS_MATERIALS = [
    {"kind": mat.DIFFUSE, "base_color": (0.75, 0.75, 0.75)},
    {"kind": mat.DIFFUSE, "base_color": (0.8, 0.3, 0.2)},
    {"kind": mat.DIFFUSE, "base_color": (0.2, 0.4, 0.8)},
    {"kind": mat.GLASS, "base_color": (0.95, 0.95, 0.95), "ior": 1.5},
]
PRIMS_LIGHT = ((-1.0, 3.5, -1.0), (2.0, 0, 0), (0, 0, 2.0),
               (10.0, 10.0, 10.0))
# bench.py:434-435: the Cornell white material made rough metal.
PBR_CORNELL_COLOR = (0.8, 0.6, 0.3)


def prims_floor():
    """The prims scene's floor → (vertices [4, 3], indices [2, 3])."""
    s = PRIMS_FLOOR
    verts = np.array([[-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s]],
                     np.float32)
    return verts, np.array([[0, 1, 2], [0, 2, 3]], np.int32)


def prims_list(with_glass=True):
    """PRIMS_LIST; with_glass=False makes the shell diffuse (material 1),
    the glass-free case of tests/test_fused_kernel.py:183-215."""
    out = [dict(p) for p in PRIMS_LIST]
    if not with_glass:
        out[1]["mat_id"] = 1
    return out


def prims_scene(device, with_glass=True) -> DeviceScene:
    """bench.py's whitted_prims scene: custom prims over a floor mesh, path
    traced (the fused kernel's inline prim intersectors)."""
    verts, idx = prims_floor()
    mats = PRIMS_MATERIALS if with_glass else PRIMS_MATERIALS[:3]
    light = ParallelogramLight.make(*PRIMS_LIGHT, device)
    return make_device_scene(verts, idx, np.zeros(2, np.int32), mats, device,
                             area_light=light,
                             prims=prim.make_prims(prims_list(with_glass),
                                                   device))


def prims_camera(width, height) -> Camera:
    return Camera(eye=(0, 1.6, -5.5), lookat=(0, 0.8, 0), up=(0, 1, 0),
                  fov_y=40.0, aspect=width / height)


def pbr_cornell_materials(metallic=0.8, roughness=0.35):
    """CORNELL_MATERIALS with the white material made PBR (bench.py:433-435);
    metallic > 0.99 with roughness <= 0.05 makes it a mirror."""
    mats = [dict(m) for m in CORNELL_MATERIALS]
    mats[WHITE] = {"kind": mat.PBR, "base_color": PBR_CORNELL_COLOR,
                   "metallic": metallic, "roughness": roughness}
    return mats


def pbr_cornell(device, metallic=0.8, roughness=0.35) -> DeviceScene:
    """bench.py's pbr_ggx scene: the Cornell box with rough-metal white
    surfaces (the fused kernel's PBR lanes); pbr_cornell(device, 1.0, 0.02)
    is the mirror Cornell (its mirror lanes)."""
    verts, idx, tri_mat = quads_to_triangles(_CORNELL_QUADS)
    light = ParallelogramLight.make(
        CORNELL_LIGHT_CORNER, CORNELL_LIGHT_V1, CORNELL_LIGHT_V2,
        CORNELL_LIGHT_EMISSION, device)
    return make_device_scene(verts, idx, tri_mat,
                             pbr_cornell_materials(metallic, roughness),
                             device, area_light=light)


# A rough PBR material of the fused kernel's mix scenes.
MIX_ROUGH = {"kind": mat.PBR, "base_color": (0.7, 0.7, 0.6), "metallic": 0.6,
             "roughness": 0.4}


def smooth_quad(mats, tri_mat, device):
    """tests/test_fused_textures.py:115-134's smooth quad (a floor with up
    normals, a tilted quad with leaning vertex normals) with the given
    materials → (scene, camera)."""
    s = 3.0
    verts = np.array([[-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s],
                      [-1, 0, -0.5], [1, 0, -0.5],
                      [1, 1.6, -0.5], [-1, 1.6, -0.5]], np.float32)
    idx = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7]], np.int32)
    normals = np.zeros((8, 3), np.float32)
    normals[:4] = (0, 1, 0)
    nr = np.array([0.3, 0.2, -0.93], np.float32)
    normals[4:] = nr / np.linalg.norm(nr)
    light = ParallelogramLight.make((-1.0, 3.0, -1.0), (2, 0, 0), (0, 0, 2),
                                    (8.0, 8.0, 8.0), device)
    scene = make_device_scene(verts, idx, np.asarray(tri_mat, np.int32), mats,
                              device, area_light=light, normals=normals)
    return scene, lambda w, h: Camera(eye=(0, 1.5, -4.5), lookat=(0, 0.6, 0),
                                      up=(0, 1, 0), fov_y=45.0, aspect=w / h)


# The fused kernel's headline frames (width, height, samples per launch,
# depth): the Cornell scenes and the prims scene at bench.py:18-21's, the
# smooth knot_scene(16, 15) (482 triangles) at the knot headline's depth
# (bench.py:299-304), the textured scene at its own (bench.py:219-259).
HEADLINE_FRAME = (1920, 1088, 16, 4)
SMOOTH_KNOT_MESH = (16, 15)
SMOOTH_KNOT_FRAME = (1920, 1088, 16, 3)
TEXTURED_FRAME = (1920, 1088, 4, 3)


# The fused kernel's instantiations (kernels.pt_fused_name) that no bench
# scene takes, and fused_mix_scene's scene for each.
FUSED_MIXES = ("pt_fused_prims", "pt_fused_pbr_prims", "pt_fused_specular_pbr",
               "pt_fused_specular_pbr_prims", "pt_fused_smooth_pbr",
               "pt_fused_smooth_specular")


def fused_mix_scene(name, device):
    """A scene for the fused kernel's instantiation `name` (one of
    FUSED_MIXES) → (scene, camera): the prims scene without glass, or with a
    rough PBR floor (and glass); the PBR Cornell with a glass wall and a
    mirror wall; the smooth quad with a PBR or a glass material."""
    if name == "pt_fused_smooth_pbr":
        return smooth_quad([MIX_ROUGH], [0, 0, 0, 0], device)
    if name == "pt_fused_smooth_specular":
        return smooth_quad([{"kind": mat.DIFFUSE,
                             "base_color": (0.7, 0.5, 0.4)},
                            {"kind": mat.GLASS,
                             "base_color": (0.95, 0.95, 0.95), "ior": 1.5}],
                           [0, 0, 1, 1], device)
    if name == "pt_fused_specular_pbr":
        mats = pbr_cornell_materials()
        mats[GREEN] = {"kind": mat.GLASS, "base_color": (0.9, 1.0, 0.9),
                       "ior": 1.45}
        mats[RED] = {"kind": mat.PBR, "base_color": (0.9, 0.2, 0.2),
                     "metallic": 1.0, "roughness": 0.0}
        verts, idx, tri_mat = quads_to_triangles(_CORNELL_QUADS)
        light = ParallelogramLight.make(
            CORNELL_LIGHT_CORNER, CORNELL_LIGHT_V1, CORNELL_LIGHT_V2,
            CORNELL_LIGHT_EMISSION, device)
        return (make_device_scene(verts, idx, tri_mat, mats, device,
                                  area_light=light), cornell_camera)
    if name not in FUSED_MIXES:
        raise ValueError(f"no mix scene for {name}; one of {FUSED_MIXES}")
    glass = "specular" in name
    mats = [dict(m) for m in PRIMS_MATERIALS]
    if "pbr" in name:
        mats[0] = MIX_ROUGH
    if not glass:
        mats = mats[:3]
    verts, idx = prims_floor()
    scene = make_device_scene(
        verts, idx, np.zeros(2, np.int32), mats, device,
        area_light=ParallelogramLight.make(*PRIMS_LIGHT, device),
        prims=prim.make_prims(prims_list(glass), device))
    return scene, prims_camera


# The textured scene's cells a quad side in fused_variant_scene(culled=True):
# 4 * 8² = 256 triangles, culled in groups of pallas_pt.FUSED_GROUP.
CULLED_TEX_GRID = 8


def fused_variant_scene(name, device, culled=False):
    """A scene for any of the fused kernel's 32 instantiations (`name` =
    kernels.pt_fused_name(specular, pbr, prims, geometry)) → (scene,
    camera): the Cornell box (flat), the instanced Cornell (inst),
    knot_scene(8, 6) (smooth) or the textured scene with its base map alone
    at 32 / 16 / 16 / 8 (tex; its PBR material made diffuse unless pbr),
    with a glass material (specular) on every fifth triangle from the
    second, a rough PBR one (pbr) on every fifth from the third, and the
    prims scene's four prims (prims; glass-free, materials clamped to the
    table). These tables are small enough that the kernel tests them whole;
    culled=True takes tables it cuts into groups instead (outside
    instances): knot_scene(16, 15) (482 triangles; flat: without its
    normals) or the textured scene cut into CULLED_TEX_GRID² cells a quad
    (4 CULLED_TEX_GRID² triangles)."""
    import dataclasses

    import torch
    flags = dict(specular=False, pbr=False, prims=False)
    geometry = "flat"
    for part in name[len("pt_fused_"):].split("_"):
        if part in ("inst", "smooth", "tex"):
            geometry = part
        elif part in flags:
            flags[part] = True
    if geometry == "inst":
        scene, camera = cornell_box_instanced(device), cornell_camera
    elif geometry == "tex":
        scene = textured_scene(device, (32, 16, 16, 8), 0.6, 0.8, maps="base",
                               grid=CULLED_TEX_GRID if culled else 1)
        camera = textured_camera
    elif geometry == "smooth" or culled:
        scene = knot_scene(*((16, 15) if culled else (8, 6)), device=device,
                           smooth=geometry == "smooth")
        camera = knot_camera
    else:
        scene, camera = cornell_box(device), cornell_camera
    mats = dataclasses.replace(scene.materials)
    if not flags["pbr"]:
        mats.kind = torch.where(mats.kind == mat.PBR, mat.DIFFUSE, mats.kind)
    extra = []
    if flags["specular"]:
        extra.append({"kind": mat.GLASS, "base_color": (0.95, 0.95, 0.95),
                      "ior": 1.5})
    if flags["pbr"]:
        extra.append(dict(MIX_ROUGH))
    tri_mat = scene.tri_mat.clone()
    k = mats.num
    if extra:
        more = mat.make_material_table(extra, device)
        for f in dataclasses.fields(mats):
            setattr(mats, f.name, torch.cat([getattr(mats, f.name),
                                             getattr(more, f.name)]))
        idx = torch.arange(scene.num_triangles, device=device)
        for j in range(len(extra)):
            tri_mat = torch.where(idx % 5 == 1 + j, k + j, tri_mat)
    if scene.has_instances and int(scene.instances.sbt_offset.max()) != 0:
        raise ValueError("the instanced base scene has sbt offsets")
    prims = scene.prims
    if flags["prims"]:
        plist = prims_list(False)
        for p in plist:
            p["mat_id"] = min(p["mat_id"], mats.num - 1)
        prims = prim.make_prims(plist, device)
    features = tuple(f for f, on in (("glass", flags["specular"]),
                                     ("pbr", flags["pbr"])) if on)
    tex_flags = scene.mat_tex_flags
    if tex_flags:
        tex_flags = tex_flags + ((-1, False, False, False, False),) * len(
            extra)
    scene = dataclasses.replace(
        scene, materials=mats, tri_mat=tri_mat.to(torch.int32), prims=prims,
        features=features, mat_tex_flags=tex_flags)
    return scene, camera


# bench.py:219-246 (bench_textured): the maps' sizes (base, normal,
# metallic-roughness, emissive); tests/test_fused_textures.py:29-63 makes the
# same scene with maps of (32, 16, 16, 8), metallic 0.6 and roughness 0.8.
TEXTURED_SIZES = (256, 128, 128, 64)


def textured_maps(sizes=TEXTURED_SIZES):
    """The textured scene's four maps from seed 7, drawn in the bench's
    order: base color U(0.1, 0.9), a tangent-space normal map (N(0, 0.2) x
    and y, z = 1, normalised, stored as n / 2 + 1/2), a metallic-roughness
    map U(0, 1) and an emissive map U(0, 0.2), each [s, s, 3] f32."""
    rng = np.random.default_rng(7)
    sb, sn, sm, se = sizes
    base = rng.uniform(0.1, 0.9, (sb, sb, 3)).astype(np.float32)
    nm = rng.normal(0, 0.2, (sn, sn, 3)).astype(np.float32)
    nm[..., 2] = 1.0
    nm /= np.linalg.norm(nm, axis=-1, keepdims=True)
    normal = (nm * 0.5 + 0.5).astype(np.float32)
    mr = rng.uniform(0, 1, (sm, sm, 3)).astype(np.float32)
    emissive = rng.uniform(0, 0.2, (se, se, 3)).astype(np.float32)
    return [base, normal, mr, emissive]


def _grid_quads(verts, uvs, normals, quads, n):
    """Each quad (corners a, b, c, d of `verts`, a parallelogram, its
    triangles (a, x, y), (a, y', z) as `quads` gives them) cut into n x n
    cells with the same winding, the uvs and normals interpolated →
    (vertices, indices, uvs, normals or None)."""
    out_v, out_i, out_uv, out_n = [], [], [], []
    s = np.linspace(0.0, 1.0, n + 1, dtype=np.float32)
    for (a, b, c, d), tris in quads:
        base = sum(len(v) for v in out_v)
        w0 = (1 - s)[:, None, None] * (1 - s)[None, :, None]
        w1 = s[:, None, None] * (1 - s)[None, :, None]
        w2 = s[:, None, None] * s[None, :, None]
        w3 = (1 - s)[:, None, None] * s[None, :, None]

        def lerp(x):
            return (w0 * x[a] + w1 * x[b] + w2 * x[c] + w3 * x[d]).reshape(
                -1, x.shape[1]).astype(np.float32)
        out_v.append(lerp(verts))
        out_uv.append(lerp(uvs))
        if normals is not None:
            out_n.append(lerp(normals))
        i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        corner = {a: i * (n + 1) + j, b: (i + 1) * (n + 1) + j,
                  c: (i + 1) * (n + 1) + j + 1, d: i * (n + 1) + j + 1}
        for t in tris:
            out_i.append(np.stack([corner[k] for k in t], -1).reshape(-1, 3)
                         + base)
    cells = np.concatenate(out_i).reshape(len(quads), 2, n * n, 3)
    idx = cells.transpose(0, 2, 1, 3).reshape(-1, 3)
    return (np.concatenate(out_v), idx.astype(np.int32),
            np.concatenate(out_uv),
            np.concatenate(out_n) if normals is not None else None)


def textured_scene(device, sizes=TEXTURED_SIZES, metallic=1.0, roughness=1.0,
                   smooth=False, maps="all", grid=1) -> DeviceScene:
    """bench.py's textured scene: a 6x6 floor with its uvs tiled 4x and a
    2 x 1.6 upright quad tiled 2x (4 triangles), one PBR material with
    base-color, normal, metallic-roughness and emissive maps (white base,
    emission 1), under a parallelogram light; the maps make one 16-channel
    bundle of 256x256 texels and 9 mip levels. smooth=True gives the floor
    up normals and the quad leaning vertex normals, maps="base" keeps the
    base-color map alone (tests/test_fused_textures.py:29-63). grid > 1
    cuts each quad into grid x grid cells of two triangles (4 grid²
    triangles, the surfaces and their uvs unchanged)."""
    s = 3.0
    verts = np.array([[-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s],
                      [-1.0, 0.0, -0.5], [1.0, 0.0, -0.5],
                      [1.0, 1.6, -0.5], [-1.0, 1.6, -0.5]], np.float32)
    idx = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7]], np.int32)
    uvs = np.array([[0, 0], [4, 0], [4, 4], [0, 4],
                    [0, 0], [2, 0], [2, 2], [0, 2]], np.float32)
    normals = None
    if smooth:
        normals = np.zeros((8, 3), np.float32)
        normals[:4] = (0, 1, 0)
        nr = np.array([0.3, 0.2, -0.93], np.float32)
        normals[4:] = nr / np.linalg.norm(nr)
    m = {"kind": mat.PBR, "base_color": (1, 1, 1), "base_tex": 0,
         "emission": (1.0, 1.0, 1.0), "metallic": metallic,
         "roughness": roughness}
    if maps == "all":
        m.update(normal_tex=1, mr_tex=2, emissive_tex=3)
    light = ParallelogramLight.make((-1.0, 3.0, -1.0), (2, 0, 0), (0, 0, 2),
                                    (8.0, 8.0, 8.0), device)
    if grid > 1:
        verts, idx, uvs, normals = _grid_quads(
            verts, uvs, normals, [((0, 1, 2, 3), ((0, 2, 1), (0, 3, 2))),
                                  ((4, 5, 6, 7), ((4, 5, 6), (4, 6, 7)))],
            grid)
    return make_device_scene(verts, idx, np.zeros(len(idx), np.int32), [m],
                             device,
                             area_light=light, normals=normals, uvs=uvs,
                             textures=textured_maps(sizes))


def textured_camera(width, height, fov_y=40.0) -> Camera:
    """The textured scene's camera (bench.py:245-246; the tests' 45°)."""
    return Camera(eye=(0, 1.5, -4.5), lookat=(0, 0.6, 0), up=(0, 1, 0),
                  fov_y=fov_y, aspect=width / height)


# The alpha-cutout scenes (apps/cutouts.py, bench.py:477-580): each returns
# its numpy parts (vertices, indices, tri_mat, material dicts, uvs, textures,
# the area light's (corner, v1, v2, emission)), which the CPU tests hand to
# both packages' make_device_scene.
CUTOUT_LIGHT = (CORNELL_LIGHT_CORNER, CORNELL_LIGHT_V1, CORNELL_LIGHT_V2,
                CORNELL_LIGHT_EMISSION)


def _face_uvs(n_verts):
    """Per-face unit texture coordinates: every quad's corners get (0, 0),
    (1, 0), (1, 1), (0, 1), so a mask varies across each face
    (apps/cutouts.py:38-44)."""
    return np.tile(np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
                   (n_verts // 4, 1))


def cutout_cornell_parts():
    """The Cornell box whose tall block is a checker cutout and short block
    a circle cutout, both at checker_scale 4 (apps/cutouts.py:24-48)."""
    verts, idx, tri_mat = quads_to_triangles(_CORNELL_QUADS)
    materials = [dict(m) for m in CORNELL_MATERIALS]
    materials.append({"kind": mat.DIFFUSE, "base_color": (0.8, 0.8, 0.8),
                      "alpha_mode": mat.ALPHA_MASK, "cutout": mat.CUT_CHECKER,
                      "checker_scale": 4.0})
    materials.append({"kind": mat.DIFFUSE, "base_color": (0.8, 0.8, 0.8),
                      "alpha_mode": mat.ALPHA_MASK, "cutout": mat.CUT_CIRCLE,
                      "checker_scale": 4.0})
    tri_mat = tri_mat.copy()
    tri_mat[20:30] = 4      # tall block: checker
    tri_mat[10:20] = 5      # short block: circle
    return verts, idx, tri_mat, materials, _face_uvs(len(verts)), [], \
        CUTOUT_LIGHT


def opaque_alpha_cornell_parts():
    """bench.py:517-550: both blocks alpha-masked by a circle at
    checker_scale 0.2, whose uv * scale stays in [0, 0.2]² and never
    reaches a hole; the micromaps classify every triangle opaque."""
    verts, idx, tri_mat = quads_to_triangles(_CORNELL_QUADS)
    materials = [dict(m) for m in CORNELL_MATERIALS]
    materials.append({"kind": mat.DIFFUSE, "base_color": (0.8, 0.8, 0.8),
                      "alpha_mode": mat.ALPHA_MASK, "cutout": mat.CUT_CIRCLE,
                      "checker_scale": 0.2})
    tri_mat = tri_mat.copy()
    tri_mat[10:30] = 4
    return verts, idx, tri_mat, materials, _face_uvs(len(verts)), [], \
        CUTOUT_LIGHT


def cutout_grid_parts(nx=40, ny=30):
    """A cluster-scene cutout grid (apps/cutouts.py:51-89): nx x ny quads
    in the y = 300 plane, each one checker cell (scale 1, uvs offset per
    quad, so every triangle is certainly opaque or transparent), over a
    solid floor; 2 nx ny + 2 triangles."""
    verts, idx, uvs, tri_mat = [], [], [], []
    sx, sz = 500.0 / nx, 500.0 / ny
    for j in range(ny):
        for i in range(nx):
            b = len(verts)
            x0, z0 = i * sx, j * sz
            verts += [[x0, 300, z0], [x0 + sx, 300, z0],
                      [x0 + sx, 300, z0 + sz], [x0, 300, z0 + sz]]
            uvs += [[i, j], [i + 1, j], [i + 1, j + 1], [i, j + 1]]
            idx += [[b, b + 1, b + 2], [b, b + 2, b + 3]]
            tri_mat += [1, 1]
    b = len(verts)
    verts += [[0, 0, 0], [500, 0, 0], [500, 0, 500], [0, 0, 500]]
    uvs += [[0, 0], [1, 0], [1, 1], [0, 1]]
    idx += [[b, b + 2, b + 1], [b, b + 3, b + 2]]
    tri_mat += [0, 0]
    materials = [
        {"kind": mat.DIFFUSE, "base_color": (0.7, 0.7, 0.7)},
        {"kind": mat.DIFFUSE, "base_color": (0.8, 0.8, 0.8),
         "alpha_mode": mat.ALPHA_MASK, "cutout": mat.CUT_CHECKER,
         "checker_scale": 1.0},
    ]
    light = ((150, 640, 150), (200, 0, 0), (0, 0, 200), (15.0, 15.0, 15.0))
    return (np.asarray(verts, np.float32), np.asarray(idx, np.int32),
            np.asarray(tri_mat, np.int32), materials,
            np.asarray(uvs, np.float32), [], light)


def alpha_map(size=64, seed=11):
    """An RGBA uint8 map whose alpha crosses 0.5 in blobs (0.5 + 0.5
    sin(6 pi x) cos(4 pi y), x and y in [0, 1)) over a seeded random
    color."""
    rng = np.random.default_rng(seed)
    x = (np.arange(size) + 0.5) / size
    alpha = 0.5 + 0.5 * np.sin(6 * np.pi * x)[None, :] * np.cos(
        4 * np.pi * x)[:, None]
    img = np.empty((size, size, 4), np.uint8)
    img[..., :3] = rng.integers(60, 250, (size, size, 3))
    img[..., 3] = np.round(alpha * 255).astype(np.uint8)
    return img


def textured_cutout_cornell_parts(size=64):
    """The cutout Cornell with its tall block a CUT_TEXTURE cutout instead:
    the base map (alpha_map) gives its color, and its alpha under 0.5 its
    holes; the short block keeps the circle."""
    verts, idx, tri_mat, materials, uvs, _, light = cutout_cornell_parts()
    materials[4] = {"kind": mat.DIFFUSE, "base_color": (0.9, 0.9, 0.9),
                    "alpha_mode": mat.ALPHA_MASK, "cutout": mat.CUT_TEXTURE,
                    "base_tex": 0, "alpha_cutoff": 0.5}
    return verts, idx, tri_mat, materials, uvs, [alpha_map(size)], light


TEXTURED_WHITTED_LIGHTS = [
    {"kind": POINT, "position": (3.0, 5.0, 4.0), "color": (1.0, 1.0, 1.0),
     "falloff": 0},
    {"kind": AMBIENT, "color": (0.2, 0.2, 0.2)},
]


def textured_whitted_parts(size=64):
    """A Whitted scene on textured triangles: an 8 x 8 floor whose base map
    (alpha_map's colors, opaque) tiles 4x, behind a 2 x 2 upright phong
    quad cut by alpha_map's alpha (CUT_TEXTURE), under a point and an
    ambient light (TEXTURED_WHITTED_LIGHTS)."""
    verts = np.array([[-4, 0, -4], [4, 0, -4], [4, 0, 4], [-4, 0, 4],
                      [-1, 0.2, 0], [1, 0.2, 0], [1, 2.2, 0], [-1, 2.2, 0]],
                     np.float32)
    idx = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7]], np.int32)
    uvs = np.array([[0, 0], [4, 0], [4, 4], [0, 4],
                    [0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    floor_map = alpha_map(size, seed=12)
    floor_map[..., 3] = 255
    materials = [
        {"kind": mat.DIFFUSE, "base_color": (0.9, 0.9, 0.9), "base_tex": 0,
         "kr": (0.1, 0.1, 0.1)},
        {"kind": mat.PHONG, "base_color": (0.8, 0.8, 0.8), "base_tex": 1,
         "specular": (0.4, 0.4, 0.4), "phong_exp": 32.0,
         "kr": (0.2, 0.2, 0.2), "alpha_mode": mat.ALPHA_MASK,
         "cutout": mat.CUT_TEXTURE, "alpha_cutoff": 0.5},
    ]
    return (verts, idx, np.array([0, 0, 1, 1], np.int32), materials, uvs,
            [floor_map, alpha_map(size)], None)


def textured_whitted_camera(width, height) -> Camera:
    return Camera(eye=(0.5, 2.0, 6.0), lookat=(0.0, 0.8, 0.0),
                  up=(0.0, 1.0, 0.0), fov_y=45.0, aspect=width / height)


def scene_from_parts(parts, device, **kw) -> DeviceScene:
    """A DeviceScene from a *_parts() tuple; kw goes to make_device_scene
    (lights, miss_color, opacity_micromaps, ...)."""
    verts, idx, tri_mat, materials, uvs, textures, light = parts
    if light is not None:
        kw["area_light"] = ParallelogramLight.make(*light, device)
    return make_device_scene(verts, idx, tri_mat, materials, device,
                             uvs=uvs, textures=textures, **kw)


def textured_whitted_scene(device) -> DeviceScene:
    return scene_from_parts(textured_whitted_parts(), device,
                            lights=TEXTURED_WHITTED_LIGHTS,
                            miss_color=(0.3, 0.45, 0.7))


def cutout_grid_camera(width, height) -> Camera:
    """The cutout grid seen from above its plane, the floor through its
    holes."""
    return Camera(eye=(250.0, 520.0, -250.0), lookat=(250.0, 150.0, 250.0),
                  up=(0.0, 1.0, 0.0), fov_y=50.0, aspect=width / height)


# The SPD `tetra` (E. Haines, "A Proposal for Standard Graphics
# Environments", IEEE CG&A 7(11), 1987, the Standard Procedural Databases):
# a regular tetrahedron replaced, level by level, by the four half-size
# tetrahedra at its corners. Here of edge 2, y up, its base on y = 0 centred
# on the y axis, one face toward -z. The SPD lights it with points; the
# port's path tracer takes one parallelogram light, so the light (a square
# over the apex, with its emissive quad as the Cornell box has one), the
# camera, the albedo and the background are the port's own.
# `benchmark/scenes/sierpinski.py` builds the same arrays without the port.
SPD_TETRA_LEVEL = 7
SPD_TETRA_EDGE = 2.0
SPD_TETRA_MATERIALS = [
    {"kind": mat.DIFFUSE, "base_color": (0.70, 0.70, 0.70)},              # pyramid
    {"kind": mat.DIFFUSE, "base_color": (0.78, 0.78, 0.78),
     "emission": (15.0, 15.0, 15.0)},                                     # lamp
]
SPD_TETRA_LIGHT = ((-0.5, 2.4, -0.5), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0),
                   (15.0, 15.0, 15.0))
SPD_TETRA_MISS = (0.25, 0.3, 0.4)
# A tetrahedron's four faces by corner, wound outward.
_TETRA_FACES = np.array([[1, 3, 2], [0, 2, 3], [0, 3, 1], [0, 1, 2]],
                        np.int32)


def spd_tetra_corners(edge=SPD_TETRA_EDGE):
    """The level-0 tetrahedron's corners [4, 3] (float64): three on y = 0
    around the y axis (the back one on +z), the apex above them."""
    r = edge / math.sqrt(3.0)
    h = edge * math.sqrt(2.0 / 3.0)
    return np.array([[0.0, 0.0, r], [-0.5 * edge, 0.0, -0.5 * r],
                     [0.5 * edge, 0.0, -0.5 * r], [0.0, h, 0.0]], np.float64)


def spd_tetra_mesh(level=SPD_TETRA_LEVEL, edge=SPD_TETRA_EDGE):
    """The pyramid of `level` levels → (vertices [4^(level+1), 3] f32,
    indices [4^(level+1), 3] int32): 4^level tetrahedra, four corners and
    four flat faces each. Level L is level L-1 halved toward each corner in
    turn, p → (p + corner) / 2, worked in float64."""
    corners = spd_tetra_corners(edge)
    tets = corners[None]
    for _ in range(level):
        tets = ((tets[None] + corners[:, None, None]) * 0.5).reshape(-1, 4, 3)
    n = tets.shape[0]
    idx = (np.arange(n, dtype=np.int32)[:, None, None] * 4
           + _TETRA_FACES[None]).reshape(-1, 3)
    return tets.reshape(-1, 3).astype(np.float32), idx


def spd_tetra_parts(level=SPD_TETRA_LEVEL):
    """The pyramid (material 0) and the lamp quad over it (material 1, two
    triangles where the light lies) as a *_parts() tuple."""
    verts, idx = spd_tetra_mesh(level)
    corner, v1, v2 = (np.asarray(v, np.float64) for v in SPD_TETRA_LIGHT[:3])
    lamp = np.stack([corner, corner + v1, corner + v1 + v2,
                     corner + v2]).astype(np.float32)
    n0 = len(verts)
    verts = np.concatenate([verts, lamp])
    idx = np.concatenate([idx, np.array([[n0, n0 + 1, n0 + 2],
                                         [n0, n0 + 2, n0 + 3]], np.int32)])
    tri_mat = np.concatenate([np.zeros(len(idx) - 2, np.int32),
                              np.ones(2, np.int32)])
    return (verts, idx, tri_mat, [dict(m) for m in SPD_TETRA_MATERIALS],
            None, [], SPD_TETRA_LIGHT)


def spd_tetra_scene(device, level=SPD_TETRA_LEVEL) -> DeviceScene:
    """The SPD `tetra` at `level` (7: 65,536 triangles and the lamp's two,
    a cluster scene) under its light, on a constant background."""
    return scene_from_parts(spd_tetra_parts(level), device,
                            miss_color=SPD_TETRA_MISS)


def spd_tetra_camera(width, height) -> Camera:
    """A three-quarter view from the front left and above: the pyramid fills
    the frame's height, the light lies above it."""
    return Camera(eye=(-1.4, 1.85, -3.0), lookat=(0.0, 0.66, 0.0),
                  up=(0.0, 1.0, 0.0), fov_y=40.0, aspect=width / height)

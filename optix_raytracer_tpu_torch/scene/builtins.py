"""The Cornell box (flat and instanced), the trefoil-knot scene, the bench's
prims, PBR and textured scenes and their cameras (counterpart of
`scene/builtins.py:18-141, 196-274` and of the scenes `bench.py:153-202,
205-246, 418-450` builds inline).

The data tables are a copy of the JAX package's (a CPU test holds them
equal): the JAX module cannot be imported without JAX.
"""
from __future__ import annotations

import numpy as np

from ..accel import primitives as prim
from ..core.camera import Camera
from ..shade import materials as mat
from ..shade.lights import ParallelogramLight
from .device_scene import DeviceScene, make_device_scene

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


def knot_scene(segments: int = 140, sides: int = 45, *,
               device) -> DeviceScene:
    """Large-mesh scene: a trefoil-knot tube (2*segments*sides smooth
    triangles) over a two-triangle floor, lit by an overhead parallelogram
    light."""
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
    light = ParallelogramLight.make(
        (lo[0], ly, lo[2]), (hi[0] - lo[0], 0.0, 0.0),
        (0.0, 0.0, hi[2] - lo[2]), (10.0, 10.0, 10.0), device)
    return make_device_scene(verts, idx, tri_mat, KNOT_MATERIALS, device,
                             area_light=light, normals=normals,
                             miss_color=(0.0, 0.0, 0.0))


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


def textured_scene(device, sizes=TEXTURED_SIZES, metallic=1.0, roughness=1.0,
                   smooth=False, maps="all") -> DeviceScene:
    """bench.py's textured scene: a 6x6 floor with its uvs tiled 4x and a
    2 x 1.6 upright quad tiled 2x (4 triangles), one PBR material with
    base-color, normal, metallic-roughness and emissive maps (white base,
    emission 1), under a parallelogram light; the maps make one 16-channel
    bundle of 256x256 texels and 9 mip levels. smooth=True gives the floor
    up normals and the quad leaning vertex normals, maps="base" keeps the
    base-color map alone (tests/test_fused_textures.py:29-63)."""
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
    return make_device_scene(verts, idx, np.zeros(4, np.int32), [m], device,
                             area_light=light, normals=normals, uvs=uvs,
                             textures=textured_maps(sizes))


def textured_camera(width, height, fov_y=40.0) -> Camera:
    """The textured scene's camera (bench.py:245-246; the tests' 45°)."""
    return Camera(eye=(0, 1.5, -4.5), lookat=(0, 0.6, 0), up=(0, 1, 0),
                  fov_y=fov_y, aspect=width / height)

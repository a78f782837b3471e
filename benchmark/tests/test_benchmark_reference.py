"""The plain reference (`benchmark/reference/`) on known cases, on the CPU at
tiny sizes: the RNG words against the hash written out on Python integers,
the camera frame, the intersection queries on hand-made triangles, the
cosine bounce, the path tracer against closed forms and against the port,
the film merge, and the bfloat16 control reading far off.

    python -m pytest benchmark/tests -q
"""
import math

import numpy as np
import pytest
import torch

from benchmark import check, scenes
from benchmark.reference import pathtracer as ref

M32 = 0xFFFFFFFF


def tea_int(v0, v1):
    s = 0
    for _ in range(4):
        s = (s + 0x9E3779B9) & M32
        v0 = (v0 + ((((v1 << 4) + 0xA341316C) & M32) ^ ((v1 + s) & M32)
                    ^ (((v1 >> 5) + 0xC8013EA4) & M32))) & M32
        v1 = (v1 + ((((v0 << 4) + 0xAD90777D) & M32) ^ ((v0 + s) & M32)
                    ^ (((v0 >> 5) + 0x7E95761E) & M32))) & M32
    return v0


def pcg_int(state):
    state = (state * 747796405 + 2891336453) & M32
    x = ((state ^ (state >> 16)) * 0x7FEB352D) & M32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & M32
    return x ^ (x >> 16), state


def test_rng_words_match_the_hash_on_python_ints():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 2 ** 32, 64)
    b = rng.integers(0, 2 ** 32, 64)
    state = ref.tea(torch.as_tensor(a), torch.as_tensor(b))
    want = [tea_int(int(x), int(y)) for x, y in zip(a, b)]
    assert state.tolist() == want
    for _ in range(5):
        u, state = ref.next_uniform(state, torch.float32)
        words = [pcg_int(s) for s in want]
        want = [s for _, s in words]
        assert state.tolist() == want
        assert u.tolist() == [(w >> 8) / 16777216.0 for w, _ in words]


def test_camera_frame():
    u, v, w = ref.camera_frame((1.0, 2.0, 3.0), (1.0, 2.0, -7.0),
                               (0.0, 1.0, 0.0), 90.0, 2.0)
    np.testing.assert_allclose(w, [0, 0, -10])
    np.testing.assert_allclose(v, [0, 10, 0], rtol=1e-6)   # |W| tan 45
    np.testing.assert_allclose(u, [20, 0, 0], rtol=1e-6)   # W x up, x aspect


def one_triangle_scene(**kw):
    arrays = dict(vertices=np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0],
                                     [0, 0, 0], [1, 0, 0], [0, 1, 0]],
                                    np.float32),
                  indices=np.array([[0, 1, 2], [3, 4, 5]], np.int32),
                  normals=None, tri_mat=np.zeros(2, np.int32),
                  materials=[{"kind": "diffuse",
                              "base_color": (0.5, 0.5, 0.5)}],
                  light=dict(corner=(0, 0, 5), v1=(1, 0, 0), v2=(0, 1, 0),
                             emission=(1, 1, 1)))
    arrays.update(kw)
    return ref.Scene(arrays, "cpu")


def rays(o, d, tmin=1e-4, tmax=1e16):
    o = torch.tensor(o, dtype=torch.float32)
    d = torch.tensor(d, dtype=torch.float32)
    n = o.shape[0]
    return (o, d, torch.full((n,), tmin), torch.full((n,), tmax))


def test_closest_hit_and_occlusion():
    sc = one_triangle_scene()
    o, d, tmin, tmax = rays([[0.25, 0.25, 2.0], [0.75, 0.75, 2.0],
                             [0.25, 0.25, -1.0], [0.1, 0.2, 2.0]],
                            [[0, 0, -1], [0, 0, -1], [0, 0, -1], [0, 0, -1]])
    tmax[3] = 1.5          # the triangle lies past the window
    t, prim, u, v = ref.closest_hit(sc, o, d, tmin, tmax)
    assert prim.tolist() == [0, -1, -1, -1]       # ties go to the first
    assert float(t[0]) == 2.0
    assert (float(u[0]), float(v[0])) == (0.25, 0.25)
    occ = ref.occluded(sc, o, d, tmin, tmax)
    assert occ.tolist() == [True, False, False, False]


def test_closest_hit_across_blocks(monkeypatch):
    """The nearest of many triangles, whatever the block size."""
    rng = np.random.default_rng(0)
    m = 40
    base = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    verts = np.concatenate([base + [0, 0, z] for z in rng.uniform(-5, 5, m)])
    arrays = dict(vertices=verts.astype(np.float32),
                  indices=np.arange(3 * m, dtype=np.int32).reshape(m, 3),
                  normals=None, tri_mat=np.zeros(m, np.int32),
                  materials=[{"kind": "diffuse", "base_color": (1, 1, 1)}],
                  light=dict(corner=(0, 0, 9), v1=(1, 0, 0), v2=(0, 1, 0),
                             emission=(1, 1, 1)))
    sc = ref.Scene(arrays, "cpu")
    o, d, tmin, tmax = rays([[0.2, 0.3, 6.0]] * 3, [[0, 0, -1]] * 3)
    want = int(np.argmax(verts[0::3, 2]))
    for block in (1 << 25, 7, 1):
        monkeypatch.setattr(ref, "BLOCK_ELEMS", block)
        _, prim, _, _ = ref.closest_hit(sc, o, d, tmin, tmax)
        assert prim.tolist() == [want] * 3


def test_cosine_hemisphere():
    g = torch.Generator().manual_seed(0)
    u1, u2 = torch.rand(20000, generator=g), torch.rand(20000, generator=g)
    n = torch.nn.functional.normalize(torch.randn(20000, 3, generator=g),
                                      dim=-1)
    d = ref.cosine_hemisphere(u1, u2, n)
    assert torch.allclose(ref.dot(d, d), torch.ones(20000), atol=1e-5)
    cos = ref.dot(d, n)
    assert float(cos.min()) >= -1e-6
    assert abs(float(cos.mean()) - 2.0 / 3.0) < 0.01      # E[cos] = 2/3


def floor_arrays(albedo=0.5, emission=None):
    """A large floor quad (y = 0) under a 1 x 1 light at height 1."""
    mat = {"kind": "diffuse", "base_color": (albedo,) * 3}
    if emission is not None:
        mat["emission"] = emission
    spec = dict(kind="quads", quads=[dict(corners=[[-50, 0, -50], [-50, 0, 50],
                                                   [50, 0, 50], [50, 0, -50]],
                                          material=0)],
                materials=[mat],
                light=dict(corner=[-0.5, 1.0, -0.5], v1=[1.0, 0.0, 0.0],
                           v2=[0.0, 0.0, 1.0], emission=[2.0, 2.0, 2.0]))
    return scenes.build(spec)


def camera_down(launches=1):
    u, v, w = ref.camera_frame((0.0, 0.5, 0.0), (0.0, 0.0, 0.0),
                               (0.0, 0.0, 1.0), 1.0, 1.0)
    return dict(eye=np.tile([0.0, 0.5, 0.0], (launches, 1)),
                U=np.tile(u, (launches, 1)), V=np.tile(v, (launches, 1)),
                W=np.tile(w, (launches, 1)))


def test_direct_light_matches_the_closed_form():
    """Depth 1 below the light's centre: radiance = albedo / pi * E, E the
    irradiance of a unit square of radiance 2 at height 1 (the closed form
    of a rectangle's form factor), within the estimate's spread."""
    sc = ref.Scene(floor_arrays(), "cpu")
    spl = 4096
    sums, rays_ = ref.render_pixels(sc, camera_down(), np.array([[8]]),
                                    np.array([[8]]), 16, 16, [0], spl, 1)
    x = y = 0.5     # half sides over the height: four corner rectangles

    def ff(a, b):   # point-to-rectangle form factor, a x b at unit height
        return (a / math.sqrt(1 + a * a) * math.atan(b / math.sqrt(1 + a * a))
                + b / math.sqrt(1 + b * b)
                * math.atan(a / math.sqrt(1 + b * b))) / (2 * math.pi)
    irradiance = 2.0 * math.pi * 4 * ff(x, y)
    want = 0.5 / math.pi * irradiance
    got = float(sums[0, 0, 0]) / spl
    assert abs(got / want - 1) < 0.02
    assert int(rays_[0, 0]) == 2 * spl          # a camera ray and a shadow


def test_miss_and_emission():
    arrays = floor_arrays(emission=(3.0, 3.0, 3.0))
    arrays["miss_color"] = (0.25, 0.5, 1.0)
    sc = ref.Scene(arrays, "cpu")
    cams = camera_down()
    cams["W"] = -cams["W"]                       # looking up: a miss
    sums, rays_ = ref.render_pixels(sc, cams, np.array([[3]]),
                                    np.array([[3]]), 8, 8, [0], 4, 2)
    np.testing.assert_allclose(sums[0, 0].numpy(), [1.0, 2.0, 4.0])
    assert int(rays_[0, 0]) == 4
    # looking down at the emitter, depth 1: emission + NEE
    sums, _ = ref.render_pixels(sc, camera_down(), np.array([[4]]),
                                np.array([[4]]), 8, 8, [0], 64, 1)
    assert float(sums[0, 0, 0]) / 64 > 3.0


def test_merge_films():
    sums = torch.tensor([[[2.0, 4.0, 8.0]], [[4.0, 4.0, 4.0]]])
    acc = ref.merge_films(sums, [0, 2], 2, reset=False)
    np.testing.assert_allclose(acc[1, 0].numpy(), [1.5, 2.0, 3.0])
    fresh = ref.merge_films(sums, [0, 0], 2, reset=True)
    np.testing.assert_allclose(fresh[1, 0].numpy(), [2.0, 2.0, 2.0])


def knot_arrays_and_camera():
    """A smooth trefoil tube of 562 triangles (past the cluster table's 512)
    from the port's builtins, as scene arrays, and its camera."""
    from optix_raytracer_tpu_torch.scene import builtins as B
    verts, idx, normals, tri_mat, (corner, v1, v2) = B.knot_mesh(20, 14)
    arrays = dict(vertices=verts, indices=idx, normals=normals,
                  tri_mat=tri_mat, miss_color=[0.0, 0.0, 0.0],
                  materials=[dict(base_color=list(m["base_color"]))
                             for m in B.KNOT_MATERIALS],
                  light=dict(corner=list(corner), v1=list(v1), v2=list(v2),
                             emission=[10.0, 10.0, 10.0]))
    cam = dict(eye=[0.0, 2.5, -9.0], lookat=[0.0, 0.0, 0.0],
               up=[0.0, 1.0, 0.0], fov_y=45.0)
    return arrays, cam


@pytest.mark.parametrize("config", ["cornell", "smooth_knot"])
def test_reference_follows_the_port(config, tiny_root):
    """The port on the CPU (the wavefront and, on the smooth knot, the
    plain cluster walks) and the reference agree at 16 x 16, depth 2, on
    two launches of 2 samples."""
    from optix_raytracer_tpu_torch.core.camera import Camera
    from optix_raytracer_tpu_torch.core.film import Film
    from optix_raytracer_tpu_torch.wavefront import engine

    from benchmark import harness, spec as spec_mod
    cell = spec_mod.Cell(tiny_root, spec_mod.load(tiny_root),
                         "cornell-progressive")
    cfg = cell.config
    cfg.update(width=16, height=16, max_depth=2)
    if config == "cornell":
        arrays = scenes.build(cfg["scene"])
    else:
        arrays, cfg["camera"] = knot_arrays_and_camera()
        assert arrays["indices"].shape[0] > 512
    scene = harness._port_scene(arrays, torch.device("cpu"))
    cam = cfg["camera"]
    params = Camera(eye=tuple(cam["eye"]), lookat=tuple(cam["lookat"]),
                    up=tuple(cam["up"]), fov_y=cam["fov_y"],
                    aspect=1.0).params("cpu")
    film = Film.create(16, 16, "cpu")
    films, total = [], 0
    for _ in range(2):
        film, r = engine.render_accumulate(scene, params, film, 16, 16,
                                           samples_per_launch=2, max_depth=2)
        films.append(film.accum.reshape(-1, 3).clone())
        total += int(r)
    yy, xx = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    px = np.tile(xx.ravel(), (2, 1))
    py = np.tile(yy.ravel(), (2, 1))
    traffic = dict(samples_per_launch=2, film="accumulate")
    ref_films, ref_rays = check.reference_films(
        arrays, cfg, traffic, [tuple(cam["eye"])] * 2, px, py, "cpu")
    values = check.numbers(torch.stack(films).numpy(), ref_films, total,
                           ref_rays, np.ones_like(px, np.float64))
    assert values["film_rel_l1"] < 1e-4
    assert int(ref_rays.sum()) == total          # every pixel: exact


def test_bfloat16_control_reads_far_off(tiny_root):
    from benchmark import control
    values = control.control_numbers(tiny_root, "cornell-interactive", 5, 3,
                                     "cpu")
    assert values["film_rel_l1"] > 0.05

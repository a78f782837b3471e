"""The SPD `tetra` pyramid (`scene/builtins.py::spd_tetra_*`) on the CPU:
the generator's shape, the benchmark's copy of it
(`benchmark/scenes/sierpinski.py`, `benchmark/configs/spd_tetra.json`) bit
for bit, the port on its cluster path against the benchmark's plain
reference (`benchmark/reference/pathtracer.py`), the apps' `--scene
spd-tetra`, the cluster path's spans and `clusters.queries` counters, and
the ray planes that `Rays.make` fills on the device.
Renders run at level 4 (1,026 triangles with the lamp's two, 9 clusters: the
cluster path's plain versions)."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from optix_raytracer_tpu_torch import telemetry
from optix_raytracer_tpu_torch.accel import clusters
from optix_raytracer_tpu_torch.apps import pathtracer, viewer
from optix_raytracer_tpu_torch.core.camera import Camera
from optix_raytracer_tpu_torch.core.film import Film
from optix_raytracer_tpu_torch.core.rays import Rays
from optix_raytracer_tpu_torch.scene import builtins as B
from optix_raytracer_tpu_torch.wavefront import engine

from benchmark import check, scenes
from benchmark.scenes import sierpinski

ROOT = Path(__file__).resolve().parents[1]
LEVEL = 4
W = H = 16


def config():
    return json.loads((ROOT / "benchmark/configs/spd_tetra.json").read_text())


def bits(a):
    return np.ascontiguousarray(a).view(np.uint8)


@pytest.mark.parametrize("level", [0, 1, 3, 5])
def test_mesh_counts_and_no_degenerate_triangle(level):
    verts, idx = B.spd_tetra_mesh(level)
    assert idx.shape == (4 ** (level + 1), 3) and idx.dtype == np.int32
    assert verts.shape == (4 ** (level + 1), 3) and verts.dtype == np.float32
    assert idx.min() == 0 and idx.max() == len(verts) - 1
    tri = verts[idx].astype(np.float64)
    area2 = np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0],
                                    tri[:, 2] - tri[:, 0]), axis=1)
    edge = B.SPD_TETRA_EDGE / 2 ** level
    # every face is an equilateral triangle of the level's edge
    np.testing.assert_allclose(area2, edge * edge * np.sqrt(3) / 2, rtol=1e-4)


@pytest.mark.parametrize("level", [1, 2, 4])
def test_level_is_four_half_copies_of_the_last(level):
    """Level L is level L-1 halved toward each corner in turn, the faces of
    every copy in the same order."""
    verts, idx = B.spd_tetra_mesh(level)
    prev, prev_idx = B.spd_tetra_mesh(level - 1)
    corners = B.spd_tetra_corners()
    n = len(prev)
    for i, c in enumerate(corners):
        want = (prev.astype(np.float64) + c) * 0.5
        np.testing.assert_allclose(verts[i * n:(i + 1) * n], want, rtol=0,
                                   atol=1e-6)
        assert np.array_equal(idx[i * len(prev_idx):(i + 1) * len(prev_idx)],
                              prev_idx + i * n)


def test_bounding_box_is_the_stated_tetrahedron():
    """Regular, edge 2, y up, base on y = 0 about the y axis: the corners
    stay at every level, and the faces point outward."""
    c = B.spd_tetra_corners()
    d = np.linalg.norm(c[:, None] - c[None], axis=-1)
    np.testing.assert_allclose(d[~np.eye(4, dtype=bool)], 2.0, rtol=1e-12)
    assert (c[:3, 1] == 0).all() and c[3, 1] > 0
    np.testing.assert_allclose(c[:3, [0, 2]].mean(axis=0), 0.0, atol=1e-12)
    verts, idx = B.spd_tetra_mesh(B.SPD_TETRA_LEVEL)
    assert np.array_equal(verts.min(axis=0), c.min(axis=0).astype(np.float32))
    assert np.array_equal(verts.max(axis=0), c.max(axis=0).astype(np.float32))
    tri = verts[idx[:4]].astype(np.float64)
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    out = tri.mean(axis=1) - verts[:4].astype(np.float64).mean(axis=0)
    assert ((n * out).sum(axis=1) > 0).all()


@pytest.mark.parametrize("level", [0, 2, 4, 7])
def test_benchmark_generator_equals_the_builtin(level):
    """The benchmark's arrays (nothing of the port imported) are the port's
    builtin bit for bit: the pyramid, the lamp quad, the materials, the
    light, the background and the camera."""
    cfg = config()
    arrays = scenes.build(dict(cfg["scene"], level=level))
    verts, idx, tri_mat, materials, uvs, textures, light = \
        B.spd_tetra_parts(level)
    assert bits(arrays["vertices"]).tobytes() == bits(verts).tobytes()
    assert arrays["vertices"].dtype == verts.dtype
    assert np.array_equal(arrays["indices"], idx)
    assert arrays["indices"].dtype == idx.dtype
    assert np.array_equal(arrays["tri_mat"], tri_mat)
    assert arrays["normals"] is None and uvs is None and textures == []
    pyr = B.spd_tetra_mesh(level)
    assert bits(verts[:-4]).tobytes() == bits(pyr[0]).tobytes()
    for m, want in zip(arrays["materials"], materials):
        assert tuple(m["base_color"]) == want["base_color"]
        assert tuple(m.get("emission", (0.0,) * 3)) == want.get(
            "emission", (0.0,) * 3)
    got_light = arrays["light"]
    assert (tuple(got_light["corner"]), tuple(got_light["v1"]),
            tuple(got_light["v2"]), tuple(got_light["emission"])) == light
    assert arrays["miss_color"] == B.SPD_TETRA_MISS
    cam = B.spd_tetra_camera(1920, 1088)
    want_cam = cfg["camera"]
    assert (cam.eye, cam.lookat, cam.up, cam.fov_y) == (
        tuple(want_cam["eye"]), tuple(want_cam["lookat"]),
        tuple(want_cam["up"]), want_cam["fov_y"])
    assert cfg["scene"]["level"] == B.SPD_TETRA_LEVEL
    assert cfg["scene"]["edge"] == B.SPD_TETRA_EDGE
    np.testing.assert_array_equal(sierpinski.corners(2.0),
                                  B.spd_tetra_corners())


@pytest.fixture(scope="module")
def tetra4():
    return B.spd_tetra_scene("cpu", level=LEVEL)


def test_scene_takes_the_cluster_path(tetra4, monkeypatch):
    """A cluster scene that the fused kernel refuses; on the card "auto"
    takes the sample-major strips from 8 samples a launch (the
    progressive cell's 16) and the sequential loop below (the interactive
    cell's 4). The card is faked: nothing launches."""
    assert tetra4.has_clusters and tetra4.num_triangles == 4 ** 5 + 2
    assert tetra4.clusters.num_clusters == -(-(4 ** 5 + 2) // 128)
    assert not tetra4.fused_fits
    monkeypatch.setattr(type(tetra4), "device",
                        property(lambda self: torch.device("cuda")),
                        raising=False)
    assert not engine._use_fused(tetra4, "auto")
    for name in ("render_sum_sample_major", "render_sum_wavefront"):
        monkeypatch.setattr(engine, name, lambda *a, _n=name, **k: _n)
    cam = B.spd_tetra_camera(8, 8).params("cpu")
    assert engine.render_sum(tetra4, cam, 8, 8, 0, 16) == \
        "render_sum_sample_major"
    assert engine.render_sum(tetra4, cam, 8, 8, 0, 4) == \
        "render_sum_wavefront"


@pytest.mark.parametrize("impl, spl", [("spl", 8), ("wavefront", 2)])
def test_port_follows_the_reference(impl, spl, tetra4):
    """The port (sample-major strips, or the sorted sequential loop; the
    plain cull and walks on the CPU) against the plain reference at every
    pixel of a 16 x 16 frame, depth 2, two launches: the bars that the
    benchmark's tests set for the knot."""
    cfg = config()
    cfg.update(width=W, height=H, max_depth=2)
    arrays = scenes.build(dict(cfg["scene"], level=LEVEL))
    cam = cfg["camera"]
    params = Camera(eye=tuple(cam["eye"]), lookat=tuple(cam["lookat"]),
                    up=tuple(cam["up"]), fov_y=cam["fov_y"],
                    aspect=1.0).params("cpu")
    film = Film.create(H, W, "cpu")
    films, total = [], 0
    for _ in range(2):
        film, r = engine.render_accumulate(tetra4, params, film, W, H,
                                           samples_per_launch=spl,
                                           max_depth=2, impl=impl)
        films.append(film.accum.reshape(-1, 3).clone())
        total += int(r)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    px = np.tile(xx.ravel(), (2, 1))
    py = np.tile(yy.ravel(), (2, 1))
    traffic = dict(samples_per_launch=spl, film="accumulate")
    ref_films, ref_rays = check.reference_films(
        arrays, cfg, traffic, [tuple(cam["eye"])] * 2, px, py, "cpu")
    values = check.numbers(torch.stack(films).numpy(), ref_films, total,
                           ref_rays, np.ones_like(px, np.float64))
    assert values["film_rel_l1"] < 1e-4
    assert int(ref_rays.sum()) == total
    # the frame sees the pyramid, its holes and the background
    last = films[-1].numpy()
    sky = (last == np.float32(B.SPD_TETRA_MISS)).all(axis=1)
    assert 0.1 < sky.mean() < 0.9
    assert len(np.unique(last[~sky].round(4), axis=0)) > (~sky).sum() // 2


def small_tetra(device):
    return B.spd_tetra_scene(device, level=LEVEL)


def test_pathtracer_app_scene(monkeypatch, tmp_path):
    """`--scene spd-tetra` renders the builtin (here cut to level 4) through
    render_accumulate; Cornell stays the default."""
    calls = []
    real = pathtracer.render_accumulate

    def spy(scene, *a, **k):
        calls.append((scene.num_triangles, k.get("impl", "auto")))
        return real(scene, *a, **k)

    monkeypatch.setattr(pathtracer, "render_accumulate", spy)
    monkeypatch.setitem(pathtracer.SCENES, "spd-tetra",
                        (small_tetra, B.spd_tetra_camera))
    out = tmp_path / "t.ppm"
    pathtracer.main(["--scene", "spd-tetra", "--file", str(out), "--dim",
                     "8x8", "--samples", "2", "--launch-samples", "2",
                     "--depth", "2", "--device", "cpu"])
    assert out.is_file() and calls == [(4 ** 5 + 2, "auto")]
    calls.clear()
    pathtracer.main(["--file", str(tmp_path / "c.ppm"), "--dim", "8x8",
                     "--samples", "1", "--depth", "1", "--device", "cpu"])
    assert calls == [(32, "auto")]


def test_viewer_app_scene(monkeypatch, tmp_path):
    monkeypatch.setattr(viewer, "spd_tetra_scene", small_tetra)
    v, img = viewer.main(["--scene", "spd-tetra", "--frames", "1", "--dim",
                          "8x8", "--spf", "1", "--depth", "2", "--file",
                          str(tmp_path / "v.ppm"), "--device", "cpu"])
    assert v.scene.has_clusters and v.integrator == "pathtrace"
    assert v.scene.num_triangles == 4 ** 5 + 2
    assert img.shape[:2] == (8, 8) and int(v.film.subframe) == 2


@pytest.fixture
def spans():
    telemetry.reset_spans()
    telemetry.enable()
    try:
        yield telemetry
    finally:
        telemetry.disable()
        telemetry.reset_spans()


def _launch(scene, impl, spl, w=8, h=8):
    cam = B.spd_tetra_camera(w, h).params("cpu")
    return engine.render_accumulate(scene, cam, Film.create(h, w, "cpu"), w,
                                    h, samples_per_launch=spl, max_depth=2,
                                    impl=impl)


def test_cluster_spans_when_enabled(spans, tetra4):
    """On: a sample-major launch records its strip, and each query its
    pack, cull (interval at bounce 0, exact after), compact and walk
    (closest and any); a sequential launch its sorts. Every cluster span
    lies inside its launch's root span."""
    _launch(tetra4, "spl", 8)
    got = spans.drain()
    by_id = {s.id: s for s in got}
    names = {(s.name, s.tag) for s in got}
    for want in [("engine.strip", None), ("clusters.pack", None),
                 ("clusters.cull", "interval"), ("clusters.cull", "exact"),
                 ("clusters.compact", None), ("clusters.walk", "closest"),
                 ("clusters.walk", "any")]:
        assert want in names, want
    assert ("engine.sort", None) not in names
    for s in got:
        if s.name.startswith("clusters."):
            a = s
            while a.parent != -1:
                a = by_id[a.parent]
            assert a.name == "engine.render_accumulate"
        if s.name == "clusters.walk":
            assert by_id[s.parent].name != "clusters.walk"
    strips = [s for s in got if s.name == "engine.strip"]
    assert len(strips) == 1
    assert sum(s.name == "clusters.walk" for s in got) == 4   # 2 bounces x 2
    _launch(tetra4, "wavefront", 2)
    got = spans.drain()
    assert sum(s.name == "engine.sort" for s in got) == 2    # 2 samples x 1
    assert not any(s.name == "engine.strip" for s in got)


def test_cluster_spans_off_record_nothing(tetra4):
    assert telemetry.ENABLED is False
    telemetry.reset_spans()
    _launch(tetra4, "spl", 8)
    _launch(tetra4, "wavefront", 1)
    assert telemetry.drain() == []


def test_cluster_query_counters(tetra4):
    """`clusters.queries` counts a cluster launch and its queries from
    shapes (padded to 4,096 rays, 16 blocks); a Cornell launch, fused or
    wavefront, leaves it at 0."""
    assert telemetry.COUNTERS["clusters.queries"] is clusters.QUERIES
    assert list(clusters.QUERIES) == ["launches", "closest", "any", "rays",
                                      "blocks"]
    saved = dict(clusters.QUERIES)
    try:
        telemetry.reset_counters("clusters.queries")
        scene = B.cornell_box("cpu")
        cam = B.cornell_camera(8, 8).params("cpu")
        for impl in ("fused", "auto"):
            engine.render_accumulate(scene, cam, Film.create(8, 8, "cpu"), 8,
                                     8, samples_per_launch=1, max_depth=2,
                                     impl=impl)
        assert clusters.QUERIES == dict.fromkeys(clusters.QUERIES, 0)
        _launch(tetra4, "spl", 8)          # one strip of 512 lanes, depth 2
        assert clusters.QUERIES == dict(launches=1, closest=2, any=2,
                                        rays=4 * 512, blocks=4 * 16)
        _launch(tetra4, "wavefront", 2)    # 2 samples of 64 rays, depth 2
        assert clusters.QUERIES == dict(launches=2, closest=6, any=6,
                                        rays=4 * 512 + 8 * 64,
                                        blocks=4 * 16 + 8 * 16)
        telemetry.reset_counters("clusters.queries")
        assert clusters.QUERIES == dict.fromkeys(clusters.QUERIES, 0)
    finally:
        clusters.QUERIES.update(saved)


@pytest.mark.parametrize("value", [1e-4, 1e16, 0.0, 2, True])
def test_ray_planes_from_numbers(value):
    """`Rays.make` fills a plane given as a Python number on the rays'
    device (no host-to-device copy, which would wait for the device):
    the same float32 value, a view of one element, as before."""
    o = torch.zeros((3, 5, 3))
    r = Rays.make(o, torch.ones_like(o), tmin=value, tmax=value)
    want = torch.as_tensor(value, dtype=torch.float32)
    for p in (r.tmin, r.tmax):
        assert p.shape == (3, 5) and p.dtype == torch.float32
        assert p.stride() == (0, 0)
        assert torch.equal(p, want.expand(3, 5))
    t = torch.tensor([0.5, 1.5, 2.5], dtype=torch.float64)
    r = Rays.make(o[0, :3], o[0, :3], tmin=t)
    assert r.tmin.dtype == torch.float32 and torch.equal(r.tmin, t.float())

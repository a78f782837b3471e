"""The port's host API (`api/{context,module,callables,accel,pipeline}.py`),
exception counters (`wavefront/exceptions.py`), checkpoints
(`core/checkpoint.py`) and threefry draws (`core/threefry.py`) against the
JAX package on the CPU.

Bars: launches within atol 2e-3 / rtol 1e-3 of the JAX `Pipeline.launch`
(tests/test_fused_kernel.py) with equal ray counts, and bit-equal to the
port's own direct `render_accumulate` / `render_whitted_sample` on the
assembled scene; exception counters and log lines equal; checkpoints
round-trip bit for bit in either package and resume to the straight run's
image within the bars; threefry words and uniforms equal `jax.random`'s.
The Cornell box is 16x16 at depth 2, two samples a launch; the 562-triangle
knot (past 512 triangles: the JAX pipeline walks its LBVH, the port takes
its cluster table) 16x16 at depth 2. About 45 s on one worker, most of it
the JAX pipeline's compiles.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_raytracer_tpu import api as japi
from optix_raytracer_tpu.core import checkpoint as jckpt
from optix_raytracer_tpu.core.film import Film as JFilm
from optix_raytracer_tpu.core.rays import Rays as JRays
from optix_raytracer_tpu.scene import builtins as jb
from optix_raytracer_tpu.shade.lights import ParallelogramLight as JLight
from optix_raytracer_tpu.wavefront import exceptions as jexc
from optix_raytracer_tpu_torch import api, kernels
from optix_raytracer_tpu_torch.api.context import StageTimers
from optix_raytracer_tpu_torch.core import checkpoint as ckpt
from optix_raytracer_tpu_torch.core import threefry
from optix_raytracer_tpu_torch.core.film import Film
from optix_raytracer_tpu_torch.core.rays import Rays
from optix_raytracer_tpu_torch.scene import builtins as B
from optix_raytracer_tpu_torch.shade.lights import ParallelogramLight
from optix_raytracer_tpu_torch.wavefront import exceptions as exc
from optix_raytracer_tpu_torch.wavefront.engine import render_accumulate
from optix_raytracer_tpu_torch.wavefront.whitted import render_whitted_sample

from torch_parity import assert_image_close, one_torch_thread  # noqa: F401

W = H = 16
POINT_LIGHT = {"kind": 0, "position": (278.0, 500.0, 200.0),
               "color": (0.8, 0.8, 0.8)}


class _Pkg:
    """One package's API, builtins and light class."""

    def __init__(self, port):
        self.port = port
        self.api = api if port else japi
        self.B = B if port else jb
        self.Light = ParallelogramLight if port else JLight
        self.dev = {"device": "cpu"} if port else {}

    def cam(self, w=W, h=H):
        return self.B.cornell_camera(w, h).params(*(["cpu"] if self.port
                                                     else []))

    def records(self, materials):
        a = self.api
        mod = a.Module({}, name="pt")
        groups = [a.ProgramGroup(a.ProgramGroupKind.RAYGEN, "__raygen__rg",
                                 mod),
                  a.ProgramGroup(a.ProgramGroupKind.MISS, "__miss__radiance",
                                 mod),
                  a.ProgramGroup(a.ProgramGroupKind.HITGROUP,
                                 "__closesthit__radiance", mod)]
        sbt = a.ShaderBindingTable(
            raygen_record=a.SbtRecord(groups[0]),
            miss_records=[a.SbtRecord(groups[1], {"color": (0.0, 0.0, 0.0)})],
            hitgroup_records=[a.SbtRecord(groups[2], m) for m in materials])
        return groups, sbt

    def cornell(self):
        """(groups, sbt, handle, tri_mat, light) of the Cornell box built
        through build_gas and SBT records (tests/test_exceptions.py:22-42)."""
        verts, idx, tri_mat = self.B.quads_to_triangles(self.B._CORNELL_QUADS)
        handle = self.api.build_gas(verts, idx, **self.dev)
        groups, sbt = self.records(self.B.CORNELL_MATERIALS)
        light = self.Light.make(self.B.CORNELL_LIGHT_CORNER,
                                self.B.CORNELL_LIGHT_V1,
                                self.B.CORNELL_LIGHT_V2,
                                self.B.CORNELL_LIGHT_EMISSION, **self.dev)
        return groups, sbt, handle, tri_mat, light

    def pipeline(self, integrator="pathtrace", context=None):
        groups, _, _, _, _ = self.cornell()
        return self.api.Pipeline(context=context, program_groups=groups,
                                 integrator=integrator, max_trace_depth=2,
                                 samples_per_launch=2)


PORT, JAX = _Pkg(True), _Pkg(False)


def launch(pkg, integrator="pathtrace", film=None, cam=None, context=None,
           lights=(), emission=None):
    groups, sbt, handle, tri_mat, light = pkg.cornell()
    if emission is not None:
        light = pkg.Light.make(pkg.B.CORNELL_LIGHT_CORNER,
                               pkg.B.CORNELL_LIGHT_V1, pkg.B.CORNELL_LIGHT_V2,
                               emission, **pkg.dev)
    pipe = pkg.pipeline(integrator, context)
    film, rays = pipe.launch(sbt, handle, pkg.cam() if cam is None else cam,
                             W, H, film=film, tri_sbt_index=tri_mat,
                             area_light=light, lights=lights)
    return pipe, film, rays


# --- context ---------------------------------------------------------------

def test_context_log_levels_and_properties():
    msgs = []
    ctx = api.DeviceContext(
        log_callback=lambda lvl, tag, msg: msgs.append((lvl, tag, msg)),
        log_level=api.LogLevel.PRINT, validation_mode=True, device="cpu")
    assert ("CACHE" in [t for _, t, _ in msgs]
            and (api.LogLevel.PRINT, "VALIDATION", "validation mode ALL")
            in msgs)
    ctx.log(api.LogLevel.ERROR, "TEST", "boom")
    assert msgs[-1] == (api.LogLevel.ERROR, "TEST", "boom")
    ctx.set_log_callback(lambda *a: msgs.append(a), api.LogLevel.FATAL)
    before = len(msgs)
    ctx.log(api.LogLevel.WARNING, "X", "filtered")
    assert len(msgs) == before
    jctx = japi.DeviceContext(cache_enabled=False)
    assert ctx.device == torch.device("cpu")
    assert ctx.get_property("platform") == "cpu"
    assert ctx.get_property("num_devices") == 1
    for k in ("rtcore_version", "limit_max_trace_depth",
              "limit_max_instance_id"):
        assert ctx.get_property(k) == jctx.get_property(k), k
    assert api.LogLevel.__dict__.items() >= {
        k: v for k, v in japi.LogLevel.__dict__.items()
        if k.isupper()}.items()
    with pytest.raises(ValueError):
        api.DeviceContext(debug_nans=True, device="cpu")


def test_context_cache_is_the_kernel_build_dir(tmp_path):
    """The cache calls read and set kernels.py's build directory; disabled,
    a build does not reuse a library it finds."""
    old = kernels.build_dir()
    try:
        ctx = api.DeviceContext(device="cpu")
        assert ctx.get_cache_location() == str(old)
        ctx.set_cache_location(str(tmp_path / "c3"))
        assert kernels.build_dir() == tmp_path / "c3"
        assert ctx.get_cache_location().endswith("c3")
        assert (tmp_path / "c3").is_dir()
        ctx.set_cache_enabled(False)
        assert not kernels._REUSE
    finally:
        kernels.set_build_dir(old)
    assert kernels._REUSE and kernels.build_dir() == old


def test_stage_timers_and_profiler_trace(tmp_path):
    t = StageTimers()
    with t.stage("render"):
        torch.ones(8).sum()
    with t.stage("display"):
        pass
    t.frame_done()
    rep = t.report()
    assert "render" in rep and "fps" in rep and "fps" in t.overlay()
    path = tmp_path / "trace.json"
    with StageTimers.profiler_trace(str(path)):
        torch.ones(64).cumsum(0)
    assert "traceEvents" in json.loads(path.read_text())


# --- modules, callables, threefry ------------------------------------------

def test_module_bound_values_and_compile():
    calls = []

    def shade(x, scale=1.0):
        calls.append(1)
        return x * scale

    mod = api.Module({"__closesthit__shade": shade},
                     bound_values={"scale": 3.0})
    fn = mod.get("__closesthit__shade")
    assert float(fn(torch.tensor(2.0))) == 6.0
    with pytest.raises(KeyError):
        mod.get("__miss__nope")
    compiled = mod.compile_entry("__closesthit__shade", torch.zeros(4))
    assert len(calls) == 2 and float(compiled(torch.ones(1))) == 3.0
    jobs = [(lambda x, i=i: x + i, (torch.zeros(4),)) for i in range(3)]
    execs = api.compile_with_tasks(jobs, max_workers=2)
    assert len(execs) == 3
    assert torch.equal(execs[2](torch.ones(4)), torch.full((4,), 3.0))


def test_abortable_compile_finishes_and_aborts():
    """A child that runs a small entry finishes (wait → True); one aborted
    at once is killed (poll → False)."""
    me = "optix_raytracer_tpu_torch.apps.module_create_abort"
    shapes = [((8, 8), "float32")]
    done = api.AbortableCompile(me, "heavy_entry", shapes, device="cpu")
    killed = api.AbortableCompile(me, "heavy_entry", shapes, device="cpu")
    killed.abort()
    assert killed.poll() is False
    assert done.wait(timeout=120) is True and done.poll() is True


def test_builtin_is_modules():
    """The sphere module's hits equal the JAX module's; every kind's
    make_primitives gives the JAX module's prim table, and a ray down the
    strand's midline hits it (test_api.py:81-101)."""
    mod, jmod = (api.builtin_is_module("sphere", device="cpu"),
                 japi.builtin_is_module("sphere"))
    o = np.array([[0.0, 0.0, 3.0], [0.5, 0.2, 3.0], [3.0, 3.0, 3.0]],
                 np.float32)
    d = np.array([[0.0, 0.0, -1.0]] * 3, np.float32)
    rays = Rays.make(torch.as_tensor(o), torch.as_tensor(d), 1e-3, 1e9)
    jrays = JRays.make(jnp.asarray(o), jnp.asarray(d), 1e-3, 1e9)
    h = mod.get("__intersection__sphere")(
        mod.make_primitives([(0.0, 0.0, 0.0)], [1.0]), rays)
    jh = jmod.get("__intersection__sphere")(
        jmod.make_primitives([(0.0, 0.0, 0.0)], [1.0]), jrays)
    assert np.array_equal(h.prim_id.numpy(), np.asarray(jh.prim_id))
    np.testing.assert_allclose(h.t.numpy(), np.asarray(jh.t), rtol=1e-6)
    assert mod.get("__intersection_any__sphere")(
        mod.make_primitives([(0.0, 0.0, 0.0)], [1.0]), rays).tolist() == [
            True, True, False]
    control = np.asarray([[-1.0, 0.0, 0.0], [-0.4, 0.0, 0.0],
                          [0.4, 0.0, 0.0], [1.0, 0.0, 0.0]], np.float32)
    widths = np.full((4,), 0.25, np.float32)
    down = Rays.make(torch.tensor([[0.0, 3.0, 0.0]]),
                     torch.tensor([[0.0, -1.0, 0.0]]), 1e-3, 1e9)
    assert set(api.BUILTIN_IS_KINDS) == set(japi.BUILTIN_IS_KINDS)
    for kind in api.BUILTIN_IS_KINDS[1:]:
        mod = api.builtin_is_module(kind, device="cpu")
        prims = mod.make_primitives(control, widths)
        jprims = japi.builtin_is_module(kind).make_primitives(control,
                                                              widths)
        assert np.array_equal(prims.kind.numpy(), np.asarray(jprims.kind))
        np.testing.assert_allclose(prims.params.numpy(),
                                   np.asarray(jprims.params)[:, :18],
                                   rtol=1e-6, atol=1e-7, err_msg=kind)
        hit = mod.get(f"__intersection__{kind}")(prims, down)
        assert bool(hit.valid[0]), kind
        expect = 3.0 if kind == "flat_quadratic" else 2.75
        np.testing.assert_allclose(float(hit.t[0]), expect, atol=0.1)
    with pytest.raises(ValueError):
        api.builtin_is_module("torus", device="cpu")


def test_callable_table_dispatch():
    """A scalar and a per-lane index on the device: the values of the JAX
    table's lax.switch (vmapped per lane)."""
    fns = [lambda x: x + 1.0, lambda x: x * 10.0, lambda x: x - 0.5]
    table = api.CallableTable(fns[:1])
    assert table.add(fns[1]) == 1 and table.add(fns[2]) == 2
    jtable = japi.CallableTable(fns)
    assert float(table.direct_call(torch.tensor(1), torch.tensor(3.0))) \
        == float(jtable.direct_call(jnp.int32(1), jnp.float32(3.0))) == 30.0
    idx = np.array([0, 1, 2, 1, 5, -1], np.int32)
    vals = np.arange(6, dtype=np.float32)[:, None] * np.ones((1, 3),
                                                            np.float32)
    out = table.direct_call(torch.as_tensor(idx), torch.as_tensor(vals))
    jout = jax.vmap(jtable.direct_call)(jnp.asarray(idx), jnp.asarray(vals))
    assert np.array_equal(out.numpy(), np.asarray(jout))
    assert len(table) == 3 and table.continuation_call is not None
    with pytest.raises(ValueError):
        api.CallableTable().direct_call(torch.tensor(0), torch.tensor(1.0))


@pytest.mark.parametrize("seed", [0, 7, 123456789])
def test_threefry_equals_jax_random(seed):
    """PRNGKey, fold_in and uniform of shapes (2, N), (N,) and (3, 5, 7):
    the same words and float bits as jax.random."""
    key, jkey = threefry.prng_key(seed, "cpu"), jax.random.PRNGKey(seed)
    assert key.tolist() == np.asarray(jax.random.key_data(jkey)).tolist()
    for i in (0, 1, 3, 4096):
        k, jk = threefry.fold_in(key, i), jax.random.fold_in(jkey, i)
        assert k.tolist() == np.asarray(jax.random.key_data(jk)).tolist()
        for shape in ((2, 1000), (7,), (3, 5, 7)):
            u = threefry.uniform(k, shape).numpy()
            ju = np.asarray(jax.random.uniform(jk, shape))
            assert np.array_equal(u.view(np.int32), ju.view(np.int32))


# --- accel ------------------------------------------------------------------

def test_accel_builds():
    """build_gas's byte count is its tensors'; the BVH starts past 512
    triangles; a custom GAS holds the prims; build_ias is the JAX
    instance table."""
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    h = api.build_gas(verts, np.array([[0, 1, 2]], np.int32), device="cpu")
    tensors = [h.vertices, h.indices, h.geom.tri_consts, h.geom.face_normal,
               h.geom.valid, h.geom.v0, h.geom.e1, h.geom.e2,
               h.geom.corner_normal, h.geom.corner_uv, h.geom.tangent,
               h.geom.uv_density]
    assert h.memory_usage_bytes == sum(t.numel() * t.element_size()
                                       for t in tensors)
    assert h.compacted_size_bytes == h.memory_usage_bytes
    assert h.bvh is None
    moved = api.refit_gas(h, verts + np.array([5, 0, 0], np.float32))
    assert moved.geom.v0[0].tolist() == [5.0, 0.0, 0.0]
    verts, idx, _, _, _ = B.knot_mesh(20, 14)
    big = api.build_gas(verts, idx, device="cpu")
    assert big.bvh is not None and big.bvh.num_nodes == 2 * 562 - 1
    assert big.memory_usage_bytes > h.memory_usage_bytes + 562 * 32
    from optix_raytracer_tpu_torch.accel import primitives as prim
    c = api.build_custom_gas([{"kind": prim.SPHERE, "center": (0, 0, 0),
                               "radius": 1.0}], device="cpu")
    assert c.prims.num == 1 and c.geom is None
    t1 = np.eye(4, dtype=np.float32)
    t1[0, 3], t1[:3, :3] = 5.0, 2.0 * np.eye(3)
    inst = api.build_ias([np.eye(4, dtype=np.float32), t1], [0, 3], [7, 8],
                         device="cpu")
    jinst = japi.build_ias([np.eye(4, dtype=np.float32), t1], [0, 3], [7, 8])
    for f in ("transform", "inv_transform"):
        np.testing.assert_allclose(getattr(inst, f).numpy(),
                                   np.asarray(getattr(jinst, f)), atol=1e-6)
    for f in ("sbt_offset", "instance_id"):
        assert np.array_equal(getattr(inst, f).numpy(),
                              np.asarray(getattr(jinst, f)))


# --- pipeline ---------------------------------------------------------------

@pytest.mark.parametrize("integrator", ["pathtrace", "whitted"])
def test_pipeline_launch_matches_jax(integrator):
    """Two progressive launches of the Cornell box through build_gas and
    SBT records: within the bars of the JAX pipeline's (ray counts equal;
    the JAX Whitted launch reports 0 rays, the port its integrator's
    count, equal to a direct render_whitted_sample's), and the port's
    launch bit-equal to its own direct render on the assembled scene."""
    lights = [POINT_LIGHT] if integrator == "whitted" else ()
    pipe, film, rays = launch(PORT, integrator, lights=lights)
    _, film2, rays2 = launch(PORT, integrator, film=film, lights=lights)
    _, jfilm, jrays = launch(JAX, integrator, lights=lights)
    _, jfilm2, jrays2 = launch(JAX, integrator, film=jfilm, lights=lights)
    assert int(film2.subframe) == int(jfilm2.subframe) == 4
    assert film2.subframe.dtype == torch.int64
    assert_image_close(film2.accum.numpy(), np.asarray(jfilm2.accum),
                       integrator)
    assert float(film2.accum.max()) > 0
    _, sbt, handle, tri_mat, light = PORT.cornell()
    scene = pipe._assemble_scene(sbt, handle, tri_mat, lights, light)
    assert scene.features == ("glass", "mirror", "pbr")
    cam = PORT.cam()
    if integrator == "pathtrace":
        assert int(rays) == int(jrays) and int(rays2) == int(jrays2)
        ref, ref_rays = render_accumulate(scene, cam, Film.create(H, W, "cpu"),
                                          W, H, samples_per_launch=2,
                                          max_depth=2)
        assert torch.equal(film.accum, ref.accum)
        assert int(ref_rays) == int(rays)
    else:
        assert int(jrays) == 0
        ref = Film.create(H, W, "cpu")
        total = 0
        for _ in range(2):
            rad, r = render_whitted_sample(scene, cam, W, H, ref.subframe,
                                           max_depth=2)
            ref, total = ref.accumulate(rad), total + int(r)
        assert torch.equal(film.accum, ref.accum) and int(rays) == total


def test_pipeline_mesh_past_512_matches_jax():
    """build_gas of the 562-triangle knot (an LBVH in both packages): the
    JAX pipeline walks it on the CPU, the port's scene takes its cluster
    table (the plain walks); the launches agree within the bars with
    equal ray counts."""
    verts, idx, _, tri_mat, light = B.knot_mesh(20, 14)
    out = {}
    for pkg in (PORT, JAX):
        handle = pkg.api.build_gas(verts, idx, **pkg.dev)
        assert handle.bvh is not None
        groups, sbt = pkg.records(B.KNOT_MATERIALS)
        pipe = pkg.api.Pipeline(program_groups=groups, max_trace_depth=2,
                                samples_per_launch=2)
        lgt = pkg.Light.make(*light, (10.0, 10.0, 10.0), **pkg.dev)
        cam = pkg.B.knot_camera(W, H).params(*(["cpu"] if pkg.port else []))
        if pkg.port:
            scene = pipe._assemble_scene(sbt, handle, tri_mat, (), lgt)
            assert scene.has_clusters and scene.has_bvh
        out[pkg.port] = pipe.launch(sbt, handle, cam, W, H,
                                    tri_sbt_index=tri_mat, area_light=lgt)
    (film, rays), (jfilm, jrays) = out[True], out[False]
    assert int(rays) == int(jrays)
    assert_image_close(film.accum.numpy(), np.asarray(jfilm.accum), "knot")
    assert float(film.accum.mean()) > 0


# --- exceptions ---------------------------------------------------------------

def test_exception_counters_match_jax():
    """check_radiance on injected NaN / inf / negative values, check_raygen
    on a clean and a NaN camera, launch_diagnostics on a launch's sum (the
    JAX package's on the films whose running means hide it): the JAX
    counters."""
    rad = np.zeros((4, 4, 3), np.float32)
    rad[0, 0, 1] = np.nan
    rad[1, 2, 0] = np.inf
    rad[2, 1, 2] = -np.inf
    rad[3, 3, 2] = -0.5
    d = exc.check_radiance(torch.as_tensor(rad))
    jd = jexc.check_radiance(jnp.asarray(rad))
    assert {k: int(v) for k, v in d.items()} == {
        k: int(v) for k, v in jd.items()} == {"nonfinite_radiance": 3,
                                              "negative_radiance": 1}
    for eye in ((278.0, 273.0, -900.0), (np.nan, 273.0, -900.0)):
        cam, jcam = PORT.cam(), dict(JAX.cam())
        cam["eye"] = torch.tensor(eye, dtype=torch.float32)
        jcam["eye"] = jnp.asarray(eye, jnp.float32)
        assert int(exc.check_raygen(cam, W, H)) == int(
            jexc.check_raygen(jcam, W, H))
    jf0 = JFilm.create(4, 4).replace(accum=jnp.full((4, 4, 3), 0.25),
                                     subframe=jnp.asarray(4, jnp.int32))
    jf1 = jf0.accumulate(jnp.asarray(rad))
    d = exc.launch_diagnostics(PORT.cam(4, 4), torch.as_tensor(rad), 4, 4)
    jd = jexc.launch_diagnostics(JAX.cam(4, 4), jf0, jf1, 4, 4)
    assert {k: int(v) for k, v in d.items()} == {
        k: int(v) for k, v in jd.items()}
    assert exc.format_exceptions(d) == jexc.format_exceptions(jd) != ""


def test_validation_launch_matches_jax():
    """A validation-mode launch through the context: a NaN camera fires
    invalid_ray on every pixel with the JAX log line; a clean launch counts
    zeros and logs none; without validation nothing is counted; a launch
    whose light is NaN gives the JAX counters, and with debug_nans raises.
    A film carrying a NaN into a clean launch: the reference counts it
    again (its sum is recovered from the films), the port counts the
    launch's own sum and reads 0."""
    for eye in ((np.nan, 273.0, -900.0), None):
        logs, jlogs, cams = [], [], []
        for pkg, sink in ((PORT, logs), (JAX, jlogs)):
            cam = dict(pkg.cam())
            if eye is not None:
                cam["eye"] = (torch.tensor(eye, dtype=torch.float32)
                              if pkg.port else jnp.asarray(eye, jnp.float32))
            ctx = pkg.api.DeviceContext(
                log_callback=lambda lvl, tag, msg, sink=sink: sink.append(
                    (lvl, tag, msg)), log_level=4, validation_mode=True,
                **({"device": "cpu"} if pkg.port else
                   {"cache_enabled": False}))
            pipe, _, _ = launch(pkg, cam=cam, context=ctx)
            cams.append(pipe.last_exceptions)
        assert cams[0] == cams[1]
        errs = [m for _, t, m in logs if t == "EXCEPTION"]
        assert errs == [m for _, t, m in jlogs if t == "EXCEPTION"]
        if eye is None:
            assert cams[0] == {"invalid_ray": 0, "nonfinite_radiance": 0,
                               "negative_radiance": 0} and not errs
        else:
            assert cams[0]["invalid_ray"] == W * H and errs == [
                f"invalid_ray={W * H}"]
    pipe, _, _ = launch(PORT)
    assert pipe.last_exceptions is None
    nan = np.full((H, W, 3), 0.1, np.float32)
    nan[3, 4, 1] = np.nan
    films = (Film(accum=torch.as_tensor(nan), subframe=torch.tensor(2)),
             JFilm(accum=jnp.asarray(nan), subframe=jnp.asarray(2, jnp.int32)))
    found, lit = [], []
    for pkg, f in zip((PORT, JAX), films):
        ctx = pkg.api.DeviceContext(validation_mode=True, **(
            {"device": "cpu"} if pkg.port else {"cache_enabled": False}))
        pipe, _, _ = launch(pkg, film=f, context=ctx)
        found.append(pipe.last_exceptions)
        pipe, _, _ = launch(pkg, context=ctx, emission=(np.nan,) * 3)
        lit.append(pipe.last_exceptions)
    assert found[0]["nonfinite_radiance"] == 0
    assert found[1]["nonfinite_radiance"] == 1
    assert lit[0] == lit[1] and lit[0]["nonfinite_radiance"] > 0
    ctx = api.DeviceContext(validation_mode=True, debug_nans=True,
                            device="cpu")
    launch(PORT, film=films[0], context=ctx)
    with pytest.raises(FloatingPointError):
        launch(PORT, context=ctx, emission=(np.nan,) * 3)


def test_continued_film_counts_the_launch_sum():
    """Three validation launches on one film, the third under a black
    light, so most pixels gain exactly 0. Each launch on a new or clean
    film counts alike in both packages; on the third the reference's sum,
    recovered as n1 accum1 - n0 accum0 from the films, rounds below zero on
    some pixels and counts them as negative_radiance, while the port counts
    its launch's own sum and reads 0 (ROADMAP.md Queue 3: a deliberate
    divergence)."""
    counts = {}
    for pkg in (PORT, JAX):
        ctx = pkg.api.DeviceContext(validation_mode=True, **(
            {"device": "cpu"} if pkg.port else {"cache_enabled": False}))
        film, counts[pkg.port] = None, []
        for i in range(3):
            pipe, film, _ = launch(pkg, film=film, context=ctx,
                                   emission=(0.0,) * 3 if i == 2 else None)
            counts[pkg.port].append(pipe.last_exceptions)
    assert counts[True][:2] == counts[False][:2]
    assert counts[True][2]["negative_radiance"] == 0
    assert counts[False][2]["negative_radiance"] > 0
    assert all(c["nonfinite_radiance"] == 0 and c["invalid_ray"] == 0
               for c in counts[True] + counts[False])


# --- checkpoints --------------------------------------------------------------

def test_checkpoint_round_trips_between_packages(tmp_path):
    """A film saved by either package loads in the other (accum bits,
    subframe, variance planes, camera, config) and resumes to the straight
    run's image: bit-equal within the port, within the bars across."""
    cam_desc = B.cornell_camera(W, H)
    _, straight, _ = launch(PORT)
    _, straight, _ = launch(PORT, film=straight)
    _, jstraight, _ = launch(JAX)
    _, jstraight, _ = launch(JAX, film=jstraight)
    _, half, _ = launch(PORT)
    _, jhalf, _ = launch(JAX)
    ckpt.save_checkpoint(str(tmp_path / "port.npz"), half, cam_desc,
                         {"spp": 2})
    jckpt.save_checkpoint(str(tmp_path / "jax.npz"), jhalf,
                          jb.cornell_camera(W, H), {"spp": 2})
    # the port's own round trip resumes bit for bit
    back, cam_back, cfg = ckpt.load_checkpoint(str(tmp_path / "port.npz"),
                                               "cpu")
    assert cam_back == cam_desc and cfg == {"spp": 2}
    assert back.subframe.dtype == torch.int64 and int(back.subframe) == 2
    _, resumed, _ = launch(PORT, film=back)
    assert torch.equal(resumed.accum, straight.accum)
    # the JAX package reads the port's file and resumes
    jback, jcam_back, jcfg = jckpt.load_checkpoint(str(tmp_path / "port.npz"))
    assert jback.subframe.dtype == jnp.int32 and int(jback.subframe) == 2
    assert np.array_equal(np.asarray(jback.accum).view(np.int32),
                          half.accum.numpy().view(np.int32))
    assert jcam_back == jb.cornell_camera(W, H) and jcfg == {"spp": 2}
    _, jresumed, _ = launch(JAX, film=jback)
    assert_image_close(np.asarray(jresumed.accum), np.asarray(jstraight.accum),
                       "port film resumed by JAX")
    # the port reads the JAX file and resumes
    pback, pcam, _ = ckpt.load_checkpoint(str(tmp_path / "jax.npz"), "cpu")
    assert pcam == cam_desc and int(pback.subframe) == 2
    _, presumed, _ = launch(PORT, film=pback)
    assert_image_close(presumed.accum.numpy(), straight.accum.numpy(),
                       "JAX film resumed by the port")
    # variance planes both ways
    var = Film.create(2, 2, "cpu", track_variance=True).accumulate(
        torch.rand(2, 2, 3, generator=torch.Generator().manual_seed(0)))
    ckpt.save_checkpoint(str(tmp_path / "var.npz"), var)
    jvar, none_cam, _ = jckpt.load_checkpoint(str(tmp_path / "var.npz"))
    assert none_cam is None and int(jvar.launches) == 1
    assert np.array_equal(np.asarray(jvar.sq), var.sq.numpy())
    jckpt.save_checkpoint(str(tmp_path / "jvar.npz"), jvar)
    pvar, _, _ = ckpt.load_checkpoint(str(tmp_path / "jvar.npz"), "cpu")
    assert torch.equal(pvar.sq, var.sq) and int(pvar.launches) == 1
    assert pvar.launches.dtype == torch.int64

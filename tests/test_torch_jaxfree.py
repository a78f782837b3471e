"""The port needs no JAX: in a process where `import jax` and `import flax`
fail, the package imports, renders an 8x8 1-spp Cornell box on the CPU and
saves it as a PNG through its own writer, and builds the small knot scene (its cluster table through
the port's own native binding, or morton order without a compiler) and
renders it 8x8 at 8 samples per launch through the sample-major path, again
through the cluster-major queue (ORT_QWALK=1), then again with the
supercluster tier forced (the same image within the parity
bars, the same ray count), renders the prims + glass scene 8x8 (custom
prims, glass lanes) through the fused kernel's plain version, and builds
the instanced Cornell box through its own Scene class, instance table and
transforms and the small smooth knot, rendering each 8x8 through the fused
kernel's plain version (the instance loop, the shading-frame epilogue),
renders bench.py's textured scene 8x8 through the fused kernel's plain
version (the texture lanes), runs kernel 9's plain version from the
port's tools/bench_texfetch, and renders the Whitted scene 8x6 through the
Whitted app and the small smooth knot 8x8 through the meshviewer's
headlight rig (the Whitted integrator, its light table and Film.accumulate),
renders the cutouts app 8x8, builds a 602-triangle cutout grid (a cluster
scene; its 302 certain-solid triangles get no table of their own) and
holds its micromap occlusion to the alpha loop, runs the opacity-micromap
and displaced-micromesh apps, and renders the textured Whitted scene 8x6
(the micromaps, the alpha paths, the cut lanes and the textured lane),
runs `pathtracer --denoise` 8x8 (render_aovs and the trained net, its
weights read from the port's own copy) and a Denoiser invoke per backend,
and writes and reads an EXR with the port's codec.
Until then no module of the JAX package is loaded; the JAX package's reader
then checks the PNG."""
import os
import subprocess
import sys

_SCRIPT = r"""
import os
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import numpy as np
import optix_raytracer_tpu_torch
from optix_raytracer_tpu_torch.apps import pathtracer
from optix_raytracer_tpu_torch.core.film import make_color
from optix_raytracer_tpu_torch.io.image import save_image
accum, film, rays = pathtracer.render(8, 8, samples=1, max_depth=2,
                                      device="cpu")
img = make_color(accum).numpy()
save_image(sys.argv[1], img)
assert np.isfinite(accum.numpy()).all() and int(rays) > 64
from optix_raytracer_tpu_torch.core.film import Film
from optix_raytracer_tpu_torch.scene.builtins import knot_camera, knot_scene
from optix_raytracer_tpu_torch.wavefront.engine import render_accumulate
knot = knot_scene(20, 14, device="cpu")
assert knot.has_clusters and knot.clusters.num_clusters == 5
film, rays = render_accumulate(knot, knot_camera(8, 8).params("cpu"),
                               Film.create(8, 8, "cpu"), 8, 8,
                               samples_per_launch=8, max_depth=2)
assert np.isfinite(film.accum.numpy()).all() and int(rays) > 8 * 8 * 8
assert float(film.accum.mean()) > 0
from optix_raytracer_tpu_torch.accel import qwalk
os.environ["ORT_QWALK"] = "1"
q_film, q_rays = render_accumulate(knot, knot_camera(8, 8).params("cpu"),
                                   Film.create(8, 8, "cpu"), 8, 8,
                                   samples_per_launch=8, max_depth=2)
del os.environ["ORT_QWALK"]
assert qwalk.STATS["any_queue"] + qwalk.STATS["any_overflow"] == 2
assert int(q_rays) == int(rays)
assert np.allclose(q_film.accum.numpy(), film.accum.numpy(), atol=2e-3,
                   rtol=1e-3)
from optix_raytracer_tpu_torch.accel import clusters
clusters.MAX_STREAM_CLUSTERS, clusters.SC_CLUSTERS = 2, 2
tier = knot_scene(20, 14, device="cpu")
assert tier.clusters.comp.shape[0] == 6
sc_film, sc_rays = render_accumulate(tier, knot_camera(8, 8).params("cpu"),
                                     Film.create(8, 8, "cpu"), 8, 8,
                                     samples_per_launch=8, max_depth=2)
assert int(sc_rays) == int(rays)
assert np.allclose(sc_film.accum.numpy(), film.accum.numpy(), atol=2e-3,
                   rtol=1e-3)
from optix_raytracer_tpu_torch.scene.builtins import prims_camera, prims_scene
prims = prims_scene("cpu")
assert prims.prims.num == 4 and prims.features == ("glass",)
p_film, p_rays = render_accumulate(prims, prims_camera(8, 8).params("cpu"),
                                   Film.create(8, 8, "cpu"), 8, 8,
                                   samples_per_launch=2, max_depth=3,
                                   impl="fused")
assert np.isfinite(p_film.accum.numpy()).all() and int(p_rays) > 8 * 8 * 2
assert float(p_film.accum.max()) > 0
from optix_raytracer_tpu_torch.accel import tlas
from optix_raytracer_tpu_torch.core import transforms
from optix_raytracer_tpu_torch.scene import scene as host_scene
from optix_raytracer_tpu_torch.scene.builtins import (cornell_box_instanced,
                                                     cornell_camera)
inst = cornell_box_instanced("cpu")
assert isinstance(inst.instances, tlas.InstanceTable)
assert inst.instances.num == 3 and inst.num_triangles == 22
assert transforms.to_4x4(inst.instances.transform).shape == (3, 4, 4)
assert host_scene.Scene().miss_color == (0.05, 0.05, 0.12)
small = knot_scene(8, 6, device="cpu")
assert small.geom.smooth and not small.has_clusters
for sc, cam in ((inst, cornell_camera(8, 8)), (small, knot_camera(8, 8))):
    s_film, s_rays = render_accumulate(sc, cam.params("cpu"),
                                       Film.create(8, 8, "cpu"), 8, 8,
                                       samples_per_launch=2, max_depth=2,
                                       impl="fused")
    assert np.isfinite(s_film.accum.numpy()).all() and int(s_rays) > 8 * 8 * 2
    assert float(s_film.accum.max()) > 0
from optix_raytracer_tpu_torch.scene.builtins import (textured_camera,
                                                     textured_scene)
tex = textured_scene("cpu")
assert tex.has_textures and tex.bundles.shape[0] == 1
t_film, t_rays = render_accumulate(tex, textured_camera(8, 8).params("cpu"),
                                   Film.create(8, 8, "cpu"), 8, 8,
                                   samples_per_launch=1, max_depth=2,
                                   impl="fused")
assert np.isfinite(t_film.accum.numpy()).all() and int(t_rays) > 8 * 8
assert float(t_film.accum.max()) > 0
from optix_raytracer_tpu_torch.tools import bench_texfetch
idx, base, local = bench_texfetch.make_workload(1024, 1024, 128)
_, atlas_bf = bench_texfetch.make_atlas("cpu", 1024)
rows = bench_texfetch.onehot_fetch(atlas_bf, *bench_texfetch.tile_window(
    base, local, 128), 128)
assert (rows == atlas_bf[idx.long()].float()).all()
from optix_raytracer_tpu_torch.apps import meshviewer, whitted
from optix_raytracer_tpu_torch.core.rays import Rays
from optix_raytracer_tpu_torch.wavefront import whitted as whitted_mod
from optix_raytracer_tpu_torch.scene.builtins import knot_host_scene
w_accum, w_film, w_rays = whitted.render(8, 6, samples=1, max_depth=3,
                                         device="cpu")
assert w_accum.shape == (6, 8, 3) and np.isfinite(w_accum.numpy()).all()
assert int(w_film.subframe) == 1 and int(w_rays) > 8 * 6
assert float(w_accum.mean()) > 0
m_accum, _, m_rays = meshviewer.render(None, 8, 8, samples=1, max_depth=2,
                                       scene=knot_host_scene(8, 6),
                                       device="cpu")
assert np.isfinite(m_accum.numpy()).all() and int(m_rays) > 0
from optix_raytracer_tpu_torch.accel import micromap
from optix_raytracer_tpu_torch.apps import (cutouts, displaced_micromesh,
                                            opacity_micromap)
from optix_raytracer_tpu_torch.wavefront import intersect
c_accum, c_film, c_rays = cutouts.render(8, 8, samples=2, max_depth=3,
                                         device="cpu")
assert np.isfinite(c_accum.numpy()).all() and int(c_rays) > 8 * 8 * 2
grid = cutouts.cutout_grid("cpu", nx=20, ny=15)
assert grid.has_clusters and grid.omm_solid_clusters is None
assert grid.omm_all_certain and grid.omm_solid_geom.num_triangles == 302
g_rays = Rays.make(grid.geom.v0[:64] + 1.0, -grid.geom.face_normal[:64],
                   tmin=1e-3, tmax=1e4)
assert (intersect.scene_any(grid, g_rays)
        == intersect._scene_any_alpha(grid, g_rays)).all()
o_accum, o_stats, _ = opacity_micromap.render(8, 8, samples=1, device="cpu")
assert o_stats["micro_states"].shape == (4, 64)
assert (o_stats["micro_states"] != micromap.UNKNOWN_OPAQUE).all()
d_accum, d_tris, _ = displaced_micromesh.render(8, 8, level=2, samples=1,
                                                device="cpu")
assert d_tris == 32 and np.isfinite(d_accum.numpy()).all()
from optix_raytracer_tpu_torch.scene.builtins import (textured_whitted_camera,
                                                     textured_whitted_scene)
tw_film, _ = whitted_mod.render_whitted(
    textured_whitted_scene("cpu"), textured_whitted_camera(8, 6).params(
        "cpu"), 8, 6, 1, max_depth=2)
assert np.isfinite(tw_film.accum.numpy()).all()
from optix_raytracer_tpu_torch.api import Denoiser
from optix_raytracer_tpu_torch.denoise import kpcnn
from optix_raytracer_tpu_torch.io import exr
pathtracer.main(["--file", sys.argv[1] + ".ppm", "--dim", "8x8", "--samples",
                 "1", "--depth", "2", "--denoise", "--device", "cpu"])
assert kpcnn.WEIGHTS_PATH.startswith(os.path.dirname(
    optix_raytracer_tpu_torch.__file__) + os.sep)
noisy = np.random.default_rng(0).gamma(1.0, 0.5, (8, 8, 3)).astype(
    np.float32)
for backend in ("kpcnn", "atrous"):
    den = Denoiser(backend=backend, device="cpu").setup(8, 8)
    out = den.invoke(noisy, albedo=np.ones_like(noisy))
    assert out.shape == (8, 8, 3) and np.isfinite(out.numpy()).all()
exr.write_exr(sys.argv[1] + ".exr", out.numpy())
assert exr.read_exr(sys.argv[1] + ".exr").shape == (8, 8, 3)
assert not any(m == "jax" or m.startswith(("jax.", "flax"))
               for m in sys.modules if sys.modules[m] is not None)
assert not any(m == "optix_raytracer_tpu"
               or m.startswith("optix_raytracer_tpu.") for m in sys.modules)
from optix_raytracer_tpu.io.image import load_image
back = load_image(sys.argv[1])
assert back.shape == (8, 8, 4) and (back == img).all()
print("OK")
"""


def test_port_runs_without_jax(tmp_path):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", _SCRIPT,
                          str(tmp_path / "c.png")],
                         capture_output=True, text=True, env=env, cwd=root,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("OK")


_SCRIPT_ITEM9 = r"""
import struct
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import numpy as np
from optix_raytracer_tpu_torch.accel import curves as cv
from optix_raytracer_tpu_torch.apps import (curves, hair, motion_geometry,
                                            ribbons, simple_motion_blur,
                                            volume_viewer)
from optix_raytracer_tpu_torch.io import nanovdb
out = sys.argv[1]
for accum in (simple_motion_blur.render(8, 8, samples=2, device="cpu")[0],
              simple_motion_blur.render_engine(8, 8, 2, device="cpu")[0],
              motion_geometry.render(8, 8, samples=2, device="cpu")[0],
              curves.render(8, 8, samples=1, device="cpu")[0],
              curves.render(8, 8, samples=1, kind=cv.QUADRATIC_BSPLINE,
                            swept=True, device="cpu")[0],
              ribbons.render(8, 8, samples=1, device="cpu")[0],
              hair.render(8, 8, samples=1, spline=cv.CUBIC_BSPLINE,
                          swept=True, device="cpu")[0],
              volume_viewer.render(8, 8, samples=1, res=16, num_steps=8,
                                   device="cpu")[0],
              volume_viewer.render_engine(8, 8, 2, res=16, max_depth=2,
                                          device="cpu")[0]):
    a = accum.numpy()
    assert a.shape == (8, 8, 3) and np.isfinite(a).all() and a.max() > 0
vals = np.zeros((16, 16, 16), np.float32)
vals[4:12, 2:10, 5:14] = np.random.default_rng(0).uniform(0.1, 1, (8, 8, 9))
nanovdb.write_nvdb(out + ".nvdb", vals, ijk_min=(8, 0, -8),
                   codec=nanovdb.CODEC_ZIP)
g = nanovdb.read_nvdb(out + ".nvdb")
assert (g.values == vals[4:12, 2:10, 5:14]).all()
grid = nanovdb.load_density_grid(out + ".nvdb", device="cpu")
assert grid.density.shape == (8, 8, 9)
pts = np.random.default_rng(1).normal(size=(9, 3)).astype(np.float32)
header = struct.pack("<4sIIIIIII", b"HAIR", 2, 9, 1 | 2, 0, 0, 0, 0)
header += b"\x00" * (128 - len(header))
with open(out + ".hair", "wb") as f:
    f.write(header + np.array([3, 4], np.uint16).tobytes() + pts.tobytes())
strands, radii = cv.load_hair_file(out + ".hair")
assert [len(s) for s in strands] == [4, 5]
assert (np.concatenate(strands) == pts).all()
volume_viewer.main(["--file", out + ".ppm", "--dim", "8x8", "--samples", "1",
                    "--steps", "8", "--grid", out + ".nvdb", "--engine",
                    "--device", "cpu"])
hair.main(["--file", out + "h.ppm", "--dim", "8x8", "--samples", "1",
           "--hair", out + ".hair", "--device", "cpu"])
assert not any(m == "jax" or m.startswith(("jax.", "flax"))
               for m in sys.modules if sys.modules[m] is not None)
assert not any(m == "optix_raytracer_tpu"
               or m.startswith("optix_raytracer_tpu.") for m in sys.modules)
from optix_raytracer_tpu.io import nanovdb as jnanovdb
assert (jnanovdb.read_nvdb(out + ".nvdb").values == g.values).all()
print("OK")
"""


def test_motion_curves_volumes_run_without_jax(tmp_path):
    """With `import jax` and `import flax` failing, the six apps of motion
    blur, curves and volumes render 8x8 on the CPU (the standalone and
    engine modes of the motion-blur and volume viewer apps, capsule and
    swept curves, swept hair), a .nvdb (ZIP, non-zero origin) and a .hair
    file written here read back through the port's codec and reader, and
    the volume viewer and hair CLIs read them. Until then no module of the
    JAX package is loaded; the JAX package's reader then reads the .nvdb
    the port wrote."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", _SCRIPT_ITEM9,
                          str(tmp_path / "v")],
                         capture_output=True, text=True, env=env, cwd=root,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("OK")


_SCRIPT_API = r"""
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import numpy as np
import torch
from optix_raytracer_tpu_torch import api
from optix_raytracer_tpu_torch.accel import clusters, lbvh, traverse
from optix_raytracer_tpu_torch.apps import (bound_values, callable_programs,
                                            compile_with_tasks,
                                            dynamic_geometry,
                                            module_create_abort, sphere)
from optix_raytracer_tpu_torch.core import checkpoint, threefry
from optix_raytracer_tpu_torch.core.film import Film
from optix_raytracer_tpu_torch.scene import builtins as B
from optix_raytracer_tpu_torch.shade.lights import ParallelogramLight
from optix_raytracer_tpu_torch.wavefront import exceptions
from optix_raytracer_tpu_torch.wavefront.engine import render_accumulate
out = sys.argv[1]
logged = []
ctx = api.DeviceContext(log_callback=lambda *m: logged.append(m),
                        log_level=4, validation_mode=True, device="cpu")
verts, idx, tri_mat = B.quads_to_triangles(B._CORNELL_QUADS)
handle = api.build_gas(verts, idx, device="cpu")
mod = api.Module({}, name="pt")
groups = [api.ProgramGroup(api.ProgramGroupKind.RAYGEN, "__raygen__rg", mod),
          api.ProgramGroup(api.ProgramGroupKind.HITGROUP, "__closesthit__", mod)]
sbt = api.ShaderBindingTable(
    raygen_record=api.SbtRecord(groups[0]),
    hitgroup_records=[api.SbtRecord(groups[1], m) for m in B.CORNELL_MATERIALS])
light = ParallelogramLight.make(B.CORNELL_LIGHT_CORNER, B.CORNELL_LIGHT_V1,
                                B.CORNELL_LIGHT_V2, B.CORNELL_LIGHT_EMISSION,
                                "cpu")
pipe = api.Pipeline(context=ctx, program_groups=groups, max_trace_depth=2,
                    samples_per_launch=2)
film, rays = pipe.launch(sbt, handle, B.cornell_camera(8, 8).params("cpu"),
                         8, 8, tri_sbt_index=tri_mat, area_light=light)
assert int(rays) > 8 * 8 * 2 and pipe.last_exceptions["invalid_ray"] == 0
assert exceptions.format_exceptions(pipe.last_exceptions) == ""
checkpoint.save_checkpoint(out + ".npz", film, B.cornell_camera(8, 8),
                           {"spp": 2})
back, cam, cfg = checkpoint.load_checkpoint(out + ".npz", "cpu")
assert torch.equal(back.accum, film.accum) and cfg == {"spp": 2}
assert len(threefry.uniform(threefry.prng_key(7, "cpu"), (2, 5)).reshape(-1)) == 10
clusters.MAX_SUPERCLUSTERS, clusters.SC_CLUSTERS = 1, 2
knot = B.knot_scene(20, 14, device="cpu")
assert not knot.has_clusters and not knot.has_bvh
verts, idx, normals, tm, lgt = B.knot_mesh(20, 14)
gas = api.build_gas(verts, idx, device="cpu")
assert gas.bvh.num_nodes == 2 * 562 - 1
scene = api.Pipeline()._assemble_scene(
    sbt, gas, np.zeros(562, np.int32),
    area_light=ParallelogramLight.make(*lgt, (10, 10, 10), "cpu"))
assert scene.has_bvh and not scene.has_clusters
k_film, k_rays = render_accumulate(scene, B.knot_camera(8, 8).params("cpu"),
                                   Film.create(8, 8, "cpu"), 8, 8,
                                   samples_per_launch=1, max_depth=2)
assert np.isfinite(k_film.accum.numpy()).all() and int(k_rays) > 8 * 8
for app, args in ((sphere, []), (callable_programs, ["--shade", "all"]),
                  (bound_values, ["--compare"]),
                  (dynamic_geometry, ["--frames", "1"]),
                  (dynamic_geometry, ["--frames", "1", "--ias"])):
    app.main(["--dim", "8x8", "--file", out + ".ppm", "--device", "cpu"]
             + args)
compile_with_tasks.main(["--jobs", "1", "--workers", "1", "--device", "cpu"])
module_create_abort.main(["--dim", "8x8", "--file", out + ".ppm",
                          "--device", "cpu"])
assert not any(m == "jax" or m.startswith(("jax.", "flax"))
               for m in sys.modules if sys.modules[m] is not None)
assert not any(m == "optix_raytracer_tpu"
               or m.startswith("optix_raytracer_tpu.") for m in sys.modules)
del sys.modules["jax"], sys.modules["flax"]
from optix_raytracer_tpu.core import checkpoint as jcheckpoint
jfilm, jcam, jcfg = jcheckpoint.load_checkpoint(out + ".npz")
assert (np.asarray(jfilm.accum) == film.accum.numpy()).all()
assert int(jfilm.subframe) == 2 and jcfg == {"spp": 2}
print("OK")
"""


def test_api_lbvh_and_api_apps_run_without_jax(tmp_path):
    """With `import jax` and `import flax` failing: a validation-mode
    pipeline launch of the Cornell box through build_gas and SBT records,
    its film checkpointed and read back, threefry draws, a knot past the
    (lowered) cluster cap through build_gas's LBVH and the engine's BVH
    walk, and the six apps of the API 8x8 through their main() (sphere,
    callable programs, bound values, dynamic geometry and its IAS mode,
    compile with tasks, module create abort). Until then no module of the
    JAX package is loaded; then JAX is let in and the JAX package's loader
    reads the port's checkpoint."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", _SCRIPT_API,
                          str(tmp_path / "a")],
                         capture_output=True, text=True, env=env, cwd=root,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("OK")


_SCRIPT_LOAD = r"""
import os
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import numpy as np
import torch
from optix_raytracer_tpu_torch.apps import (console, custom_primitive,
                                            dynamic_materials, hello,
                                            meshviewer, raycasting, triangle,
                                            viewer)
from optix_raytracer_tpu_torch.core.camera import Trackball
from optix_raytracer_tpu_torch.core.film import OutputBuffer
from optix_raytracer_tpu_torch.io import ktx2, meshio
from optix_raytracer_tpu_torch.io.image import load_image
from optix_raytracer_tpu_torch.scene import gltf
from optix_raytracer_tpu_torch.scene.scene import Scene
from optix_raytracer_tpu_torch.tools import model_probe as mp
out = sys.argv[1]
glb, meshes, mats, imgs = mp.write_knot_model(out + ".glb", 6, 5, 16)
g = gltf.load_gltf(glb)
assert len(g.meshes) == 2 and g.cameras and g.lights and g.animations
assert (g.textures[0] == imgs[0]).all()
assert len(gltf.pose_meshes(g, 0.5)) == 2
host = Scene.load(glb)
assert host.cameras and host.default_camera(16, 8).aspect == 2.0
v = np.concatenate([m["positions"] for m in meshes])
f = np.concatenate([meshes[0]["indices"],
                    meshes[1]["indices"] + len(meshes[0]["positions"])])
for path in (mp.write_obj(out + ".obj", v, f), mp.write_ply(out + ".ply",
                                                            v, f)):
    a = meshio.load_mesh(path)
    b = meshio.load_mesh(path, prefer_native=False)
    assert all((x == y).all() for x, y in zip(a[:2], b[:2]))
    assert Scene.load(path).finalize("cpu").num_triangles == 62
ktx2.write_ktx2(out + ".ktx2", imgs[0], supercompression="ZLIB")
assert (ktx2.read_ktx2_rgba(out + ".ktx2") == imgs[0]).all()
meshviewer.main(["--model", glb, "--dim", "8x8", "--samples", "1",
                 "--file", out + "_m.ppm", "--device", "cpu"])
meshviewer.main(["--model", glb, "--animate", "2", "--dim", "8x8",
                 "--samples", "1", "--file", out + "_a.ppm", "--device",
                 "cpu"])
assert not (load_image(out + "_a_000.ppm") == load_image(out + "_a_001.ppm")
            ).all()
for app, args in ((hello, []), (triangle, []), (custom_primitive, []),
                  (dynamic_materials, []), (raycasting, []),
                  (raycasting, ["--model", glb])):
    app.main(["--dim", "8x8", "--file", out + ".ppm", "--device", "cpu"]
             + args)
console.main(["--samples", "1", "--device", "cpu"])
viewer.main(["--dim", "8x8", "--frames", "1", "--spf", "0", "--depth", "2",
             "--file", out + "_v.ppm", "--device", "cpu", "--checkpoint",
             out + "_v.npz"])
vw, img = viewer.main(["--dim", "8x8", "--frames", "1", "--model", glb,
                       "--file", out + "_v.ppm", "--device", "cpu"])
assert vw.integrator == "whitted" and img.shape == (8, 8, 4)
Trackball(vw.camera).orbit(5, 5)
assert OutputBuffer(4, 2).get_host().shape == (2, 4, 4)
assert not any(m == "jax" or m.startswith(("jax.", "flax"))
               for m in sys.modules if sys.modules[m] is not None)
assert not any(m == "optix_raytracer_tpu"
               or m.startswith("optix_raytracer_tpu.") for m in sys.modules)
assert "PIL" not in sys.modules
print("OK")
"""


def test_loaders_and_last_apps_run_without_jax(tmp_path):
    """With `import jax` and `import flax` failing: a glTF model written
    in-process (the small knot with a KTX2 map, camera, light, spin) loads
    through the port's glTF loader and `Scene.load`, the same mesh as OBJ
    and PLY through both parsers, a KTX2 file round-trips, and the
    meshviewer (`--model`, `--animate 2`), hello, triangle, custom
    primitive, dynamic materials, raycasting (Cornell and `--model`),
    console and viewer (`--checkpoint`, `--model`) apps run 8x8 on the CPU
    through their main(); neither JAX, nor the JAX package, nor PIL (the
    images are KTX2 and the outputs .ppm) is loaded."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", _SCRIPT_LOAD,
                          str(tmp_path / "l")],
                         capture_output=True, text=True, env=env, cwd=root,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("OK")


_SCRIPT_MULTI = r"""
import os
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import numpy as np
import torch
from optix_raytracer_tpu_torch.apps import multigpu, nvlink
from optix_raytracer_tpu_torch.core import checkpoint
from optix_raytracer_tpu_torch.core.film import Film
from optix_raytracer_tpu_torch.denoise import kpcnn
from optix_raytracer_tpu_torch.io.image import load_image
from optix_raytracer_tpu_torch.multichip import (distributed, memory,
                                                 multislice, tiles)
from optix_raytracer_tpu_torch.scene.builtins import cornell_camera
from optix_raytracer_tpu_torch.shade import texture
from optix_raytracer_tpu_torch.tools import train_denoiser
out = sys.argv[1]
multigpu.main(["--file", out + "_m.ppm", "--dim", "8x8", "--samples", "2",
               "--rows", "2", "--sample-shards", "1", "--tint", "--device",
               "cpu"])
assert load_image(out + "_m.ppm").shape == (8, 8, 3)
reports = nvlink.main(["--file", out + "_n.ppm", "--dim", "8x8",
                       "--samples", "1", "--tex-size", "16", "--budget-mb",
                       "0.001", "--ranks", "2", "--check", "--device", "cpu"])
assert reports[0]["mode"] == "shard_island" and all(
    r["bit_equal"] for r in reports)
mesh = multislice.make_multislice_mesh(1, 1, 1, device="cpu")
film = Film.create(8, 8, "cpu")
checkpoint.save_checkpoint_sharded(out + "_ck", film, mesh,
                                   cornell_camera(8, 8), {"a": 1})
back, cam, cfg = checkpoint.load_checkpoint_sharded(out + "_ck", "cpu")
assert torch.equal(back.accum, film.accum) and cfg == {"a": 1}
assert distributed.detect_config("h:1", 2, 1) == ("h:1", 2, 1)
assert memory.plan_texture_placement(1 << 30, mesh)["mode"] == "shard_island"
mips = torch.tensor([[[0, 0, 4, 4], [0, 4, 2, 2], [0, 6, 1, 1]]],
                    dtype=torch.int32)
fp = texture.tex_footprint_2d(mips, torch.tensor([0]),
                              torch.tensor([[0.5, 0.5]]))
assert fp["level"].tolist() == [0]
atlas = torch.rand(1, 4, 7, 4)
assert texture.sample_trilinear(atlas, mips, torch.tensor([0]),
                                torch.tensor([[0.5, 0.5]]),
                                torch.tensor([0.3])).shape == (1, 4)
train_denoiser.main(["--data", out + "_d", "--scenes", "2", "--res", "8",
                     "--clean-spp", "64", "--render-only", "--device",
                     "cpu"])
train_denoiser.main(["--data", out + "_d", "--out", out + "_w.npz",
                     "--steps", "1", "--batch", "1", "--patch", "8",
                     "--train-only", "--device", "cpu"])
assert set(kpcnn.load_params(out + "_w.npz", "cpu")) == set(
    kpcnn.load_params(kpcnn.WEIGHTS_PATH, "cpu"))
assert not any(m == "jax" or m.startswith(("jax.", "flax"))
               for m in sys.modules if sys.modules[m] is not None)
assert not any(m == "optix_raytracer_tpu"
               or m.startswith("optix_raytracer_tpu.") for m in sys.modules)
print("OK")
"""


def test_multichip_and_training_run_without_jax(tmp_path):
    """With `import jax` and `import flax` failing: the multigpu app on two
    local ranks (gloo, --tint), the nvlink app on two ranks with --check
    at a budget that shards the textures, a sharded checkpoint written and
    read, the bring-up's config and the placement plan, sample_trilinear
    and a footprint query, and train_denoiser's --render-only and
    --train-only (two 8x8 scenes, one step, the weights to --out), all on
    the CPU; neither JAX nor the JAX package is loaded."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", _SCRIPT_MULTI,
                          str(tmp_path / "m")],
                         capture_output=True, text=True, env=env, cwd=root,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("OK")

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
version (the texture lanes) and runs kernel 9's plain version from the
port's tools/bench_texfetch. Until then no module of the JAX package is
loaded; the JAX package's reader then checks the PNG."""
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

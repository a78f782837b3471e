"""The port needs no JAX: in a process where `import jax` and `import flax`
fail, the package imports, renders an 8x8 1-spp Cornell box on the CPU and
saves it as a PNG, and builds the small knot scene (its cluster table through
the port's own native binding, or morton order without a compiler) and
renders it 8x8 at 8 samples per launch through the sample-major path."""
import os
import subprocess
import sys

_SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import numpy as np
import optix_raytracer_tpu_torch
from optix_raytracer_tpu_torch.apps import pathtracer
from optix_raytracer_tpu_torch.core.film import make_color
from optix_raytracer_tpu.io.image import load_image, save_image
accum, film, rays = pathtracer.render(8, 8, samples=1, max_depth=2,
                                      device="cpu")
img = make_color(accum).numpy()
save_image(sys.argv[1], img)
back = load_image(sys.argv[1])
assert back.shape == (8, 8, 4) and (back == img).all()
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
assert not any(m == "jax" or m.startswith(("jax.", "flax"))
               for m in sys.modules if sys.modules[m] is not None)
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

"""The six apps of the host API (`apps/{sphere,callable_programs,
bound_values,dynamic_geometry,compile_with_tasks,module_create_abort}.py`)
against the JAX apps on the CPU, at 8-16².

Bars: linear radiance within atol 2e-3 / rtol 1e-3 (the JAX apps encode
their images with `film.make_color`, which the tests swap for the identity
through monkeypatch to read the radiance; the port's apps return it from
`radiance` / their renders); `bound_values`' bound and runtime modules give
identical images in both packages. The JAX dynamic-geometry frame is
rendered from a handle built without its LBVH (the frame's scene never
reads it; the LBVH is held equal in tests/test_torch_lbvh.py): the image is
the app's. `compile_with_tasks` and `module_create_abort` run through their
`main()`; their output, files and exit status are checked, and the first
compiled job's radiance is held against the JAX job's. About 45 s on one
worker, most of it the JAX renders' compiles.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_raytracer_tpu import api as japi
from optix_raytracer_tpu.apps import bound_values as jbound
from optix_raytracer_tpu.apps import callable_programs as jcallables
from optix_raytracer_tpu.apps import compile_with_tasks as jcompile
from optix_raytracer_tpu.apps import dynamic_geometry as jdynamic
from optix_raytracer_tpu.apps import module_create_abort as jabort
from optix_raytracer_tpu.apps import sphere as jsphere
from optix_raytracer_tpu.core import film as jfilm
from optix_raytracer_tpu_torch.apps import (bound_values, callable_programs,
                                            compile_with_tasks,
                                            dynamic_geometry,
                                            module_create_abort, sphere)
from optix_raytracer_tpu_torch.core.film import make_color

from torch_parity import (assert_image_close, jax_native_sah,  # noqa: F401
                          one_torch_thread)


@pytest.fixture
def jax_radiance(monkeypatch):
    """The JAX apps' make_color as the identity: their renders return the
    linear radiance they would encode."""
    monkeypatch.setattr(jfilm, "make_color", lambda r: r)


def test_sphere_app(jax_radiance):
    out = sphere.radiance(16, 12, device="cpu")
    ref = np.asarray(jsphere.render(16, 12))
    assert_image_close(out.numpy(), ref, "sphere")
    assert torch.equal(sphere.render(16, 12, device="cpu"), make_color(out))
    assert float(out.max()) > 0.5


@pytest.mark.parametrize("shade", range(3))
def test_callable_programs_app(jax_radiance, shade):
    """Each direct callable, by its index on the device, and the
    continuation callable's background."""
    out = callable_programs.radiance(16, 16, shade=shade, device="cpu")
    ref = np.asarray(jcallables.render(16, 16, shade=shade))
    assert_image_close(out.numpy(), ref, callable_programs.SHADE_NAMES[shade])


def test_bound_values_app(jax_radiance):
    """The bound and the runtime module: the JAX app's image (its
    threefry draws and shadow queries), and identical to each other."""
    imgs = {}
    for bound in (True, False):
        _, fn = bound_values.render(16, 16, light_samples=4, bound=bound,
                                    device="cpu")
        cam = bound_values.cornell_camera(16, 16).params("cpu")
        out = (fn(cam) if bound else
               fn(cam, torch.tensor(4, dtype=torch.int32)))
        ref, _ = jbound.render(16, 16, light_samples=4, bound=bound)
        assert_image_close(out.numpy(), np.asarray(ref), f"bound={bound}")
        imgs[bound] = out
    assert torch.equal(imgs[True], imgs[False])
    assert float(imgs[True].mean()) > 0


def test_dynamic_geometry_app(jax_native_sah):  # noqa: F811
    """Two frames of refit + path trace (1,152 triangles: the port takes
    its cluster table, the JAX engine brute force on the CPU), and the
    IAS mode's two instances."""
    base, idx = dynamic_geometry.make_grid_mesh()
    assert np.array_equal(base, jdynamic.make_grid_mesh()[0])
    handle = dynamic_geometry.build_gas(base, idx, device="cpu")
    jhandle = japi.build_gas(base, idx, with_bvh=False)
    assert handle.bvh is not None and handle.bvh.num_nodes == 2 * 1152 - 1
    for f in range(2):
        out, handle = dynamic_geometry.render_frame(handle, 0.4 * f, base,
                                                    8, 8)
        ref, jhandle = jdynamic.render_frame(jhandle, 0.4 * f, base, 8, 8)
        assert_image_close(out.numpy(), np.asarray(ref), f"frame {f}")
    assert float(out.mean()) > 0
    out = dynamic_geometry.render_frames_ias(8, 8, 2, device="cpu")
    assert_image_close(out.numpy(),
                       np.asarray(jdynamic.render_frames_ias(8, 8, 2)), "ias")
    assert torch.equal(dynamic_geometry.render(8, 8, 2, ias=True,
                                               device="cpu"), out)


def test_compile_with_tasks_app(capsys):
    """main() compiles the jobs on the pool and runs one; the first job's
    radiance is the JAX job's."""
    compile_with_tasks.main(["--jobs", "2", "--workers", "2",
                             "--device", "cpu"])
    text = capsys.readouterr().out
    assert "pool(2 workers)" in text and "for 2 modules" in text
    assert "module 0 executes: output (48, 48, 3)" in text
    _, compiled = compile_with_tasks.run(1, 1, base=16, device="cpu")
    jobs = compile_with_tasks.make_jobs(1, base=16, device="cpu")
    out, rays = compiled[0](*jobs[0][1])
    _, jcompiled = jcompile.run(1, 1, base=16)
    ref = jcompiled[0](jcompile.make_jobs(1, base=16)[0][1][0])
    assert_image_close(out.numpy(), np.asarray(ref), "compiled job 0")
    assert int(rays) > 16 * 16


def test_module_create_abort_app(tmp_path, capsys):
    """main(): the first compile aborted mid-flight, the second finished,
    frames rendered meanwhile, the last one written."""
    path = tmp_path / "abort.ppm"
    module_create_abort.main(["--dim", "16x16", "--file", str(path),
                              "--device", "cpu"])
    text = capsys.readouterr().out
    assert "aborted compile" in text
    assert "second compile finished ok=True" in text
    assert path.exists() and path.stat().st_size > 16 * 16 * 3
    x = np.random.default_rng(0).normal(size=(8, 8)).astype(np.float32)
    np.testing.assert_allclose(
        module_create_abort.heavy_entry(torch.as_tensor(x)).numpy(),
        np.asarray(jabort.heavy_entry(jnp.asarray(x))), rtol=1e-4, atol=1e-5)

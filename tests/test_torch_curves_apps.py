"""The port's curves app (apps/curves.py: the spiral strand in each of the
five bases, as capsules and, where the basis has them, as swept spans,
through the Whitted integrator) against the JAX package's on the CPU at
16x16, one sample, depth 2.

Bar: images within atol 3e-3 / rtol 1e-3 (tests/test_fused_kernel.py:238's
bar for shaded prims), the pixels outside it counted and required to be
none (the largest difference seen: 2.3e-4, on the capsule Catmull-Rom
strand). The JAX side runs jitted, as the reference's app runs. About 80 s
on one worker, nearly all of it the JAX compiles of the nine scenes'
Whitted samples.
"""
import numpy as np
import pytest

from optix_raytracer_tpu.accel import primitives as jprim
from optix_raytracer_tpu.apps import curves as jcurves
from optix_raytracer_tpu_torch.apps import curves

from torch_parity import assert_image_close, one_torch_thread  # noqa: F401

ATOL = 3e-3
# --swept on the linear basis gives its capsules again (main() takes the
# quadratic spans instead, test_curves_app_cli)
CASES = [(k, s) for k in curves.KINDS for s in (False, True)
         if not (s and k == curves.cv.LINEAR)]


@pytest.mark.parametrize("kind,swept", CASES,
                         ids=[f"{k}{'_swept' if s else ''}" for k, s in CASES])
def test_curves_app_matches_jax(kind, swept):
    """The scene's prim table equals the reference's (swept spans for the
    quadratic and cubic bases with --swept; capsules otherwise, linear
    included), and its image at 16x16 is within the bar."""
    scene = curves.make_curve_scene("cpu", kind, swept=swept)
    jscene = jcurves.make_curve_scene(kind, swept=swept)
    np.testing.assert_array_equal(scene.prims.params.numpy(),
                                  np.asarray(jscene.prims.params))
    want = {jprim.SWEPT_QUAD} if (swept and kind == curves.cv.QUADRATIC_BSPLINE
                                  ) else {jprim.SWEPT_CUBIC} if (
        swept and kind != curves.cv.LINEAR) else {jprim.CAPSULE}
    assert set(scene.prims.kinds_static) == want
    out, film, rays = curves.render(16, 16, samples=1, scene=scene)
    ref, _ = jcurves.render(16, 16, samples=1, kind=kind, swept=swept)
    assert_image_close(out.numpy(), ref, f"{kind} swept={swept}", atol=ATOL)
    assert int(rays) > 16 * 16 and float(out.max()) > 0.3


def test_curves_app_cli(tmp_path):
    """main() with --swept on a linear kind takes the quadratic spans, as
    the reference does, and writes its image."""
    path = tmp_path / "c.ppm"
    curves.main(["--file", str(path), "--dim", "8x8", "--samples", "1",
                 "--kind", "linear", "--swept", "--device", "cpu"])
    assert path.stat().st_size == len(b"P6\n8 8\n255\n") + 8 * 8 * 3

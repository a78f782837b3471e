"""The port's hair app (apps/hair.py: the procedural fur, the three
shadings, splines, swept spans and `--hair FILE`) against the JAX package's
on the CPU at 16x16.

Bar: images within atol 3e-3 / rtol 1e-3 (tests/test_fused_kernel.py:238's
bar for shaded prims), the pixels outside it counted and required to be
none. The JAX app runs under `jax.disable_jit()`. Its capsule normal is
(p_hit - axis point) / r with no renormalisation, and the body's t comes
from a discriminant that loses digits to cancellation on strands of radius
0.004-0.012 seen from 2.6 away: the FMAs XLA:CPU contracts inside `jit` then
move n.l by several percent on many pixels, while the JAX package run op
by op and the port agree to the last bits. About 50 s on one worker, most
of it the reference's op-by-op renders.
"""
import jax
import numpy as np
import pytest

from optix_raytracer_tpu.apps import hair as jhair
from optix_raytracer_tpu_torch.accel import curves as cv
from optix_raytracer_tpu_torch.apps import hair

from torch_parity import (assert_image_close, hair_bytes,  # noqa: F401
                          one_torch_thread)

ATOL = 3e-3


@pytest.mark.parametrize("kw", [
    dict(shading="strand_u"), dict(shading="segment_u"),
    dict(shading="strand_idx"), dict(spline=cv.CATMULL_ROM),
    dict(spline=cv.CUBIC_BSPLINE, swept=True), dict(swept=True)],
    ids=["strand_u", "segment_u", "strand_idx", "catmullrom",
         "swept_cubic", "swept_quad"])
def test_hair_app_matches_jax(kw):
    """The procedural fur at 16x16 in each shading, through a spline, and as
    swept cubic and quadratic spans (the JAX side op by op, see the module
    docstring)."""
    out, _ = hair.render(16, 16, samples=1, device="cpu", **kw)
    with jax.disable_jit():
        ref, _ = jhair.render(16, 16, samples=1, **kw)
    assert_image_close(out.numpy(), ref, f"hair {kw}", atol=ATOL)


def test_hair_app_reads_hair_file(tmp_path):
    """--hair FILE: two strands written here, rendered by main()."""
    points = np.stack([np.zeros(8), np.linspace(-0.4, 0.6, 8),
                       np.zeros(8)], 1).astype(np.float32)
    points = np.concatenate([points, points + [0.3, 0.0, 0.1]])
    path = tmp_path / "two.hair"
    path.write_bytes(hair_bytes(points, segments=[7, 7],
                                 thickness=np.full(16, 0.03, np.float32)))
    out, _ = hair.render(16, 16, hair_file=str(path), samples=1,
                         device="cpu")
    with jax.disable_jit():
        ref, _ = jhair.render(16, 16, hair_file=str(path), samples=1)
    assert_image_close(out.numpy(), ref, "hair --hair", atol=ATOL)
    assert float(out.max()) > 0.3
    img = tmp_path / "h.ppm"
    hair.main(["--file", str(img), "--hair", str(path), "--dim", "8x8",
               "--samples", "1", "--spline", cv.CUBIC_BSPLINE, "--swept",
               "--device", "cpu"])
    assert img.stat().st_size == len(b"P6\n8 8\n255\n") + 8 * 8 * 3

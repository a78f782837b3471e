"""The port's `sample_trilinear` and texture footprint queries
(`shade/texture.py`) against the JAX package's on the cases of
tests/test_tex_footprint.py and tests/test_texture_maps.py's TestTrilinear:
the same mip atlas (the JAX `pack_textures`), the same uv, lods,
gradients and footprint scales; footprints equal exactly, fetches within
1e-6. Each case also checks the property the reference's test states."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_raytracer_tpu.scene.device_scene import pack_textures
from optix_raytracer_tpu.shade import texture as jtx
from optix_raytracer_tpu_torch.shade import texture as tx


def checker_image(n=64):
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    c = ((yy + xx) % 2).astype(np.float32)
    return np.where(c[..., None] > 0, 1.0, 0.0).repeat(3, -1).astype(
        np.float32)


def tables(img):
    """The JAX package's atlas, mip table and sizes of `img`."""
    return pack_textures([img])


def random_table(size):
    return tables(np.random.default_rng(0).uniform(
        0, 1, (size, size, 3)).astype(np.float32))


def both(fn, *args, **kw):
    """fn's port and JAX results on the same numpy arguments."""
    port = getattr(tx, fn)(*[torch.as_tensor(np.array(a)) for a in args],
                           **{k: (torch.as_tensor(np.array(v))
                                  if isinstance(v, np.ndarray) else v)
                              for k, v in kw.items()})
    ref = getattr(jtx, fn)(*[jnp.asarray(a) for a in args],
                           **{k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                                  else v) for k, v in kw.items()})
    return port, ref


def assert_same_footprint(port, ref):
    for k in ("level", "lo", "size", "level_dim", "single_mip"):
        assert np.array_equal(port[k].numpy(), np.asarray(ref[k])), k


LOD_CASES = {
    # (size, uv, lod, coarse, expected level, single_mip, size, level_dim)
    "integral_lod_single_level": (64, [[0.5, 0.5]], [2.0], False, 2, True,
                                  [2, 2], [16, 16]),
    "fractional_lod_fine": (64, [[0.25, 0.75]], [1.5], False, 1, False,
                            None, None),
    "fractional_lod_coarse": (64, [[0.25, 0.75]], [1.5], True, 2, False,
                              None, None),
    "lod_clamped_to_chain": (32, [[0.5, 0.5]], [99.0], False, 5, True,
                             None, [1, 1]),
    "rect_wraps": (64, [[0.001, 0.001]], [0.0], False, 0, True, [2, 2],
                   None),
}


@pytest.mark.parametrize("case", list(LOD_CASES))
def test_footprint_lod_matches_jax(case):
    n, uv, lod, coarse, level, single, size, dim = LOD_CASES[case]
    _, _, jmips = random_table(n)
    port, ref = both("tex_footprint_2d_lod", np.asarray(jmips),
                     np.asarray([0], np.int32), np.asarray(uv, np.float32),
                     np.asarray(lod, np.float32), coarse=coarse)
    assert_same_footprint(port, ref)
    assert int(port["level"][0]) == level
    assert bool(port["single_mip"][0]) == single
    if size is not None:
        assert port["size"][0].tolist() == size
    if dim is not None:
        assert port["level_dim"][0].tolist() == dim
    if case == "rect_wraps":
        assert port["lo"][0].tolist() == [63, 63]


GRAD_CASES = {
    # (duv_dx, duv_dy, expected level)
    "grad_lod_matches_trilinear_rule": ([[4.0 / 64.0, 0.0]], [[0.0, 0.0]],
                                        2),
    "zero_grad_is_level0_bilinear": ([[0.0, 0.0]], [[0.0, 0.0]], 0),
    "anisotropic": ([[3.0 / 64.0, 1.0 / 64.0]], [[0.5 / 64.0, 9.0 / 64.0]],
                    3),
}


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_footprint_grad_matches_jax(case):
    dx, dy, level = GRAD_CASES[case]
    _, _, jmips = random_table(64)
    port, ref = both("tex_footprint_2d_grad", np.asarray(jmips),
                     np.asarray([0], np.int32),
                     np.asarray([[0.5, 0.5]], np.float32),
                     np.asarray(dx, np.float32), np.asarray(dy, np.float32))
    assert_same_footprint(port, ref)
    assert int(port["level"][0]) == level
    assert int(port["size"][0, 0]) >= 2


@pytest.mark.parametrize("scale,level", [(None, 0), (8.0 / 64.0, 3),
                                         (1e6, 6)])
def test_footprint_implicit_matches_jax(scale, level):
    _, _, jmips = random_table(64)
    kw = {} if scale is None else {
        "texel_scale": np.asarray([scale], np.float32)}
    port, ref = both("tex_footprint_2d", np.asarray(jmips),
                     np.asarray([0], np.int32),
                     np.asarray([[0.5, 0.5]], np.float32), **kw)
    assert_same_footprint(port, ref)
    assert int(port["level"][0]) == level


def test_footprint_covers_sampled_texels():
    """Every texel a level-0 bilinear fetch reads lies in the reported rect
    (tests/test_tex_footprint.py:84-107), on the same 64 uv as JAX."""
    _, _, jmips = random_table(32)
    uv = np.random.default_rng(1).uniform(0.1, 0.9, (64, 2)).astype(
        np.float32)
    port, ref = both("tex_footprint_2d_lod", np.asarray(jmips),
                     np.zeros(64, np.int32), uv, np.zeros(64, np.float32))
    assert_same_footprint(port, ref)
    lo, size, dim = (port[k].numpy() for k in ("lo", "size", "level_dim"))
    for axis in (0, 1):
        f = uv[:, axis] * dim[:, axis] - 0.5
        for tap in (np.floor(f), np.floor(f) + 1):
            assert ((tap - lo[:, axis]) % dim[:, axis] < size[:, axis]).all()


TRILINEAR_CASES = ("lod0_matches_bilinear", "huge_footprint_converges_to_mean",
                   "lod_monotone_blur", "missing_texture_is_white",
                   "random_scales")


@pytest.mark.parametrize("case", TRILINEAR_CASES)
def test_sample_trilinear_matches_jax(case):
    """tests/test_texture_maps.py:61-98's cases, and random uv (wrapping
    outside [0, 1)) at random footprints, against the JAX fetch."""
    rng = np.random.default_rng(2)
    if case in ("lod0_matches_bilinear", "random_scales"):
        img = rng.uniform(0, 1, (16, 16, 3)).astype(np.float32)
    else:
        img = checker_image(64 if case != "missing_texture_is_white" else 8)
    jtex, jsize, jmips = tables(img)
    if case == "lod0_matches_bilinear":
        uv = rng.uniform(0, 1, (50, 2)).astype(np.float32)
        scales = [None]
    elif case == "random_scales":
        uv = rng.uniform(-1, 2, (512, 2)).astype(np.float32)
        scales = [rng.uniform(0, 0.5, 512).astype(np.float32)]
    elif case == "lod_monotone_blur":
        uv = np.asarray([[0.25 + 1 / 128.0, 0.25]], np.float32)
        scales = [np.asarray([s], np.float32)
                  for s in (0.0, 4.0 / 64, 16.0 / 64, 1.0)]
    else:
        uv = np.asarray([[0.3, 0.7]] if case.startswith("huge")
                        else [[0.5, 0.5]], np.float32)
        scales = [np.asarray([1e6 if case.startswith("huge") else 0.1],
                             np.float32)]
    tid = np.full(len(uv), -1 if case == "missing_texture_is_white" else 0,
                  np.int32)
    vals = []
    for scale in scales:
        kw = {} if scale is None else {"texel_scale": scale}
        port, ref = both("sample_trilinear", np.asarray(jtex),
                         np.asarray(jmips), tid, uv, **kw)
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=1e-6,
                                   rtol=0)
        vals.append(port.numpy())
    if case == "lod0_matches_bilinear":
        bil = tx.sample_bilinear(torch.as_tensor(np.array(jtex)),
                                 torch.as_tensor(np.array(jsize)),
                                 torch.as_tensor(tid), torch.as_tensor(uv))
        np.testing.assert_allclose(vals[0], bil.numpy(), atol=1e-6)
    elif case == "huge_footprint_converges_to_mean":
        np.testing.assert_allclose(vals[0][0, :3], 0.5, atol=1e-3)
    elif case == "lod_monotone_blur":
        dev = [abs(float(v[0, 0]) - 0.5) for v in vals]
        assert dev[0] >= dev[1] >= dev[2] >= dev[3] - 1e-6
    elif case == "missing_texture_is_white":
        assert (vals[0] == 1.0).all()

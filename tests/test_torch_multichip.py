"""The port's multichip tiles (`multichip/{tiles,multislice}.py`) over
torch.distributed against the JAX package on the CPU.

Four ranks on gloo (`distributed.launch_local`, torch on one thread each,
`tools/multichip_probe.layouts_case`) render launches of 4 samples of the
Cornell box 16x16 at depth 2 as 2 rows x 2 samples
(`render_accumulate_sharded`, twice: progressive), 4 interleaved rows and
2 slices x 1 row x 2 samples (`render_accumulate_multislice`). Each
gathered frame is held against the port's single-process
`render_accumulate` within rtol and atol 1e-5 on accum
(tests/test_multichip.py:49), with the ranks' summed rays equal to its
count, and against the JAX package's same function on a virtual CPU mesh
of the same shape (tests/conftest.py's 8 devices) with equal subframe
counts. The two packages' single-process frames differ by up to 1.7e-4
here (3 of 768 values; torch's and XLA's CPU arithmetic), so against JAX
the bars are the parity bars (atol 2e-3, rtol 1e-3), and per value the
tiled frames may differ by no more than the single-process frames do, plus
2e-5 (the 1e-5 each package's tiling may add). The multislice
mesh's log shows that no collective crossed the slice axis before the
gather. About 25 s on one worker, most of it the JAX meshes' compiles.
"""
import jax
import numpy as np
import pytest
import torch

from optix_raytracer_tpu.core import film as jfilm
from optix_raytracer_tpu.multichip import multislice as jms
from optix_raytracer_tpu.multichip import tiles as jtiles
from optix_raytracer_tpu.scene import builtins as jb
from optix_raytracer_tpu.wavefront.engine import render_accumulate as jra
from optix_raytracer_tpu_torch.core.film import Film
from optix_raytracer_tpu_torch.multichip import distributed, multislice, tiles
from optix_raytracer_tpu_torch.scene.builtins import (cornell_box,
                                                     cornell_camera)
from optix_raytracer_tpu_torch.tools import multichip_probe as probe
from optix_raytracer_tpu_torch.wavefront.engine import render_accumulate

from torch_parity import assert_image_close, one_torch_thread  # noqa: F401

W = H = 16
DEPTH = 2
SPL = 4          # samples of one launch over the whole mesh
SHAPES = {"sharded": (2, 2), "interleaved": 4, "multislice": (2, 1, 2)}
RTOL = ATOL = 1e-5


@pytest.fixture(scope="module")
def port():
    return distributed.launch_local(probe.layouts_case, 4, W, H, SPL, DEPTH,
                                    SHAPES, device="cpu", timeout=300,
                                    threads=1)


def jax_single(samples):
    film, _ = jra(jb.cornell_box(), jb.cornell_camera(W, H).params(),
                  jfilm.Film.create(H, W), W, H, samples_per_launch=samples,
                  max_depth=DEPTH, chunk_size=None)
    return np.asarray(film.accum)


def single(samples):
    """The port's single-process frame of `samples` samples and its rays."""
    film, rays = render_accumulate(
        cornell_box("cpu"), cornell_camera(W, H).params("cpu"),
        Film.create(H, W, "cpu"), W, H, samples_per_launch=samples,
        max_depth=DEPTH)
    return film.accum.numpy(), int(rays)


def jax_layout(layout):
    """The JAX package's same launch on a virtual mesh of the same shape
    → (accum in the gathered layout, subframe)."""
    scene = jb.cornell_box()
    cam = jb.cornell_camera(W, H).params()
    devices = jax.devices()[:4]
    film = jfilm.Film.create(H, W)
    if layout == "multislice":
        mesh = jms.make_multislice_mesh(*SHAPES[layout], devices=devices)
        film = jms.render_accumulate_multislice(
            scene, cam, jms.shard_film(film, mesh), mesh, W, H,
            samples_per_launch=SPL // 2, max_depth=DEPTH)
    elif layout == "interleaved":
        mesh = jtiles.make_mesh(n_rows=4, n_samples=1, devices=devices)
        film = jtiles.render_accumulate_interleaved(
            scene, cam, jtiles.shard_film(film, mesh), mesh, W, H,
            samples_per_launch=SPL, max_depth=DEPTH)
    else:
        mesh = jtiles.make_mesh(*SHAPES[layout], devices=devices)
        film = jtiles.render_accumulate_sharded(
            scene, cam, jtiles.shard_film(film, mesh), mesh, W, H,
            samples_per_launch=SPL // 2, max_depth=DEPTH)
    return np.asarray(film.accum), int(film.subframe)


@pytest.mark.parametrize("layout", ["sharded", "interleaved", "multislice"])
def test_layout_matches_jax_and_single_process(port, layout, one_torch_thread):
    """Each layout's gathered frame: every rank's equal; the
    single-process frame within 1e-5 (the interleaved one after
    deinterleave_rows) with the same rays; the JAX package's same function
    within the parity bars and no farther than the single-process frames
    are apart, with the same subframe count."""
    r0 = port[0][layout]
    accum, sub, rays = r0["accum"], r0["subframe"], r0["rays"]
    for other in port[1:]:
        assert (other[layout]["digest"], other[layout]["subframe"],
                other[layout]["rays"]) == (r0["digest"], sub, rays)
    jaccum, jsub = jax_layout(layout)
    assert sub == jsub == SPL
    if layout == "interleaved":
        accum = tiles.deinterleave_rows(accum, 4)
        jaccum = np.asarray(jtiles.deinterleave_rows(jaccum, 4))
    ref, ref_rays = single(SPL)
    np.testing.assert_allclose(accum, ref, rtol=RTOL, atol=ATOL)
    assert rays == ref_rays
    assert_image_close(accum, jaccum, f"{layout} vs JAX")
    gap = np.abs(ref - jax_single(SPL))
    assert (np.abs(accum - jaccum) <= gap + 2 * ATOL
            + 2 * RTOL * np.abs(ref)).all()


def test_progressive_across_launches(port, one_torch_thread):
    """Two sharded launches on 2 x 2 equal one single-process launch of
    their 8 samples within the bars, with 8 subframes."""
    accum, sub = port[0]["sharded_2"]["accum"], port[0]["sharded_2"][
        "subframe"]
    ref, _ = single(2 * SPL)
    assert sub == 2 * SPL
    np.testing.assert_allclose(accum, ref, rtol=RTOL, atol=ATOL)


def test_no_collective_crosses_the_slice_axis(port):
    """On the (2 slices, 1 row, 2 samples) mesh every collective of the
    launch joins the ranks of one slice only, and the sample mean joined
    each slice's two sample ranks; the frame's gather and the slices' ray
    sum, after it, are the only ones across slices."""
    render_log, after, grid = port[0]["multislice_log"]
    slices = [set(np.ravel(s).tolist()) for s in grid]
    assert render_log, "the launch ran no collective"
    for op, axes, members in render_log:
        assert any(set(members) <= s for s in slices), (op, axes, members)
    assert ("all_reduce", ("samples",), (0, 1)) in render_log
    assert [op for op, _, _ in after] == ["all_gather", "all_reduce"]
    assert all(not any(set(m) <= s for s in slices) for _, _, m in after)


def test_deinterleave_permutation():
    """Band r holds global rows r, r + 8: out[g] = acc[(g % 8) * 2 + g // 8]
    (tests/test_multichip_extras.py:35-43), for a tensor and an array."""
    acc = torch.arange(16, dtype=torch.float32).reshape(16, 1, 1)
    out = tiles.deinterleave_rows(acc, 8)
    for g in range(16):
        assert out[g, 0, 0] == acc[(g % 8) * 2 + g // 8, 0, 0]
    assert np.array_equal(tiles.deinterleave_rows(acc.numpy(), 8),
                          out.numpy())


def test_one_process_mesh_is_the_single_process_render(one_torch_thread):
    """Without a process group a 1 x 1 mesh renders in place: no
    collective runs, and the frame equals the single-process launch."""
    mesh = tiles.make_mesh(device="cpu")
    assert mesh.shape == {"rows": 1, "samples": 1} and mesh.coord == {
        "rows": 0, "samples": 0}
    film = tiles.shard_film(Film.create(H, W, "cpu"), mesh)
    film, rays = tiles.render_accumulate_sharded(
        cornell_box("cpu"), cornell_camera(W, H).params("cpu"), film, mesh,
        W, H, samples_per_launch=SPL, max_depth=DEPTH)
    ref, ref_rays = single(SPL)
    np.testing.assert_allclose(tiles.gather_film(film, mesh).accum.numpy(),
                               ref, rtol=RTOL, atol=ATOL)
    assert int(rays) == ref_rays
    ms = multislice.make_multislice_mesh(1, 1, 1, device="cpu")
    assert ms.shape == {"slice": 1, "rows": 1, "samples": 1}
    with pytest.raises(ValueError):
        tiles.make_mesh(2, 1, device="cpu")

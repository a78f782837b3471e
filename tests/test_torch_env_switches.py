"""The reference engine's environment switches, read by the port's engine at
call time (wavefront/engine.py of the port against the reference's
`optix_raytracer_tpu/wavefront/engine.py:763-769` and `:622-628`):

- ORT_SPL_MAJOR=0 turns "auto"'s sample-major default off on a cluster
  scene: the launch takes the sequential sorted loop;
- ORT_GROUP_WALK=0 turns the walk's group gating off on the sample-major
  path, where it is on by default; an explicit group_walk still wins.

Neither changes a result: the sequential loop gives the sample-major
path's rays and radiance within the parity bars (test_fused_kernel.py:
atol 2e-3, rtol 1e-3), gating off gives bit for bit the same launch. On
knot_scene(20, 14) (562 triangles, 5 clusters), 8x8 pixels, 8 samples,
depth 3, on the CPU (the walks' plain versions)."""
import numpy as np
import pytest
import torch

from optix_raytracer_tpu_torch.core.film import Film
from optix_raytracer_tpu_torch.scene.builtins import knot_camera, knot_scene
from optix_raytracer_tpu_torch.wavefront import engine

from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CPU = torch.device("cpu")
W = H = 8
SPL, DEPTH = 8, 3


@pytest.fixture(scope="module")
def knot():
    scene = knot_scene(20, 14, device=CPU)
    assert scene.has_clusters
    return scene, knot_camera(W, H).params(CPU)


def _spy(monkeypatch, name, calls):
    """Wrap engine.<name> so that each call appends its keyword arguments
    to `calls`."""
    fn = getattr(engine, name)

    def call(*args, **kw):
        calls.append(kw)
        return fn(*args, **kw)
    monkeypatch.setattr(engine, name, call)


def _launch(scene, cam):
    film, rays = engine.render_accumulate(
        scene, cam, Film.create(H, W, CPU), W, H, samples_per_launch=SPL,
        max_depth=DEPTH)
    return film.accum, int(rays)


def test_spl_major_switch(knot, monkeypatch):
    """Unset (or 1), "auto" takes the sample-major path; ORT_SPL_MAJOR=0
    the sequential one, with the same rays and radiance within the bars."""
    scene, cam = knot
    out = {}
    for value in (None, "1", "0"):
        if value is None:
            monkeypatch.delenv("ORT_SPL_MAJOR", raising=False)
        else:
            monkeypatch.setenv("ORT_SPL_MAJOR", value)
        major, seq = [], []
        with monkeypatch.context() as mp:
            _spy(mp, "render_sum_sample_major", major)
            _spy(mp, "render_sum_wavefront", seq)
            out[value] = _launch(scene, cam)
        assert (len(major), len(seq)) == ((0, 1) if value == "0" else (1, 0))
    np.testing.assert_array_equal(out[None][0].numpy(), out["1"][0].numpy())
    assert out["0"][1] == out[None][1] > W * H * SPL
    np.testing.assert_allclose(out["0"][0].numpy(), out[None][0].numpy(),
                               atol=2e-3, rtol=1e-3)


def test_group_walk_switch(knot, monkeypatch):
    """On the sample-major path the walk is gated unless ORT_GROUP_WALK=0;
    a caller's group_walk=True overrides the switch. Gating never changes
    a hit: the launches are bit-equal."""
    scene, cam = knot
    out = {}
    for value, arg in ((None, None), ("0", None), ("0", True), ("1", None)):
        if value is None:
            monkeypatch.delenv("ORT_GROUP_WALK", raising=False)
        else:
            monkeypatch.setenv("ORT_GROUP_WALK", value)
        calls = []
        with monkeypatch.context() as mp:
            _spy(mp, "_bounce", calls)
            rad, rays = engine.render_sum_sample_major(
                scene, cam, W, H, 0, SPL, max_depth=DEPTH, group_walk=arg)
        gated = {kw["group_walk"] for kw in calls}
        assert gated == {arg if arg is not None else value != "0"}
        out[(value, arg)] = (rad, int(rays))
    ref = out[(None, None)]
    for key, (rad, rays) in out.items():
        assert rays == ref[1]
        np.testing.assert_array_equal(rad.numpy(), ref[0].numpy())

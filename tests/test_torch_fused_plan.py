"""The fused launch's host prelude (wavefront/pallas_pt.py fused_plan,
pack_camera): one plan per scene and launch shape, built at the first
launch and reused after (counted by the `fused.plans` family), refusals on
every call, and a camera block bit-equal to the two-row pack it replaced.
A plan is built on a CPU scene here: its construction needs no card."""
import dataclasses

import numpy as np
import pytest
import torch

from optix_raytracer_tpu_torch import kernels, telemetry
from optix_raytracer_tpu_torch.accel import tlas
from optix_raytracer_tpu_torch.core.camera import Camera
from optix_raytracer_tpu_torch.scene import builtins as tb
from optix_raytracer_tpu_torch.scene.device_scene import make_device_scene
from optix_raytracer_tpu_torch.wavefront import engine, pallas_pt

SMALL = (32, 16, 16, 8)


def _pack_camera_two_rows(cam_params, miss_color, spread=0.0):
    """The camera block as render_sum_fused packed it before its launch
    plan: two cats, a stack and the spread uploaded from the host."""
    dev = cam_params["eye"].device
    row0 = torch.cat([
        cam_params["eye"], cam_params["U"], cam_params["V"],
        cam_params["W"], cam_params["aperture"].reshape(1),
        cam_params["focal_distance"].reshape(1),
        cam_params["ortho"].to(torch.float32).reshape(1),
        torch.zeros((1,), dtype=torch.float32, device=dev)])
    row1 = torch.cat([cam_params["ortho_half"],
                      torch.as_tensor(miss_color, dtype=torch.float32,
                                      device=dev),
                      torch.as_tensor(spread, dtype=torch.float32,
                                      device=dev).reshape(1),
                      torch.zeros((10,), dtype=torch.float32, device=dev)])
    return torch.stack([row0, row1]).to(torch.float32)


def _blue_miss(scene):
    return dataclasses.replace(scene, miss_color=torch.tensor(
        [0.1, 0.25, 0.7], dtype=torch.float32))


_CAMERAS = {
    "pinhole": lambda w, h: tb.cornell_camera(w, h),
    "thin_lens": lambda w, h: Camera(
        eye=(278.0, 273.0, -900.0), lookat=(278.0, 273.0, 330.0),
        up=(0.0, 1.0, 0.0), fov_y=35.0, aspect=w / h, aperture=12.5,
        focal_distance=1050.0),
    "orthographic": lambda w, h: Camera(
        eye=(278.0, 273.0, -900.0), lookat=(278.0, 273.0, 330.0),
        up=(0.0, 1.0, 0.0), aspect=w / h, orthographic=True,
        ortho_height=620.0),
}


@pytest.mark.parametrize("case", ["pinhole", "thin_lens", "orthographic",
                                  "textured", "textured_tile"])
def test_pack_camera_bit_equal_to_two_row_pack(case):
    """The plan's one-cat camera block equals, bit for bit, the two-row
    pack: each camera kind, a miss colour, and on a textured scene the
    spread column (engine.pixel_spread at the full frame's height, a row
    tile's too)."""
    w, h = 24, 16
    if case.startswith("textured"):
        scene = _blue_miss(tb.textured_scene("cpu", SMALL, 0.6, 0.8))
        cam = tb.textured_camera(w, 2 * h).params("cpu")
        tile = case == "textured_tile"
        plan = pallas_pt.fused_plan(
            scene, w, h, 2, 3, y0=h if tile else 0,
            full_width=w if tile else None,
            full_height=2 * h if tile else None)
        assert plan.textured
        spread = engine.pixel_spread(cam, 2 * h if tile else h)
        assert float(spread) > 0.0
    else:
        scene = _blue_miss(tb.cornell_box("cpu"))
        cam = _CAMERAS[case](w, h).params("cpu")
        plan = pallas_pt.fused_plan(scene, w, h, 2, 3)
        assert not plan.textured
        spread = 0.0
    got = pallas_pt.pack_camera(cam, plan)
    ref = _pack_camera_two_rows(cam, scene.miss_color, spread)
    assert got.shape == (2, 16) and got.dtype == torch.float32
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.view(torch.int32).numpy(),
                                  ref.view(torch.int32).numpy())
    if case == "orthographic":
        assert float(got[0, 14]) == 1.0 and float(got[1, 0]) > 0.0
    if case == "thin_lens":
        assert float(got[0, 12]) == 12.5 and float(got[0, 13]) == 1050.0


def _plans_counted():
    return dict(pallas_pt.PLANS)


def test_one_plan_per_scene_and_shape():
    """Launches of one scene at one shape build one plan and reuse it;
    another row offset, full frame, sample count, depth or group size
    builds its own, and so does a new DeviceScene of the same content."""
    scene = tb.cornell_box("cpu")
    before = _plans_counted()
    first = pallas_pt.fused_plan(scene, 32, 16, 2, 3)
    again = [pallas_pt.fused_plan(scene, 32, 16, 2, 3) for _ in range(3)]
    assert all(p is first for p in again)
    assert pallas_pt.PLANS["built"] == before["built"] + 1
    assert pallas_pt.PLANS["reused"] == before["reused"] + 3
    assert [id(p) for p in scene.fused_plans.values()] == [id(first)]
    assert telemetry.COUNTERS["fused.plans"] is pallas_pt.PLANS

    # what the library call takes besides the camera, subframe and outputs
    tables = scene.fused_tables
    assert first.name == kernels.pt_fused_name(*pallas_pt.fused_variant(
        scene)) == "pt_fused_cornell"
    assert first.head == (tables["tri"].data_ptr(), 32,
                          tables["prims"].data_ptr(), 0,
                          tables["mats"].data_ptr(), scene.materials.num,
                          tables["light"].data_ptr())
    assert first.tail[:10] == (32, 16, 32, 16, 0, 2, 3, 0, 0, 0)
    group = pallas_pt.fused_group_size(scene)
    assert first.tail[-1] == group == pallas_pt.FUSED_GROUP < 32
    assert first.tail[-2] == tables["boxes"][group].data_ptr()

    shapes = [dict(y0=8, full_width=32, full_height=32),
              dict(full_width=64, full_height=16),
              dict(samples_per_launch=4), dict(max_depth=5),
              dict(group=64)]
    made = []
    for change in shapes:
        args = dict(samples_per_launch=2, max_depth=3) | change
        plan = pallas_pt.fused_plan(scene, 32, 16, **args)
        assert all(plan is not p for p in [first, *made])
        assert pallas_pt.fused_plan(scene, 32, 16, **args) is plan
        made.append(plan)
    assert pallas_pt.PLANS["built"] == before["built"] + 1 + len(shapes)
    assert pallas_pt.PLANS["reused"] == before["reused"] + 3 + len(shapes)
    assert made[0].tail[:5] == (32, 16, 32, 32, 8)
    assert made[4].tail[-1] == 32           # the whole table, no culling
    assert made[4].tail[-2] == tables["boxes"][32].data_ptr()

    other = dataclasses.replace(scene)
    plan = pallas_pt.fused_plan(other, 32, 16, 2, 3)
    assert plan is not first and other.fused_plans is not scene.fused_plans
    assert pallas_pt.PLANS["built"] == before["built"] + 2 + len(shapes)
    assert len(scene.fused_plans) == 1 + len(shapes)


def test_plans_stay_within_their_bound():
    """Past MAX_FUSED_PLANS shapes the oldest plan goes; the newest stay,
    and a shape that went builds its plan again."""
    scene = tb.cornell_box("cpu")
    cap = pallas_pt.MAX_FUSED_PLANS
    plans = [pallas_pt.fused_plan(scene, 8, 8, spl) for spl in
             range(1, cap + 4)]
    assert len(scene.fused_plans) == cap
    assert ([id(p) for p in scene.fused_plans.values()]
            == [id(p) for p in plans[-cap:]])
    before = _plans_counted()
    assert pallas_pt.fused_plan(scene, 8, 8, cap + 3) is plans[-1]
    rebuilt = pallas_pt.fused_plan(scene, 8, 8, 1)
    assert rebuilt is not plans[0]
    assert pallas_pt.PLANS["built"] == before["built"] + 1
    assert pallas_pt.PLANS["reused"] == before["reused"] + 1
    assert len(scene.fused_plans) == cap


def _refused(case):
    cornell = tb.cornell_box("cpu")
    if case == "cutouts":
        return dataclasses.replace(cornell, features=("cutouts",)), (
            NotImplementedError, "cutouts")
    if case == "volume":
        return dataclasses.replace(cornell, features=("volume",)), (
            NotImplementedError, "volume")
    if case == "motion":
        verts, idx, tri_mat = tb.quads_to_triangles(tb._CORNELL_QUADS)
        return make_device_scene(
            verts, idx, tri_mat, tb.CORNELL_MATERIALS, "cpu",
            motion={"verts0": verts, "verts1": verts, "indices": idx}), (
            NotImplementedError, "moving triangles")
    if case == "textured_instanced":
        return dataclasses.replace(tb.cornell_box_instanced("cpu"),
                                   num_textures=1), (
            ValueError, "textured scene with instances")
    return dataclasses.replace(cornell, instances=tlas.make_instances(
        [np.eye(4, dtype=np.float32)], "cpu", prim_ranges=[(0, 600)])), (
        ValueError, "instance range of 600")


@pytest.mark.parametrize("case", ["cutouts", "volume", "motion",
                                  "textured_instanced", "large_range"])
def test_refusals_raise_on_every_call(case):
    """A scene the kernel does not render gets no plan: fused_plan and
    render_sum_fused raise on every call, and nothing is kept."""
    scene, (err, match) = _refused(case)
    assert not engine._use_fused(scene, "auto")
    before = _plans_counted()
    for _ in range(3):
        with pytest.raises(err, match=match):
            pallas_pt.fused_plan(scene, 8, 8, 2, 3)
        with pytest.raises(err, match=match):
            pallas_pt.render_sum_fused(scene, None, 8, 8, 0)
    assert scene.fused_plans == {}
    assert _plans_counted() == before


def test_use_fused_reads_the_scene_once(monkeypatch):
    """"auto" decides the scene's content once (DeviceScene.fused_fits) and
    its device on every call; the forced impls and ORT_SPL_MAJOR stay
    call-time reads."""
    scene = tb.cornell_box("cpu")
    assert not engine._use_fused(scene, "auto")
    assert "fused_fits" not in vars(scene)       # CPU: not worked out
    calls = []
    real = engine._fused_fits
    monkeypatch.setattr(engine, "_fused_fits",
                        lambda s: calls.append(s) or real(s))
    from optix_raytracer_tpu_torch.scene.device_scene import DeviceScene
    monkeypatch.setattr(DeviceScene, "device",
                        property(lambda self: torch.device("cuda")))
    assert all(engine._use_fused(scene, "auto") for _ in range(3))
    assert calls == [scene]
    assert engine._use_fused(scene, "fused")
    assert not engine._use_fused(scene, "wavefront")
    monkeypatch.setenv("ORT_SPL_MAJOR", "0")
    assert not engine._spl_major_default()
    monkeypatch.setenv("ORT_SPL_MAJOR", "1")
    assert engine._spl_major_default()

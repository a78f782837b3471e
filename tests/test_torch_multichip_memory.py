"""The port's texture placement (`multichip/memory.py`), process-group
bring-up (`multichip/distributed.py`) and sharded checkpoints
(`core/checkpoint.py`) against the JAX package on the CPU.

Placement decisions equal the JAX package's over a grid of stack sizes,
mesh shapes and budgets. Four ranks on gloo place the nvlink app's
textured scene (32-texel base map, 16x16, 1 sample): shard_island over a
4-rank rows mesh, shard_global over (2 slices, 2 rows) and the atlas alone
over rows, each rank's bytes at rest dropping by its island's size, and
each render through the gathered stacks bit-equal to the render from the
whole stacks. `detect_config` and `initialize` follow
tests/test_multichip_extras.py:163-210 with torch's variable names. A
sharded checkpoint written by four ranks loads whole in one process, by
two ranks of another row split, and equals what the JAX package's Orbax
pair restores for the same film; the two-rank resume is bit-equal to the
straight run. About 15 s on one worker.
"""
import dataclasses
import itertools
import json
import os

import jax
import numpy as np
import pytest
import torch

from optix_raytracer_tpu.core import checkpoint as jckpt
from optix_raytracer_tpu.core import film as jfilm
from optix_raytracer_tpu.multichip import memory as jmemory
from optix_raytracer_tpu.multichip import multislice as jms
from optix_raytracer_tpu.multichip import tiles as jtiles
from optix_raytracer_tpu_torch.core import checkpoint
from optix_raytracer_tpu_torch.multichip import (distributed, memory,
                                                 multislice, tiles)
from optix_raytracer_tpu_torch.scene.builtins import cornell_camera
from optix_raytracer_tpu_torch.tools import multichip_probe as probe

from torch_parity import one_torch_thread  # noqa: F401

W = H = 16
TEX_PX = 32
ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
       "LOCAL_WORLD_SIZE", "COORDINATOR_ADDRESS", "SLURM_NTASKS",
       "SLURM_PROCID", "SLURM_LOCALID", "SLURM_NTASKS_PER_NODE",
       "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK",
       "OMPI_COMM_WORLD_LOCAL_RANK", "OMPI_COMM_WORLD_LOCAL_SIZE")

# (slices, rows, samples); slices None is the (rows, samples) mesh
SHAPES = [(None, 4, 1), (None, 2, 2), (None, 8, 1), (2, 2, 2), (2, 2, 1),
          (4, 1, 2), (1, 4, 2)]
SIZES = [0, 1 << 10, 3 << 20, 16 << 20, (64 << 20) + 7]
BUDGETS = [1, 1 << 20, 8 << 20, memory.DEFAULT_TEXTURE_BUDGET]


def _meshes(shape):
    slices, rows, samples = shape
    n = rows * samples * (slices or 1)
    devices = jax.devices()[:n]
    if slices is None:
        return (tiles.make_mesh(rows, samples, ranks=range(n), device="cpu"),
                jtiles.make_mesh(rows, samples, devices=devices))
    return (multislice.make_multislice_mesh(slices, rows, samples,
                                            ranks=range(n), device="cpu"),
            jms.make_multislice_mesh(slices, rows, samples, devices=devices))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plan_matches_jax(shape):
    """plan_texture_placement equals the JAX package's for every size and
    budget on this mesh shape (a description: one process may build a
    mesh of ranks it will never run)."""
    mesh, jmesh = _meshes(shape)
    for nbytes, budget in itertools.product(SIZES, BUDGETS):
        assert memory.plan_texture_placement(nbytes, mesh, budget) == (
            jmemory.plan_texture_placement(nbytes, jmesh, budget)), (
            nbytes, budget)


@pytest.fixture(scope="module")
def placed():
    return distributed.launch_local(probe.placement_case, 4, W, H, 1, TEX_PX,
                                    1, device="cpu", timeout=300, threads=1)


@pytest.mark.parametrize("key,mode,island", [
    ("rows", "shard_island", 4), ("slices", "shard_global", 4),
    ("atlas_rows", None, 2)])
def test_placed_render_bit_equal_and_bytes_drop(placed, key, mode, island):
    """On every rank the render through the gathered stacks equals the
    render from the whole stacks bit for bit, and the bytes kept at rest
    fall by the island's size (the stacks' rows padded to a multiple of
    it; the atlas-only placement keeps the bundles whole)."""
    from optix_raytracer_tpu_torch.apps.nvlink import textured_scene
    scene = textured_scene(tex_px=TEX_PX, device="cpu")
    whole = memory.texture_nbytes(scene)
    for r in placed:
        rep = r[key]
        assert rep["bit_equal"], (key, rep)
        per = rep["per_chip_bytes_measured"]
        if mode is None:
            t = scene.textures
            share = t.shape[0] * -(-t.shape[1] // island) * t[0, 0].numel()
            assert per == 4 * share + (whole - t.numel() * 4)
            continue
        assert rep["mode"] == mode and rep["total_bytes"] == whole
        pad = sum(t.shape[0] * (-(-t.shape[1] // island) * island
                                - t.shape[1]) * t[0, 0].numel() * 4
                  for t in (scene.textures, scene.bundles))
        assert per * island == whole + pad
        assert per < whole / (island - 0.5)


def test_placement_gathers_only_inside_the_island(placed):
    """shard_global gathers over the whole mesh; the atlas placed over rows
    gathers over each rank's rows group, never across slices."""
    for r in placed:
        assert {axes for _, axes, _ in r["slices"]["log"]} == {
            ("slice", "rows", "samples")}
        assert {axes for _, axes, _ in r["atlas_rows"]["log"]} == {("rows",)}


def test_replicate_keeps_the_whole_stacks():
    """Under the budget every rank keeps the whole stacks, and the
    gathered scene is the scene's stacks themselves."""
    from optix_raytracer_tpu_torch.apps.nvlink import textured_scene
    scene = textured_scene(tex_px=TEX_PX, device="cpu")
    mesh = tiles.make_mesh(device="cpu")
    p, report = memory.place_scene_textures(scene, mesh)
    assert report["mode"] == "replicate" and report["replicas"] == 1
    assert memory.per_chip_texture_bytes(p) == memory.texture_nbytes(scene)
    with p.gathered() as full:
        assert full.textures is scene.textures
    assert memory.replicate_scene(scene, mesh).axes == ()


# --- bring-up ----------------------------------------------------------------

def test_detect_config_empty_is_single_process(monkeypatch):
    for v in ENV:
        monkeypatch.delenv(v, raising=False)
    assert distributed.detect_config() == (None, 1, 0)


def test_detect_config_env(monkeypatch):
    for v in ENV:
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.2")
    monkeypatch.setenv("MASTER_PORT", "1234")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    assert distributed.detect_config() == ("10.0.0.2:1234", 4, 2)
    assert distributed.detect_config("h:1", 8, 7) == ("h:1", 8, 7)


def test_detect_config_slurm_and_ompi(monkeypatch):
    for v in ENV:
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setenv("COORDINATOR_ADDRESS", "head:999")
    monkeypatch.setenv("SLURM_NTASKS", "16")
    monkeypatch.setenv("SLURM_PROCID", "5")
    monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "3")
    monkeypatch.setenv("OMPI_COMM_WORLD_RANK", "1")
    assert distributed.detect_config() == ("head:999", 16, 5)
    monkeypatch.delenv("SLURM_NTASKS")
    monkeypatch.delenv("SLURM_PROCID")
    assert distributed.detect_config() == ("head:999", 3, 1)


def test_single_process_initialize_noop_and_pod_mesh(monkeypatch):
    for v in ENV:
        monkeypatch.delenv(v, raising=False)
    distributed.shutdown()
    info = distributed.initialize(device="cpu")
    assert not info.initialized and info.backend is None
    assert info.num_processes == 1 and info.process_id == 0
    assert not info.is_multi_host and info.device == torch.device("cpu")
    assert distributed.initialize() is info
    assert distributed.pod_mesh().shape == {"slice": 1, "rows": 1,
                                            "samples": 1}
    with pytest.raises(ValueError):
        distributed.pod_mesh(rows_per_slice=2)
    distributed.shutdown()


def test_backend_rule():
    """NCCL with a card a rank, gloo where ranks share a card or run on
    the CPU; a CUDA rank with no card visible is an error."""
    assert distributed.choose_backend("cpu", 4, 0)[0] == "gloo"
    assert distributed.choose_backend("cuda", 4, 4)[0] == "nccl"
    assert distributed.choose_backend("cuda", 1, 8)[0] == "nccl"
    assert distributed.choose_backend("cuda", 4, 1)[0] == "gloo"
    with pytest.raises(RuntimeError):
        distributed.choose_backend("cuda", 1, 0)


# --- sharded checkpoints ----------------------------------------------------

@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "film")
    out = distributed.launch_local(probe.checkpoint_case, 4, W, H, 4, 2, path,
                                   device="cpu", timeout=300, threads=1)
    return path, out


def test_sharded_checkpoint_round_trips(ckpt, tmp_path):
    """One process loads the whole frame bit-equal to the gathered film,
    with its camera and config; two ranks of a 2-row split load their
    rows; the JAX package's Orbax pair saves and restores the same film to
    the same bits."""
    path, out = ckpt
    accum, _, sub = out[0]["first"]
    film, camera, config = checkpoint.load_checkpoint_sharded(path, "cpu")
    assert np.array_equal(film.accum.numpy(), accum)
    assert int(film.subframe) == sub == 4
    assert camera == cornell_camera(W, H) and config == {"spl": 4}
    for r, o in enumerate(out[:2]):
        band, bsub = o["loaded_band"]
        assert np.array_equal(band, accum[r * H // 2:(r + 1) * H // 2])
        assert bsub == sub and o["config"] == {"spl": 4}
    jpath = str(tmp_path / "orbax")
    jckpt.save_checkpoint_orbax(jpath, jfilm.Film.create(H, W).replace(
        accum=jax.numpy.asarray(accum), subframe=jax.numpy.asarray(
            sub, jax.numpy.int32)), camera, config)
    jf, jcam, jcfg = jckpt.load_checkpoint_orbax(jpath)
    assert np.array_equal(np.asarray(jf.accum), film.accum.numpy())
    assert int(jf.subframe) == int(film.subframe)
    assert dataclasses.asdict(jcam) == dataclasses.asdict(camera)
    assert jcfg == config


def test_sharded_resume_is_bit_equal(ckpt):
    """Resumed from the checkpoint in two ranks, the next launch equals
    the straight run's bit for bit; the directory holds no partial copy."""
    path, out = ckpt
    assert np.array_equal(out[0]["resumed"][0], out[0]["straight"][0])
    for o in out[:2]:
        assert o["resumed"][1:] == o["straight"][1:]
        assert o["resumed"][2] == 8
    assert sorted(os.listdir(os.path.dirname(path))) == ["film"]


def test_checkpoint_rejects_missing_rows_and_versions(tmp_path):
    """A directory whose bands do not hold the loader's rows, or of
    another version, raises; a second save replaces the first."""
    from optix_raytracer_tpu_torch.core.film import Film
    path = str(tmp_path / "c")
    checkpoint.save_checkpoint_sharded(path, Film.create(H, W, "cpu"))
    checkpoint.save_checkpoint_sharded(path, Film.create(H, W, "cpu"),
                                       config={"second": True})
    assert checkpoint.load_checkpoint_sharded(path, "cpu")[2] == {
        "second": True}
    meta_path = os.path.join(path, "render_meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    for key, value in (("bands", [[0, H // 2]]), ("version", 2)):
        with open(meta_path, "w") as f:
            json.dump(dict(meta, **{key: value}), f)
        with pytest.raises(ValueError):
            checkpoint.load_checkpoint_sharded(path, "cpu")

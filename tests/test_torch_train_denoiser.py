"""The port's denoiser training (`tools/train_denoiser.py`,
`denoise/kpcnn.py::init_params / save_params`) against the JAX package's
on the CPU.

- `init_params`: the reference's layer names and shapes (HWIO after
  `params_to_numpy`), zero biases and He-scaled kernels (each tensor's
  mean and standard deviation within the sampling bounds of
  sqrt(2 / (9 cin))).
- `save_params` writes the .npz the JAX `load_params` reads, bit-equal.
- `cosine_lr` equals `optax.cosine_decay_schedule(lr, steps, alpha=0.02)`.
- From the same parameters and batch (2 patches of 16x16), the loss, its
  gradients and the parameters after one Adam step equal the reference's
  (its loss written out from tools/train_denoiser.py:337-349 over the
  JAX `denoise_kp`, under `optax.adam`) within atol 1e-5 / rtol 1e-4.
- The first `render_dataset` scene at RES 16 (clean 64 spp) from seed 0:
  the same scene draw and spp, equal ray counts, every layer within the
  parity bars (atol 2e-3, rtol 1e-3, after both store float16).
About 30 s on one worker, most of it the JAX renders' compiles.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from optix_raytracer_tpu.core.film import Film as JFilm
from optix_raytracer_tpu.denoise import kpcnn as jkpcnn
from optix_raytracer_tpu.wavefront.engine import (
    render_accumulate as jrender_accumulate)
from optix_raytracer_tpu_torch.core.film import Film
from optix_raytracer_tpu_torch.denoise import kpcnn
from optix_raytracer_tpu_torch.tools import train_denoiser as td
from optix_raytracer_tpu_torch.wavefront.engine import render_accumulate

from torch_parity import assert_image_close, one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_tool():
    """The reference's tools/train_denoiser.py as a module."""
    spec = importlib.util.spec_from_file_location(
        "jax_train_denoiser", os.path.join(ROOT, "tools", "train_denoiser.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("cin,alpha", [(10, False), (13, False), (13, True)])
def test_init_params_shapes_and_scale(cin, alpha):
    params = kpcnn.init_params(torch.Generator().manual_seed(0), cin=cin,
                               out_alpha=alpha)
    ref = jkpcnn.init_params(jax.random.PRNGKey(0), cin=cin, out_alpha=alpha)
    got = kpcnn.params_to_numpy(params)
    assert {k: v.shape for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in ref.items()}
    for k, v in got.items():
        if k.endswith("_b"):
            assert not v.any(), k
            continue
        n, fan_in = v.size, v.shape[0] * v.shape[1] * v.shape[2]
        scale = np.sqrt(2.0 / fan_in)
        assert abs(v.mean()) < 5 * scale / np.sqrt(n), k
        assert abs(v.std() / scale - 1.0) < 5 / np.sqrt(2 * n) + 0.01, k
    other = kpcnn.init_params(torch.Generator().manual_seed(0), cin=cin,
                              out_alpha=alpha)
    assert all(torch.equal(params[k], other[k]) for k in params)


def test_save_params_loads_in_jax_bit_equal(tmp_path):
    params = kpcnn.init_params(torch.Generator().manual_seed(3), cin=13,
                               out_alpha=True)
    path = str(tmp_path / "w" / "kpcnn_trained.npz")
    kpcnn.save_params(params, path)
    back = jkpcnn.load_params(path)
    want = kpcnn.params_to_numpy(params)
    assert set(back) == set(want)
    for k in want:
        assert np.asarray(back[k]).dtype == np.float32
        assert np.array_equal(np.asarray(back[k]), want[k]), k
    mine = kpcnn.load_params(path, "cpu")
    assert all(torch.equal(mine[k], params[k]) for k in params)


def test_schedule_equals_optax():
    """Equal to optax's at five points and past the end, within optax's
    float32 (the port's factor is a Python float)."""
    sched = optax.cosine_decay_schedule(1e-3, 100, alpha=0.02)
    factor = td.cosine_lr(1e-3, 100)
    for t in (0, 1, 37, 99, 100, 150):
        assert abs(1e-3 * factor(t) / float(sched(t)) - 1) < 1e-6, t


def _batch(seed=0, n=2, px=16):
    rng = np.random.default_rng(seed)
    noisy = rng.gamma(1.0, 0.4, (n, px, px, 3)).astype(np.float32)
    clean = rng.uniform(0.0, 1.0, (n, px, px, 3)).astype(np.float32)
    albedo = rng.uniform(0.1, 0.9, (n, px, px, 3)).astype(np.float32)
    normal = rng.normal(0, 1, (n, px, px, 3)).astype(np.float32)
    emission = np.where(rng.random((n, px, px, 1)) < 0.05, 2.0, 0.0).astype(
        np.float32) * np.ones(3, np.float32)
    history = np.zeros_like(noisy)
    return noisy, albedo, normal, emission, history, clean


def _jax_loss(params, noisy, albedo, normal, emission, history, clean):
    """tools/train_denoiser.py:337-349's loss_fn (spatial net)."""
    out = jkpcnn.denoise_kp(params, noisy, albedo, normal, emission=emission,
                            history=None)

    def tonemap(x):
        return jnp.log1p(jnp.maximum(x, 0.0))
    lt = jnp.abs(tonemap(out) - tonemap(clean))
    gy = jnp.abs(jnp.diff(tonemap(out), axis=1)
                 - jnp.diff(tonemap(clean), axis=1))
    gx = jnp.abs(jnp.diff(tonemap(out), axis=2)
                 - jnp.diff(tonemap(clean), axis=2))
    return jnp.mean(lt) + 0.5 * (jnp.mean(gx) + jnp.mean(gy))


def test_loss_and_one_adam_step_match_jax():
    """Same parameters, same batch: loss, gradients and the parameters after
    one step (lr 1e-3, the cosine schedule over 10 steps) within atol 1e-5 /
    rtol 1e-4 of optax.adam's."""
    params = kpcnn.init_params(torch.Generator().manual_seed(1))
    jparams = {k: jnp.asarray(v)
               for k, v in kpcnn.params_to_numpy(params).items()}
    batch = _batch()
    loss, grads = jax.value_and_grad(_jax_loss)(jparams, *map(jnp.asarray,
                                                              batch))
    opt = optax.adam(optax.cosine_decay_schedule(1e-3, 10, alpha=0.02))
    updates, _ = opt.update(grads, opt.init(jparams))
    jnew = optax.apply_updates(jparams, updates)

    tb = tuple(torch.as_tensor(a) for a in batch)
    opt_t, sched = td.make_optimizer(params, 1e-3, 10)
    t_loss = td.loss_fn(params, *tb)
    t_loss.backward()
    np.testing.assert_allclose(float(t_loss.detach()), float(loss),
                               rtol=1e-4,
                               atol=1e-5)
    for k, p in params.items():
        g = p.grad.detach()
        if k.endswith("_w"):
            g = g.permute(2, 3, 1, 0)
        np.testing.assert_allclose(g.numpy(), np.asarray(grads[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    params_0 = kpcnn.init_params(torch.Generator().manual_seed(1))
    opt_t, sched = td.make_optimizer(params_0, 1e-3, 10)
    step_loss = td.train_step(params_0, opt_t, sched, tb)
    assert float(step_loss) == float(t_loss.detach())
    got = kpcnn.params_to_numpy(params_0)
    for k in got:
        np.testing.assert_allclose(got[k], np.asarray(jnew[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    assert abs(sched.get_last_lr()[0] / float(
        optax.cosine_decay_schedule(1e-3, 10, alpha=0.02)(1)) - 1) < 1e-6


def test_first_dataset_scene_matches_jax(tmp_path, monkeypatch):
    """render_dataset's first scene at RES 16: the same draw (spp, the
    noisy launch's rays) and every stored layer within the parity bars."""
    jtd = jax_tool()
    monkeypatch.setattr(jtd, "RES", 16)
    monkeypatch.setattr(jtd, "DATA", str(tmp_path / "jax"))
    jtd.render_dataset(1, seed=0, clean_spp=64)
    td.render_dataset(1, str(tmp_path / "port"), seed=0, clean_spp=64,
                      res=16, device="cpu")
    with np.load(tmp_path / "jax" / "scene_0000.npz") as a, \
            np.load(tmp_path / "port" / "scene_0000.npz") as b:
        assert set(a.files) == set(b.files)
        assert int(a["spp"]) == int(b["spp"])
        spp = int(b["spp"])
        for k in ("noisy", "clean", "albedo", "normal", "emission"):
            assert b[k].dtype == np.float16
            assert_image_close(b[k].astype(np.float32),
                               a[k].astype(np.float32), k)
    rng, jrng = np.random.default_rng(0), np.random.default_rng(0)
    scene, jscene = td.random_scene(rng, "cpu"), jtd.random_scene(jrng)
    cam, jcam = (td.random_camera(rng, 16, 16, "cpu"),
                 jtd.random_camera(jrng, 16, 16))
    _, rays = render_accumulate(scene, cam, Film.create(16, 16, "cpu"), 16,
                                16, samples_per_launch=spp, max_depth=4)
    _, jrays = jrender_accumulate(jscene, jcam, JFilm.create(16, 16), 16, 16,
                                  samples_per_launch=spp, max_depth=4)
    assert int(rays) == int(jrays) > 16 * 16 * spp


def test_train_writes_out_and_refuses_the_shipped_weights(tmp_path):
    """Two steps on a one-scene dataset write --out (loadable, finite); an
    --out in denoise/weights/ is refused."""
    td.render_dataset(2, str(tmp_path / "d"), seed=1, clean_spp=64, res=8,
                      device="cpu")
    out = str(tmp_path / "w.npz")
    params = td.train(str(tmp_path / "d"), out, steps=2, batch=1, patch=8,
                      device="cpu")
    back = kpcnn.load_params(out, "cpu")
    assert all(torch.isfinite(v).all() for v in back.values())
    assert all(torch.equal(back[k], params[k].detach()) for k in back)
    with pytest.raises(SystemExit):
        td.main(["--out", kpcnn.WEIGHTS_PATH, "--train-only"])

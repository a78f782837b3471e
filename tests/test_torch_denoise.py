"""The port's denoiser (the KPCNN net, the à-trous filter, optical flow and
the `Denoiser` API) against the JAX package on the CPU, on the same numpy
inputs made from a seed.

Bars: the net's logits within atol 1e-4; every denoised output within
atol 1e-4 / rtol 1e-3 with no pixel outside; the flows equal. The frame is
30x42, not a multiple of 4 (the net pads to one). About 80 s on one worker
with a cold JAX compile cache, most of it the JAX side's compiles (one
per input layout of denoise_kp, one per iteration count and shape of the
filter, one per level count, radius and shape of the flow).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_raytracer_tpu.api import denoiser as japi
from optix_raytracer_tpu.denoise import atrous as jatrous
from optix_raytracer_tpu.denoise import flow as jflow
from optix_raytracer_tpu.denoise import kpcnn as jkpcnn
from optix_raytracer_tpu_torch.api import denoiser as tapi
from optix_raytracer_tpu_torch.denoise import atrous as tatrous
from optix_raytracer_tpu_torch.denoise import flow as tflow
from optix_raytracer_tpu_torch.denoise import kpcnn as tkpcnn
from optix_raytracer_tpu_torch.tools.denoise_probe import (CASES, case_id,
                                                          invoke_case, layers)

from torch_parity import one_torch_thread  # noqa: F401

H, W = 30, 42
ATOL, RTOL = 1e-4, 1e-3
# The tiled filter: a 28x28 crop in 2x2 tiles of 14 with 4 pixels of
# overlap, whose four windows are all 18x18 (one JAX compile, shared with
# test_invoke's tiled case).
TILED, TILE, OVERLAP = 28, 14, 4


def _t(x):
    return None if x is None else torch.as_tensor(x)


def _close(out, ref):
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_weights_are_the_reference_checkpoints():
    """The port ships byte-identical copies and reads no file of the JAX
    package."""
    for name in ("WEIGHTS_PATH", "TEMPORAL_WEIGHTS_PATH",
                 "UPSCALE_WEIGHTS_PATH"):
        mine, ref = getattr(tkpcnn, name), getattr(jkpcnn, name)
        assert "optix_raytracer_tpu_torch" in mine and mine != ref
        with open(mine, "rb") as a, open(ref, "rb") as b:
            assert a.read() == b.read()
    assert tkpcnn.has_weights() and tkpcnn.has_temporal_weights() \
        and tkpcnn.has_upscale_weights()


@pytest.mark.parametrize("path", ["WEIGHTS_PATH", "TEMPORAL_WEIGHTS_PATH"])
def test_params_and_logits(path):
    """params_from_numpy turns HWIO into OIHW; the net's logits (25, or 26
    with the temporal net's blend) match apply_net's."""
    with np.load(getattr(jkpcnn, path)) as z:
        raw = {k: z[k] for k in z.files}
    params = tkpcnn.params_from_numpy(raw, "cpu")
    assert set(params) == set(raw)
    for k, v in raw.items():
        want = v.transpose(3, 2, 0, 1) if k.endswith("_w") else v
        np.testing.assert_array_equal(params[k].numpy(), want)
    cin = raw["in0_w"].shape[2]
    feats = np.random.default_rng(1).normal(
        size=(2, 32, 48, cin)).astype(np.float32)
    ref = np.asarray(jkpcnn.apply_net(
        {k: jnp.asarray(v) for k, v in raw.items()}, jnp.asarray(feats)))
    out = tkpcnn.apply_net(params, torch.as_tensor(feats)).numpy()
    assert out.shape == ref.shape == (2, 32, 48, raw["out_b"].shape[0])
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("guides", [(), ("albedo",), ("albedo", "normal"),
                                    ("albedo", "normal", "emission"),
                                    ("albedo", "normal", "emission",
                                     "history")])
def test_denoise_kp(guides):
    d = layers()
    path = (tkpcnn.TEMPORAL_WEIGHTS_PATH if "history" in guides
            else tkpcnn.WEIGHTS_PATH)
    jpath = (jkpcnn.TEMPORAL_WEIGHTS_PATH if "history" in guides
             else jkpcnn.WEIGHTS_PATH)
    kw = {k: d[k] for k in guides}
    ref = jkpcnn.denoise_kp(jkpcnn.load_params(jpath), d["beauty"], **kw)
    out = tkpcnn.denoise_kp(tkpcnn.load_params(path, "cpu"),
                            _t(d["beauty"]), **{k: _t(v)
                                                for k, v in kw.items()})
    _close(out, ref)


def test_upscale2x_kp_and_upsample():
    d = layers()
    lo = layers(seed=3, h=H // 2, w=W // 2)["beauty"]
    _close(tkpcnn.upsample2x_bilinear(_t(lo)),
           jkpcnn.upsample2x_bilinear(jnp.asarray(lo)))
    ref = jkpcnn.upscale2x_kp(jkpcnn.load_params(jkpcnn.UPSCALE_WEIGHTS_PATH),
                              lo, albedo=d["albedo"], normal=d["normal"],
                              emission=d["emission"])
    out = tkpcnn.upscale2x_kp(
        tkpcnn.load_params(tkpcnn.UPSCALE_WEIGHTS_PATH, "cpu"), _t(lo),
        albedo=_t(d["albedo"]), normal=_t(d["normal"]),
        emission=_t(d["emission"]))
    _close(out, ref)


@pytest.mark.parametrize("iterations,guides", [
    (3, ("albedo", "normal")), (5, ("albedo", "normal")), (5, ())])
def test_atrous_denoise(iterations, guides):
    d = layers()
    kw = {k: d[k] for k in guides}
    ref = jatrous.denoise(d["beauty"], iterations=iterations, **kw)
    out = tatrous.denoise(_t(d["beauty"]), iterations=iterations,
                          **{k: _t(v) for k, v in kw.items()})
    _close(out, ref)


def test_warp_temporal_tiled_and_statistics():
    d = layers()
    big = d["flow"] * 4.0       # sources past every border too
    _close(tatrous.warp_by_flow(_t(d["history"]), _t(big)),
           jatrous.warp_by_flow(d["history"], big))
    _close(tatrous.denoise_temporal(_t(d["beauty"]), _t(d["history"]),
                                    _t(d["flow"]), _t(d["albedo"]),
                                    _t(d["normal"]), iterations=3),
           jatrous.denoise_temporal(d["beauty"], d["history"], d["flow"],
                                    d["albedo"], d["normal"], iterations=3))
    sq = {k: v[:TILED, :TILED] for k, v in d.items()}
    out = tatrous.denoise_tiled(_t(sq["beauty"]), _t(sq["albedo"]),
                                _t(sq["normal"]), tile=TILE, overlap=OVERLAP,
                                iterations=3)
    ref = jatrous.denoise_tiled(sq["beauty"], sq["albedo"], sq["normal"],
                                tile=TILE, overlap=OVERLAP, iterations=3)
    _close(out, ref)
    np.testing.assert_allclose(
        float(tatrous.compute_intensity(_t(d["beauty"]))),
        float(jatrous.compute_intensity(d["beauty"])), rtol=1e-6)
    _close(tatrous.compute_average_color(_t(d["beauty"])),
           jatrous.compute_average_color(d["beauty"]))


def test_optical_flow_integer_shift():
    """A noise frame rolled by whole pixels: the flows are equal; on one
    level with the shift inside the radius, both find it at every pixel
    (its cost is 0 and every other candidate's is not)."""
    rng = np.random.default_rng(4)
    a = rng.uniform(size=(32, 48, 3)).astype(np.float32)
    b = np.roll(a, (1, -2), (0, 1))
    for kw in (dict(), dict(levels=1, radius=2)):
        ref = np.asarray(jflow.optical_flow(a, b, **kw))
        out = tflow.optical_flow(_t(a), _t(b), **kw).numpy()
        np.testing.assert_array_equal(out, ref)
    assert (out == np.array([-2.0, 1.0], np.float32)).all()


def test_optical_flow_smooth_pair():
    """A smooth pair moved by a fraction of a pixel (near-ties): the flows
    are equal, at the defaults and at levels 3, radius 1."""
    y, x = np.mgrid[0:32, 0:48].astype(np.float32)

    def frame(dx, dy):
        u, v = (x - dx) / 7.0, (y - dy) / 5.0
        return np.stack([np.sin(u) * np.cos(v), np.cos(u + v),
                         np.sin(u - v)], -1).astype(np.float32) * 0.5 + 0.5

    a, b = frame(0.0, 0.0), frame(1.6, -0.7)
    for kw in (dict(), dict(levels=3, radius=1)):
        ref = np.asarray(jflow.optical_flow(a, b, **kw))
        out = tflow.optical_flow(_t(a), _t(b), **kw).numpy()
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("backend", ["kpcnn", "atrous"])
@pytest.mark.parametrize("kind,case", CASES,
                         ids=[case_id(k, c) for k, c in CASES])
def test_invoke(backend, kind, case):
    """Every kind on both backends, with the alpha modes, the variance
    gate, blend_factor, AOVs, flow trust, an explicit intensity and
    tiling (a 28x28 crop in 2x2 tiles of 14 with 4 pixels of overlap:
    four 18x18 windows, one JAX compile)."""
    d = layers()
    lo = layers(seed=5, h=H // 2, w=W // 2)
    ref = invoke_case(japi, backend, kind, case, d, lo, jnp.asarray)
    out = invoke_case(tapi, backend, kind, case, d, lo, _t, device="cpu")
    if "aovs" in case:
        (ref, ref_aovs), (out, out_aovs) = ref, out
        assert list(out_aovs) == list(ref_aovs)
        for k in ref_aovs:
            _close(out_aovs[k], ref_aovs[k])
    _close(out, ref)
    assert out.shape[-1] == (4 if "alpha" in case else 3)


def test_invoke_numpy_inputs_and_errors():
    """Numpy inputs go onto the denoiser's device; invoke before setup,
    and backend="kpcnn" without a checkpoint, raise."""
    d = layers()
    den = tapi.Denoiser(device="cpu")
    assert den.backend == "kpcnn"
    with pytest.raises(RuntimeError):
        den.invoke(d["beauty"])
    out = den.setup(W, H).invoke(d["beauty"], albedo=d["albedo"],
                                 normal=d["normal"])
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    _close(out, japi.Denoiser().setup(W, H).invoke(
        d["beauty"], albedo=d["albedo"], normal=d["normal"]))
    flow = den.compute_flow(d["history"], d["beauty"], levels=2)
    assert flow.shape == (H, W, 2)
    np.testing.assert_array_equal(flow.numpy(), np.asarray(
        japi.Denoiser.compute_flow(d["history"], d["beauty"], levels=2)))
    tkpcnn._load.cache_clear()
    saved = tkpcnn.WEIGHTS_PATH
    try:
        tkpcnn.WEIGHTS_PATH = saved + ".missing"
        with pytest.raises(ValueError, match="checkpoint"):
            tapi.Denoiser(backend="kpcnn", device="cpu")
        assert tapi.Denoiser(backend="auto", device="cpu").backend \
            == "atrous"
    finally:
        tkpcnn.WEIGHTS_PATH = saved

"""The denoiser's configurations and probes, shared by chip_smoke.py (phases
n1-n3), tools/profile_torch_port.py --scene denoise and the tests: the
frame `pathtracer --denoise` renders at the headline size, the model kinds
timed on it, the matrix of invoke cases held between two devices (or
against the JAX package on the CPU), and the quality bars of the
reference's `tests/test_denoise.py::TestNeverWorse`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..api import denoiser as port_api
from ..api.denoiser import Denoiser, ModelKind
from ..core.film import Film
from ..denoise import flow as flow_mod
from ..scene import builtins
from ..wavefront.engine import render_accumulate

K = ModelKind

# apps/pathtracer.py --denoise at the headline frame (bench.py:18-21): two
# launches of 16 samples, depth 4, then render_aovs and the HDR invoke
DENOISE = dict(width=1920, height=1088, samples=32, spl=16, depth=4)
# the crop denoised on the card and on the CPU in n1
CROP = 256
# card against CPU: the net runs with TF32 off (kpcnn.apply_net)
ATOL, RTOL = 1e-3, 1e-3
# n2: the optical flow's levels and radius (the reference's defaults)
FLOW = dict(levels=4, radius=2)
# n2: the tiled invoke's tile and overlap (Denoiser.setup's defaults)
TILED = dict(tile=256, overlap=32)
# n2's matrix and the CPU tests: (kind, what the case adds), on both
# backends: every kind, and the alpha modes, the variance gate,
# blend_factor, AOVs, flow trust, an explicit intensity and tiling
CASES = [
    (K.LDR, dict(blend_factor=0.3)),
    (K.HDR, dict(variance=True, emission=True)),
    (K.AOV, dict(aovs=2, alpha="COPY")),
    (K.TEMPORAL, dict(prev=True, flow=True, trust=True, emission=True)),
    (K.TEMPORAL_AOV, dict(prev=True, flow=True, aovs=1)),
    (K.UPSCALE2X, dict(alpha="COPY", emission=True)),
    (K.TEMPORAL_UPSCALE2X, dict(prev=True, flow="low", trust=True)),
    (K.HDR, dict(alpha="DENOISE", intensity=0.7)),
    (K.HDR, dict(tiled=True)),
]
# n3: TestNeverWorse's renders (tests/test_denoise.py:241-310): 128x128,
# (spp, launches) for the clean reference, the noisy case whose gate must
# stay open, and the near-converged case that must come out no worse
QUALITY = dict(size=128, depth=4, clean=(512, 8), open=(4, 4),
               converged=(64, 16))


def case_id(kind, case):
    return f"{kind}-{'-'.join(case)}"


def layers(seed=0, h=30, w=42):
    """Numpy float32 layers from a seed: a noisy HDR beauty, albedo, unit
    normals, a sparse emission, a history, a flow of a few pixels, a trust
    plane, a variance and an alpha plane."""
    rng = np.random.default_rng(seed)
    n = rng.normal(size=(h, w, 3))
    d = dict(beauty=rng.gamma(1.0, 0.5, (h, w, 3)),
             albedo=rng.uniform(0.1, 1.0, (h, w, 3)),
             normal=n / np.linalg.norm(n, axis=-1, keepdims=True),
             emission=(rng.uniform(size=(h, w, 1)) > 0.9) * np.array(
                 [3.0, 2.5, 2.0]),
             history=rng.gamma(1.0, 0.5, (h, w, 3)),
             flow=rng.normal(0.0, 2.0, (h, w, 2)),
             trust=rng.uniform(size=(h, w, 1)),
             variance=rng.gamma(1.0, 0.01, (h, w, 3)),
             alpha=rng.uniform(size=(h, w)))
    return {k: v.astype(np.float32) for k, v in d.items()}


def invoke_case(api, backend, kind, case, d, lo, to, tile=14, overlap=4,
                tiled_crop=28, **den_kw):
    """One invoke of the matrix through `api` (the port's api.denoiser or
    the JAX package's) on layers d (and lo at half size for the upscale
    kinds), each converted by `to`. The upscale kinds take the low-res
    beauty; the net's guides are full-res, the filter's low-res. The tiled
    case runs on a square crop of tiled_crop pixels."""
    up = kind in K.UPSCALE_KINDS
    den = api.Denoiser(model_kind=kind, backend=backend,
                       alpha_mode=case.get("alpha", "COPY"), **den_kw)
    h, w = d["beauty"].shape[:2]
    den.setup(w, h, tiled=case.get("tiled", False), tile=tile,
              overlap=overlap, iterations=3)
    if case.get("tiled"):
        d = {k: v[:tiled_crop, :tiled_crop] for k, v in d.items()}
    src = lo if up else d
    guide = d if up and backend == "kpcnn" else src
    beauty = src["beauty"]
    if "alpha" in case:
        beauty = np.concatenate([beauty, src["alpha"][..., None]], -1)
    kw = dict(albedo=to(guide["albedo"]), normal=to(guide["normal"]))
    if case.get("emission"):
        kw["emission"] = to(guide["emission"])
    if case.get("prev"):
        kw["previous_output"] = to(d["history"] if up else src["history"])
    if case.get("flow") == "low":
        kw["flow"] = to(lo["flow"])
    elif case.get("flow"):
        kw["flow"] = to(src["flow"])
    if case.get("trust"):
        kw["flow_trust"] = to(d["trust"] if up else src["trust"])
    if case.get("variance"):
        kw["variance"] = to(src["variance"])
    if "aovs" in case:
        kw["aovs"] = {f"aov{i}": to(src["history"] * (i + 1.0))
                      for i in range(case["aovs"])}
    if "intensity" in case:
        kw["intensity"] = case["intensity"]
    return den.invoke(to(beauty), blend_factor=case.get("blend_factor", 0.0),
                      **kw)


def _host(x):
    return x.detach().cpu().numpy()


def matrix_parity(device, h=96, w=128, seed=0):
    """Every CASES invoke on both backends on `device` and on the CPU, the
    same layers → {case: max |difference|}; raises where an output is
    outside atol ATOL / rtol RTOL or not finite. Also the optical flow,
    which must be equal."""
    d = layers(seed, h, w)
    lo = layers(seed + 5, h // 2, w // 2)
    errs = {}
    for backend in ("kpcnn", "atrous"):
        for kind, case in CASES:
            outs = []
            for dev in (device, torch.device("cpu")):
                def to(x, dev=dev):
                    return torch.as_tensor(np.asarray(x, np.float32),
                                           device=dev)
                r = invoke_case(port_api, backend, kind, case, d, lo, to,
                                tile=64, overlap=16, tiled_crop=96,
                                device=dev)
                outs.append([r[0], *r[1].values()] if isinstance(r, tuple)
                            else [r])
            worst = 0.0
            for a, b in zip(*outs):
                a, b = _host(a), _host(b)
                if not (np.isfinite(a).all() and a.shape == b.shape):
                    raise AssertionError(f"{case_id(kind, case)} "
                                         f"{backend}: not finite")
                bad = np.abs(a - b) > ATOL + RTOL * np.abs(b)
                if bad.any():
                    raise AssertionError(
                        f"{case_id(kind, case)} {backend}: {int(bad.sum())} "
                        f"values outside atol {ATOL} / rtol {RTOL}, max "
                        f"{np.abs(a - b).max():.3g}")
                worst = max(worst, float(np.abs(a - b).max()))
            errs[f"{case_id(kind, case)}-{backend}"] = worst
    fa = flow_mod.optical_flow(torch.as_tensor(d["beauty"], device=device),
                               torch.as_tensor(d["history"], device=device))
    fb = flow_mod.optical_flow(torch.as_tensor(d["beauty"]),
                               torch.as_tensor(d["history"]))
    if not np.array_equal(_host(fa), _host(fb)):
        raise AssertionError("optical_flow: the card's flow differs from "
                             "the CPU's")
    return errs


def headline_inputs(accum, aovs):
    """n2's inputs from the n1 frame: a second frame (the beauty moved by
    (3, -2) pixels), the half-res beauty (2x2 means) for UPSCALE2X, and
    one AOV."""
    h, w = accum.shape[:2]
    low = 0.25 * (accum[0::2, 0::2] + accum[1::2, 0::2]
                  + accum[0::2, 1::2] + accum[1::2, 1::2])
    return dict(beauty=accum, next=torch.roll(accum, (3, -2), (0, 1)),
                low=low, aov={"diffuse": accum * aovs["albedo"]}, **aovs)


def kind_calls(x, device):
    """n2's timed calls at the headline frame: name → a no-argument
    callable. HDR through the net and through the filter (5 iterations),
    TEMPORAL through the trained temporal net (the previous output and
    the flow to the next frame), UPSCALE2X from the half-res beauty with
    full-res guides, AOV with one AOV, the tiled HDR invoke, and the
    optical flow."""
    h, w = x["beauty"].shape[:2]
    g = dict(albedo=x["albedo"], normal=x["normal"])

    def den(kind, backend="kpcnn", **setup):
        return Denoiser(model_kind=kind, backend=backend,
                        device=device).setup(w, h, **setup)

    hdr, atrous = den(K.HDR), den(K.HDR, "atrous", iterations=5)
    temporal, up = den(K.TEMPORAL), den(K.UPSCALE2X)
    aov, tiled = den(K.AOV), den(K.HDR, tiled=True, **TILED)
    prev = hdr.invoke(x["beauty"], emission=x["emission"], **g)
    flow = hdr.compute_flow(x["beauty"], x["next"], levels=FLOW["levels"])
    return {
        "hdr_kpcnn": lambda: hdr.invoke(x["beauty"], emission=x["emission"],
                                        **g),
        "hdr_atrous": lambda: atrous.invoke(x["beauty"], **g),
        "temporal": lambda: temporal.invoke(x["next"], previous_output=prev,
                                            flow=flow, **g),
        "upscale2x": lambda: up.invoke(x["low"], emission=x["emission"],
                                       **g),
        "aov": lambda: aov.invoke(x["beauty"], aovs=x["aov"], **g),
        "tiled": lambda: tiled.invoke(x["beauty"], **g),
        "optical_flow": lambda: flow_mod.optical_flow(x["beauty"], x["next"],
                                                      **FLOW),
    }


def tracked_render(spp, launches, size, depth, device):
    """The Cornell box at size², spp samples in `launches` launches of
    equal count, with variance tracking → the Film."""
    scene = builtins.cornell_box(device)
    cam = builtins.cornell_camera(size, size).params(device)
    film = Film.create(size, size, device, track_variance=True)
    for _ in range(launches):
        film, _ = render_accumulate(scene, cam, film, size, size,
                                    samples_per_launch=spp // launches,
                                    max_depth=depth)
    return film


def log_mse(x, clean):
    """The training metric of the reference's quality tests."""
    return float(torch.mean((torch.log1p(torch.clamp_min(x, 0.0))
                             - torch.log1p(torch.clamp_min(clean, 0.0)))
                            ** 2))

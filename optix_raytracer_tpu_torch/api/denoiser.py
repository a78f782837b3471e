"""Denoiser API: the `optixDenoiser*` surface over two backends
(counterpart of `api/denoiser.py`).

All seven model kinds (LDR, HDR, AOV, TEMPORAL, TEMPORAL_AOV, UPSCALE2X,
TEMPORAL_UPSCALE2X), `setup` / `invoke` / `compute_intensity` /
`compute_average_color` / `compute_flow`, both alpha modes, the tiled
helper, `blend_factor`, AOV layers, the flow-trust guide and the
variance gate. Backends: "kpcnn", the trained net (`denoise/kpcnn.py`);
"atrous", the filter (no weights); "auto" takes the net when its
checkpoint exists. Inputs, numpy arrays or tensors, go onto the
denoiser's device; nothing moves to the CPU on its own.

Border policies kept where the reference has them: the variance gate's
3x3 box divides by the count of valid taps (api/denoiser.py:42-46); the
history clamp takes its 3x3 min / max over ±inf padding (:59-64); the
upscale epilogue's blur wraps around (:339-341). A render-res history,
alpha or flow is lifted with `F.interpolate(bilinear,
align_corners=False)`, whose border clamp equals the reference's
renormalised triangle kernel when upsampling, the only direction these
paths take (:86, 98, 114).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..denoise import atrous, flow as flow_mod, kpcnn


def _lum(x):
    return 0.2126 * x[..., 0] + 0.7152 * x[..., 1] + 0.0722 * x[..., 2]


def _variance_gate(noisy, filtered, variance, lo: float = 0.05,
                   hi: float = 0.25):
    """Never-worse blend (api/denoiser.py:25-46): a weight from the
    relative stderr of the progressive mean, 0 below `lo` (the input kept
    exactly), 1 above `hi`, a ramp between, box-smoothed 3x3 over the
    valid taps."""
    stderr = torch.sqrt(torch.clamp_min(_lum(variance), 0.0))
    rel = stderr / (_lum(noisy) + 1e-2)
    w = torch.clamp((rel - lo) / (hi - lo), 0.0, 1.0)
    w = F.avg_pool2d(w[None, None], 3, stride=1, padding=1,
                     count_include_pad=False)[0, 0]
    return noisy + w[..., None] * (filtered - noisy)


def _accumulate_history(current, history, alpha: float = 0.7, trust=None):
    """Consistency-gated temporal accumulation (api/denoiser.py:49-76):
    clamp the warped history to the current frame's 3x3 range per
    channel, and blend toward it by alpha times how little the clamp
    moved it, times the flow trust where given."""
    cur = current.permute(2, 0, 1)[None]
    nb_max = F.max_pool2d(cur, 3, stride=1, padding=1)[0].permute(1, 2, 0)
    nb_min = -F.max_pool2d(-cur, 3, stride=1, padding=1)[0].permute(1, 2, 0)
    clamped = torch.clamp(history, nb_min, nb_max)
    moved = torch.abs(history - clamped)
    span = torch.clamp_min(nb_max - nb_min, 1e-3)
    w = alpha * torch.clamp(1.0 - moved / span, 0.0, 1.0)
    if trust is not None:
        t = trust.to(torch.float32)
        if t.dim() == 3:
            t = t[..., 0]
        w = w * torch.clamp(t, 0.0, 1.0)[..., None]
    return current + w * (clamped - current)


def _resize(img, out_hw):
    """Bilinear lift of [H, W] or [H, W, C] to out_hw (upsampling only)."""
    x = img[..., None] if img.dim() == 2 else img
    x = F.interpolate(x.permute(2, 0, 1)[None], size=tuple(out_hw),
                      mode="bilinear", align_corners=False)[0]
    x = x.permute(1, 2, 0)
    return x[..., 0] if img.dim() == 2 else x


def _lift_flow(flow, out_hw, device):
    """The flow guide at the output resolution (api/denoiser.py:102-115):
    None gives zeros; a low-res flow is lifted, its vectors scaled by the
    resolution ratio."""
    h, w = out_hw
    if flow is None:
        return torch.zeros((h, w, 2), dtype=torch.float32, device=device)
    fh, fw = flow.shape[:2]
    if (fh, fw) == (h, w):
        return flow
    scale = torch.tensor([w / fw, h / fh], dtype=torch.float32,
                         device=flow.device)
    return _resize(flow, (h, w)) * scale


def _warped_history(previous_output, flow, out_hw):
    """The flow-warped history at the output resolution; a render-res
    previous output is lifted first (api/denoiser.py:79-88)."""
    prev = previous_output
    if prev.shape[:2] != tuple(out_hw):
        prev = _resize(prev, out_hw)
    return atrous.warp_by_flow(prev, _lift_flow(flow, out_hw, prev.device))


def _attach_alpha(out, alpha):
    """Append the alpha plane, lifted to the output resolution for the
    upscale kinds (api/denoiser.py:91-99)."""
    if alpha is None:
        return out
    if alpha.shape[:2] != out.shape[:2]:
        alpha = _resize(alpha, out.shape[:2])
    return torch.cat([out, alpha[..., None]], dim=-1)


class ModelKind:
    """The seven model kinds (`optix_types.h:1609-1635`)."""
    LDR = "LDR"
    HDR = "HDR"
    AOV = "AOV"
    TEMPORAL = "TEMPORAL"
    TEMPORAL_AOV = "TEMPORAL_AOV"
    UPSCALE2X = "UPSCALE2X"
    TEMPORAL_UPSCALE2X = "TEMPORAL_UPSCALE2X"

    TEMPORAL_KINDS = (TEMPORAL, TEMPORAL_AOV, TEMPORAL_UPSCALE2X)
    UPSCALE_KINDS = (UPSCALE2X, TEMPORAL_UPSCALE2X)
    AOV_KINDS = (AOV, TEMPORAL_AOV)


class AlphaMode:
    """`OptixDenoiserAlphaMode`: COPY passes alpha through, DENOISE filters
    it like a radiance channel."""
    COPY = "COPY"
    DENOISE = "DENOISE"


class Denoiser:
    """`optixDenoiserCreate`: a model kind, the guides it reads, a backend
    and an alpha mode, on `device` (the card unless the caller asks for
    the CPU). backend="kpcnn" without its checkpoint raises."""

    def __init__(self, context=None, model_kind: str = ModelKind.HDR,
                 guide_albedo: bool = True, guide_normal: bool = True,
                 backend: str = "auto", alpha_mode: str = AlphaMode.COPY,
                 device="cuda"):
        self.context = context
        self.model_kind = model_kind
        self.guide_albedo = guide_albedo
        self.guide_normal = guide_normal
        self.alpha_mode = alpha_mode
        self.device = torch.device(device)
        if backend == "auto":
            backend = "kpcnn" if kpcnn.has_weights() else "atrous"
        if backend == "kpcnn" and self._params() is None:
            raise ValueError("backend='kpcnn' but no trained checkpoint at "
                             f"{kpcnn.WEIGHTS_PATH}")
        self.backend = backend
        self._setup = None

    def _params(self, path=None):
        """A checkpoint on the denoiser's device (the spatial net's by
        default), or None."""
        return kpcnn.load_params(path or kpcnn.WEIGHTS_PATH, self.device)

    def _t(self, x):
        """An input layer as float32 on the denoiser's device (None
        stays None)."""
        if x is None:
            return None
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def _spatial(self, work, albedo, normal, iterations, emission=None):
        """One spatial pass through the backend."""
        if self.backend == "kpcnn":
            return kpcnn.denoise_kp(self._params(), work, albedo=albedo,
                                    normal=normal, emission=emission)
        return atrous.denoise(work, albedo=albedo, normal=normal,
                              iterations=iterations)

    def setup(self, width: int, height: int, tiled: bool = False,
              tile: int = 256, overlap: int = 32, iterations: int = 5):
        """optixDenoiserSetup: the working size, tiling and the filter's
        iterations."""
        self._setup = dict(width=width, height=height, tiled=tiled,
                           tile=tile, overlap=overlap, iterations=iterations)
        return self

    def compute_intensity(self, beauty):
        return atrous.compute_intensity(self._t(beauty))

    def compute_average_color(self, beauty):
        return atrous.compute_average_color(self._t(beauty))

    def compute_flow(self, prev_frame, curr_frame, levels: int = 4):
        """The flow guide in invoke()'s convention, curr(p) ≈ prev(p -
        flow), on the denoiser's device (a method here, since the frames
        go onto that device)."""
        return -flow_mod.optical_flow(self._t(curr_frame),
                                      self._t(prev_frame), levels=levels)

    def invoke(self, beauty, albedo=None, normal=None, flow=None,
               previous_output=None, intensity=None,
               blend_factor: float = 0.0, aovs: Optional[dict] = None,
               emission=None, variance=None, flow_trust=None):
        """optixDenoiserInvoke (api/denoiser.py:176-354) → the denoised
        image, and in the AOV kinds with `aovs` also a dict of denoised
        AOVs.

        The filter backend pre-scales HDR input by `intensity` (computed
        where not given) and un-scales after; the net was trained on raw
        radiance and takes none. blend_factor lerps toward the noisy
        input. variance (`Film.variance_of_mean()`) gates the output so
        that converged pixels keep their input."""
        if self._setup is None:
            raise RuntimeError("call setup() first (optixDenoiserSetup)")
        it = self._setup["iterations"]
        beauty = self._t(beauty)
        if previous_output is not None:
            # a previous output may carry its alpha; history is RGB
            previous_output = self._t(previous_output)[..., :3]
        if albedo is not None:
            albedo = self._t(albedo)[..., :3]
        if normal is not None:
            normal = self._t(normal)[..., :3]
        emission, flow = self._t(emission), self._t(flow)
        flow_trust = self._t(flow_trust)
        alpha = None
        if beauty.shape[-1] == 4:
            alpha = beauty[..., 3]
            beauty = beauty[..., :3]
            if self.alpha_mode == AlphaMode.DENOISE:
                a3 = alpha[..., None].expand(alpha.shape + (3,))
                alpha = atrous.denoise(
                    a3, albedo=albedo if self.guide_albedo else None,
                    normal=normal if self.guide_normal else None,
                    iterations=it)[..., 0]
        if not self.guide_albedo:
            albedo = None
        if not self.guide_normal:
            normal = None

        temporal = (self.model_kind in ModelKind.TEMPORAL_KINDS
                    and previous_output is not None)
        upscale = self.model_kind in ModelKind.UPSCALE_KINDS
        scale = 1.0
        if self.model_kind not in (ModelKind.LDR, ModelKind.AOV) \
                and self.backend != "kpcnn":
            scale = (self._t(intensity) if intensity is not None
                     else atrous.compute_intensity(beauty))
        work = beauty * scale

        if upscale and self.backend == "kpcnn":
            up_params = self._params(kpcnn.UPSCALE_WEIGHTS_PATH)
            if up_params is not None:
                # the trained upscaler denoises and lifts in one net with
                # full-res guides; the spatial pass is skipped
                out = kpcnn.upscale2x_kp(up_params, beauty, albedo=albedo,
                                         normal=normal, emission=emission)
                if temporal:
                    out = _accumulate_history(
                        out, _warped_history(previous_output, flow,
                                             out.shape[:2]),
                        trust=flow_trust)
                return _attach_alpha(out, alpha)

        core = None
        if self.backend == "kpcnn":
            def core(b, a, n):
                return kpcnn.denoise_kp(self._params(), b, a, n,
                                        emission=emission)

        if temporal and not upscale:
            if flow is None:
                flow = torch.zeros(beauty.shape[:2] + (2,),
                                   dtype=torch.float32, device=self.device)
            tparams = (self._params(kpcnn.TEMPORAL_WEIGHTS_PATH)
                       if self.backend == "kpcnn" else None)
            if tparams is not None:
                # the trained temporal net takes the warped history as
                # three input channels (scale is 1 on this backend), then
                # the consistency-gated accumulation
                history = atrous.warp_by_flow(previous_output, flow)
                out = kpcnn.denoise_kp(tparams, beauty, albedo=albedo,
                                       normal=normal, emission=emission,
                                       history=history)
                out = _accumulate_history(out, history, trust=flow_trust)
            else:
                out = atrous.denoise_temporal(
                    work, previous_output * scale, flow, albedo=albedo,
                    normal=normal, iterations=it, core=core)
        elif self._setup["tiled"]:
            out = atrous.denoise_tiled(
                work, albedo=albedo, normal=normal,
                tile=self._setup["tile"], overlap=self._setup["overlap"],
                iterations=it, core=core)
        else:
            out = self._spatial(work, albedo, normal, it, emission=emission)

        out = out / scale
        if variance is not None:
            out = _variance_gate(beauty, out, self._t(variance))
        if blend_factor > 0.0:
            out = (1.0 - blend_factor) * out + blend_factor * beauty

        if upscale:
            out = out.repeat_interleave(2, 0).repeat_interleave(2, 1)
            # soften the nearest-neighbour blocks (wrapping, as the
            # reference's jnp.roll)
            out = 0.25 * (out + torch.roll(out, 1, 0) + torch.roll(out, 1, 1)
                          + torch.roll(out, (1, 1), (0, 1)))
            if temporal:
                out = _accumulate_history(
                    out, _warped_history(previous_output, flow,
                                         out.shape[:2]),
                    trust=flow_trust)

        out = _attach_alpha(out, alpha)
        if self.model_kind in ModelKind.AOV_KINDS and aovs:
            den_aovs = {k: self._spatial(self._t(v) * scale, albedo, normal,
                                         it) / scale
                        for k, v in aovs.items()}
            return out, den_aovs
        return out

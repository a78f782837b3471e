"""Kernel-prediction CNN denoiser, the trained backend (counterpart of
`denoise/kpcnn.py`).

A small three-scale encoder/decoder reads the noisy beauty's demodulated
log-irradiance, the albedo and normal guides and a local-variance cue
(plus three channels of reprojected history for the temporal net) and
predicts a softmaxed 5x5 filter per pixel, applied to the albedo-
demodulated irradiance. The weights are the JAX package's checkpoints,
shipped byte for byte in `weights/`; `params_from_numpy` turns their HWIO
kernels into torch's OIHW. Tensors are NHWC at the interface, as in the
reference; the net runs NCHW through `torch.nn.functional.conv2d`.

Border policies, each where the reference has it: the variance cue's
3x3 sums are zero-padded and divided by 9 (kpcnn.py:171-174), the
predicted kernel's taps and the pad to a multiple of 4 replicate the edge
(kpcnn.py:139-144, 214-218).
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

KERNEL_SIZE = 5                        # predicted filter footprint
_KK = KERNEL_SIZE * KERNEL_SIZE
_EPS = 1e-3

_WEIGHTS = os.path.join(os.path.dirname(__file__), "weights")
WEIGHTS_PATH = os.path.join(_WEIGHTS, "kpcnn.npz")
# the same net trained on bilinear-lifted low-res beauty with full-res
# guides (the UPSCALE2X model kind)
UPSCALE_WEIGHTS_PATH = os.path.join(_WEIGHTS, "kpcnn_up2x.npz")
# 13 input channels (+3 of reprojected history) and a 26th output channel,
# the predicted history blend (the TEMPORAL model kind)
TEMPORAL_WEIGHTS_PATH = os.path.join(_WEIGHTS, "kpcnn_temporal.npz")

# (name, output channels): a three-scale encoder and its decoder, whose
# levels take the nearest x2 of the level below beside the matching skip
# (kpcnn.py:64-66).
_ENC = (("e0", 32), ("e1", 48), ("e2", 64))
_DEC = (("d1", 48), ("d0", 32))


def upsample2x_bilinear(img):
    """[..., H, W, C] → [..., 2H, 2W, C] bilinear, align_corners=False
    (kpcnn.py:46-61): source coordinate (i + 0.5) / 2 - 0.5, base index
    clipped to [0, n - 1], weight clipped to [0, 1]."""
    h, w = img.shape[-3], img.shape[-2]
    dev = img.device
    y = (torch.arange(2 * h, dtype=torch.float32, device=dev) + 0.5) / 2.0 \
        - 0.5
    x = (torch.arange(2 * w, dtype=torch.float32, device=dev) + 0.5) / 2.0 \
        - 0.5
    y0 = torch.clamp(torch.floor(y).long(), 0, h - 1)
    x0 = torch.clamp(torch.floor(x).long(), 0, w - 1)
    y1 = torch.clamp_max(y0 + 1, h - 1)
    x1 = torch.clamp_max(x0 + 1, w - 1)
    fy = torch.clamp(y - y0, 0.0, 1.0)[:, None, None]
    fx = torch.clamp(x - x0, 0.0, 1.0)[None, :, None]
    r0 = (img.index_select(-3, y0) * (1 - fy)
          + img.index_select(-3, y1) * fy)
    return (r0.index_select(-2, x0) * (1 - fx)
            + r0.index_select(-2, x1) * fx)


def params_from_numpy(params, device) -> dict:
    """A checkpoint's arrays (the dict `np.load` gives) → torch tensors on
    `device`: each HWIO kernel `*_w` becomes OIHW (w.transpose(3, 2, 0,
    1)), each bias `*_b` stays as it is."""
    out = {}
    for k in params:
        a = np.asarray(params[k], np.float32)
        if k.endswith("_w"):
            a = np.ascontiguousarray(a.transpose(3, 2, 0, 1))
        out[k] = torch.as_tensor(a, device=device)
    return out


def params_to_numpy(params) -> dict:
    """The inverse of `params_from_numpy`: each OIHW kernel back to the
    checkpoint's HWIO (w.permute(2, 3, 1, 0)), as float32 arrays."""
    out = {}
    for k, v in params.items():
        v = v.detach()
        if k.endswith("_w"):
            v = v.permute(2, 3, 1, 0)
        out[k] = np.ascontiguousarray(v.cpu().numpy(), np.float32)
    return out


def init_params(generator: torch.Generator, cin: int = 10,
                out_alpha: bool = False, device="cpu") -> dict:
    """He-initialised parameters in the port's layout (kpcnn.py:88-120):
    the reference's layer names and shapes, each kernel drawn from a
    standard normal by `generator` (on the CPU) in HWIO order and scaled by
    sqrt(2 / (k k cin)), each bias zero. cin: 10 spatial features, 13 with
    the temporal net's history; out_alpha adds the predicted history-blend
    channel."""
    params = {}

    def add(name, c_in, c_out, k=3):
        w = torch.randn((k, k, c_in, c_out), generator=generator,
                        dtype=torch.float32) * float(np.sqrt(2.0
                                                             / (k * k * c_in)))
        params[name + "_w"] = w.permute(3, 2, 0, 1).contiguous().to(device)
        params[name + "_b"] = torch.zeros(c_out, dtype=torch.float32,
                                          device=device)

    add("in0", cin, _ENC[0][1])
    prev = _ENC[0][1]
    for name, ch in _ENC:
        add(name, prev, ch)
        prev = ch
    for (name, ch), (_, skip) in zip(_DEC, _ENC[-2::-1]):
        add(name, prev + skip, ch)
        prev = ch
    add("out", prev, _KK + int(out_alpha))
    return params


def _conv(params, name, x, relu=True):
    y = F.conv2d(x, params[name + "_w"], params[name + "_b"], padding=1)
    return F.relu(y) if relu else y


def _up(x):
    """Nearest x2 of NCHW."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def apply_net(params, feats):
    """feats [N, H, W, 10 | 13] (H, W multiples of 4) → kernel logits
    [N, H, W, 25] (+1 history-blend logit when the out conv has it).

    PyTorch lets cuDNN run f32 convolutions in TF32 by default (about 1e-3
    relative error); the reference accumulates in f32
    (kpcnn.py:67-74). So the net runs with TF32 off for its own
    convolutions, inside a cuDNN flags context, never as a global switch."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        x = _conv(params, "in0", feats.permute(0, 3, 1, 2).contiguous())
        skips = []
        for i, (name, _) in enumerate(_ENC):
            x = _conv(params, name, x)
            if i < len(_ENC) - 1:
                skips.append(x)
                x = F.avg_pool2d(x, 2)
        for (name, _), skip in zip(_DEC, skips[::-1]):
            x = _conv(params, name, torch.cat([_up(x), skip], dim=1))
        x = _conv(params, "out", x, relu=False)
    return x.permute(0, 2, 3, 1)


def _edge_index(n, pad, dev):
    """Row / column indices of an edge-replicated extension by `pad`."""
    return torch.clamp(torch.arange(n + 2 * pad, device=dev) - pad, 0, n - 1)


def apply_kernel(logits, img):
    """The softmaxed per-pixel 5x5 kernel of logits [N, H, W, 25] applied
    to img [N, H, W, C] with edge-replicated taps, summed dy outer, dx
    inner (kpcnn.py:147-157)."""
    weights = torch.softmax(logits, dim=-1)
    h, w = img.shape[1], img.shape[2]
    r = KERNEL_SIZE // 2
    dev = img.device
    padded = img[:, _edge_index(h, r, dev)][:, :, _edge_index(w, r, dev)]
    acc = torch.zeros_like(img)
    i = 0
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            tap = padded[:, r - dy:r - dy + h, r - dx:r - dx + w]
            acc = acc + weights[..., i:i + 1] * tap
            i += 1
    return acc


def _features(beauty, albedo, normal, history=None):
    """Network features [N, H, W, 10 | 13] and the demodulated irradiance
    to filter (kpcnn.py:160-183): log1p(beauty / (albedo + eps)), albedo,
    normal, the local luminance deviation from zero-padded 3x3 sums / 9,
    and with history its demodulated log-irradiance."""
    irr = beauty / (albedo + _EPS)
    log_irr = torch.log1p(irr)
    lum = (0.2126 * beauty[..., 0] + 0.7152 * beauty[..., 1]
           + 0.0722 * beauty[..., 2])

    def mean3(x):
        return F.avg_pool2d(x[:, None], 3, stride=1, padding=1,
                            count_include_pad=True)[:, 0]

    mean = mean3(lum)
    mean2 = mean3(lum * lum)
    var = torch.sqrt(torch.clamp_min(mean2 - mean * mean, 0.0))
    parts = [log_irr, albedo, normal, var[..., None]]
    if history is not None:
        parts.append(torch.log1p(torch.clamp_min(history, 0.0)
                                 / (albedo + _EPS)))
    return torch.cat(parts, dim=-1), irr


def denoise_kp(params, beauty, albedo=None, normal=None, emission=None,
               history=None):
    """Denoise HDR beauty [H, W, 3] (or [N, H, W, 3]) with guide layers
    (kpcnn.py:186-244). Albedo defaults to ones and normal to zeros;
    emission, the noise-free primary-hit emitter radiance, is taken off
    before filtering and added back after; history, the flow-reprojected
    previous output, feeds the temporal net, whose 26th output channel
    blends the history's demodulated irradiance in by its sigmoid."""
    batched = beauty.dim() == 4

    def b4(x):
        return None if x is None or batched else x[None]

    if not batched:
        beauty, albedo, normal, emission, history = (
            beauty[None], b4(albedo), b4(normal), b4(emission), b4(history))
    if albedo is None:
        albedo = torch.ones_like(beauty)
    if normal is None:
        normal = torch.zeros_like(beauty)
    if emission is not None:
        beauty = torch.clamp_min(beauty - emission, 0.0)
        if history is not None:
            history = torch.clamp_min(history - emission, 0.0)
    h, w = beauty.shape[1], beauty.shape[2]
    # pad to a multiple of 4 (two downsamples), replicating the edge
    dev = beauty.device
    ys = torch.clamp_max(torch.arange(h + (-h) % 4, device=dev), h - 1)
    xs = torch.clamp_max(torch.arange(w + (-w) % 4, device=dev), w - 1)

    def pad(x):
        return None if x is None else x[:, ys][:, :, xs]

    albedo_p, history_p = pad(albedo), pad(history)
    feats, irr = _features(pad(beauty), albedo_p, pad(normal),
                           history=history_p)
    logits = apply_net(params, feats)
    filtered = apply_kernel(logits[..., :_KK], irr)
    if history_p is not None and logits.shape[-1] > _KK:
        alpha = torch.sigmoid(logits[..., _KK:_KK + 1])
        hist_irr = torch.clamp_min(history_p, 0.0) / (albedo_p + _EPS)
        filtered = filtered + alpha * (hist_irr - filtered)
    out = (filtered * (albedo_p + _EPS))[:, :h, :w]
    if emission is not None:
        out = out + emission
    return out if batched else out[0]


def upscale2x_kp(params, beauty_lr, albedo=None, normal=None,
                 emission=None):
    """2x upscale and denoise (kpcnn.py:247-256): the low-res beauty
    lifted bilinearly, then the net with full-res (2H, 2W) guides."""
    return denoise_kp(params, upsample2x_bilinear(beauty_lr), albedo=albedo,
                      normal=normal, emission=emission)


@functools.lru_cache(maxsize=8)
def _load(path: str, device: str):
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        return params_from_numpy({k: data[k] for k in data.files}, device)


def load_params(path: str = WEIGHTS_PATH, device="cuda"):
    """A shipped checkpoint on `device` (None where the file is missing),
    loaded once per (path, device); callers must not modify it."""
    return _load(path, str(torch.device(device)))


def save_params(params, path: str):
    """Write `params` (the port's layout) as the .npz of HWIO arrays that
    either package's `load_params` reads (kpcnn.py:261-264), and forget the
    loaded copies. The shipped checkpoints in `weights/` are the JAX
    package's, byte for byte; a training run writes elsewhere."""
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **params_to_numpy(params))
    _load.cache_clear()


def has_weights() -> bool:
    return os.path.exists(WEIGHTS_PATH)


def has_upscale_weights() -> bool:
    return os.path.exists(UPSCALE_WEIGHTS_PATH)


def has_temporal_weights() -> bool:
    return os.path.exists(TEMPORAL_WEIGHTS_PATH)

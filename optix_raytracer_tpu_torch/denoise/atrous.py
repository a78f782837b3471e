"""Edge-avoiding à-trous wavelet denoiser with albedo / normal guides, the
filter backend (counterpart of `denoise/atrous.py`).

SVGF-style: hierarchical 5x5 B3-spline passes whose weights stop at
luminance (in units of the local standard deviation), normal and albedo
edges, on the albedo-demodulated signal. Every tap, and the 3x3 moments,
replicate the edge (atrous.py:31-42): a wrapped tap would bleed opposite
borders into each other, and tiles into themselves. Plain torch ops on
[H, W, C] tensors, on the device they are given.
"""
from __future__ import annotations

import torch

# 1-D B3-spline taps; the 2-D kernel is the outer product.
_B3 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)
_OFFSETS = (-2, -1, 0, 1, 2)


def _luminance(rgb):
    return (rgb[..., 0] * 0.2126 + rgb[..., 1] * 0.7152
            + rgb[..., 2] * 0.0722)


class _Taps:
    """Edge-replicated shifts of img [H, W, ...] by up to `r` pixels:
    tap(dy, dx)[y, x] = img[clip(y - dy), clip(x - dx)] (the reference's
    _shift2d), each a view of one padded copy."""

    def __init__(self, img, r):
        h, w = img.shape[0], img.shape[1]
        dev = img.device
        ys = torch.clamp(torch.arange(h + 2 * r, device=dev) - r, 0, h - 1)
        xs = torch.clamp(torch.arange(w + 2 * r, device=dev) - r, 0, w - 1)
        self.padded = img[ys][:, xs]
        self.r, self.h, self.w = r, h, w

    def __call__(self, dy, dx):
        y, x = self.r - dy, self.r - dx
        return self.padded[y:y + self.h, x:x + self.w]


def _box3(x):
    taps = _Taps(x, 1)
    acc = torch.zeros_like(x)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            acc = acc + taps(dy, dx)
    return acc / 9.0


def denoise(beauty, albedo=None, normal=None, iterations: int = 5,
            sigma_color: float = 4.0, sigma_normal: float = 64.0,
            sigma_albedo: float = 8.0):
    """Denoise linear radiance [H, W, 3] → [H, W, 3] (atrous.py:53-108).

    Iteration i takes taps 2^i apart. The luminance edge-stop divides by
    sigma_color local deviations (3x3 moments, re-estimated each
    iteration) plus a floor, so the filter is exposure-invariant; with
    albedo the signal is demodulated first and remodulated after."""
    beauty = beauty.to(torch.float32)
    has_albedo = albedo is not None
    if has_albedo:
        albedo = albedo.to(torch.float32)
        signal = beauty / torch.clamp_min(albedo, 1e-3)
    else:
        signal = beauty
    if normal is not None:
        normal = normal.to(torch.float32)

    out = signal
    for it in range(iterations):
        step = 1 << it
        r = 2 * step
        lum0 = _luminance(out)
        mu = _box3(lum0)
        sigma = torch.sqrt(torch.clamp_min(_box3(lum0 * lum0) - mu * mu,
                                           0.0))
        denom = sigma_color * sigma + 1e-3 + 1e-2 * torch.abs(mu)
        out_taps = _Taps(out, r)
        normal_taps = None if normal is None else _Taps(normal, r)
        albedo_taps = _Taps(albedo, r) if has_albedo else None
        acc = torch.zeros_like(out)
        wsum = torch.zeros(out.shape[:2] + (1,), dtype=torch.float32,
                           device=out.device)
        for iy, wy in zip(_OFFSETS, _B3):
            for ix, wx in zip(_OFFSETS, _B3):
                dy, dx = iy * step, ix * step
                tap = out_taps(dy, dx)
                dl = torch.abs(_luminance(tap) - lum0)
                w = (wy * wx) * torch.exp(-dl / denom)
                if normal is not None:
                    ndot = torch.sum(normal_taps(dy, dx) * normal, -1)
                    w = w * torch.pow(torch.clamp_min(ndot, 0.0),
                                      sigma_normal)
                if has_albedo:
                    da = torch.abs(albedo_taps(dy, dx) - albedo).sum(-1)
                    w = w * torch.exp(-da * sigma_albedo)
                acc = acc + tap * w[..., None]
                wsum = wsum + w[..., None]
        out = acc / torch.clamp_min(wsum, 1e-8)

    if has_albedo:
        out = out * torch.clamp_min(albedo, 1e-3)
    return out


def warp_by_flow(prev_output, flow):
    """Bilinear back-warp out(p) = prev(p - flow(p)), flow [H, W, 2] (x, y)
    in pixels (atrous.py:111-132). The base index is clipped to
    [0, h - 2] x [0, w - 2] and the weight is not, so a source past the
    border extrapolates from the last two rows / columns, as the
    reference does."""
    h, w = prev_output.shape[:2]
    dev = prev_output.device
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    src_y = yy - flow[..., 1]
    src_x = xx - flow[..., 0]
    y0 = torch.clamp(torch.floor(src_y), 0, h - 2)
    x0 = torch.clamp(torch.floor(src_x), 0, w - 2)
    fy = (src_y - y0)[..., None]
    fx = (src_x - x0)[..., None]
    y0i = y0.long()
    x0i = x0.long()
    p00 = prev_output[y0i, x0i]
    p10 = prev_output[y0i, x0i + 1]
    p01 = prev_output[y0i + 1, x0i]
    p11 = prev_output[y0i + 1, x0i + 1]
    return (p00 * (1 - fx) + p10 * fx) * (1 - fy) \
        + (p01 * (1 - fx) + p11 * fx) * fy


def denoise_temporal(beauty, prev_output, flow, albedo=None, normal=None,
                     iterations: int = 5, alpha: float = 0.2, core=None):
    """Temporal mode (atrous.py:135-146): warp the previous output by
    `flow`, blend alpha of the current frame with it, then filter; `core`
    replaces the spatial filter (the trained net)."""
    warped = warp_by_flow(prev_output, flow)
    blended = alpha * beauty + (1.0 - alpha) * warped
    if core is not None:
        return core(blended, albedo, normal)
    return denoise(blended, albedo=albedo, normal=normal,
                   iterations=iterations)


def denoise_tiled(beauty, albedo=None, normal=None, tile: int = 256,
                  overlap: int = 32, core=None, **kw):
    """Tile by tile with `overlap` pixels of context on each side
    (atrous.py:149-184, the tiled invoke helper): each tile's window is
    filtered on its own and its core written out → [H, W, 3] on beauty's
    device. `core` replaces the filter."""
    h, w = beauty.shape[:2]
    out = torch.zeros((h, w, 3), dtype=torch.float32, device=beauty.device)
    for y in range(0, h, tile):
        y0, y1 = max(0, y - overlap), min(h, y + tile + overlap)
        for x in range(0, w, tile):
            x0, x1 = max(0, x - overlap), min(w, x + tile + overlap)

            def sub(img):
                return None if img is None else img[y0:y1, x0:x1]

            if core is not None:
                den = core(sub(beauty), sub(albedo), sub(normal))
            else:
                den = denoise(sub(beauty), albedo=sub(albedo),
                              normal=sub(normal), **kw)
            oy, ox = y - y0, x - x0
            ny, nx = min(tile, h - y), min(tile, w - x)
            out[y:y + ny, x:x + nx] = den[oy:oy + ny, ox:ox + nx]
    return out


def compute_intensity(beauty):
    """Inverse average log-luminance (atrous.py:187-192), a 0-d tensor:
    the HDR pre-scale of `optixDenoiserComputeIntensity`."""
    lum = _luminance(beauty.to(torch.float32))
    avg_log = torch.mean(torch.log(torch.clamp_min(lum, 1e-8)))
    return 1.0 / torch.clamp_min(torch.exp(avg_log), 1e-8)


def compute_average_color(beauty):
    """Mean colour over the image (atrous.py:195-197)."""
    return torch.mean(beauty.to(torch.float32), dim=(0, 1))

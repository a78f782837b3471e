"""The texture fetches (counterpart of `shade/texture.py`):
`sample_bilinear` on level 0 of the texture atlas, `sample_trilinear` over
its mip chain, the material-bundle fetch `sample_bundle`, and the
footprint queries `tex_footprint_2d{,_lod,_grad}`.

`sample_bilinear` reads one map of the atlas (`scene/device_scene.py::
pack_textures`) bilinearly: the Whitted integrator's base map and the
any-hit side of a CUT_TEXTURE cutout read it.

A material's whole texture set is one 16-channel bundle image
(`scene/device_scene.py::pack_bundles`): base RGBA (0:4), normal RGB (4:7),
emissive RGB (7:10), roughness (10), metallic (11). `sample_bundle` filters
it trilinearly: wrap addressing, texel centres at half-integer uv, and a mip
level from the ray cone's footprint in level-0 texels. This is the
reference's (2, 2, 16)-slice form written as plain indexing; its quad-row
form (one [N, 128] gather per level) is a TPU gather device and gives the
same values.

The fused kernel's texture variant (`csrc/pt_fused.cuh`, kTex) repeats this
arithmetic operation for operation, so the two round alike on the card.
"""
from __future__ import annotations

import torch

# The fetch of bundle id -1: white base, flat normal, unit emissive and
# metallic-roughness scales (shade/texture.py:103-105).
NEUTRAL = (1, 1, 1, 1, 0.5, 0.5, 1.0, 1, 1, 1, 1, 1, 0, 0, 0, 0)


def sample_bilinear(textures, tex_size, tex_id, uv):
    """Bilinear fetch from level 0 of the atlas → RGBA [..., 4].

    textures [T, H', W', 4] f32; tex_size [T, 2] int32 level-0 (h, w);
    tex_id [...] int (-1 gives white, RGBA 1); uv [..., 2]. Wrap
    addressing with texel centres at half-integer uv, as the reference: x =
    (u - floor(u)) w - 0.5, x0 = floor(x), fx = x - x0 (y alike); each of
    the four taps wraps on its own, (xi mod w, yi mod h) with w and h taken
    as at least 1; ((c00 (1 - fx) + c10 fx)(1 - fy) + (c01 (1 - fx) + c11
    fx) fy)."""
    if textures.shape[0] == 0:
        return torch.ones(uv.shape[:-1] + (4,), dtype=torch.float32,
                          device=uv.device)
    tid = torch.clamp_min(tex_id, 0).long()
    hw = tex_size[tid].to(torch.float32)
    h, w = hw[..., 0], hw[..., 1]
    u = uv[..., 0] - torch.floor(uv[..., 0])
    v = uv[..., 1] - torch.floor(uv[..., 1])
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    wi = torch.clamp_min(w.to(torch.int64), 1)
    hi = torch.clamp_min(h.to(torch.int64), 1)

    def texel(xf, yf):
        xi = torch.remainder(xf.to(torch.int64), wi)
        yi = torch.remainder(yf.to(torch.int64), hi)
        return textures[tid, yi, xi]

    c00 = texel(x0, y0)
    c10 = texel(x0 + 1, y0)
    c01 = texel(x0, y0 + 1)
    c11 = texel(x0 + 1, y0 + 1)
    rgba = ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
            + (c01 * (1 - fx) + c11 * fx) * fy)
    return torch.where((tex_id >= 0)[..., None], rgba, 1.0)


def sample_bundle(bundles, bundle_mip, bundle_id, uv, texel_scale=None):
    """Trilinear fetch from the bundle atlas → [..., 16] f32.

    bundles [B, H', W', 16] f32; bundle_mip [B, L, 4] int32 (y, x, h, w)
    per level (h, w the level's logical size, each level stored with one
    wrapped border row and column); bundle_id [...] int (-1 gives NEUTRAL);
    uv [..., 2]; texel_scale [...] the footprint in uv units (cone width x
    uv density), or None for level 0.

    Per lane: lod = log2(max(texel_scale * dim0, 1)) with dim0 the larger
    level-0 side, clipped to [0, chain - 1]; l0 = floor(lod), l1 = min(l0 +
    1, chain - 1), f = lod - l0. Per level: x = (u - floor(u)) * w - 0.5,
    x0 = floor(x), fx = x - x0 (y alike); the base corner wraps, (x0 mod w,
    y0 mod h) + the level's offset, and the border holds the far taps;
    ((c00 (1 - fx) + c01 fx)(1 - fy) + (c10 (1 - fx) + c11 fx) fy). The
    levels blend as (1 - f) L0 + f L1. The corner is clamped into the atlas
    as the reference's gather mode="clip" clamps it."""
    neutral = torch.tensor(NEUTRAL, dtype=torch.float32, device=uv.device)
    if bundles.shape[0] == 0:
        return neutral.expand(uv.shape[:-1] + (16,))
    bid = torch.clamp_min(bundle_id, 0).long()
    n_levels = bundle_mip.shape[1]
    chain_b = (bundle_mip[:, :, 2] > 0).sum(dim=1)                  # [B]
    dim_b = torch.maximum(bundle_mip[:, 0, 2], bundle_mip[:, 0, 3])
    dim0 = dim_b[bid].to(torch.float32)
    chain_len = chain_b[bid].to(torch.float32)
    if texel_scale is None or n_levels == 1:
        lod = torch.zeros(uv.shape[:-1], dtype=torch.float32, device=uv.device)
    else:
        lod = torch.log2(torch.clamp_min(texel_scale * dim0, 1.0))
    lod = torch.minimum(torch.clamp_min(lod, 0.0), chain_len - 1.0)
    l0 = torch.floor(lod).to(torch.int64)
    l1 = torch.minimum(l0 + 1, (chain_len - 1.0).to(torch.int64))
    f = (lod - l0.to(torch.float32))[..., None]
    rows, cols = bundles.shape[1], bundles.shape[2]

    def level(lv):
        entry = bundle_mip[bid, lv].to(torch.float32)          # [..., 4]
        y_off, x_off = entry[..., 0], entry[..., 1]
        h = torch.clamp_min(entry[..., 2], 1.0)
        w = torch.clamp_min(entry[..., 3], 1.0)
        u = uv[..., 0] - torch.floor(uv[..., 0])
        v = uv[..., 1] - torch.floor(uv[..., 1])
        x = u * w - 0.5
        y = v * h - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx = (x - x0)[..., None]
        fy = (y - y0)[..., None]
        # the base corner's integer wrap equals the float mod of x0 by w
        xi = (torch.remainder(x0.to(torch.int64), w.to(torch.int64))
              + x_off.to(torch.int64)).clamp(0, cols - 2)
        yi = (torch.remainder(y0.to(torch.int64), h.to(torch.int64))
              + y_off.to(torch.int64)).clamp(0, rows - 2)
        c00 = bundles[bid, yi, xi]
        c01 = bundles[bid, yi, xi + 1]
        c10 = bundles[bid, yi + 1, xi]
        c11 = bundles[bid, yi + 1, xi + 1]
        return ((c00 * (1 - fx) + c01 * fx) * (1 - fy)
                + (c10 * (1 - fx) + c11 * fx) * fy)

    out = (1.0 - f) * level(l0) + f * level(l1)
    return torch.where((bundle_id >= 0)[..., None], out, neutral)


def _sample_level(textures, tex_mip, tid, uv, level):
    """Bilinear fetch from one mip level of the atlas, wrap-addressed inside
    the level's (y, x, h, w) window (texture.py:48-75)."""
    entry = tex_mip[tid, level].to(torch.float32)             # [..., 4]
    y_off, x_off = entry[..., 0], entry[..., 1]
    h = torch.clamp_min(entry[..., 2], 1.0)
    w = torch.clamp_min(entry[..., 3], 1.0)
    u = uv[..., 0] - torch.floor(uv[..., 0])
    v = uv[..., 1] - torch.floor(uv[..., 1])
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    def texel(xf, yf):
        xi = torch.remainder(xf, w).to(torch.int64) + x_off.to(torch.int64)
        yi = torch.remainder(yf, h).to(torch.int64) + y_off.to(torch.int64)
        return textures[tid, yi, xi]

    c00 = texel(x0, y0)
    c10 = texel(x0 + 1, y0)
    c01 = texel(x0, y0 + 1)
    c11 = texel(x0 + 1, y0 + 1)
    return ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
            + (c01 * (1 - fx) + c11 * fx) * fy)


def _chain_len(tex_mip, tid):
    """Each lane's texture's mip levels (h = 0 marks past the end)."""
    return (tex_mip[tid, :, 2] > 0).to(torch.float32).sum(dim=-1)


def _dim0(tex_mip, tid):
    return torch.maximum(tex_mip[tid, 0, 2],
                         tex_mip[tid, 0, 3]).to(torch.float32)


def _scale_lod(tex_mip, tid, texel_scale):
    """lod = log2(max(texel_scale * dim0, 1)), dim0 the larger level-0
    side: the footprint in level-0 texels."""
    return torch.log2(torch.clamp_min(texel_scale * _dim0(tex_mip, tid),
                                      1.0))


def sample_trilinear(textures, tex_mip, tex_id, uv, texel_scale=None):
    """Trilinear mipmapped fetch from the atlas → RGBA [..., 4]; tex_id -1
    gives white (texture.py:202-227). texel_scale: the footprint in uv
    units (ray-cone width x uv density), or None for level-0 bilinear. The
    lod is clipped to the texture's own chain; l0 = floor(lod), l1 = min(l0
    + 1, chain - 1), blended by the fraction."""
    tid = torch.clamp_min(tex_id, 0).long()
    if texel_scale is None or tex_mip.shape[1] == 1:
        lod = torch.zeros(uv.shape[:-1], dtype=torch.float32,
                          device=uv.device)
    else:
        lod = _scale_lod(tex_mip, tid, texel_scale)
    chain = _chain_len(tex_mip, tid)
    lod = torch.minimum(torch.clamp_min(lod, 0.0), chain - 1.0)
    l0 = torch.floor(lod).to(torch.int64)
    l1 = torch.minimum(l0 + 1, (chain - 1.0).to(torch.int64))
    f = (lod - l0.to(torch.float32))[..., None]
    rgba = ((1.0 - f) * _sample_level(textures, tex_mip, tid, uv, l0)
            + f * _sample_level(textures, tex_mip, tid, uv, l1))
    return torch.where((tex_id >= 0)[..., None], rgba, 1.0)


# --- texture footprints (optixTexFootprint2D{,Lod,Grad},
# `optix_device.h:1551-1591`; texture.py:230-312): which texel rect a
# filtered fetch touches and whether it spans one mip level or two.

def _footprint_at_level(tex_mip, tid, uv, level, du=None, dv=None):
    """Texel rect of a bilinear fetch at `level` (texture.py:239-259): lo
    (x, y) wrapped, size, and the level's (w, h), grown by the gradient
    extent when du / dv are given."""
    entry = tex_mip[tid, level].to(torch.float32)
    h, w = entry[..., 2], entry[..., 3]
    fx = uv[..., 0] * w - 0.5
    fy = uv[..., 1] * h - 0.5
    ex = torch.zeros_like(fx) if du is None else 0.5 * torch.abs(du) * w
    ey = torch.zeros_like(fy) if dv is None else 0.5 * torch.abs(dv) * h
    x0 = torch.floor(fx - ex)
    y0 = torch.floor(fy - ey)
    x1 = torch.floor(fx + ex) + 1.0
    y1 = torch.floor(fy + ey) + 1.0
    return {
        "lo": torch.stack([torch.remainder(x0, w), torch.remainder(y0, h)],
                          -1).to(torch.int32),
        "size": torch.stack([torch.minimum(x1 - x0 + 1.0, w),
                             torch.minimum(y1 - y0 + 1.0, h)],
                            -1).to(torch.int32),
        "level_dim": torch.stack([w, h], -1).to(torch.int32),
    }


def tex_footprint_2d_lod(tex_mip, tex_id, uv, lod, coarse: bool = False):
    """optixTexFootprint2DLod: the footprint of a fetch at an explicit lod
    (texture.py:262-277) → dict(level, lo, size, level_dim, single_mip);
    `coarse` takes the coarser of the two levels a fractional lod spans."""
    tid = torch.clamp_min(tex_id, 0).long()
    chain = _chain_len(tex_mip, tid)
    lod = torch.as_tensor(lod, dtype=torch.float32, device=uv.device)
    lod = torch.minimum(torch.clamp_min(lod, 0.0), chain - 1.0)
    l0 = torch.floor(lod).to(torch.int64)
    l1 = torch.minimum(l0 + 1, (chain - 1.0).to(torch.int64))
    single = (lod == l0.to(torch.float32)) | (l1 == l0)
    level = torch.where(coarse & ~single, l1, l0)
    out = _footprint_at_level(tex_mip, tid, uv, level)
    out["level"] = level.to(torch.int32)
    out["single_mip"] = single
    return out


def tex_footprint_2d_grad(tex_mip, tex_id, uv, duv_dx, duv_dy,
                          coarse: bool = False):
    """optixTexFootprint2DGrad: the lod from the uv screen gradients ([...,
    2] each) by the trilinear rule, and the chosen level's rect grown by
    the gradients' extent (texture.py:280-299)."""
    tid = torch.clamp_min(tex_id, 0).long()
    ext = torch.maximum(torch.sqrt((duv_dx * duv_dx).sum(-1)),
                        torch.sqrt((duv_dy * duv_dy).sum(-1)))
    lod = torch.log2(torch.clamp_min(ext * _dim0(tex_mip, tid), 1.0))
    out = tex_footprint_2d_lod(tex_mip, tex_id, uv, lod, coarse=coarse)
    scale = torch.exp2(-out["level"].to(torch.float32))
    du = (torch.abs(duv_dx[..., 0]) + torch.abs(duv_dy[..., 0])) * scale
    dv = (torch.abs(duv_dx[..., 1]) + torch.abs(duv_dy[..., 1])) * scale
    grown = _footprint_at_level(tex_mip, tid, uv, out["level"].long(), du,
                                dv)
    grown["level"] = out["level"]
    grown["single_mip"] = out["single_mip"]
    return grown


def tex_footprint_2d(tex_mip, tex_id, uv, texel_scale=None):
    """optixTexFootprint2D: the footprint at the lod `sample_trilinear`
    would take (texture.py:302-312)."""
    tid = torch.clamp_min(tex_id, 0).long()
    if texel_scale is None:
        lod = torch.zeros(uv.shape[:-1], dtype=torch.float32,
                          device=uv.device)
    else:
        lod = _scale_lod(tex_mip, tid, texel_scale)
    return tex_footprint_2d_lod(tex_mip, tex_id, uv, lod)

"""The texture fetches (counterpart of `shade/texture.py:16-45, 78-199`):
`sample_bilinear` on level 0 of the texture atlas, and the material-bundle
fetch `sample_bundle`.

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

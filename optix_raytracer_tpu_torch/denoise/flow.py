"""Optical flow between two frames by coarse-to-fine block matching
(counterpart of `denoise/flow.py`).

A luminance pyramid of 2x average pooling; at each level, from the
coarsest, an exhaustive integer search of (2r+1)^2 candidates around the
lifted flow, each scored by the 5x5 box-blurred squared difference. The
candidate shifts and the blur wrap around the image (`torch.roll`), as the
reference's `jnp.roll` does (flow.py:49-76); the warp clamps its base
index. The argmin is a strict `<` in dy-then-dx order, so a tie keeps the
first candidate, and the blur divides by a device tensor so that the card
and the CPU round alike (a CUDA division by a Python scalar multiplies by
its reciprocal) and never flip a near-tie apart.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _lum(img):
    img = img.to(torch.float32)
    if img.dim() == 3:
        return (img[..., 0] * 0.2126 + img[..., 1] * 0.7152
                + img[..., 2] * 0.0722)
    return img


def _downsample(img):
    h, w = img.shape
    img = img[:h // 2 * 2, :w // 2 * 2]
    return 0.25 * (img[0::2, 0::2] + img[1::2, 0::2]
                   + img[0::2, 1::2] + img[1::2, 1::2])


def _warp(img, flow):
    """img(p + flow(p)), bilinear, base index clipped to [0, n - 2]."""
    h, w = img.shape
    dev = img.device
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None] \
        + flow[..., 1]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :] \
        + flow[..., 0]
    y0 = torch.clamp(torch.floor(yy), 0, h - 2)
    x0 = torch.clamp(torch.floor(xx), 0, w - 2)
    fy = yy - y0
    fx = xx - x0
    y0 = y0.long()
    x0 = x0.long()
    return ((img[y0, x0] * (1 - fx) + img[y0, x0 + 1] * fx) * (1 - fy)
            + (img[y0 + 1, x0] * (1 - fx) + img[y0 + 1, x0 + 1] * fx) * fy)


def _box_blur(img, r=2):
    k = torch.full((), 2 * r + 1, dtype=torch.float32, device=img.device)
    out = img
    for axis in (0, 1):
        acc = torch.zeros_like(out)
        for o in range(-r, r + 1):
            acc = acc + torch.roll(out, o, dims=axis)
        out = acc / k
    return out


def _search_level(a, b, flow, radius: int):
    """One level's refinement: the argmin over (2r+1)^2 integer
    candidates of the blurred SSD of b warped by flow + candidate
    against a."""
    best_cost = torch.full(a.shape, float("inf"), dtype=torch.float32,
                           device=a.device)
    best_dx = torch.zeros_like(best_cost)
    best_dy = torch.zeros_like(best_cost)
    b_warp = _warp(b, flow)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            cand = torch.roll(b_warp, (-dy, -dx), dims=(0, 1))
            cost = _box_blur((a - cand) ** 2, r=2)
            better = cost < best_cost
            best_cost = torch.where(better, cost, best_cost)
            best_dx = torch.where(better, float(dx), best_dx)
            best_dy = torch.where(better, float(dy), best_dy)
    return flow + torch.stack([best_dx, best_dy], dim=-1)


def optical_flow(frame_a, frame_b, levels: int = 4, radius: int = 2):
    """Flow from frame_a to frame_b ([H, W, 3] or [H, W]) → [H, W, 2]
    (x, y) in pixels, on frame_a's device; the search reaches about
    radius x (2^levels - 1) pixels (flow.py:79-105)."""
    a = _lum(frame_a)
    b = _lum(frame_b)
    pyr_a, pyr_b = [a], [b]
    for _ in range(levels - 1):
        if min(pyr_a[-1].shape) < 8:
            break
        pyr_a.append(_downsample(pyr_a[-1]))
        pyr_b.append(_downsample(pyr_b[-1]))

    flow = torch.zeros(pyr_a[-1].shape + (2,), dtype=torch.float32,
                       device=a.device)
    for lvl in range(len(pyr_a) - 1, -1, -1):
        hl, wl = pyr_a[lvl].shape
        if flow.shape[:2] != (hl, wl):
            # lift to this level: nearest x2, doubled, cropped, and
            # edge-padded where the level has an odd size
            flow = 2.0 * flow.repeat_interleave(2, 0).repeat_interleave(2, 1)
            flow = flow[:hl, :wl]
            pad_y, pad_x = hl - flow.shape[0], wl - flow.shape[1]
            if pad_y or pad_x:
                flow = F.pad(flow.permute(2, 0, 1)[None], (0, pad_x, 0, pad_y),
                             mode="replicate")[0].permute(1, 2, 0)
        flow = _search_level(pyr_a[lvl], pyr_b[lvl], flow, radius)
    return flow

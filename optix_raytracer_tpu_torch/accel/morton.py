"""Morton (Z-order) codes (counterpart of `accel/morton.py`).

The codes are 32-bit words. Torch's CPU `uint32` lacks shifts, so they are
carried in int64 holding a value in [0, 2**32), as `core/rng.py` carries its
words: every mask below is under 2**32 and every product stays inside int64,
so `(v * c) & mask` equals the JAX package's wrapping uint32 arithmetic.
"""
from __future__ import annotations

import torch

MORTON_BITS = 10  # per axis → 30-bit codes


def expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of each lane: b9..b0 → b9 0 0 b8 0 0 ... b0."""
    v = v.to(torch.int64) & 0xFFFFFFFF
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def quantize(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Unit-cube points → int64 cells in [0, 2**bits) per axis, truncating
    as the JAX package's float → uint32 conversion does."""
    q = torch.clamp(q, 0.0, 1.0 - 1e-7)
    return (q * float(1 << bits)).to(torch.int64)


def interleave(cells: torch.Tensor) -> torch.Tensor:
    """[N, 3] int64 cells → [N] int64 morton codes (x in the high bit)."""
    return ((expand_bits(cells[:, 0]) << 2) | (expand_bits(cells[:, 1]) << 1)
            | expand_bits(cells[:, 2]))


def morton3d(points: torch.Tensor, lo: torch.Tensor,
             hi: torch.Tensor) -> torch.Tensor:
    """30-bit Morton codes (int64) for [N, 3] points quantized inside the
    AABB (lo, hi)."""
    extent = torch.clamp_min(hi - lo, 1e-12)
    return interleave(quantize((points - lo) / extent, MORTON_BITS))

"""Counter-based RNG, word for word `optix_raytracer_tpu/core/rng.py`.

TEA seed + LCG advance + a constant-shift finalizer over elementwise 32-bit
words. Torch's CPU `uint32` lacks add and shifts, so the state is carried as
`int64` holding a value in [0, 2**32). Sums and shifts of such values stay far
inside int64; a product of two 32-bit words does not (up to 2**64), so
`_mul32` splits the constant into 16-bit halves: each partial product is
below 2**48 and the result is exact modulo 2**32. The CUDA kernels use plain
`uint32_t` for the same words.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def _u32(x) -> torch.Tensor:
    """Any integer tensor or Python int → int64 tensor of its low 32 bits."""
    return torch.as_tensor(x).to(torch.int64) & MASK32


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for a in [0, 2**32) and a 32-bit constant c."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & MASK32


def tea(val0, val1, rounds: int = 4) -> torch.Tensor:
    """TEA hash of two 32-bit words → 32-bit seed (reference `random.h:34-49`)."""
    v0 = _u32(val0)
    v1 = _u32(val1)
    s0 = 0
    for _ in range(rounds):
        s0 = (s0 + 0x9E3779B9) & MASK32
        v0 = (v0 + (((v1 << 4) + 0xA341316C) ^ (v1 + s0)
                    ^ ((v1 >> 5) + 0xC8013EA4))) & MASK32
        v1 = (v1 + (((v0 << 4) + 0xAD90777D) ^ (v0 + s0)
                    ^ ((v0 >> 5) + 0x7E95761E))) & MASK32
    return v0


def pcg(state):
    """One counter-hash step: returns (output_word, next_state)."""
    new_state = (_mul32(_u32(state), 747796405) + 2891336453) & MASK32
    x = new_state
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    x = x ^ (x >> 16)
    return x, new_state


def _to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """32-bit word → float32 in [0, 1) from the top 24 bits (exact in f32)."""
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)


def seed(pixel_index, subframe) -> torch.Tensor:
    """Per-ray state from (pixel linear index, subframe): tea<4>."""
    return tea(pixel_index, subframe)


def uniform(state):
    """One uniform [0, 1) float per lane; returns (u, next_state)."""
    word, next_state = pcg(state)
    return _to_unit_float(word), next_state


def uniform2(state):
    """Two uniforms; returns (u1, u2, next_state)."""
    u1, state = uniform(state)
    u2, state = uniform(state)
    return u1, u2, state

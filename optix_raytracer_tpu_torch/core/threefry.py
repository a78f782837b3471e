"""`jax.random`'s threefry2x32 keys and uniforms in torch, bit for bit
(JAX 0.9 with `jax_threefry_partitionable` on, its default): `prng_key`,
`fold_in` and `uniform`. The samples that draw through `jax.random`
(`apps/bound_values.py:40-41`) draw the same numbers here.

Words are int64 holding a value in [0, 2**32), masked after every sum, as
`core/rng.py` carries its state (torch's CPU uint32 lacks add and shifts);
a rotation shifts a word by at most 29 bits, so it stays inside int64. A
key is an int64 tensor [2] on the device.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k1, k2, x0, x1):
    """Threefry-2x32, 20 rounds (jax/_src/prng.py threefry2x32 lowering):
    keys k1, k2 and counter words x0, x1 (int64 tensors holding 32-bit
    words, broadcastable) → the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def prng_key(seed: int, device) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` for a seed in [0, 2**32): [0, seed]."""
    return torch.tensor([0, seed & MASK32], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """`jax.random.fold_in(key, data)`: the key's threefry of the counter
    pair (0, data)."""
    zero = torch.zeros((1,), dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[0], key[1], zero, zero + (data & MASK32))
    return torch.cat([y0, y1])


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """`jax.random.uniform(key, shape)` in float32 [0, 1): the partitionable
    bits of each element's row-major index (hi word, lo word) through
    threefry, the two output words xor'd, the top 23 bits as the mantissa
    of a float in [1, 2), minus 1."""
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(key[0], key[1], idx >> 32, idx & MASK32)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(floats, 0.0).reshape(tuple(shape))

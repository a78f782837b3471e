"""Counter-based RNG, word for word `optix_raytracer_tpu/core/rng.py`.

TEA seed + LCG advance + a constant-shift finalizer over elementwise 32-bit
words. Torch's CPU `uint32` lacks add and shifts, so the state is carried as
`int64` holding a value in [0, 2**32). Sums and shifts of such values stay far
inside int64; a product of two 32-bit words does not (up to 2**64), so
`_mul32` splits the constant into 16-bit halves: each partial product is
below 2**48 and the result is exact modulo 2**32. The CUDA kernels use plain
`uint32_t` for the same words.

`seed` and `uniform2` dispatch on the device of their tensors: on the CPU
they are the torch functions `seed_plain` / `uniform2_plain` (held to the JAX
package word for word by the CPU tests); on the card each is one launch of
`csrc/rng.cu` (`rng_seed_kernel`, `rng_uniform2_kernel`; LAUNCHES keys
"rng_seed" and "rng_uniform2"), bit-equal to them.
"""
from __future__ import annotations

import contextlib

import torch

from .. import kernels

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


def seed_plain(pixel_index, subframe) -> torch.Tensor:
    """Per-ray state from (pixel linear index, subframe): tea<4>."""
    return tea(pixel_index, subframe)


def _device(*operands) -> torch.device:
    """The device a call runs on: that of its tensors off the CPU, else the
    CPU."""
    devs = {x.device for x in operands
            if isinstance(x, torch.Tensor) and x.device.type != "cpu"}
    if len(devs) > 1:
        raise ValueError(f"operands on {sorted(map(str, devs))}")
    return devs.pop() if devs else torch.device("cpu")


def seed_operands(pixel_index, subframe, dev: torch.device):
    """How `rng_seed_kernel` reads the two operands on `dev` → (shape of the
    broadcast, [(tensor or None, value, s0, s1, s2)] an operand): a tensor on
    `dev` expanded to the shape (`torch.broadcast_tensors`), read at i0 * s0
    + i1 * s1 + i2 * s2 over the shape padded to rank 3 (zero strides where
    broadcast), or a Python int's or a 0-d host tensor's low 32 bits as the
    value. A host tensor of rank 1 or more beside a device one is refused,
    as torch's elementwise ops refuse it."""
    operands = (pixel_index, subframe)
    on_dev = [isinstance(x, torch.Tensor) and x.device == dev
              for x in operands]
    expanded = iter(torch.broadcast_tensors(
        *(x.to(torch.int64) for x, d in zip(operands, on_dev) if d)))
    shape, ops = (), []
    for x, d in zip(operands, on_dev):
        if d:
            x = next(expanded)
            shape = tuple(x.shape)
            ops.append((x, 0, *(0,) * (3 - x.dim()), *x.stride()))
        elif isinstance(x, torch.Tensor) and x.dim() != 0:
            raise ValueError(f"rng.seed: a {tuple(x.shape)} operand on "
                             f"{x.device} beside one on {dev}")
        else:   # as _u32 takes it
            ops.append((None, int(x) & MASK32, 0, 0, 0))
    if len(shape) > 3:
        raise ValueError(f"rng.seed: rank {len(shape)} above the kernel's 3")
    return shape, ops


def _on(dev: torch.device):
    """The context a launch on `dev` needs: none when `dev` is the current
    device already (as in every rank of the port), else `dev` made
    current."""
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def seed(pixel_index, subframe) -> torch.Tensor:
    """Per-ray state from (pixel linear index, subframe): tea<4> over the
    broadcast of the two (integers or integer tensors) → int64 in [0,
    2**32). `seed_plain` on the CPU; `rng_seed_kernel` when either is a
    CUDA tensor (the other a tensor on the same card or a host scalar)."""
    dev = _device(pixel_index, subframe)
    if dev.type == "cpu":
        return seed_plain(pixel_index, subframe)
    if dev.type != "cuda":
        raise ValueError(f"rng.seed: unsupported device {dev}")
    shape, ops = seed_operands(pixel_index, subframe, dev)
    out = torch.empty(shape, dtype=torch.int64, device=dev)
    args = [a for t, *rest in ops
            for a in (t.data_ptr() if t is not None else None, *rest)]
    with _on(dev), kernels.launch("rng_seed"):
        err = kernels.lib().ort_rng_seed(
            *args, *(1,) * (3 - len(shape)), *shape, out.data_ptr(),
            kernels.stream_ptr(dev))
    kernels.check(err, "rng_seed")
    return out


def uniform(state):
    """One uniform [0, 1) float per lane; returns (u, next_state)."""
    word, next_state = pcg(state)
    return _to_unit_float(word), next_state


def uniform2_plain(state):
    """Two uniforms; returns (u1, u2, next_state)."""
    u1, state = uniform(state)
    u2, state = uniform(state)
    return u1, u2, state


def uniform2(state: torch.Tensor):
    """Two uniforms a lane of an integer state tensor; returns (u1, u2,
    next_state): f32, f32 and int64 in [0, 2**32), of the state's shape.
    `uniform2_plain` on the CPU, `rng_uniform2_kernel` on the card."""
    dev = state.device
    if dev.type == "cpu":
        return uniform2_plain(state)
    if dev.type != "cuda":
        raise ValueError(f"rng.uniform2: unsupported device {dev}")
    state = state.to(torch.int64).contiguous()
    u1 = torch.empty(state.shape, dtype=torch.float32, device=dev)
    u2 = torch.empty(state.shape, dtype=torch.float32, device=dev)
    nxt = torch.empty(state.shape, dtype=torch.int64, device=dev)
    with _on(dev), kernels.launch("rng_uniform2"):
        err = kernels.lib().ort_rng_uniform2(
            state.data_ptr(), state.numel(), u1.data_ptr(), u2.data_ptr(),
            nxt.data_ptr(), kernels.stream_ptr(dev))
    kernels.check(err, "rng_uniform2")
    return u1, u2, nxt

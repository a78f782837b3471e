"""Texture-fetch primitive A/B (counterpart of `tools/bench_texfetch.py`):
torch's per-lane row gather against kernel 9, the block-tile row fetch.

The reference's study asked whether a coherent 256-lane block should fetch
its texel tile once and resolve each lane's row inside the tile (on the TPU
a one-hot bf16 MXU contraction against the tile in VMEM) rather than gather
each lane's row on its own. The workloads are shaped like the textured
bench: 2M lanes in 256-lane blocks, block b reading rows [base_b, base_b +
tile_w) of a 65,536-row atlas of 128-wide bf16 rows.

`onehot_fetch` keeps the reference's name and contract: block b fetches the
aligned 2-tile window starting at tile tile_idx[b] and lane l gets its row
local[b, l] (in [0, 2 tile_w)), as f32. On CUDA tensors it launches kernel 9
(`csrc/texfetch.cu`); on CPU tensors it runs `onehot_fetch_plain`, the same
indexing in torch ops. The copy is exact, so the two agree bit for bit.

    python -m optix_raytracer_tpu_torch.tools.bench_texfetch [rounds]

Needs a CUDA device. Per tile_w (128, 256, 512) it holds the kernel to its
plain version, bit for bit, then prints one JSON line: the kernel's, the
plain version's and torch's f32 row gather's mean device time (CUDA events),
the bound (bytes over the card's memory rate) and the kernel's max abs
difference from its plain version; then the card's name.
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch

from .. import kernels

BLOCK = 256          # lanes per coherent block (one traversal sub-block)
ROW_W = 128          # quad-row width (2x2 bilinear footprint packed)
N_LANES = 1 << 21
N_ROWS = 1 << 16     # the 65k-row atlas of the textured bench
TILE_WS = (128, 256, 512)
HBM_RATE = 3.35e12   # H100 SXM HBM3, bytes per second


def make_workload(n_lanes, n_rows, tile_w, seed=0, device="cpu"):
    """Per-block coherent indices (tools/bench_texfetch.py:41-50): block b
    reads rows in [base_b, base_b + tile_w) → (idx [n_lanes], base
    [n_blocks], local [n_blocks, BLOCK]), int32."""
    rng = np.random.default_rng(seed)
    n_blocks = n_lanes // BLOCK
    base = rng.integers(0, n_rows - tile_w, n_blocks).astype(np.int32)
    local = rng.integers(0, tile_w, (n_blocks, BLOCK)).astype(np.int32)
    idx = base[:, None] + local
    return tuple(torch.as_tensor(a, device=device)
                 for a in (idx.reshape(-1), base, local))


def tile_window(base, local, tile_w):
    """Any tile_w-row footprint based inside tile k lies in the aligned
    2-tile window [k tile_w, (k + 2) tile_w) (tools/bench_texfetch.py:
    136-139) → (tile_idx [n_blocks], local within the window)."""
    tile_idx = base // tile_w
    return tile_idx, local + (base - tile_idx * tile_w)[:, None]


def onehot_fetch_plain(atlas_bf16, tile_idx, local, tile_w):
    """Row tile_idx[b] * tile_w + local[b, l] of the bf16 atlas as f32 →
    [n_blocks * BLOCK, ROW_W]."""
    rows = tile_idx.to(torch.int64)[:, None] * tile_w + local.to(torch.int64)
    return atlas_bf16[rows.reshape(-1)].to(torch.float32)


def onehot_fetch(atlas_bf16, tile_idx, local, tile_w):
    """atlas_bf16 [n_rows, ROW_W] bf16 (n_rows a multiple of tile_w),
    tile_idx [n_blocks] int32, local [n_blocks, BLOCK] int32 in [0,
    2 tile_w) → f32 [n_blocks * BLOCK, ROW_W]. Kernel 9 on CUDA tensors,
    the plain version on CPU tensors."""
    dev = atlas_bf16.device
    n_blocks = tile_idx.shape[0]
    n_rows = atlas_bf16.shape[0]
    if n_rows % tile_w or (n_blocks and int(tile_idx.max()) + 2 > n_rows
                           // tile_w):
        raise ValueError(f"tile_w {tile_w}: the 2-tile windows leave the "
                         f"{n_rows}-row atlas")
    if dev.type == "cpu":
        return onehot_fetch_plain(atlas_bf16, tile_idx, local, tile_w)
    if dev.type != "cuda":
        raise ValueError(f"onehot_fetch: unsupported device {dev}")
    kernels.require(atlas_bf16, "atlas", torch.bfloat16, (n_rows, ROW_W), dev)
    kernels.require(tile_idx, "tile_idx", torch.int32, (n_blocks,), dev)
    kernels.require(local, "local", torch.int32, (n_blocks, BLOCK), dev)
    out = torch.empty((n_blocks * BLOCK, ROW_W), dtype=torch.float32,
                      device=dev)
    with torch.cuda.device(dev), kernels.launch("texfetch"):
        err = kernels.lib().ort_texfetch(
            atlas_bf16.data_ptr(), tile_idx.data_ptr(), local.data_ptr(),
            tile_w, n_blocks, out.data_ptr(), kernels.stream_ptr(dev))
    kernels.check(err, "texfetch")
    return out


def moved_bytes(tile_idx, local, tile_w):
    """The bytes the fetch must move: the distinct atlas rows it reads
    (256 bytes each), its indices, and the f32 rows it writes."""
    rows = (tile_idx.to(torch.int64)[:, None] * tile_w
            + local.to(torch.int64)).reshape(-1)
    return (int(torch.unique(rows).numel()) * ROW_W * 2
            + tile_idx.numel() * 4 + local.numel() * 4
            + rows.numel() * ROW_W * 4)


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def parity(tile_w, atlas_bf, seed=0):
    """Kernel 9 against its plain version on the A/B's workload at tile_w
    → (max abs difference, bit-equal)."""
    _, base, local = make_workload(N_LANES, atlas_bf.shape[0], tile_w,
                                   seed=seed, device=atlas_bf.device)
    tile_idx, local2 = tile_window(base, local, tile_w)
    out = onehot_fetch(atlas_bf, tile_idx, local2, tile_w)
    ref = onehot_fetch_plain(atlas_bf, tile_idx, local2, tile_w)
    return float((out - ref).abs().max()), bool(torch.equal(out, ref))


def ab(tile_w, atlas_f32, atlas_bf, rounds=5, seed=0):
    """One A/B at tile_w on N_LANES lanes → dict of mean device times (ms)
    of the kernel, its plain version and torch's row gather from the f32
    atlas (tools/bench_texfetch.py:133-147's A), and the bound."""
    dev = atlas_f32.device
    idx, base, local = make_workload(N_LANES, atlas_f32.shape[0], tile_w,
                                     seed=seed, device=dev)
    tile_idx, local2 = tile_window(base, local, tile_w)
    idx64 = idx.to(torch.int64)
    nbytes = moved_bytes(tile_idx, local2, tile_w)
    return dict(
        tile_w=tile_w, lanes=N_LANES, rows=atlas_f32.shape[0],
        kernel_ms=cuda_ms(lambda: onehot_fetch(atlas_bf, tile_idx, local2,
                                               tile_w), rounds),
        plain_ms=cuda_ms(lambda: onehot_fetch_plain(atlas_bf, tile_idx,
                                                    local2, tile_w), rounds),
        library_ms=cuda_ms(lambda: atlas_f32[idx64], rounds),
        bound_ms=1e3 * nbytes / HBM_RATE, bound_by="bytes", bytes=nbytes)


def make_atlas(device, n_rows=N_ROWS, seed=1):
    """The study's atlas: N(0, 1) rows from a seed, f32 and bf16."""
    rng = np.random.default_rng(seed)
    atlas = torch.as_tensor(rng.normal(size=(n_rows, ROW_W))
                            .astype(np.float32), device=device)
    return atlas, atlas.to(torch.bfloat16)


def main():
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    if not torch.cuda.is_available():
        raise SystemExit("bench_texfetch: needs a CUDA device")
    dev = torch.device("cuda")
    atlas, atlas_bf = make_atlas(dev)
    for tile_w in TILE_WS:
        err, equal = parity(tile_w, atlas_bf)
        if not equal:
            raise SystemExit(f"bench_texfetch: kernel 9 differs from its "
                             f"plain version at tile_w {tile_w} by {err}")
        r = ab(tile_w, atlas, atlas_bf, rounds)
        print(json.dumps(dict(r, max_abs_err=err)), flush=True)
    print(json.dumps({"card": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()

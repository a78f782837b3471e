"""Kernel 9's plain version (optix_raytracer_tpu_torch/tools/bench_texfetch.py
::onehot_fetch on CPU tensors) against the reference's
tools/bench_texfetch.py::onehot_fetch, its Pallas block-tile one-hot fetch,
in interpret mode, loaded from the reference's file by path: equal bit for
bit (the one-hot product and the row copy are both exact)."""
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from optix_raytracer_tpu_torch.tools import bench_texfetch as T

_REF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tools", "bench_texfetch.py")


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location("ref_bench_texfetch", _REF)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("tile_w", [128, 256])
def test_plain_matches_reference_kernel(ref, tile_w):
    """The same workload (the reference's make_workload from one seed)
    through both: rows equal, and equal to the bf16 atlas's own rows."""
    n_lanes, n_rows = T.BLOCK * 8, 2048
    idx, base, local = T.make_workload(n_lanes, n_rows, tile_w, seed=9)
    jidx, jbase, jlocal = ref.make_workload(n_lanes, n_rows, tile_w, seed=9)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(local.numpy(), np.asarray(jlocal))
    atlas, atlas_bf = T.make_atlas("cpu", n_rows)
    tile_idx, local2 = T.tile_window(base, local, tile_w)
    out = T.onehot_fetch(atlas_bf, tile_idx, local2, tile_w)
    jatlas = jnp.asarray(atlas.numpy()).astype(jnp.bfloat16)
    expect = ref.onehot_fetch(jatlas, jnp.asarray(tile_idx.numpy()),
                              jnp.asarray(local2.numpy()), tile_w,
                              interpret=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(expect))
    assert torch.equal(out, atlas_bf[idx.long()].float())
    assert out.shape == (n_lanes, T.ROW_W) and out.dtype == torch.float32


def test_window_and_bytes():
    """Every lane's row lies in its block's 2-tile window; the bound's bytes
    count the distinct rows read, the indices and the rows written; a
    window past the atlas raises."""
    idx, base, local = T.make_workload(T.BLOCK * 4, 1024, 128, seed=2)
    tile_idx, local2 = T.tile_window(base, local, 128)
    assert int(local2.min()) >= 0 and int(local2.max()) < 256
    rows = tile_idx[:, None].long() * 128 + local2.long()
    assert torch.equal(rows.reshape(-1), idx.long())
    n = idx.numel()
    distinct = int(torch.unique(idx).numel())
    assert T.moved_bytes(tile_idx, local2, 128) == (
        distinct * 256 + 4 * 4 + 4 * n + n * 512)
    _, atlas_bf = T.make_atlas("cpu", 1024)
    with pytest.raises(ValueError):
        T.onehot_fetch(atlas_bf, torch.full_like(tile_idx, 7), local2, 128)

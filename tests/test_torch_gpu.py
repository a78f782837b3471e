"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked `gpu`; every test skips when `torch.cuda.is_available()` is false
(decided in a fixture, never at import). Run on a CUDA machine with
`python -m pytest tests/test_torch_gpu.py -m gpu`. Bars: hit ids and
occlusion equal, t within rtol 1e-5, uv 1e-4, normals 1e-5
(test_pallas_intersect.py); the fused kernel's ray counts equal and its
radiance within atol 2e-3 / rtol 1e-3 (test_fused_kernel.py)."""
import numpy as np
import pytest
import torch

from optix_raytracer_tpu_torch import kernels
from optix_raytracer_tpu_torch.accel import pallas_bf
from optix_raytracer_tpu_torch.accel.geometry import build_triangle_geometry
from optix_raytracer_tpu_torch.core.rays import Rays
from optix_raytracer_tpu_torch.scene.builtins import cornell_box, cornell_camera
from optix_raytracer_tpu_torch.wavefront import pallas_pt

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _mesh_and_rays(num_tris, n_rays, seed, device):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-1, 1, (num_tris, 3))
    verts = np.concatenate([v0, v0 + rng.uniform(-1, 1, (num_tris, 3)),
                            v0 + rng.uniform(-1, 1, (num_tris, 3))])
    idx = np.arange(3 * num_tris).reshape(3, num_tris).T.copy()
    idx[num_tris // 2, 2] = idx[num_tris // 2, 1]   # one degenerate triangle
    geom = build_triangle_geometry(verts.astype(np.float32),
                                   idx.astype(np.int32), device)
    tri_mat = torch.as_tensor(rng.integers(0, 5, num_tris).astype(np.int32),
                              device=device)
    o = rng.uniform(-3, 3, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = Rays.make(torch.as_tensor(o, device=device),
                     torch.as_tensor(d, device=device), tmin=1e-3, tmax=50.0)
    return geom, tri_mat, rays


@pytest.mark.parametrize("num_tris", [40, 700])   # 700 spans three tiles
def test_bf_kernels_match_plain(cuda, num_tris):
    geom, tri_mat, rays = _mesh_and_rays(num_tris, 1500, 7, cuda)
    out = pallas_bf.closest_hit(geom.tri_consts, tri_mat, rays)
    ref = pallas_bf.closest_hit_plain(geom.tri_consts, tri_mat, rays)
    torch.cuda.synchronize()
    for k in ("prim_id", "mat_id"):
        np.testing.assert_array_equal(out[k].cpu().numpy(),
                                      ref[k].cpu().numpy())
    hit = ref["prim_id"].cpu().numpy() >= 0
    assert hit.any() and (~hit).any()
    for k, tol in (("t", dict(rtol=1e-5)), ("uv", dict(atol=1e-4)),
                   ("normal", dict(atol=1e-5))):
        np.testing.assert_allclose(out[k].cpu().numpy()[hit],
                                   ref[k].cpu().numpy()[hit], **tol)
    np.testing.assert_array_equal(
        pallas_bf.any_hit(geom.tri_consts, rays).cpu().numpy(),
        pallas_bf.any_hit_plain(geom.tri_consts, rays).cpu().numpy())


def test_bf_wrappers_check_arguments(cuda):
    geom, tri_mat, rays = _mesh_and_rays(8, 64, 1, cuda)
    with pytest.raises(TypeError):
        pallas_bf.closest_hit(geom.tri_consts, tri_mat.long(), rays)
    bad = Rays(rays.origin.double(), rays.direction, rays.tmin, rays.tmax)
    with pytest.raises(TypeError):
        pallas_bf.any_hit(geom.tri_consts, bad)


def test_fused_kernel_matches_plain(cuda):
    scene = cornell_box(cuda)
    w, h = 48, 40
    cam = cornell_camera(w, h).params(cuda)
    before = kernels.LAUNCHES["pt_fused_cornell"]
    out, count = pallas_pt.render_sum_fused(scene, cam, w, h,
                                            torch.tensor(7, device=cuda),
                                            samples_per_launch=2, max_depth=3)
    assert kernels.LAUNCHES["pt_fused_cornell"] == before + 1
    ref, ref_count = pallas_pt.render_sum_plain(scene, cam, w, h, 7,
                                                samples_per_launch=2,
                                                max_depth=3)
    assert int(count) == int(ref_count)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               atol=2e-3, rtol=1e-3)


def test_fused_kernel_row_tiles(cuda):
    scene = cornell_box(cuda)
    w, h = 32, 32
    cam = cornell_camera(w, h).params(cuda)
    full, c_full = pallas_pt.render_sum_fused(scene, cam, w, h, 0,
                                              samples_per_launch=2,
                                              max_depth=2)
    parts = [pallas_pt.render_sum_fused(scene, cam, w, 16, 0,
                                        samples_per_launch=2, max_depth=2,
                                        y0=y0, full_width=w, full_height=h)
             for y0 in (0, 16)]
    np.testing.assert_array_equal(
        torch.cat([p[0] for p in parts]).cpu().numpy(), full.cpu().numpy())
    assert sum(int(p[1]) for p in parts) == int(c_full)

"""The counter RNG's seed and draws (`core/rng.py`): the torch functions
against a pure-Python uint32 reference at edge words (the oracle that
`csrc/rng.cu` is held to), the CPU dispatch, and how the seed kernel reads
its broadcast operands; then, marked `gpu` and skipped without a card,
`rng_seed_kernel` / `rng_uniform2_kernel` bit-equal to the torch functions
on the card, alone and inside a sample-major strip and a graph-replayed
sequential frame of the SPD `tetra`. No JAX here: `test_torch_core.py`
holds the torch functions to the JAX package."""
import dataclasses

import numpy as np
import pytest
import torch

from optix_raytracer_tpu_torch import kernels, telemetry
from optix_raytracer_tpu_torch.core import rng
from optix_raytracer_tpu_torch.core.film import Film
from optix_raytracer_tpu_torch.scene import builtins as B
from optix_raytracer_tpu_torch.wavefront import engine

M = 0xFFFFFFFF
# 0, 1, the sign bit, all ones, TEA's delta and keys, the LCG's and the
# finalizer's constants
EDGE = (0, 1, 2 ** 31, M, 0x9E3779B9, 0xA341316C, 0xC8013EA4, 0xAD90777D,
        0x7E95761E, 747796405, 2891336453, 0x7FEB352D, 0x846CA68B)


def tea_ref(v0, v1, rounds=4):
    """random.h:34-49 in uint32 arithmetic, every step wrapped."""
    s0 = 0
    for _ in range(rounds):
        s0 = (s0 + 0x9E3779B9) & M
        v0 = (v0 + ((((v1 << 4) & M) + 0xA341316C) & M
                    ^ ((v1 + s0) & M)
                    ^ (((v1 >> 5) + 0xC8013EA4) & M))) & M
        v1 = (v1 + ((((v0 << 4) & M) + 0xAD90777D) & M
                    ^ ((v0 + s0) & M)
                    ^ (((v0 >> 5) + 0x7E95761E) & M))) & M
    return v0


def pcg_ref(state):
    state = (state * 747796405 + 2891336453) & M
    x = state
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & M
    x = ((x ^ (x >> 15)) * 0x846CA68B) & M
    return x ^ (x >> 16), state


def unit_ref(word):
    return np.float32(word >> 8) * np.float32(2.0 ** -24)


def i64(words):
    return torch.tensor(words, dtype=torch.int64)


@pytest.mark.parametrize("word", EDGE)
def test_tea_matches_uint32_reference(word):
    """tea / seed at `word` against every edge word, as either operand."""
    others = list(EDGE)
    want0 = [tea_ref(word, o) for o in others]
    want1 = [tea_ref(o, word) for o in others]
    assert rng.tea(i64([word] * len(others)), i64(others)).tolist() == want0
    assert rng.seed(word, i64(others)).tolist() == want0
    assert rng.seed(i64(others), word).tolist() == want1


@pytest.mark.parametrize("word", EDGE)
def test_pcg_and_uniform2_match_uint32_reference(word):
    """Three pcg steps from `word`, and uniform2's draws and next state,
    bit for bit (the draws' top 24 bits times 2**-24 are exact in f32)."""
    state, ref = i64([word]), word
    for _ in range(3):
        out, state = rng.pcg(state)
        ref_out, ref = pcg_ref(ref)
        assert (out.item(), state.item()) == (ref_out, ref)
    w1, s1 = pcg_ref(word)
    w2, s2 = pcg_ref(s1)
    u1, u2, nxt = rng.uniform2(i64([word]))
    assert u1.dtype == u2.dtype == torch.float32 and nxt.dtype == torch.int64
    assert u1.numpy()[0] == unit_ref(w1) and u2.numpy()[0] == unit_ref(w2)
    assert nxt.item() == s2


def test_cpu_never_loads_the_library(monkeypatch):
    """On CPU tensors seed and uniform2 are the torch functions, and a whole
    CPU launch on a cluster scene never reaches `kernels.lib()`."""
    def refuse():
        raise AssertionError("kernels.lib() called for a CPU tensor")

    monkeypatch.setattr(kernels, "lib", refuse)
    before = dict(kernels.LAUNCHES)
    pix = torch.arange(12, dtype=torch.int64).reshape(3, 4)
    for sub in (5, torch.tensor(5), torch.arange(2)[:, None, None]):
        assert torch.equal(rng.seed(pix, sub), rng.seed_plain(pix, sub))
    state = rng.seed(pix, 3)
    for a, b in zip(rng.uniform2(state), rng.uniform2_plain(state)):
        assert torch.equal(a, b)
    scene = B.spd_tetra_scene("cpu", level=4)
    assert scene.has_clusters
    cam = B.spd_tetra_camera(8, 6).params("cpu")
    for spl in (8, 1):
        film, rays = engine.render_accumulate(
            scene, cam, Film.create(6, 8, "cpu"), 8, 6,
            samples_per_launch=spl, max_depth=2)
        assert int(rays) > 0
    assert dict(kernels.LAUNCHES) == before


def test_other_devices_raise():
    meta = torch.empty((4,), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rng.uniform2(meta)
    with pytest.raises(ValueError, match="unsupported device"):
        rng.seed(meta, 0)


def _read_as_kernel(shape, ops):
    """The seed kernel's indexing, in torch: each operand's words over the
    rank-3 shape, from its strides or its value."""
    dims = (1,) * (3 - len(shape)) + tuple(shape)
    words = []
    for t, value, *strides in ops:
        words.append(torch.full(dims, value, dtype=torch.int64) if t is None
                     else torch.as_strided(t, dims, strides))
    return rng.tea(*words).reshape(shape)


@pytest.mark.parametrize("case", ["flat_int", "flat_scalar_tensor",
                                  "strip", "sliced", "int32", "negative"])
def test_seed_operands_read_the_broadcast(case):
    """`seed_operands` hands the kernel strides and values that read what
    the broadcast of the plain seed reads (here on CPU tensors, the strides
    taken as the kernel takes them)."""
    pix = torch.arange(6 * 5, dtype=torch.int64).reshape(6, 5) * 7919
    a, b = {
        "flat_int": (pix.reshape(-1), 9),
        "flat_scalar_tensor": (pix.reshape(-1), torch.tensor(2 ** 32 + 3)),
        "strip": (pix[None], 11 + torch.arange(4)[:, None, None]),
        "sliced": (pix[1::2, ::2], torch.arange(3)[:, None]),
        "int32": (pix.to(torch.int32), torch.tensor([[4], [5], [6], [7], [8],
                                                     [9]])),
        "negative": (-pix - 1, -3),
    }[case]
    shape, ops = rng.seed_operands(a, b, torch.device("cpu"))
    assert shape == torch.broadcast_shapes(
        *(x.shape if isinstance(x, torch.Tensor) else () for x in (a, b)))
    assert torch.equal(_read_as_kernel(shape, ops), rng.seed_plain(a, b))


def test_seed_operands_refuse():
    pix = torch.arange(8, dtype=torch.int64)
    with pytest.raises(ValueError, match="rank 4"):
        rng.seed_operands(pix.reshape(1, 2, 2, 2), 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="beside one on"):
        rng.seed_operands(pix.to("meta"), pix, torch.device("meta"))
    with pytest.raises(ValueError, match="beside one on"):
        rng.seed_operands(pix.to("meta"), pix[:1], torch.device("meta"))


# --- on the card ------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _states(n, device, seed=0):
    """n random states in [0, 2**32) with 0, 1 and 2**32 - 1 among them."""
    r = np.random.default_rng(seed).integers(0, 2 ** 32, n, dtype=np.int64)
    r[:3] = (0, 1, M)[:n]
    return torch.as_tensor(r, device=device)


def _assert_draws_equal(state):
    plain = rng.uniform2_plain(state)
    before = kernels.LAUNCHES["rng_uniform2"]
    got = rng.uniform2(state)
    assert kernels.LAUNCHES["rng_uniform2"] == before + 1
    for g, p in zip(got, plain):
        assert g.shape == state.shape and g.dtype == p.dtype
        assert torch.equal(g.view(torch.int32) if g.is_floating_point()
                           else g, p.view(torch.int32)
                           if p.is_floating_point() else p)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2 ** 22,), (2048, 2048), (16, 512, 512),
                                   (1001,), (1,)])
def test_uniform2_kernel_bit_equal(cuda, shape):
    """2**22 random states (0, 1, 2**32 - 1 among them) in [n], [h, w] and
    [spl, h, w], and odd counts: draws and next states bit-equal."""
    n = int(np.prod(shape))
    _assert_draws_equal(_states(n, cuda).reshape(shape))


@pytest.mark.gpu
def test_uniform2_kernel_views_and_chains(cuda):
    """A view at an odd offset (not 16-byte aligned: the one-lane loop), a
    strided view, and 19 draws chained through the kernel's own states."""
    s = _states(4097, cuda, seed=1)
    _assert_draws_equal(s[1:])
    _assert_draws_equal(s[::3])
    a = b = _states(1 << 20, cuda, seed=2)
    for _ in range(19):
        *ua, a = rng.uniform2(a)
        *ub, b = rng.uniform2_plain(b)
        assert all(torch.equal(x, y) for x, y in zip(ua, ub))
    assert torch.equal(a, b)


@pytest.mark.gpu
def test_seed_kernel_bit_equal_without_sync(cuda):
    """The strip's broadcast [1, h, w] x [spl, 1, 1] from a 0-d device
    subframe, a flat [n] with a device, CPU or Python subframe: bit-equal to
    the plain seed, and no host-device sync (sync debug mode "error")."""
    h, w, spl = 136, 1920, 16
    gy = torch.arange(h, dtype=torch.int64, device=cuda)[:, None] + 952
    gx = torch.arange(w, dtype=torch.int64, device=cuda)[None, :]
    pix = gy * w + gx
    subframe = torch.tensor(2 ** 32 - 5, dtype=torch.int64, device=cuda)
    cases = [(pix[None], subframe + torch.arange(
        spl, dtype=torch.int64, device=cuda)[:, None, None])]
    cases += [(pix.reshape(-1), s) for s in (subframe, torch.tensor(7), 7,
                                             -1)]
    cases += [(pix[::2, 1::3], subframe), (3, pix), (pix, pix.T[:1].T)]
    want = [rng.seed_plain(a, b) for a, b in cases]
    torch.cuda.synchronize()
    before = kernels.LAUNCHES["rng_seed"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [rng.seed(a, b) for a, b in cases]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert kernels.LAUNCHES["rng_seed"] == before + len(cases)
    for g, p in zip(got, want):
        assert g.dtype == torch.int64 and g.shape == p.shape
        assert torch.equal(g, p)


def _plain_rng(monkeypatch):
    monkeypatch.setattr(rng, "seed", rng.seed_plain)
    monkeypatch.setattr(rng, "uniform2", rng.uniform2_plain)


def _record_rng(monkeypatch):
    """Wrap trace_paths to keep each RNG state it returns → the list."""
    kept, trace = [], engine.trace_paths

    def keep(*args, **kw):
        out = trace(*args, **kw)
        kept.append(out[1])
        return out

    monkeypatch.setattr(engine, "trace_paths", keep)
    return kept


@pytest.mark.gpu
def test_sample_major_strips_bit_equal(cuda, monkeypatch):
    """The SPD `tetra` (level 7) at 64 x 48, spl 8, depth 4 in three strips
    of 16 rows: film, each strip's final RNG state and rays_traced
    bit-equal to the torch RNG's render; 18 draws a strip (2 camera, 4 a
    bounce) and one seed."""
    w, h, spl, depth = 64, 48, 8, 4
    monkeypatch.setattr(engine, "_SPL_TILE_RAYS", w * spl * 16)
    scene = B.spd_tetra_scene(cuda)
    cam = B.spd_tetra_camera(w, h).params(cuda)

    def render(plain):
        with monkeypatch.context() as m:
            if plain:
                _plain_rng(m)
            kept = _record_rng(m)
            kernels.reset_launches()
            film, rays = engine.render_accumulate(
                scene, cam, Film.create(h, w, cuda), w, h,
                samples_per_launch=spl, max_depth=depth, impl="spl")
            return film.accum, int(rays), kept, dict(kernels.LAUNCHES)

    f_k, r_k, s_k, l_k = render(False)
    f_p, r_p, s_p, l_p = render(True)
    assert torch.equal(f_k, f_p) and r_k == r_p
    assert len(s_k) == len(s_p) == 3
    assert all(torch.equal(a, b) for a, b in zip(s_k, s_p))
    assert (l_k["rng_seed"], l_k["rng_uniform2"]) == (3, 3 * (2 + 4 * depth))
    assert (l_p["rng_seed"], l_p["rng_uniform2"]) == (0, 0)
    assert l_k["cluster_closest"] == l_p["cluster_closest"] > 0


@pytest.mark.gpu
def test_replayed_frames_bit_equal(cuda, monkeypatch):
    """The sorted sequential loop (spl 4, depth 4, 48 x 32, the camera
    turning each launch, the film reset) captured at the second launch and
    replayed after: films, rays_traced and the last sample's RNG state of
    every launch bit-equal to the torch RNG's frames, also replayed; 72
    draws and 4 seeds a frame, as LAUNCHES counts them at each replay."""
    from optix_raytracer_tpu_torch.wavefront import launch_graph

    w, h, spl, depth = 48, 32, 4, 4
    base = B.spd_tetra_camera(w, h)
    monkeypatch.setenv("ORT_LAUNCH_GRAPH", "1")

    def frames(plain):
        with monkeypatch.context() as m:
            if plain:
                _plain_rng(m)
            kept = _record_rng(m)
            scene = B.spd_tetra_scene(cuda)
            telemetry.reset_counters("engine.graphs")
            out, refs = [], []
            for k in range(4):
                kernels.reset_launches()
                eye = np.asarray(base.eye) + np.array([0.05 * k, 0.0, 0.0])
                cam = dataclasses.replace(base, eye=tuple(eye)).params(cuda)
                film, rays = engine.render_accumulate(
                    scene, cam, Film.create(h, w, cuda), w, h,
                    samples_per_launch=spl, max_depth=depth)
                if kept:                # an eager or a captured pass
                    refs, kept[:] = list(kept), []
                # a replay rewrote the captured pass's tensors in place
                out.append((film.accum.clone(), int(rays),
                            refs[-1].clone(), dict(kernels.LAUNCHES)))
            return out, dict(launch_graph.GRAPHS)

    got, g_graphs = frames(False)
    want, p_graphs = frames(True)
    assert g_graphs == p_graphs == dict(captured=1, replayed=2)
    for (fa, ra, sa, la), (fb, rb, sb, lb) in zip(got, want):
        assert torch.equal(fa, fb) and ra == rb and torch.equal(sa, sb)
        assert (la["rng_seed"], la["rng_uniform2"]) == (spl, spl * 18)
        assert (lb["rng_seed"], lb["rng_uniform2"]) == (0, 0)

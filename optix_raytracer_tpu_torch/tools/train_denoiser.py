"""Train the kernel-prediction denoiser on the port's own renders
(counterpart of `tools/train_denoiser.py`).

Random Cornell-style rooms are rendered by the path tracer (the fused
kernel on the card): a noisy input of 1-64 samples, a clean target of
`--clean-spp` samples and the primary-hit guide layers (`render_aovs`),
each scene one .npz under `--data`. The KPCNN (`denoise/kpcnn.py`) then
trains on random patches with Adam under a cosine schedule equal to
optax's `cosine_decay_schedule(lr, steps, alpha=0.02)` and the reference's
log1p L1 + gradient loss; autograd over `F.conv2d` gives the gradients
(no hand-written kernel lies under the net). The weights go to `--out`,
never into `denoise/weights/`, whose shipped checkpoints stay the JAX
package's byte for byte.

    python -m optix_raytracer_tpu_torch.tools.train_denoiser \\
        --data denoiser_data --scenes 96 --steps 4000 --out kpcnn.npz
    python -m optix_raytracer_tpu_torch.tools.train_denoiser --render-only \\
        --data denoiser_data --scenes 8 --res 256

The scene and camera draws, the spp draw and their order are the
reference's, so the same seed gives the same dataset's scenes.
"""
from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np
import torch

RES = 256          # the reference's rendered scene resolution
PATCH = 128        # and training patch


def random_scene(rng: np.random.Generator, device="cuda"):
    """A random Cornell-style room (train_denoiser.py:30-114): recoloured
    walls, 1-3 random boxes (a quarter of the materials metal / rough
    PBR), a random ceiling light; always 3 box slots (degenerate quads for
    the missing ones) and 9 materials, the reference's fixed shapes."""
    from ..scene.builtins import quads_to_triangles
    from ..scene.device_scene import make_device_scene
    from ..shade import materials as mat
    from ..shade.lights import ParallelogramLight

    def color():
        c = rng.uniform(0.05, 0.9, 3)
        if rng.random() < 0.5:
            c[:] = rng.uniform(0.2, 0.9)
        return tuple(float(x) for x in c)

    mats = []

    def add_mat():
        i = len(mats)
        if rng.random() < 0.25:
            mats.append({"kind": mat.PBR, "base_color": color(),
                         "metallic": float(rng.uniform(0.0, 1.0)),
                         "roughness": float(rng.uniform(0.1, 0.9))})
        else:
            mats.append({"kind": mat.DIFFUSE, "base_color": color()})
        return i

    quads = []
    S = 556.0
    m_floor, m_ceil, m_back = add_mat(), add_mat(), add_mat()
    m_left, m_right = add_mat(), add_mat()
    quads.append(([(S, 0, 0), (0, 0, 0), (0, 0, S), (S, 0, S)], m_floor))
    quads.append(([(S, S, 0), (S, S, S), (0, S, S), (0, S, 0)], m_ceil))
    quads.append(([(S, 0, S), (0, 0, S), (0, S, S), (S, S, S)], m_back))
    quads.append(([(0, 0, S), (0, 0, 0), (0, S, 0), (0, S, S)], m_right))
    quads.append(([(S, 0, 0), (S, 0, S), (S, S, S), (S, S, 0)], m_left))

    n_boxes = int(rng.integers(1, 4))
    for b in range(3):
        if b >= n_boxes:
            for _ in range(5):
                quads.append(([(0.0, 0.0, 0.0)] * 4, 0))
            continue
        m = add_mat()
        w, d, h = rng.uniform(60, 200, 3)
        cx = rng.uniform(w / 2 + 10, S - w / 2 - 10)
        cz = rng.uniform(d / 2 + 10, S - d / 2 - 10)
        ang = rng.uniform(0, np.pi / 2)
        ca, sa = np.cos(ang), np.sin(ang)
        corners = []
        for dx, dz in ((-w / 2, -d / 2), (w / 2, -d / 2), (w / 2, d / 2),
                       (-w / 2, d / 2)):
            corners.append((cx + dx * ca - dz * sa, h,
                            cz + dx * sa + dz * ca))
        quads.append((corners, m))
        for i in range(4):
            a, c = corners[i], corners[(i + 1) % 4]
            quads.append(([(a[0], 0, a[2]), (a[0], h, a[2]),
                           (c[0], h, c[2]), (c[0], 0, c[2])], m))

    lw, ld = rng.uniform(80, 200, 2)
    lx = rng.uniform(lw / 2 + 20, S - lw / 2 - 20)
    lz = rng.uniform(ld / 2 + 20, S - ld / 2 - 20)
    emission = tuple(float(x) for x in rng.uniform(8.0, 30.0, 3))
    m_light = len(mats)
    mats.append({"kind": mat.DIFFUSE, "base_color": (0.8, 0.8, 0.8),
                 "emission": emission})
    corner = (lx + lw / 2, 548.6, lz - ld / 2)
    v1, v2 = (-lw, 0.0, 0.0), (0.0, 0.0, ld)
    quads.append(([corner,
                   (corner[0] + v1[0], corner[1], corner[2]),
                   (corner[0] + v1[0], corner[1], corner[2] + v2[2]),
                   (corner[0], corner[1], corner[2] + v2[2])], m_light))
    while len(mats) < 9:
        mats.append({"kind": mat.DIFFUSE, "base_color": (0.5, 0.5, 0.5)})

    verts, idx, tri_mat = quads_to_triangles(quads)
    light = ParallelogramLight.make(corner, v1, v2, emission, device)
    return make_device_scene(verts, idx, tri_mat, mats, device,
                             area_light=light)


def random_camera_obj(rng: np.random.Generator, w, h):
    """A camera looking into the room from a random eye (:117-123)."""
    from ..core.camera import Camera
    eye = (278 + rng.uniform(-120, 120), 273 + rng.uniform(-120, 120),
           -900 + rng.uniform(-100, 300))
    lookat = (278 + rng.uniform(-80, 80), 273 + rng.uniform(-80, 80), 330)
    return Camera(eye=eye, lookat=lookat, up=(0, 1, 0),
                  fov_y=float(rng.uniform(28, 45)), aspect=w / h)


def random_camera(rng: np.random.Generator, w, h, device="cuda"):
    return random_camera_obj(rng, w, h).params(device)


def render_scene(scene, cam, spp: int, clean_spp: int, res: int = RES):
    """One dataset entry (:149-168): the noisy film of `spp` samples, the
    clean film of clean_spp // 64 launches of 64 samples, and the guide
    layers → dict of float32 numpy arrays."""
    from ..core.film import Film
    from ..wavefront.engine import render_accumulate, render_aovs
    dev = scene.device
    film, _ = render_accumulate(scene, cam, Film.create(res, res, dev),
                                res, res, samples_per_launch=spp,
                                max_depth=4)
    noisy = film.accum.cpu().numpy()
    film = Film.create(res, res, dev)
    for _ in range(clean_spp // 64):
        film, _ = render_accumulate(scene, cam, film, res, res,
                                    samples_per_launch=64, max_depth=4)
    aovs = render_aovs(scene, cam, res, res)
    out = dict(noisy=noisy, clean=film.accum.cpu().numpy())
    out.update({k: aovs[k].cpu().numpy()
                for k in ("albedo", "normal", "emission")})
    return out


def render_dataset(n_scenes: int, data_dir: str, seed: int = 0,
                   noisy_spp=(1, 2, 4, 8, 16, 32, 64), clean_spp: int = 1024,
                   res: int = RES, device="cuda"):
    """Render scene_<i>.npz files into data_dir (:126-171), skipping those
    already there; the draws come before the check, so a run extending a
    dataset continues the stream."""
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n_scenes):
        path = os.path.join(data_dir, f"scene_{i:04d}.npz")
        t0 = time.time()
        scene = random_scene(rng, device)
        cam = random_camera(rng, res, res, device)
        spp = int(rng.choice(noisy_spp))
        if os.path.exists(path):
            continue
        d = render_scene(scene, cam, spp, clean_spp, res)
        np.savez_compressed(path, spp=spp,
                            **{k: v.astype(np.float16) for k, v in d.items()})
        print(f"[{i + 1}/{n_scenes}] spp={spp} {time.time() - t0:.1f}s",
              flush=True)


def add_temporal_history(n_scenes: int, data_dir: str, seed: int = 0,
                         old_spp_until: int = 120, prev_spp: int = 128,
                         res: int = RES, device="cuda"):
    """Add the flow-warped previous frame ("history") to each file
    (:174-225): the same scene from a camera moved by a fixed draw, the
    optical flow to the noisy frame, the warp. Replays the scene stream."""
    from ..core.camera import Camera
    from ..core.film import Film
    from ..denoise.atrous import warp_by_flow
    from ..denoise.flow import optical_flow
    from ..wavefront.engine import render_accumulate

    rng = np.random.default_rng(seed)
    for i in range(n_scenes):
        scene = random_scene(rng, device)
        cam_obj = random_camera_obj(rng, res, res)
        rng.choice((1, 2, 4, 8) if i < old_spp_until
                   else (1, 2, 4, 8, 16, 32, 64))
        path = os.path.join(data_dir, f"scene_{i:04d}.npz")
        if not os.path.exists(path):
            continue
        with np.load(path) as z:
            d = dict(z)
        if "history" in d:
            continue
        js = np.random.default_rng(10_000 + i)
        eye = np.asarray(cam_obj.eye, np.float32)
        lookat = np.asarray(cam_obj.lookat, np.float32)
        offset = js.normal(size=3).astype(np.float32)
        offset /= max(np.linalg.norm(offset), 1e-6)
        step = 0.02 * float(np.linalg.norm(lookat - eye))
        prev_cam = Camera(eye=tuple(eye + step * offset),
                          lookat=tuple(lookat), up=(0, 1, 0),
                          fov_y=cam_obj.fov_y, aspect=cam_obj.aspect)
        film, _ = render_accumulate(scene, prev_cam.params(device),
                                    Film.create(res, res, device), res, res,
                                    samples_per_launch=prev_spp, max_depth=4)
        noisy = torch.as_tensor(np.asarray(d["noisy"], np.float32),
                                device=device)
        fl = optical_flow(film.accum, noisy)
        d["history"] = warp_by_flow(film.accum, fl).cpu().numpy().astype(
            np.float16)
        np.savez_compressed(path, **d)


def upgrade_emission_aovs(n_scenes: int, data_dir: str, seed: int = 0,
                          old_spp_until: int = 120, res: int = RES,
                          device="cuda"):
    """Add the emission guide to files that lack it by replaying the scene
    stream (:228-262); each replayed scene's albedo must match the file's."""
    from ..wavefront.engine import render_aovs

    rng = np.random.default_rng(seed)
    for i in range(n_scenes):
        scene = random_scene(rng, device)
        cam = random_camera(rng, res, res, device)
        spp = int(rng.choice((1, 2, 4, 8) if i < old_spp_until
                             else (1, 2, 4, 8, 16, 32, 64)))
        path = os.path.join(data_dir, f"scene_{i:04d}.npz")
        if not os.path.exists(path):
            continue
        with np.load(path) as z:
            d = dict(z)
        if int(d["spp"]) != spp:
            raise ValueError(f"{path}: spp {int(d['spp'])}, the replayed "
                             f"stream draws {spp}")
        if "emission" in d:
            continue
        aovs = render_aovs(scene, cam, res, res)
        alb_err = float(np.mean(np.abs(aovs["albedo"].cpu().numpy()
                                       - np.asarray(d["albedo"], np.float32))))
        if alb_err >= 2e-3:
            raise ValueError(f"{path}: the replayed scene is not the "
                             f"recorded one (albedo off by {alb_err})")
        d["emission"] = aovs["emission"].cpu().numpy().astype(np.float16)
        np.savez_compressed(path, **d)


def load_dataset(data_dir: str):
    """Every scene file of data_dir as float32 arrays (:265-274)."""
    out = []
    for f in sorted(os.listdir(data_dir)):
        if f.endswith(".npz"):
            with np.load(os.path.join(data_dir, f)) as d:
                out.append({k: np.asarray(d[k], np.float32)
                            for k in ("noisy", "clean", "albedo", "normal",
                                      "emission", "history") if k in d})
    return out


def cosine_lr(lr: float, steps: int, alpha: float = 0.02):
    """optax.cosine_decay_schedule(lr, steps, alpha) as a LambdaLR factor:
    alpha + (1 - alpha) * 0.5 * (1 + cos(pi * min(t, steps) / steps))."""
    def factor(t):
        t = min(t, steps)
        return alpha + (1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t
                                                            / steps))
    return factor


def _tonemap(x):
    return torch.log1p(torch.clamp_min(x, 0.0))


def degrade(noisy):
    """[N, H, W, 3] → box 2x down → bilinear 2x up (:291-295): the
    UPSCALE2X net's input."""
    from ..denoise import kpcnn
    n, h, w, c = noisy.shape
    low = noisy.reshape(n, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))
    return kpcnn.upsample2x_bilinear(low)


def loss_fn(params, noisy, albedo, normal, emission, history, clean,
            upscale=False, temporal=False):
    """log1p L1 plus half the L1 of its x / y differences (:337-349)."""
    from ..denoise import kpcnn
    if upscale:
        noisy = degrade(noisy)
    out = kpcnn.denoise_kp(params, noisy, albedo, normal, emission=emission,
                           history=history if temporal else None)
    to, tc = _tonemap(out), _tonemap(clean)
    lt = torch.abs(to - tc)
    gy = torch.abs(torch.diff(to, dim=1) - torch.diff(tc, dim=1))
    gx = torch.abs(torch.diff(to, dim=2) - torch.diff(tc, dim=2))
    return lt.mean() + 0.5 * (gx.mean() + gy.mean())


def make_optimizer(params, lr: float, steps: int):
    """Adam (optax's defaults: b1 0.9, b2 0.999, eps 1e-8) over the
    parameter tensors, and its cosine schedule."""
    leaves = list(params.values())
    for p in leaves:
        p.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, cosine_lr(lr, steps))


def train_step(params, opt, sched, batch, upscale=False, temporal=False):
    """One Adam step on `batch` (the loss_fn arguments) → the loss before
    it. TF32 stays off for the backward convolutions too, as in the net's
    forward (kpcnn.apply_net)."""
    cudnn = torch.backends.cudnn
    opt.zero_grad(set_to_none=True)
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        loss = loss_fn(params, *batch, upscale=upscale, temporal=temporal)
        loss.backward()
    opt.step()
    sched.step()
    return loss.detach()


def sample_batch(ds, rng, batch: int, patch: int, device):
    """`batch` random patches of random scenes (:351-368) → tensors
    (noisy, albedo, normal, emission, history, clean)."""
    keys = ("noisy", "albedo", "normal", "emission", "history", "clean")
    cols = {k: [] for k in keys}
    for _ in range(batch):
        s = ds[rng.integers(len(ds))]
        res = s["noisy"].shape[0]
        y = rng.integers(0, res - patch + 1)
        x = rng.integers(0, res - patch + 1)
        for k in keys:
            a = s.get(k, np.zeros_like(s["noisy"]))
            cols[k].append(a[y:y + patch, x:x + patch])
    return tuple(torch.as_tensor(np.stack(cols[k]), device=device)
                 for k in keys)


def warm_start(params, temporal: bool, alpha_out: bool, device):
    """The reference's warm starts (:306-335): the predicted-alpha net from
    the temporal weights (the blend channel's weights 0, bias -2), the
    temporal net from the spatial weights (the history channels' input
    weights 0); in place."""
    from ..denoise import kpcnn
    if alpha_out and temporal and kpcnn.has_temporal_weights():
        base = kpcnn.load_params(kpcnn.TEMPORAL_WEIGHTS_PATH, device)
        for k, v in base.items():
            if k == "out_w":
                w = torch.zeros_like(params[k])
                w[:v.shape[0]] = v
                params[k] = w
            elif k == "out_b":
                b = torch.full_like(params[k], -2.0)
                b[:v.shape[0]] = v
                params[k] = b
            else:
                params[k] = v.clone()
        print("warm-started alpha net from", kpcnn.TEMPORAL_WEIGHTS_PATH)
    elif temporal and kpcnn.has_weights():
        for k, v in kpcnn.load_params(kpcnn.WEIGHTS_PATH, device).items():
            if k == "in0_w":
                w = torch.zeros_like(params[k])
                w[:, :10] = v
                params[k] = w
            else:
                params[k] = v.clone()
        print("warm-started temporal net from", kpcnn.WEIGHTS_PATH)


def train(data_dir: str, out: str, steps: int = 4000, batch: int = 8,
          lr: float = 1e-3, seed: int = 0, val_frac: float = 0.1,
          upscale: bool = False, temporal: bool = False,
          alpha_out: bool = False, patch: int = PATCH, device="cuda"):
    """Train on data_dir's scenes and write the weights to `out`
    (:277-409). Validation every 200 steps on the first tenth."""
    from ..denoise import kpcnn
    data = load_dataset(data_dir)
    if not data:
        raise SystemExit(f"no dataset in {data_dir}: run with --render-only "
                         f"first")
    n_val = max(1, int(len(data) * val_frac))
    val, trainset = data[:n_val], data[n_val:]
    print(f"dataset: {len(trainset)} train / {n_val} val scenes")
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    params = kpcnn.init_params(gen, cin=13 if temporal else 10,
                               out_alpha=alpha_out and temporal,
                               device=device)
    warm_start(params, temporal, alpha_out, device)
    opt, sched = make_optimizer(params, lr, steps)
    t0 = time.time()
    for i in range(steps):
        loss = train_step(params, opt, sched,
                          sample_batch(trainset, rng, batch, patch, device),
                          upscale=upscale, temporal=temporal)
        if (i + 1) % 200 == 0:
            vm = nm = 0.0
            with torch.no_grad():
                for s in val:
                    b = [torch.as_tensor(s.get(k, np.zeros_like(s["noisy"]))
                                         [None], device=device)
                         for k in ("noisy", "albedo", "normal", "emission",
                                   "history", "clean")]
                    noisy = degrade(b[0]) if upscale else b[0]
                    o = kpcnn.denoise_kp(params, noisy, b[1], b[2],
                                         emission=b[3],
                                         history=b[4] if temporal else None)
                    vm += float(((_tonemap(o) - _tonemap(b[5])) ** 2).mean())
                    nm += float(((_tonemap(noisy) - _tonemap(b[5])) ** 2)
                                .mean())
            print(f"step {i + 1}: loss={float(loss):.4f} "
                  f"val_mse={vm / len(val):.5f} "
                  f"noisy_mse={nm / len(val):.5f} ({time.time() - t0:.0f}s)",
                  flush=True)
    kpcnn.save_params(params, out)
    print("saved", out)
    return params


def main(argv=None):
    ap = argparse.ArgumentParser(description="train the KPCNN denoiser")
    ap.add_argument("--data", default="denoiser_data",
                    help="dataset directory (scene_<i>.npz)")
    ap.add_argument("--out", default="kpcnn_trained.npz",
                    help="where the trained weights go")
    ap.add_argument("--scenes", type=int, default=96)
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--res", type=int, default=RES)
    ap.add_argument("--patch", type=int, default=PATCH)
    ap.add_argument("--clean-spp", type=int, default=1024)
    ap.add_argument("--render-only", action="store_true")
    ap.add_argument("--train-only", action="store_true")
    ap.add_argument("--upgrade-emission", action="store_true",
                    help="replay the scene stream to add emission guides to "
                         "files that lack them")
    ap.add_argument("--upscale", action="store_true",
                    help="train the 2x-upscale net")
    ap.add_argument("--temporal", action="store_true",
                    help="train the temporal net (needs --add-history first)")
    ap.add_argument("--alpha-out", action="store_true",
                    help="the temporal net with a predicted history blend")
    ap.add_argument("--add-history", action="store_true",
                    help="render and warp previous frames into the dataset")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from ..denoise import kpcnn
    weights = os.path.dirname(os.path.abspath(kpcnn.WEIGHTS_PATH))
    if os.path.dirname(os.path.abspath(args.out)) == weights:
        raise SystemExit(f"--out {args.out}: the shipped weights in "
                         f"{weights} stay the reference's; write elsewhere")
    kw = dict(res=args.res, device=args.device)
    if args.upgrade_emission:
        upgrade_emission_aovs(args.scenes, args.data, seed=args.seed, **kw)
    if args.add_history:
        add_temporal_history(args.scenes, args.data, seed=args.seed, **kw)
        return
    if not args.train_only and not args.upgrade_emission:
        render_dataset(args.scenes, args.data, seed=args.seed,
                       clean_spp=args.clean_spp, **kw)
    if not args.render_only:
        train(args.data, args.out, steps=args.steps, batch=args.batch,
              seed=args.seed, upscale=args.upscale, temporal=args.temporal,
              alpha_out=args.alpha_out, patch=args.patch,
              device=args.device)


if __name__ == "__main__":
    main()

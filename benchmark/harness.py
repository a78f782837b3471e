"""One run of one cell of the port's benchmark.

    python3 benchmark/run.py --workload cornell-progressive --seed 7 \\
        --seconds 30 --trace 0

Set-up loads the port (`optix_raytracer_tpu_torch`), builds the cell's scene
from its configuration, and warms up the cell's launch shape. The window then
runs launches back to back for `--seconds`, as `apps/pathtracer.py` and
`apps/viewer.py` drive the port: per launch, the mix's camera (moved, and the
film reset, in an interactive mix), one `engine.render_accumulate(...,
impl="auto")`, then `torch.cuda.synchronize()`. After each launch the film is
read at the sampled pixels (one small gather, queued behind the sync). The
launch in flight when the time is up finishes the window.

After the window the port's state is freed and the plain reference
(`reference/`) works the same launches out again at those pixels
(`check.py`). The last line of standard output is the result: with `--trace
0` the cell's end-to-end metrics, with `--trace 1` its per-layer metrics,
read by `metrics/<name>.py` from the window's host clocks and from a
device-only `torch.profiler` trace (CUDA activities and runtime calls, no
host ops recorded) of its last TRACE_S seconds; the profiler's start is
left out of the window's time. Host-side readings come from the launches
before the trace.

A run needs the card: without CUDA, or with fewer devices than the cell asks
for, it prints no result and exits with 2.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from . import check, roofline, scenes, spec as spec_mod, trace as trace_mod
from .traffic import CameraPath, pixels

TRACE_S = 5.0
FORBIDDEN = ("jax", "jaxlib", "flax", "optix_raytracer_tpu")
EXIT_NO_CARD = 2
EXIT_FORBIDDEN = 3


def process_start() -> float:
    """This process's start on the `time.perf_counter` clock (Linux
    /proc; the module's import time where that is not readable)."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.perf_counter()


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def _port_scene(arrays, device):
    """The scene arrays → the port's DeviceScene, as the builtins build
    it."""
    from optix_raytracer_tpu_torch.scene.device_scene import make_device_scene
    from optix_raytracer_tpu_torch.shade import materials as mats
    from optix_raytracer_tpu_torch.shade.lights import ParallelogramLight

    materials = []
    for m in arrays["materials"]:
        d = {"kind": getattr(mats, m.get("kind", "diffuse").upper()),
             "base_color": tuple(m["base_color"])}
        if "emission" in m:
            d["emission"] = tuple(m["emission"])
        materials.append(d)
    light = arrays["light"]
    area = ParallelogramLight.make(tuple(light["corner"]), tuple(light["v1"]),
                                   tuple(light["v2"]),
                                   tuple(light["emission"]), device)
    return make_device_scene(arrays["vertices"], arrays["indices"],
                             arrays["tri_mat"], materials, device,
                             area_light=area, normals=arrays["normals"],
                             miss_color=arrays["miss_color"])


def _median(xs):
    return statistics.median(xs) if xs else float("nan")


def _power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else None
    except (OSError, subprocess.SubprocessError):
        return None


def run(root, workload, seed, seconds, trace, device=None, log=sys.stderr):
    """One run → (exit code, result dict or None). device None: the card,
    required (the command line); a device name runs there without the check
    for a card (tests)."""
    t_start = process_start()
    stages = [("interpreter and imports", time.perf_counter())]
    root = Path(root)
    bench = spec_mod.load(root)
    cell = spec_mod.Cell(root, bench, workload)
    import torch
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            have = (torch.cuda.device_count() if torch.cuda.is_available()
                    else 0)
            print(f"benchmark: {workload} needs {cell.chips} CUDA device(s), "
                  f"found {have}; no result", file=log)
            return EXIT_NO_CARD, None
        dev = torch.device("cuda", 0)
    else:
        dev = torch.device(device)
    on_card = dev.type == "cuda"
    torch.zeros(1, device=dev)
    stages.append(("device init", time.perf_counter()))

    from optix_raytracer_tpu_torch.core.camera import Camera
    from optix_raytracer_tpu_torch.core.film import Film
    from optix_raytracer_tpu_torch.wavefront import engine

    config, traffic, limits = cell.config, cell.traffic, cell.limits
    width, height = config["width"], config["height"]
    depth, spl = config["max_depth"], traffic["samples_per_launch"]
    reset = traffic["film"] == "reset"
    cam_cfg = config["camera"]
    path = CameraPath(cam_cfg, traffic["orbit"], seed)
    still = traffic["orbit"]["amplitude_deg"] == 0

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def camera(k):
        return Camera(eye=path.eye(k), lookat=tuple(cam_cfg["lookat"]),
                      up=tuple(cam_cfg["up"]), fov_y=cam_cfg["fov_y"],
                      aspect=width / height).params(dev)

    stages.append(("port import", time.perf_counter()))
    arrays = scenes.build(config["scene"])
    scene = _port_scene(arrays, dev)
    sync()
    stages.append(("scene", time.perf_counter()))

    # warm-up: the cell's own launch shape, on a film of its own
    film = Film.create(height, width, dev)
    for k in range(traffic["warmup_launches"]):
        if reset:
            film = film.reset()
        film, _ = engine.render_accumulate(
            scene, camera(k), film, width, height, samples_per_launch=spl,
            max_depth=depth, impl="auto")
        sync()
    sets = traffic["pixel_sets"]
    if sets != 1 and not reset:
        raise ValueError("an accumulating film is read at one pixel set")
    px, py, area = pixels(width, height, limits["check_pixels"], seed, sets)
    pix = torch.as_tensor(py * width + px, device=dev)           # [S, P]
    film = Film.create(height, width, dev)
    cam_still = camera(0) if still else None
    snaps, rays, launch_ms, enqueue_ms = [], [], [], []
    sync()

    t0 = time.perf_counter()
    setup_s = t0 - t_start
    stages.append(("warm-up", t0))
    # The profiler traces the window's last TRACE_S seconds, the device
    # alone: recording host ops would slow the host several fold in the
    # traced launches. The launches before it run as in an untraced run,
    # with no profiler made. Its start, seconds of CUPTI set-up, is left
    # out of the window's time.
    trace_from, first_traced, paused, k = (max(0.0, seconds - TRACE_S),
                                           None, 0.0, 0)
    while True:
        if trace and first_traced is None and \
                time.perf_counter() - t0 >= trace_from:
            p0 = time.perf_counter()
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CUDA]
                           if on_card else [ProfilerActivity.CPU])
            prof.start()
            t_traced = time.perf_counter()
            paused = t_traced - p0
            first_traced = k
        cam = cam_still if still else camera(k)
        if reset:
            film = film.reset()
        ts = time.perf_counter()
        film, r = engine.render_accumulate(
            scene, cam, film, width, height, samples_per_launch=spl,
            max_depth=depth, impl="auto")
        te_enq = time.perf_counter()
        sync()
        te = time.perf_counter()
        snaps.append(film.accum.reshape(-1, 3)[pix[k % sets]])
        rays.append(r)
        launch_ms.append((te - ts) * 1e3)
        enqueue_ms.append((te_enq - ts) * 1e3)
        k += 1
        if te - t0 - paused >= seconds:
            break
    window_s = te - t0 - paused
    sync()
    if trace:
        traced_s = time.perf_counter() - t_traced
        prof.stop()
    memory_peak = (torch.cuda.max_memory_allocated(dev) if on_card else 0)

    films = torch.stack(snaps).cpu().numpy()
    rays_per_launch = torch.stack(rays).cpu().numpy().astype(np.int64)
    ctx = None
    if trace:
        pkg = Path(sys.modules["optix_raytracer_tpu_torch"].__file__).parent
        lib_names = trace_mod.library_kernels(pkg / "csrc")
        red = trace_mod.reduce(prof.events(), lib_names, traced_s)
        del prof
        kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
        ctx = dict(trace=red, launches=k - first_traced,
                   enqueue_ms=enqueue_ms[:first_traced],
                   rays_per_launch=rays_per_launch[first_traced:].tolist(),
                   width=width, height=height,
                   scene_bytes=roofline.scene_bytes(arrays),
                   peaks=roofline.peaks(kind))
    del scene, film, snaps, rays, cam, cam_still, pix
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # the check, on the card, after the window
    t_check = time.perf_counter()
    n = len(launch_ms)
    rows = np.arange(n) % sets
    eyes = [path.eye(i) for i in range(n)]
    ref_films, ref_rays = check.reference_films(arrays, config, traffic, eyes,
                                                px[rows], py[rows], dev)
    values = check.numbers(films, ref_films, int(rays_per_launch.sum()),
                           ref_rays, area[rows])
    correct, checks = check.verdict(values, limits)
    check_s = time.perf_counter() - t_check

    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = spec_mod.reader(cell.metrics_dir, m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = dict(msamples_per_s=width * height * spl * n / window_s / 1e6,
                   launch_ms_p95=float(np.percentile(launch_ms, 95)),
                   setup_s=setup_s)
        metrics = {m["name"]: {"value": e2e[spec_mod.base_name(m["name"])],
                               "unit": m["unit"]} for m in cell.end_to_end}
    dev_info = {"platform": "gpu" if on_card else dev.type,
                "kind": torch.cuda.get_device_name(dev) if on_card else
                dev.type,
                "count": cell.chips if on_card else 0,
                "memory_peak_bytes": int(memory_peak)}
    result = {"correct": correct, "attempted": n, "failed": 0,
              "metrics": metrics, "device": dev_info}
    if trace:
        red = ctx["trace"]
        dev_info["busy_s"] = red["busy_us"] * 1e-6
        dev_info["window_s"] = red["window_s"]
        result["breakdown"] = {"device_ops": red["device_ops"],
                               "idle_gaps": red["idle_gaps"]}
    result["checks"] = checks

    print(f"benchmark: {workload} seed {seed}: {n} launches in "
          f"{window_s:.3f} s, set-up {setup_s:.3f} s, check {check_s:.3f} s, "
          f"rays {int(rays_per_launch.sum())}, "
          + "".join(f"{k} {v!r} (not compared), " for k, v in values.items()
                    if k not in checks)
          + f"launch ms median {statistics.median(launch_ms):.3f}, "
          f"enqueue ms median {statistics.median(enqueue_ms):.3f}, "
          f"frame ms mean {window_s * 1e3 / n:.3f}"
          + (f"; traced: {k - first_traced} launches, launch ms median "
             f"{_median(launch_ms[first_traced:]):.3f} against "
             f"{_median(launch_ms[:first_traced]):.3f} untraced, enqueue "
             f"ms median {_median(enqueue_ms[first_traced:]):.3f} against "
             f"{_median(enqueue_ms[:first_traced]):.3f}" if trace else ""),
          file=log)
    print("benchmark: set-up " + ", ".join(
        f"{name} {t - t_prev:.3f} s" for (_, t_prev), (name, t) in
        zip([("start", t_start)] + stages, stages)), file=log)
    if on_card:
        print(f"benchmark: card {_power_limit()}", file=log)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: loaded forbidden modules {bad}; no result",
              file=log)
        return EXIT_FORBIDDEN, None
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=log)
    return 0, result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = Path(__file__).resolve().parent.parent
    code, result = run(root, args.workload, args.seed, args.seconds,
                       bool(args.trace))
    if result is not None:
        sys.stderr.flush()
        print(json.dumps(result), flush=True)
    return code

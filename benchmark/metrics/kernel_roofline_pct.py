"""CUDA kernels: the frozen lower bound of a launch's work
(`roofline.bound_s`: the traced launches' mean rays at one triangle test
and one slab each over peak FP32, or the film and the scene tables moved
once over peak HBM, the larger) as a share of the library kernels' device
time per launch."""
import statistics

from benchmark import roofline


def read(ctx):
    tr = ctx["trace"]
    if (ctx["peaks"] is None or not ctx["launches"]
            or not tr["lib"]):
        return None
    kernel_s = sum(e - s for _, s, e in tr["lib"]) * 1e-6 / ctx["launches"]
    rays = statistics.fmean(ctx["rays_per_launch"])
    bound = roofline.bound_s(rays, ctx["width"], ctx["height"],
                             ctx["scene_bytes"], ctx["peaks"])
    return 100.0 * bound / kernel_s

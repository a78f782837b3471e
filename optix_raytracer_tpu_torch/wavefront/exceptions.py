"""Per-launch exception counters (counterpart of `wavefront/exceptions.py`).

The reference's exception programs give a launch a structured error channel
(`optix_device.h:1263-1432`). A launch cannot branch to an exception
program here either, so validation mode counts after the launch and reports
through the context's log callback (`api/pipeline.py::Pipeline._check_launch`):

  invalid_ray         the launch's primary rays (centre taps) with a
                      non-finite origin, direction, tmin or tmax, or tmin >
                      tmax (OPTIX_EXCEPTION_CODE_INVALID_RAY);
  nonfinite_radiance  pixels whose launch radiance sum holds a NaN or inf;
  negative_radiance   pixels with a finite negative component.

The counts are int64 tensors on the launch's device; `format_exceptions`
reads them to the host.
"""
from __future__ import annotations

import torch

from ..core.camera import generate_rays


def check_raygen(cam_params, width: int, height: int):
    """invalid_ray over this launch's primary rays (exceptions.py:29-38):
    centre taps, since jitter cannot repair a non-finite camera basis."""
    rays, _ = generate_rays(cam_params, width, height, jitter=False)
    bad = (~torch.isfinite(rays.origin).all(-1)
           | ~torch.isfinite(rays.direction).all(-1)
           | ~torch.isfinite(rays.tmin) | ~torch.isfinite(rays.tmax)
           | (rays.tmin > rays.tmax))
    return bad.sum()


def check_radiance(rad_sum):
    """nonfinite / negative pixel counts of a launch's radiance sum [H, W,
    3] (exceptions.py:41-51)."""
    finite = torch.isfinite(rad_sum)
    nonfinite = ~finite.all(-1)
    negative = (torch.where(finite, rad_sum, 0.0) < 0.0).any(-1)
    return {"nonfinite_radiance": nonfinite.sum(),
            "negative_radiance": negative.sum()}


def launch_diagnostics(cam_params, rad_sum, width, height):
    """The counters of one launch: raygen validity and the launch's own
    radiance sum [H, W, 3] (the engine's `render_sum`).

    The reference recovers that sum from the films' running means,
    n1 accum1 - n0 accum0 (exceptions.py:56-66). On a continued film that
    difference rounds below zero where the launch added about 0, and
    negative_radiance counts the pixel though no sample was negative; a
    NaN the film carried in counts again at every launch. The port counts
    on the sum itself: on a new film both agree, on a continued one the
    port counts only what this launch made."""
    diag = {"invalid_ray": check_raygen(cam_params, width, height)}
    diag.update(check_radiance(rad_sum))
    return diag


def format_exceptions(diag) -> str:
    """One 'name=count' entry per non-zero counter, sorted by name and joined
    by '; ' (exceptions.py:69-73)."""
    return "; ".join(f"{k}={int(v)}" for k, v in sorted(diag.items())
                     if int(v))

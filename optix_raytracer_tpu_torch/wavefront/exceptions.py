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


def launch_diagnostics(cam_params, film_before, film_after, width, height):
    """The counters of one progressive launch (exceptions.py:54-66): raygen
    validity and the launch's radiance sum recovered from the films' running
    means, (n1 accum1 - n0 accum0) with n the subframe counts."""
    n0 = film_before.subframe.to(torch.float32)
    n1 = film_after.subframe.to(torch.float32)
    rad_sum = film_after.accum * n1 - film_before.accum * n0
    diag = {"invalid_ray": check_raygen(cam_params, width, height)}
    diag.update(check_radiance(rad_sum))
    return diag


def format_exceptions(diag) -> str:
    """One 'name=count' entry per non-zero counter, sorted by name and joined
    by '; ' (exceptions.py:69-73)."""
    return "; ".join(f"{k}={int(v)}" for k, v in sorted(diag.items())
                     if int(v))

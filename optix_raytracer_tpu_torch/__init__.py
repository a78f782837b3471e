"""optix_raytracer_tpu_torch — the PyTorch + CUDA port of optix_raytracer_tpu.

A second package beside the JAX one, held against it on the same inputs.
It follows the JAX package's layout so each module's counterpart is easy to
find:

  core/       RNG, vector math, rays, camera, film, axis-aligned boxes
  shade/      materials, sampling, lights, texture fetches
  accel/      triangle geometry, brute-force intersection (CUDA kernels 1-2),
              the cluster-culled large-mesh traversal (kernels 4-6, and
              5c/6c for its supercluster tier), opacity micromaps and
              displaced micromeshes, motion blur (moving triangles and
              spheres, SRT motion transforms), curves (splines, capsules,
              ribbons, swept spans, the .hair reader), fog volumes
              (density grids, marches, scatter sampling), morton codes and
              the binding to the native SAH builder
  scene/      the torch DeviceScene, the built-in Cornell box and knot
  wavefront/  the lock-step engine, the fused path-trace kernel (kernel 3)
              and the denoiser's guide layers (render_aovs)
  denoise/    the denoiser's backends: the kernel-prediction CNN (its
              weights in denoise/weights/), the à-trous filter and
              block-matching optical flow
  api/        the OptiX-shaped surface; so far the Denoiser (seven model
              kinds, both alpha modes, tiling)
  io/         image input and output (PPM, PNG, EXR, NPZ) and the NanoVDB
              codec
  apps/       the path tracer (with --denoise), Whitted, meshviewer,
              cutouts, opacity-micromap, displaced-micromesh, denoiser,
              optical-flow, simple-motion-blur, motion-geometry, curves,
              ribbons, hair and volume-viewer CLIs
  csrc/       the hand-written CUDA C++ kernels, built on first use by
              `kernels.py`

Plain functions on tensors; every constructor that makes tensors from host
data takes an explicit `device`. On a CPU tensor each kernel wrapper runs the
kernel's plain PyTorch version; on a CUDA tensor it launches the kernel or
raises. This package never imports JAX.
"""

__version__ = "0.1.0"

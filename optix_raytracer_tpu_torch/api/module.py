"""Module: a named set of device programs, with bound values, task-pool and
abortable compiles (counterpart of `api/module.py`).

- `optixModuleCreate` (`optix_host.h:332`): a Module holds named entry
  points ("__raygen__x", "__closesthit__y", ...) and the compile options.
- `OptixModuleCompileBoundValueEntry` (`optix_types.h:1969`, the
  `optixBoundValues` sample): `bound_values` are baked into the entry points
  with functools.partial, so an entry sees them as Python constants (a loop
  count is a host int, never a device read).
- "Compile" has no ahead-of-time step in eager PyTorch. Here it means the
  first call: it builds any CUDA kernel it needs (`kernels.lib()`, nvcc at
  first use, cached by the sources' hash) and runs the entry once on the
  example arguments. `compile_entry`, `compile_with_tasks` and
  `AbortableCompile` do exactly that and return the callable (or whether
  the child finished).
- `optixModuleCreateWithTasks` (`lib/CompileWithTasks.h:53-117`):
  `compile_with_tasks` fans such first calls out to a thread pool (torch's
  ops release the GIL); the kernels are built once before the fan-out.
- the `optixModuleCreateAbort` sample (`optixModuleCreateAbort.cpp:30,
  786`): `AbortableCompile` runs a first call in a spawned child process
  that `.abort()` kills.
"""
from __future__ import annotations

import functools
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional

import torch

from .. import kernels


def _on_cuda(args) -> bool:
    def cuda(a):
        if isinstance(a, torch.Tensor):
            return a.device.type == "cuda"
        if isinstance(a, dict):
            return any(cuda(v) for v in a.values())
        if isinstance(a, (list, tuple)):
            return any(cuda(v) for v in a)
        return False
    return cuda(args)


def _first_call(fn: Callable, args) -> Callable:
    """Build the kernels where the arguments live on the card, run fn once
    (synchronised) → fn."""
    if _on_cuda(args):
        kernels.lib()
    fn(*args)
    if _on_cuda(args):
        torch.cuda.synchronize()
    return fn


class Module:
    """A named bundle of device programs (the PTX-module analogue)."""

    def __init__(self, entry_points: Dict[str, Callable],
                 bound_values: Optional[dict] = None,
                 opt_level: int = 3, debug: bool = False,
                 context=None, name: str = "module"):
        self.name = name
        self.opt_level = opt_level
        self.debug = debug
        self._context = context
        self.bound_values = dict(bound_values or {})
        self.entry_points = {
            k: (functools.partial(fn, **self.bound_values)
                if self.bound_values else fn)
            for k, fn in entry_points.items()
        }
        if context is not None:
            context.log(4, "COMPILE",
                        f"module {name}: {sorted(entry_points)}")

    def get(self, entry: str) -> Callable:
        if entry not in self.entry_points:
            raise KeyError(
                f"no entry point {entry!r} in module {self.name!r}; "
                f"have {sorted(self.entry_points)}")
        return self.entry_points[entry]

    def compile_entry(self, entry: str, *example_args) -> Callable:
        """Compile one entry point now, not at its first use: its first
        call on the example arguments → the callable."""
        return _first_call(self.get(entry), example_args)


#: Built-in intersector families, the `OptixPrimitiveType`s the driver's
#: builtin IS modules cover (`optix_types.h` curve / sphere types).
BUILTIN_IS_KINDS = ("sphere", "round_linear", "round_quadratic_bspline",
                    "round_cubic_bspline", "round_catmullrom", "round_bezier",
                    "flat_quadratic")


def builtin_is_module(kind: str, context=None, device="cuda") -> Module:
    """`optixBuiltinISModuleGet` (`optix_host.h:409`): a Module of the named
    built-in intersection programs, ``__intersection__<kind>`` (prims,
    rays) → closest Hits and ``__intersection_any__<kind>`` (prims, rays)
    → occluded bool, and a ``make_primitives`` helper that turns the
    family's inputs (sphere centres and radii; curve control points and
    widths) into the prim table on `device` the intersectors take
    (`optixCurves.cpp:380-412,489`, `optixSphere`). Curves map to the
    port's prims: capsules (kind 3), swept quadratic and cubic spans (kinds
    4-5), ribbons (parallelograms, kind 2)."""
    from ..accel import curves as _curves
    from ..accel import primitives as _prim

    kind = kind.lower()

    def prims(descs):
        return _prim.make_prims(descs, device)

    def _spheres(centers, radii, mat_id: int = 0):
        return prims([{"kind": _prim.SPHERE, "center": tuple(map(float, c)),
                       "radius": float(r), "mat_id": mat_id}
                      for c, r in zip(centers, radii)])

    def _cubic(curve):
        return lambda control, widths, mat_id=0: prims(
            _curves.strand_to_swept_cubics(control, widths, kind=curve,
                                           mat_id=mat_id))

    builders = {
        "sphere": _spheres,
        "round_linear": lambda control, widths, mat_id=0: prims(
            _curves.strand_to_capsules(control, widths, mat_id=mat_id)),
        "round_quadratic_bspline":
            lambda control, widths, mat_id=0: prims(
                _curves.strand_to_swept_quads(control, widths,
                                              mat_id=mat_id)),
        "round_cubic_bspline": _cubic(_curves.CUBIC_BSPLINE),
        "round_catmullrom": _cubic(_curves.CATMULL_ROM),
        "round_bezier": _cubic(_curves.BEZIER),
        "flat_quadratic": lambda control, widths, mat_id=0: prims(
            _curves.strand_to_ribbons(control, widths, mat_id=mat_id)),
    }
    if kind not in builders:
        raise ValueError(f"no builtin IS module {kind!r}; "
                         f"have {sorted(builders)}")
    mod = Module({f"__intersection__{kind}": _prim.intersect_prims_closest,
                  f"__intersection_any__{kind}": _prim.intersect_prims_any},
                 context=context, name=f"builtin_is_{kind}")
    mod.make_primitives = builders[kind]
    return mod


def compile_with_tasks(jobs, max_workers: int = 4):
    """Parallel first calls, the `optixModuleCreateWithTasks` +
    `OptixTaskExecutePool` role (`lib/CompileWithTasks.h`). jobs: list of
    (fn, example_args tuple) → the callables, in order, each run once. The
    kernel library is built before the pool starts (one nvcc build a
    process)."""
    if any(_on_cuda(args) for _, args in jobs):
        kernels.lib()
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        return list(pool.map(lambda job: _first_call(*job), jobs))


class AbortableCompile:
    """A first call in a separate process that can be killed mid-flight.

    The `optixModuleCreateAbort` sample compiles in a spawned child process
    and kills it on demand, so a hung compile cannot wedge the render loop
    (`optixModuleCreateAbort.cpp:29-31`). Here the child imports
    `module_path`, makes zero tensors of `example_shapes` on `device` and
    runs the entry once (building the kernels first on CUDA); `.poll()` /
    `.wait()` say whether it finished, `.abort()` kills it. The parent then
    hot-swaps or goes on with the old pipeline (`:446, 586-599`).
    """

    def __init__(self, module_path: str, entry: str, example_shapes,
                 device="cuda"):
        """module_path / entry name an importable function (what the
        reference serialises to the child's command line,
        `optixModuleCreateAbort.cpp:786-835`); example_shapes: (shape
        tuple, dtype name) per argument."""
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self._proc = ctx.Process(
            target=_abortable_worker,
            args=(module_path, entry, list(example_shapes), str(device)),
            daemon=True)
        self._proc.start()

    def poll(self) -> Optional[bool]:
        """None while running; then whether the child finished cleanly."""
        if self._proc.is_alive():
            return None
        return self._proc.exitcode == 0

    def wait(self, timeout=None) -> bool:
        self._proc.join(timeout)
        return self._proc.exitcode == 0

    def abort(self):
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join()


def _abortable_worker(module_path, entry, example_shapes, device):
    import importlib

    fn = getattr(importlib.import_module(module_path), entry)
    args = [torch.zeros(tuple(shape), dtype=getattr(torch, dtype),
                        device=device) for shape, dtype in example_shapes]
    _first_call(fn, args)

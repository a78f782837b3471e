"""DeviceContext: device, logging, validation mode, the kernels' build cache
and device properties; StageTimers (counterpart of `api/context.py`).

The `optixDeviceContextCreate` surface (`include/optix_host.h:98-228`):
- the device: `torch.device("cuda", 0)` unless the caller gives another
  (`device="cpu"` runs every query through the kernels' plain versions);
- the severity-tagged log callback (`optix_host.h:118-134`);
- the compiled-module disk cache, `OPTIX_CACHE_PATH` (here ORT_CACHE_PATH,
  and ORT_CACHE_OFF to disable it): the port compiles its CUDA kernels
  once into a library keyed by the sources' hash (`kernels.py`), so the
  cache is that build directory. The cache calls read and set it; a change
  made after the library was loaded applies to the next process, and the
  context logs a warning. Disabled, the kernels build anew at first use;
- validation mode (`OPTIX_DEVICE_CONTEXT_VALIDATION_MODE_ALL`,
  `optixPathTracer.cpp:566-569`): each pipeline launch counts its
  exceptions (`wavefront/exceptions.py`) and logs them. With `debug_nans`
  (the reference's jax_debug_nans, which torch has no switch for) the
  launch also raises FloatingPointError on the first NaN in its radiance.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch

from .. import kernels


class LogLevel:
    """Severity levels of the OptiX log callback (optix_host.h:118-134)."""
    DISABLE = 0
    FATAL = 1
    ERROR = 2
    WARNING = 3
    PRINT = 4


class DeviceContext:
    _CACHE_PATH_ENV = "ORT_CACHE_PATH"       # OPTIX_CACHE_PATH analogue
    _CACHE_ENABLED_ENV = "ORT_CACHE_OFF"

    def __init__(self, log_callback: Optional[Callable] = None,
                 log_level: int = LogLevel.WARNING,
                 validation_mode: bool = False,
                 cache_enabled: bool = True,
                 cache_location: Optional[str] = None,
                 debug_nans: bool = False, device="cuda"):
        if debug_nans and not validation_mode:
            raise ValueError("debug_nans checks launches in validation mode: "
                             "pass validation_mode=True")
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", 0)
        self._log_cb = log_callback
        self._log_level = log_level
        self.validation_mode = validation_mode
        self.debug_nans = debug_nans
        self._cache_enabled = (cache_enabled
                               and not os.environ.get(self._CACHE_ENABLED_ENV))
        self._cache_location = str(cache_location
                                   or os.environ.get(self._CACHE_PATH_ENV)
                                   or kernels.build_dir())
        self._apply_cache()
        if validation_mode:
            self.log(LogLevel.PRINT, "VALIDATION", "validation mode ALL")

    def _apply_cache(self):
        if self._cache_enabled:
            os.makedirs(self._cache_location, exist_ok=True)
        live = kernels.set_build_dir(self._cache_location,
                                     reuse=self._cache_enabled)
        state = "at" if self._cache_enabled else "off, building into"
        self.log(LogLevel.PRINT, "CACHE",
                 f"kernel cache {state} {self._cache_location}")
        if not live:
            self.log(LogLevel.WARNING, "CACHE",
                     "the kernels are already loaded in this process; the "
                     "cache setting applies to the next one")

    # --- properties (optixDeviceContextGetProperty) ---
    def get_property(self, name: str):
        cuda = self.device.type == "cuda"
        props = {
            "platform": "gpu" if cuda else self.device.type,
            "device_kind": (torch.cuda.get_device_name(self.device) if cuda
                            else self.device.type),
            "num_devices": torch.cuda.device_count() if cuda else 1,
            "rtcore_version": 0,            # the H100 has no RT cores
            "limit_max_trace_depth": 31,
            "limit_max_instance_id": 1 << 28,
        }
        return props[name]

    # --- logging (optixDeviceContextSetLogCallback) ---
    def set_log_callback(self, callback, level: int):
        self._log_cb = callback
        self._log_level = level

    def log(self, level: int, tag: str, message: str):
        if self._log_cb is not None and level <= self._log_level:
            self._log_cb(level, tag, message)

    # --- cache controls (optixDeviceContextSetCache*) ---
    def set_cache_enabled(self, enabled: bool):
        self._cache_enabled = enabled
        self._apply_cache()

    def set_cache_location(self, path: str):
        self._cache_location = str(path)
        self._apply_cache()

    def get_cache_location(self) -> str:
        return self._cache_location

    def destroy(self):
        pass


class StageTimers:
    """Per-frame stage timing and overlay text: the `sutil::displayStats` /
    `displayFPS` role (`SDK/sutil/sutil.h:117-121`), and a torch.profiler
    trace for deep dives.

    Usage: `with timers.stage("render"): ...`; `timers.report()` returns the
    state / render / display text the reference overlays each frame
    (`optixPathTracer.cpp:1030-1041`). A stage's time is the host clock:
    end a stage that ends in device work with `torch.cuda.synchronize()`.
    """

    def __init__(self):
        self.totals = {}
        self.last = {}
        self.frames = 0
        self._ticks = []          # recent frame_done timestamps → FPS

    class _Stage:
        def __init__(self, timers, name):
            self.timers = timers
            self.name = name

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            dt = time.perf_counter() - self.t0
            self.timers.totals[self.name] = (
                self.timers.totals.get(self.name, 0.0) + dt)
            self.timers.last[self.name] = dt
            return False

    def stage(self, name: str):
        return self._Stage(self, name)

    def frame_done(self):
        self.frames += 1
        self._ticks.append(time.perf_counter())
        if len(self._ticks) > 16:
            self._ticks.pop(0)

    def fps(self) -> float:
        """Frames per second over the recent window (`displayFPS`)."""
        if len(self._ticks) < 2:
            return 0.0
        span = self._ticks[-1] - self._ticks[0]
        return (len(self._ticks) - 1) / span if span > 0 else 0.0

    def overlay(self) -> str:
        """One-line live overlay: FPS and this frame's stage times."""
        parts = [f"{self.fps():.1f} fps"]
        parts += [f"{k} {1e3 * v:.1f}ms" for k, v in self.last.items()]
        return " | ".join(parts)

    def report(self) -> str:
        if not self.frames:
            return "no frames"
        parts = [f"{k}: {1000 * v / self.frames:8.2f} ms"
                 for k, v in self.totals.items()]
        fps = self.frames / max(sum(self.totals.values()), 1e-9)
        return " | ".join(parts) + f" | {fps:6.1f} fps"

    @staticmethod
    @contextlib.contextmanager
    def profiler_trace(path: str):
        """A torch.profiler trace of the block (CPU, and CUDA where a card
        exists), written as a Chrome trace to the file `path` when the
        block ends (the NVTX / jax.profiler.trace role)."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            yield prof
        prof.export_chrome_trace(str(path))

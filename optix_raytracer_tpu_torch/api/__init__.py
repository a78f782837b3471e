"""The OptiX-shaped host API (counterpart of `api/__init__.py`): classes
named and shaped after the reference's `include/optix_host.h`, so
reference-style applications port one to one.

| OptiX                                  | here                              |
|----------------------------------------|-----------------------------------|
| optixInit / optixDeviceContextCreate   | DeviceContext (device, logging,   |
|   + disk cache env vars                |   validation, the kernels' cache) |
| optixModuleCreate                      | Module: named entry points, bound |
|   optixModuleCreateWithTasks           |   values; first-call compiles on  |
|   optixModuleCreateAbort sample        |   a pool or in a killable child   |
| optixProgramGroupCreate                | ProgramGroup(kind, entry, module) |
| optixPipelineCreate (+stack sizes)     | Pipeline (one integrator, depth)  |
| OptixShaderBindingTable                | ShaderBindingTable of SbtRecords  |
| optixAccelBuild / Compact / Relocate   | build_gas (LBVH past 512 tris),   |
|                                        |   build_custom_gas, build_ias,    |
|                                        |   refit_gas                       |
| optixLaunch                            | Pipeline.launch                   |
| optixDenoiserCreate/Setup/Invoke       | Denoiser                          |
| optixDirectCall / ContinuationCall     | CallableTable (index on device)   |
| OptixModuleCompileBoundValueEntry      | Module(bound_values=...)          |
"""
from .accel import (build_custom_gas, build_gas, build_ias,  # noqa: F401
                    refit_gas)
from .callables import CallableTable  # noqa: F401
from .context import DeviceContext, LogLevel  # noqa: F401
from .denoiser import AlphaMode, Denoiser, ModelKind  # noqa: F401
from .module import (AbortableCompile, BUILTIN_IS_KINDS,  # noqa: F401
                     Module, builtin_is_module, compile_with_tasks)
from .pipeline import (Pipeline, ProgramGroup,  # noqa: F401
                       ProgramGroupKind, SbtRecord, ShaderBindingTable)

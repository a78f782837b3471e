"""Build, load and count the hand-written CUDA kernels under `csrc/`.

The kernels are CUDA C++ for `sm_90a` with a plain C interface. On first use
`nvcc` compiles every `csrc/*.cu` into one shared library under `_build/`,
keyed by a hash of the sources and flags, and `ctypes` loads it. Nothing is
built or loaded at import time, so the CPU tests import this module freely.

`LAUNCHES` counts launches per kernel: each wrapper adds one where it
launches its kernel and nowhere else.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import itertools
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_CSRC = Path(__file__).parent / "csrc"
_BUILD = Path(__file__).parent / "_build"

# No --use_fast_math. -fmad=false keeps every product and sum rounded on
# its own, as PyTorch's elementwise ops round them, so the kernels and their
# plain versions take the same branches on the same rays.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")


# The fused kernel's geometry modes (wavefront/pallas_pt.py) and their codes
# in csrc/pt_fused.cuh; "tex" is the texture variant.
GEOMETRY = {"flat": 0, "inst": 1, "smooth": 2, "tex": 3}


def pt_fused_name(specular: bool, pbr: bool, prims: bool,
                  geometry: str = "flat") -> str:
    """LAUNCHES key of the fused kernel's instantiation <geometry, specular,
    pbr, prims>: "pt_fused_cornell" for <flat, false, false, false>, else
    the geometry mode unless flat, then the flags that are on, e.g.
    "pt_fused_specular_prims", "pt_fused_inst", "pt_fused_smooth_pbr",
    "pt_fused_tex_specular_pbr" (bench.py's textured scene)."""
    if geometry not in GEOMETRY:
        raise ValueError(f"geometry must be one of {tuple(GEOMETRY)}")
    on = [t for t, f in ((geometry, geometry != "flat"),
                         ("specular", specular), ("pbr", pbr),
                         ("prims", prims)) if f]
    return "pt_fused_" + ("_".join(on) if on else "cornell")


LAUNCHES = {"bf_closest": 0, "bf_any": 0,
            **{pt_fused_name(*v, g): 0 for g in GEOMETRY
               for v in itertools.product((False, True), repeat=3)},
            "cluster_cull_exact": 0, "cluster_closest": 0, "cluster_any": 0,
            "cluster_sc_closest": 0, "cluster_sc_any": 0,
            "qwalk_oct_cull": 0, "qwalk_closest": 0, "qwalk_any": 0,
            "texfetch": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # tri, tri_mat, m, org, dir, tmin, tmax, n, t, prim, mat, uv, normal, stream
    "ort_bf_closest": (_P, _P, _I, _P, _P, _P, _P, _I,
                       _P, _P, _P, _P, _P, _P),
    # tri, m, org, dir, tmin, tmax, n, occ, stream
    "ort_bf_any": (_P, _I, _P, _P, _P, _P, _I, _P, _P),
    # tri, m, prims, p, mats, k, light, cam, subframe, width, height,
    # full_w, full_h, y0, spl, max_depth, specular, pbr, geometry, inst,
    # inst_ranges, n_inst, corner, bundles, bundle_mip, n_levels, atlas_h,
    # atlas_w, rad, count, stream
    "ort_pt_fused": (_P, _I, _P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I,
                     _I, _I, _I, _I, _I, _I, _P, _P, _I, _P, _P, _P, _I, _I,
                     _I, _P, _P, _P),
    # aabb, c_pad, rays, n_blocks, tn, gm, stream
    "ort_cluster_cull_exact": (_P, _I, _P, _I, _P, _P, _P),
    # counts, lists, tnear, comp, n_comp, rays, n_blocks, c_pad, gate, out,
    # stream
    "ort_cluster_closest": (_P, _P, _P, _P, _I, _P, _I, _I, _I, _P, _P),
    "ort_cluster_any": (_P, _P, _P, _P, _I, _P, _I, _I, _I, _P, _P),
    # counts, lists, tnear, comp, n_comp, member_aabb, n_member_rows,
    # members, rays, n_blocks, c_pad, out, stream
    "ort_cluster_sc_closest": (_P, _P, _P, _P, _I, _P, _I, _I, _P, _I, _I,
                               _P, _P),
    "ort_cluster_sc_any": (_P, _P, _P, _P, _I, _P, _I, _I, _P, _I, _I, _P,
                           _P),
    # aabb, c_pad, rays, n_blocks, om, stream
    "ort_qwalk_oct_cull": (_P, _I, _P, _I, _P, _P),
    # steps, n_steps, qrays, q_cols, comp, n_comp, out, stream
    "ort_qwalk_closest": (_P, _I, _P, _L, _P, _I, _P, _P),
    "ort_qwalk_any": (_P, _I, _P, _L, _P, _I, _P, _P),
    # atlas, tile_idx, local, tile_w, n_blocks, out, stream
    "ort_texfetch": (_P, _P, _P, _I, _I, _P, _P),
}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _sources():
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def build() -> tuple[Path, float]:
    """Compile the library if this source hash has not been built yet: one
    `nvcc` per source, all started together, then one link. Returns (path,
    seconds spent compiling in this call)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = _BUILD / h.hexdigest()[:16]
    lib_path = out_dir / "libort_kernels.so"
    if lib_path.exists():
        return lib_path, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    # -Xptxas=-v reports registers, shared memory and spills per kernel; the
    # report goes to nvcc.log beside the library.
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"] + ["-Xptxas=-v"]
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(_CSRC.glob("*.cu")):
        obj = out_dir / f"{src.stem}.{tag}.o"
        jobs.append((obj, subprocess.Popen(
            [_nvcc(), *compile_flags, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors, log = [], []
    for obj, proc in jobs:
        _, err = proc.communicate()
        log.append(f"== {obj.name}\n{err}")
        if proc.returncode != 0:
            errors.append(f"{obj.name}: nvcc failed ({proc.returncode}):\n{err}")
    if errors:
        raise RuntimeError("\n".join(errors))
    tmp = out_dir / f"libort_kernels.{tag}.tmp.so"
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                          *[str(obj) for obj, _ in jobs]],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{res.stderr}")
    (out_dir / "nvcc.log").write_text("\n".join(log))
    os.replace(tmp, lib_path)   # atomic, so concurrent builds agree
    for obj, _ in jobs:
        obj.unlink(missing_ok=True)
    return lib_path, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    path, _ = build()
    so = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(so, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    so.ort_error_string.argtypes = [ctypes.c_int]
    so.ort_error_string.restype = ctypes.c_char_p
    return so


def check(err: int, name: str):
    """Raise if a launch returned a CUDA error (`cudaGetLastError`)."""
    if err != 0:
        msg = lib().ort_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require(t: torch.Tensor, name: str, dtype, shape, device):
    """Wrapper-side argument check: device, dtype, shape, contiguity."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")

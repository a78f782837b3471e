"""The port's ctypes binding to the repository's host-side SAH BVH builder
(`native/bvh_builder.cpp`; counterpart of `accel/native.py`).

The JAX package's binding cannot be imported without JAX (its package
`__init__` imports the JAX intersectors), so the port binds the same C++
source itself. `g++` builds it at first use into
`optix_raytracer_tpu_torch/_build/native-<source hash>/`, with the JAX
binding's flags, so both produce the same tree. Without a compiler (or
without the source), `build_bvh_sah` and `sah_leaf_order` return None and
the caller falls back to morton order, as the JAX package does. A build or
load that fails raises: it would silently change the cluster order.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_SOURCE = Path(__file__).resolve().parents[2] / "native" / "bvh_builder.cpp"
_BUILD = Path(__file__).resolve().parents[1] / "_build"
_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")


def build_shared_library(source: Path, prefix: str,
                         name: str) -> Optional[Path]:
    """Build `source` with g++ into `_build/<prefix>-<hash of the flags and
    the source>/<name>` once, or None without g++ or without the source.
    Processes building at once (test workers) take turns on a file lock in
    the directory, and the library moves into place from a per-pid temp
    file with os.replace, so none loads half a file; a failed build
    raises."""
    cxx = shutil.which("g++")
    if cxx is None or not source.exists():
        return None
    src = source.read_bytes()
    h = hashlib.sha256(" ".join(_FLAGS).encode() + src).hexdigest()[:16]
    out_dir = _BUILD / f"{prefix}-{h}"
    so_path = out_dir / name
    if so_path.exists():
        return so_path
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not so_path.exists():
                tmp = out_dir / f"{so_path.stem}.{os.getpid()}.tmp.so"
                proc = subprocess.run(
                    [cxx, *_FLAGS, "-o", str(tmp), str(source)],
                    capture_output=True, text=True, timeout=300)
                if proc.returncode != 0:
                    raise RuntimeError(f"building {source.name} failed:\n"
                                       f"{proc.stderr}")
                os.replace(tmp, so_path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return so_path


@functools.lru_cache(maxsize=None)
def _load() -> Optional[ctypes.CDLL]:
    so_path = build_shared_library(_SOURCE, "native", "libort_bvh.so")
    if so_path is None:
        return None
    lib = ctypes.CDLL(str(so_path))
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    lib.ort_build_bvh_sah_mt.restype = ctypes.c_int32
    lib.ort_build_bvh_sah_mt.argtypes = [fp, fp, fp, ctypes.c_int32, fp, fp,
                                         ip, ip, ctypes.c_int32]
    return lib


def available() -> bool:
    return _load() is not None


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def build_bvh_sah(geom, num_threads: Optional[int] = None):
    """Threaded SAH BVH of the geometry's triangles → dict of numpy arrays
    (node_lo, node_hi [2M-1, 3], node_skip, node_prim [2M-1]), or None
    without the native builder. The output does not depend on the thread
    count (default: all cores)."""
    lib = _load()
    if lib is None:
        return None
    # The bounds come from v0 / v0+e1 / v0+e2, as accel/native.py:140-147.
    v0 = geom.v0.detach().cpu().numpy().astype(np.float32)
    e1 = geom.e1.detach().cpu().numpy().astype(np.float32)
    e2 = geom.e2.detach().cpu().numpy().astype(np.float32)
    v1 = v0 + e1
    v2 = v0 + e2
    tri_lo = np.ascontiguousarray(np.minimum(v0, np.minimum(v1, v2)))
    tri_hi = np.ascontiguousarray(np.maximum(v0, np.maximum(v1, v2)))
    centroid = np.ascontiguousarray(0.5 * (tri_lo + tri_hi))
    n = tri_lo.shape[0]
    if n == 0:
        return None
    num_nodes = 2 * n - 1
    out = dict(node_lo=np.empty((num_nodes, 3), np.float32),
               node_hi=np.empty((num_nodes, 3), np.float32),
               node_skip=np.empty(num_nodes, np.int32),
               node_prim=np.empty(num_nodes, np.int32))
    threads = num_threads if num_threads else max(1, os.cpu_count() or 1)
    written = lib.ort_build_bvh_sah_mt(
        _fptr(tri_lo), _fptr(tri_hi), _fptr(centroid), n,
        _fptr(out["node_lo"]), _fptr(out["node_hi"]),
        _iptr(out["node_skip"]), _iptr(out["node_prim"]), threads)
    return out if written == num_nodes else None


def sah_leaf_order(geom) -> Optional[np.ndarray]:
    """Triangle ids in SAH-tree DFS leaf order ([M] int32), or None without
    the native builder: consecutive leaves make tighter 128-triangle
    clusters than a morton run (accel/native.py:167-178)."""
    bvh = build_bvh_sah(geom)
    if bvh is None:
        return None
    prim = bvh["node_prim"]
    return prim[prim >= 0].astype(np.int32)

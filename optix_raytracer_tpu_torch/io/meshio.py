"""OBJ and PLY (ASCII and binary) mesh loading (counterpart of
`io/meshio.py:25-262`): the repository's C++ parser
(`native/mesh_loader.cpp`, `ort_load_mesh` / `ort_free_mesh`), with the
numpy parsers `_load_obj_py` / `_load_ply_py` where no g++ exists. Both
return the (positions [V, 3] f32, indices [M, 3] i32, normals [V, 3] or
None, uvs [V, 2] or None) tuple `Scene.add_mesh` takes.

The JAX package builds the parser into its own library beside the source;
the port builds it alone, with g++ at first use, into
`optix_raytracer_tpu_torch/_build/meshio-<hash of the flags and the
source>/` (`accel/native.py::build_shared_library`). A build or a load that
fails raises, and so does a file the parser refuses.
"""
from __future__ import annotations

import ctypes
import functools
import os
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..accel import native

MeshTuple = Tuple[np.ndarray, np.ndarray,
                  Optional[np.ndarray], Optional[np.ndarray]]

_SOURCE = Path(__file__).resolve().parents[2] / "native" / "mesh_loader.cpp"


@functools.lru_cache(maxsize=None)
def _native_lib() -> Optional[ctypes.CDLL]:
    """The parser's library, built at first use; None without g++ (or
    without the source)."""
    so_path = native.build_shared_library(_SOURCE, "meshio", "libort_mesh.so")
    if so_path is None:
        return None
    lib = ctypes.CDLL(str(so_path))
    pf = ctypes.POINTER(ctypes.c_float)
    pi = ctypes.POINTER(ctypes.c_int32)
    lib.ort_load_mesh.restype = ctypes.c_int32
    lib.ort_load_mesh.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(pf), pi,         # pos, n_verts
        ctypes.POINTER(pi), pi,         # idx, n_tris
        ctypes.POINTER(pf), pi,         # normals, has_normals
        ctypes.POINTER(pf), pi,         # uvs, has_uvs
        ctypes.c_char_p,                # err buffer
    ]
    lib.ort_free_mesh.restype = None
    lib.ort_free_mesh.argtypes = [pf, pi, pf, pf]
    return lib


def native_available() -> bool:
    return _native_lib() is not None


def _load_native(path: str) -> Optional[MeshTuple]:
    lib = _native_lib()
    if lib is None:
        return None
    pf = ctypes.POINTER(ctypes.c_float)
    pi = ctypes.POINTER(ctypes.c_int32)
    pos, idx = pf(), pi()
    nrm, uv = pf(), pf()
    nv = ctypes.c_int32()
    nt = ctypes.c_int32()
    has_n = ctypes.c_int32()
    has_t = ctypes.c_int32()
    err = ctypes.create_string_buffer(256)
    rc = lib.ort_load_mesh(os.fsencode(path), ctypes.byref(pos),
                           ctypes.byref(nv), ctypes.byref(idx),
                           ctypes.byref(nt), ctypes.byref(nrm),
                           ctypes.byref(has_n), ctypes.byref(uv),
                           ctypes.byref(has_t), err)
    if rc != 0:
        raise ValueError(f"{path}: {err.value.decode(errors='replace')}")
    try:
        v = np.ctypeslib.as_array(pos, (nv.value, 3)).copy()
        f = np.ctypeslib.as_array(idx, (nt.value, 3)).copy()
        n = (np.ctypeslib.as_array(nrm, (nv.value, 3)).copy()
             if has_n.value else None)
        t = (np.ctypeslib.as_array(uv, (nv.value, 2)).copy()
             if has_t.value else None)
    finally:
        lib.ort_free_mesh(pos, idx, nrm if has_n.value else None,
                          uv if has_t.value else None)
    return v, f, n, t


# The numpy parsers (io/meshio.py:101-245).

def _load_obj_py(path: str) -> MeshTuple:
    vs, vts, vns = [], [], []
    remap = {}
    out_v, out_n, out_t, faces = [], [], [], []
    any_n = any_t = False

    def emit(tok):
        nonlocal any_n, any_t
        if tok in remap:
            return remap[tok]
        parts = tok.split("/")
        vi = int(parts[0])
        vi = vi - 1 if vi > 0 else len(vs) + vi
        ti = ni = -1
        if len(parts) > 1 and parts[1]:
            ti = int(parts[1])
            ti = ti - 1 if ti > 0 else len(vts) + ti
        if len(parts) > 2 and parts[2]:
            ni = int(parts[2])
            ni = ni - 1 if ni > 0 else len(vns) + ni
        iid = len(out_v)
        out_v.append(vs[vi])
        if 0 <= ni < len(vns):
            any_n = True
            out_n.append(vns[ni])
        else:
            out_n.append((0.0, 0.0, 0.0))
        if 0 <= ti < len(vts):
            any_t = True
            out_t.append(vts[ti])
        else:
            out_t.append((0.0, 0.0))
        remap[tok] = iid
        return iid

    with open(path) as f:
        for line in f:
            p = line.split()
            if not p:
                continue
            if p[0] == "v" and len(p) >= 4:
                vs.append(tuple(float(x) for x in p[1:4]))
            elif p[0] == "vn" and len(p) >= 4:
                vns.append(tuple(float(x) for x in p[1:4]))
            elif p[0] == "vt" and len(p) >= 3:
                vts.append(tuple(float(x) for x in p[1:3]))
            elif p[0] == "f" and len(p) >= 4:
                poly = [emit(t) for t in p[1:]]
                for i in range(2, len(poly)):
                    faces.append((poly[0], poly[i - 1], poly[i]))
    if not faces:
        raise ValueError(f"{path}: obj: no faces")
    return (np.asarray(out_v, np.float32), np.asarray(faces, np.int32),
            np.asarray(out_n, np.float32) if any_n else None,
            np.asarray(out_t, np.float32) if any_t else None)


_PLY_DT = {"char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
           "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
           "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
           "float": "f4", "float32": "f4", "double": "f8", "float64": "f8"}


def _load_ply_py(path: str) -> MeshTuple:
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: ply: missing magic")
        fmt = None
        elems = []           # (name, count, [(prop_name, dtype|list-spec)])
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: ply: truncated header")
            s = line.decode("ascii", errors="replace").strip()
            if s.startswith("comment"):
                continue
            if s.startswith("format"):
                fmt = s.split()[1]
                if fmt not in ("ascii", "binary_little_endian"):
                    raise ValueError(f"{path}: ply: unsupported {fmt}")
            elif s.startswith("element"):
                _, name, cnt = s.split()[:3]
                elems.append((name, int(cnt), []))
            elif s.startswith("property"):
                p = s.split()
                if p[1] == "list":
                    elems[-1][2].append((p[4], ("list", _PLY_DT[p[2]],
                                                _PLY_DT[p[3]])))
                else:
                    elems[-1][2].append((p[2], _PLY_DT[p[1]]))
            elif s == "end_header":
                break
        verts = norms = uvs = None
        faces = []
        for name, count, props in elems:
            fixed = all(not isinstance(d, tuple) for _, d in props)
            if fmt == "binary_little_endian" and fixed:
                dt = np.dtype([(pn, "<" + d) for pn, d in props])
                arr = np.frombuffer(f.read(dt.itemsize * count), dt,
                                    count=count)
                rows = {pn: arr[pn].astype(np.float64) for pn, _ in props}
            elif fmt == "ascii" and fixed:
                flat = []
                need = count * len(props)
                while len(flat) < need:
                    flat.extend(f.readline().split())
                a = np.asarray(flat[:need], np.float64).reshape(
                    count, len(props))
                rows = {pn: a[:, i] for i, (pn, _) in enumerate(props)}
            else:
                # row-by-row (lists present)
                rows = None
                for _ in range(count):
                    vals = []
                    if fmt == "ascii":
                        toks = f.readline().split()
                        ti = 0
                        for pn, d in props:
                            if isinstance(d, tuple):
                                cnt = int(toks[ti]); ti += 1
                                vals = [int(x) for x in
                                        toks[ti:ti + cnt]]
                                ti += cnt
                            else:
                                ti += 1
                    else:
                        for pn, d in props:
                            if isinstance(d, tuple):
                                cnt = int(np.frombuffer(
                                    f.read(np.dtype(d[1]).itemsize),
                                    "<" + d[1])[0])
                                isz = np.dtype(d[2]).itemsize
                                vals = np.frombuffer(
                                    f.read(isz * cnt), "<" + d[2]
                                ).astype(np.int64).tolist()
                            else:
                                f.read(np.dtype(d).itemsize)
                    if name == "face" and len(vals) >= 3:
                        for i in range(2, len(vals)):
                            faces.append((vals[0], vals[i - 1], vals[i]))
                continue
            if name == "vertex":
                verts = np.stack([rows["x"], rows["y"], rows["z"]],
                                 axis=1).astype(np.float32)
                if all(k in rows for k in ("nx", "ny", "nz")):
                    norms = np.stack([rows["nx"], rows["ny"], rows["nz"]],
                                     axis=1).astype(np.float32)
                for ku, kv in (("u", "v"), ("s", "t"),
                               ("texture_u", "texture_v")):
                    if ku in rows and kv in rows:
                        uvs = np.stack([rows[ku], rows[kv]],
                                       axis=1).astype(np.float32)
                        break
    if verts is None or not faces:
        raise ValueError(f"{path}: ply: no vertices or faces")
    idx = np.asarray(faces, np.int32)
    if idx.min() < 0 or idx.max() >= len(verts):
        raise ValueError(f"{path}: ply: index out of range")
    return verts, idx, norms, uvs


def load_mesh(path: str, prefer_native: bool = True) -> MeshTuple:
    """Load an .obj or .ply model → (positions, indices, normals, uvs):
    the native parser where g++ exists, else (or with prefer_native=False)
    the numpy parsers. Raises ValueError on malformed input and on other
    extensions."""
    path = os.fspath(path)
    ext = os.path.splitext(path)[1].lower()
    if ext not in (".obj", ".ply"):
        raise ValueError(f"unsupported mesh format: {ext}")
    if prefer_native:
        out = _load_native(path)
        if out is not None:
            return out
    return _load_obj_py(path) if ext == ".obj" else _load_ply_py(path)

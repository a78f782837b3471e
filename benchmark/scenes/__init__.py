"""Scene generators, one module a kind: `scenes/<kind>.py` defines
`build(spec) -> dict` of numpy arrays and plain values (vertices, indices,
normals or None, tri_mat, materials, light, miss_color), found by the `kind`
of a configuration's `scene`."""
from __future__ import annotations

import importlib


def build(spec: dict) -> dict:
    kind = spec["kind"]
    if not kind.isidentifier():
        raise ValueError(f"scene kind {kind!r} is not a module name")
    return importlib.import_module(f"{__name__}.{kind}").build(spec)

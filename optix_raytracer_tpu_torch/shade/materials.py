"""Material table as planes of tensors (counterpart of `shade/materials.py`).

The table carries the fields of the diffuse, emissive, glass and PBR
(metallic-roughness, mirror) lanes, the phong and checker planes of the
Whitted integrator (specular, phong_exp, checker1, checker_scale) and the
texture wiring: per material the ids of its base-color, normal,
metallic-roughness and emissive maps (-1 = none) and its texture bundle
(`scene/device_scene.py::pack_bundles`, -1 = untextured), and the alpha
cutout planes: the alpha mode, the cutout mask style (checker, circle, or
the base map's alpha against the alpha cutoff; the checker and circle
masks read `checker_scale`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

# Material kinds, the same tags as the JAX package.
DIFFUSE = 0
PBR = 1
GLASS = 2
PHONG = 3
CHECKER = 4
EMISSIVE = 5

# Alpha modes (shade/materials.py:26-30)
ALPHA_OPAQUE = 0
ALPHA_MASK = 1
ALPHA_BLEND = 2

# Cutout mask styles of an ALPHA_MASK material (shade/materials.py:32-36):
# the checker and circle anyhit masks, and the base map's alpha.
CUT_NONE = 0
CUT_CHECKER = 1
CUT_CIRCLE = 2
CUT_TEXTURE = 3

# Texture-id keys of a material dict (shade/materials.py:53-57).
TEX_KEYS = ("base_tex", "normal_tex", "mr_tex", "emissive_tex")
# The Whitted planes and their defaults (shade/materials.py:47-50, 107-110).
WHITTED_DEFAULTS = {"specular": (0.0, 0.0, 0.0), "phong_exp": 32.0,
                    "checker1": (0.0, 0.0, 0.0), "checker_scale": 1.0}
# The fields the path tracer's bounce reads (gather's default).
PT_FIELDS = ("kind", "base_color", "emission", "metallic", "roughness",
             "ior", "kr", *TEX_KEYS, "bundle")
# The fields the alpha mask reads (wavefront/intersect.py::_eval_hole).
CUT_FIELDS = ("alpha_mode", "cutout", "alpha_cutoff", "checker_scale",
              "base_tex")


@dataclasses.dataclass
class MaterialTable:
    kind: torch.Tensor         # [K] int32
    base_color: torch.Tensor   # [K, 3]
    emission: torch.Tensor     # [K, 3]
    metallic: torch.Tensor     # [K]
    roughness: torch.Tensor    # [K]
    ior: torch.Tensor          # [K]
    kr: torch.Tensor           # [K, 3]
    # The Whitted planes: phong Ks, phong exponent, the checker's second
    # color and frequency.
    specular: torch.Tensor     # [K, 3]
    phong_exp: torch.Tensor    # [K]
    checker1: torch.Tensor     # [K, 3]
    checker_scale: torch.Tensor  # [K]
    # [K] int32 texture ids (-1 = none; the mr map is glTF-packed: G =
    # roughness, B = metallic) and the bundle id; None means all -1.
    base_tex: Optional[torch.Tensor] = None
    normal_tex: Optional[torch.Tensor] = None
    mr_tex: Optional[torch.Tensor] = None
    emissive_tex: Optional[torch.Tensor] = None
    bundle: Optional[torch.Tensor] = None
    # [K] int32 alpha mode and CUT_* mask style (None: 0), [K] f32 alpha
    # cutoff (None: 0.5).
    alpha_mode: Optional[torch.Tensor] = None
    cutout: Optional[torch.Tensor] = None
    alpha_cutoff: Optional[torch.Tensor] = None

    def __post_init__(self):
        for name in (*TEX_KEYS, "bundle"):
            if getattr(self, name) is None:
                setattr(self, name, torch.full_like(self.kind, -1))
        for name in ("alpha_mode", "cutout"):
            if getattr(self, name) is None:
                setattr(self, name, torch.zeros_like(self.kind))
        if self.alpha_cutoff is None:
            self.alpha_cutoff = torch.full_like(self.metallic, 0.5)

    @property
    def num(self):
        return self.kind.shape[0]


def make_material_table(materials, device) -> MaterialTable:
    """materials: list of dicts; unspecified fields get the JAX defaults."""
    K = max(len(materials), 1)

    def plane(key, default, width=None):
        if width is None:
            out = np.full((K,), default, np.float32)
        else:
            out = np.tile(np.asarray(default, np.float32), (K, 1))
        for i, m in enumerate(materials):
            if key in m:
                out[i] = m[key]
        return torch.as_tensor(out, device=device)

    def ids(key, default=-1):
        out = np.full(K, default, np.int32)
        for i, m in enumerate(materials):
            out[i] = m.get(key, default)
        return torch.as_tensor(out, device=device)

    return MaterialTable(
        kind=ids("kind", DIFFUSE),
        base_color=plane("base_color", (0.8, 0.8, 0.8), 3),
        emission=plane("emission", (0.0, 0.0, 0.0), 3),
        metallic=plane("metallic", 0.0),
        roughness=plane("roughness", 0.5),
        ior=plane("ior", 1.5),
        kr=plane("kr", (0.0, 0.0, 0.0), 3),
        **{key: ids(key) for key in TEX_KEYS},
        **{key: plane(key, default, 3 if isinstance(default, tuple) else None)
           for key, default in WHITTED_DEFAULTS.items()},
        alpha_mode=ids("alpha_mode", ALPHA_OPAQUE),
        cutout=ids("cutout", CUT_NONE),
        alpha_cutoff=plane("alpha_cutoff", 0.5),
    )


def gather(table: MaterialTable, mat_id, fields=PT_FIELDS):
    """Per-hit material parameters of `fields` (misses read material 0, as
    in JAX)."""
    mid = torch.clamp_min(mat_id, 0).long()
    return {name: getattr(table, name)[mid] for name in fields}

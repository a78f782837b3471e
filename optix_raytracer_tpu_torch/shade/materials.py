"""Material table as planes of tensors (counterpart of `shade/materials.py`).

The table carries the fields of the diffuse, emissive, glass and PBR
(metallic-roughness, mirror) lanes. Textures and alpha cutouts are not
ported yet (ROADMAP.md Queue 1 item 8), and a material that asks for one
raises NotImplementedError.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Material kinds, the same tags as the JAX package.
DIFFUSE = 0
PBR = 1
GLASS = 2
PHONG = 3
CHECKER = 4
EMISSIVE = 5

# Keys that switch on an unported feature, with their "off" value.
_UNPORTED_KEYS = {"base_tex": -1, "normal_tex": -1, "mr_tex": -1,
                  "emissive_tex": -1, "cutout": 0, "alpha_mode": 0}


@dataclasses.dataclass
class MaterialTable:
    kind: torch.Tensor         # [K] int32
    base_color: torch.Tensor   # [K, 3]
    emission: torch.Tensor     # [K, 3]
    metallic: torch.Tensor     # [K]
    roughness: torch.Tensor    # [K]
    ior: torch.Tensor          # [K]
    kr: torch.Tensor           # [K, 3]

    @property
    def num(self):
        return self.kind.shape[0]


def make_material_table(materials, device) -> MaterialTable:
    """materials: list of dicts; unspecified fields get the JAX defaults."""
    for i, m in enumerate(materials):
        used = [k for k, off in _UNPORTED_KEYS.items() if m.get(k, off) != off]
        if used:
            raise NotImplementedError(
                f"material {i}: {used} (textures / cutouts) are not ported "
                "yet (ROADMAP.md Queue 1 item 8)")
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

    kind = np.zeros(K, np.int32)
    for i, m in enumerate(materials):
        kind[i] = m.get("kind", DIFFUSE)
    return MaterialTable(
        kind=torch.as_tensor(kind, device=device),
        base_color=plane("base_color", (0.8, 0.8, 0.8), 3),
        emission=plane("emission", (0.0, 0.0, 0.0), 3),
        metallic=plane("metallic", 0.0),
        roughness=plane("roughness", 0.5),
        ior=plane("ior", 1.5),
        kr=plane("kr", (0.0, 0.0, 0.0), 3),
    )


def gather(table: MaterialTable, mat_id):
    """Per-hit material parameters (misses read material 0, as in JAX)."""
    mid = torch.clamp_min(mat_id, 0).long()
    return {f.name: getattr(table, f.name)[mid]
            for f in dataclasses.fields(table)}

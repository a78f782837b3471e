"""Checkpoint and resume of a progressive render (counterpart of
`core/checkpoint.py:26-70`).

The film (running mean, subframe count, and with variance tracking the
running mean of squares and the launch count), the camera and a user config
round-trip through one .npz in the JAX package's format (version 1), so a
file that either package writes loads and resumes in the other. The JAX
film counts in int32 and the port's in int64: the writer stores int32 and
the loader widens.

`save_checkpoint_sharded` / `load_checkpoint_sharded` are the reference's
Orbax pair (`core/checkpoint.py:73-120`) for a film sharded over ranks
(`multichip/tiles.py`): a directory of one file per row band and
`render_meta.json`, written atomically, loaded whole by one process or by
the ranks of any row split, each reading its own rows.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil

import numpy as np
import torch

from .camera import Camera
from .film import Film

FORMAT_VERSION = 1


def _count32(t) -> np.ndarray:
    v = int(t)
    if not -2 ** 31 <= v < 2 ** 31:
        raise ValueError(f"count {v} does not fit the format's int32")
    return np.asarray(v, np.int32)


def _camera_from(d):
    if d is None:
        return None
    return Camera(**{k: tuple(v) if isinstance(v, list) else v
                     for k, v in d.items()})


def save_checkpoint(path: str, film: Film, camera: Camera = None,
                    config: dict = None):
    """Write the film, camera and config to `path` (.npz)."""
    camera_json = (json.dumps(dataclasses.asdict(camera))
                   if camera is not None else "")
    extra = {}
    if film.sq is not None:
        extra["sq"] = film.sq.detach().cpu().numpy()
        extra["launches"] = _count32(film.launches)
    np.savez_compressed(
        path, version=FORMAT_VERSION,
        accum=film.accum.detach().cpu().numpy(),
        subframe=_count32(film.subframe), camera_json=camera_json,
        config_json=json.dumps(config or {}), **extra)


def load_checkpoint(path: str, device):
    """→ (Film on `device`, Camera or None, config dict)."""
    def counter(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    with np.load(path, allow_pickle=False) as z:
        if int(z["version"]) != FORMAT_VERSION:
            raise ValueError(f"{path}: checkpoint version {int(z['version'])}"
                             f", expected {FORMAT_VERSION}")
        film = Film(
            accum=torch.as_tensor(np.asarray(z["accum"], np.float32),
                                  device=device),
            subframe=counter(z["subframe"]),
            sq=(torch.as_tensor(np.asarray(z["sq"], np.float32),
                                device=device) if "sq" in z.files else None),
            launches=counter(z["launches"]) if "launches" in z.files
            else None)
        cam_js = str(z["camera_json"])
        camera = _camera_from(json.loads(cam_js) if cam_js else None)
        config = json.loads(str(z["config_json"]))
    return film, camera, config


# ---------------------------------------------------------------------------
# Sharded directory checkpoints (the reference's Orbax pair, :73-120). The
# card has no Orbax; the layout is the port's own: band_<k>.npz holds the
# k-th band of rows of the film's accum, render_meta.json the version,
# camera, config, frame size, subframe count and each band's (first row,
# rows).
# ---------------------------------------------------------------------------

def save_checkpoint_sharded(path: str, film: Film, mesh=None,
                            camera: Camera = None, config: dict = None):
    """Write a row-sharded film to the directory `path` (replaced if it
    exists). Every rank of `mesh` calls this with its band
    (`tiles.shard_film`); the first rank of each row band writes it. With
    mesh None, `film` is the whole frame, written as one band. The files go
    to `path`.partial first, which the first rank renames to `path` once
    every band is written, so a reader never sees half a checkpoint."""
    from ..multichip import tiles
    path = os.path.abspath(path)
    tmp = path + ".partial"
    lead = mesh is None or mesh.rank == int(mesh.ranks.flat[0])
    if mesh is None:
        band, n_band, first_of_band = 0, 1, True
    else:
        band, n_band = tiles.band_index(mesh), tiles.n_bands(mesh)
        first_of_band = mesh.coord.get(tiles.SAMPLES_AXIS, 0) == 0
    if lead:
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    if mesh is not None:
        tiles.barrier(mesh)
    rows = film.accum.shape[0]
    if first_of_band:
        np.savez(os.path.join(tmp, f"band_{band:04d}.npz"),
                 accum=film.accum.detach().cpu().numpy())
    if mesh is not None:
        tiles.barrier(mesh)
    if lead:
        meta = {"version": FORMAT_VERSION,
                "camera": (dataclasses.asdict(camera) if camera is not None
                           else None),
                "config": config or {}, "height": rows * n_band,
                "width": int(film.accum.shape[1]),
                "subframe": int(film.subframe),
                "bands": [[k * rows, rows] for k in range(n_band)]}
        with open(os.path.join(tmp, "render_meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(path):
            old = path + ".old"
            shutil.rmtree(old, ignore_errors=True)
            os.replace(path, old)
            os.replace(tmp, path)
            shutil.rmtree(old)
        else:
            os.replace(tmp, path)
    if mesh is not None:
        tiles.barrier(mesh)


def load_checkpoint_sharded(path: str, device, mesh=None):
    """→ (Film on `device`, Camera or None, config dict) from a directory
    `save_checkpoint_sharded` wrote. With mesh None the whole frame; with a
    mesh this rank's band of the mesh's own row split
    (`tiles.shard_film`'s rows), read from whichever band files hold those
    rows, whatever split wrote them."""
    from ..multichip import tiles
    with open(os.path.join(path, "render_meta.json")) as f:
        meta = json.load(f)
    if int(meta["version"]) != FORMAT_VERSION:
        raise ValueError(f"{path}: checkpoint version {meta['version']}, "
                         f"expected {FORMAT_VERSION}")
    height = int(meta["height"])
    lo, hi = 0, height
    if mesh is not None:
        n_band = tiles.n_bands(mesh)
        if height % n_band:
            raise ValueError(f"{height} rows do not split into {n_band} "
                             f"bands")
        tile_h = height // n_band
        lo = tiles.band_index(mesh) * tile_h
        hi = lo + tile_h
    parts = []
    for k, (row0, rows) in enumerate(meta["bands"]):
        a, b = max(lo, row0), min(hi, row0 + rows)
        if a < b:
            with np.load(os.path.join(path, f"band_{k:04d}.npz")) as z:
                parts.append(np.asarray(z["accum"][a - row0:b - row0],
                                        np.float32))
    if sum(p.shape[0] for p in parts) != hi - lo:
        raise ValueError(f"{path}: rows {lo}-{hi} are not all present")
    accum = np.concatenate(parts)
    film = Film(accum=torch.as_tensor(accum, device=device),
                subframe=torch.tensor(int(meta["subframe"]),
                                      dtype=torch.int64, device=device))
    return film, _camera_from(meta["camera"]), meta["config"]

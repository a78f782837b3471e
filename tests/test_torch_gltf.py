"""The port's glTF loader (`optix_raytracer_tpu_torch/scene/gltf.py`)
against the JAX package's on the same files.

Every field of `load_gltf`'s result (meshes with their transforms, skins
and morph targets, materials, textures, cameras, animations, skins, lights,
nodes) equals the JAX loader's bit for bit, and so do `sample_animation`,
`node_world_transforms` and `pose_meshes` at three times. The files are the
reference tests' own (`tests/test_scene_gltf.py::make_cube_gltf`, the
documents of `tests/test_gltf_animation.py`: TRS, skin, morph and morph
normals) and the port's writer (`tools/model_probe.write_gltf`: an external
buffer, KTX2 images, the texture transform, emissive strength, lights and
a camera). Numpy only, a few seconds.
"""
import dataclasses

import numpy as np
import pytest

from optix_raytracer_tpu.scene import gltf as jgltf
from optix_raytracer_tpu_torch.scene import gltf as tgltf
from optix_raytracer_tpu_torch.tools import model_probe as mp

import test_gltf_animation as ga
import test_scene_gltf as sg

JLOAD = jgltf.load_gltf


def assert_same(a, b, where="scene"):
    """Recursive bit-equality of loader results: dataclasses field by
    field, numpy arrays with their dtype and shape, containers, scalars."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{where}.{f.name}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert a.tobytes() == b.tobytes(), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def written(maker, tmp_path, monkeypatch, **kw):
    """The path a reference test's maker writes: its JAX load_gltf is
    swapped for the identity while it runs."""
    with monkeypatch.context() as m:
        m.setattr(ga.G, "load_gltf", lambda p: p)
        return maker(tmp_path, **kw)


def _writer_model(tmp_path, name, **kw):
    meshes, materials, images = mp.knot_model(6, 5, tex_size=16)
    materials[0]["texture_transform"] = {"offset": [0.25, 0.5],
                                         "scale": [2.0, 3.0],
                                         "rotation": 0.3}
    materials[1].update(emissive=(1.0, 0.5, 0.25), emissive_strength=6.0)
    meshes[1]["translation"] = (0.5, -1.0, 2.0)
    meshes[1]["rotation"] = mp.axis_quat((1, 1, 0), 30.0)
    meshes[1]["scale"] = (1.5, 1.0, 0.5)
    return mp.write_gltf(tmp_path / name, meshes, materials, images,
                         camera=mp.KNOT_CAMERA, light=mp.KNOT_LIGHT,
                         animation=mp.KNOT_SPIN, **kw)


CASES = {
    "cube_base64_png": lambda p: sg.make_cube_gltf(str(p / "c.gltf")),
    "cube_glb_png": lambda p: sg.make_cube_gltf(str(p / "c.glb"),
                                                binary=True),
    "cube_untextured": lambda p: sg.make_cube_gltf(str(p / "u.gltf"),
                                                   with_texture=False),
    "ktx2_glb_camera_light": lambda p: _writer_model(p, "k.glb"),
    "ktx2_external_buffer": lambda p: _writer_model(p, "k.gltf",
                                                    external_buffer=True),
    "png_base64": lambda p: _writer_model(p, "k.gltf", image_format="png"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_load_gltf_equals_jax(tmp_path, case):
    path = str(CASES[case](tmp_path))
    own, ref = tgltf.load_gltf(path), JLOAD(path)
    assert_same(own, ref)
    if case.startswith(("ktx2", "png")):
        assert own.cameras and own.lights and own.animations
        assert own.textures[0].shape == (16, 16, 4)
        np.testing.assert_array_equal(own.textures[0], mp.base_color_map(16))
        assert own.materials[1].emissive == (6.0, 3.0, 1.5)
        assert not np.array_equal(own.meshes[1].transform, np.eye(4))


def _extension_doc(kind):
    doc = ga.tri_mesh_doc()
    if kind == "emissive":
        doc["materials"] = [{
            "emissiveFactor": [1.0, 0.5, 0.25],
            "extensions": {"KHR_materials_emissive_strength":
                           {"emissiveStrength": 8.0}}}]
        doc["meshes"][0]["primitives"][0]["material"] = 0
    else:
        doc["extensions"] = {"KHR_lights_punctual": {"lights": [
            {"type": "point", "color": [1, 0.5, 1], "intensity": 3.0},
            {"type": "directional", "intensity": 2.0}]}}
        doc["nodes"] = [
            {"mesh": 0},
            {"translation": [1, 2, 3],
             "extensions": {"KHR_lights_punctual": {"light": 0}}},
            {"extensions": {"KHR_lights_punctual": {"light": 1}}},
        ]
        doc["scenes"] = [{"nodes": [0, 1, 2]}]
    return doc


@pytest.mark.parametrize("kind", ["emissive", "lights"])
def test_extension_documents_equal_jax(tmp_path, kind):
    path = ga.write_gltf(tmp_path, _extension_doc(kind))
    assert_same(tgltf.load_gltf(path), JLOAD(path))


def test_texture_transform_equals_jax():
    uv = np.random.default_rng(3).uniform(-1, 2, (50, 2)).astype(np.float32)
    for tt in ({"offset": [0.5, 0.25], "scale": [2.0, 2.0]},
               {"rotation": 0.7}, {"offset": [0.1, -0.2], "rotation": -1.1,
                                   "scale": [0.5, 3.0]}):
        assert_same(tgltf._apply_texture_transform(uv, tt),
                    jgltf._apply_texture_transform(uv, tt))


def _pose_case(kind, tmp_path, monkeypatch):
    if kind == "trs":
        return ga.write_gltf(tmp_path, ga.tri_mesh_doc(), "trs.gltf")
    if kind == "skin":
        return written(ga.TestSkinning().make_skinned, tmp_path,
                       monkeypatch)
    if kind == "morph":
        return written(ga.TestMorphTargets().make_morph, tmp_path,
                       monkeypatch, default_weights=[0.5])
    if kind == "morph_normals":
        return written(ga.TestMorphNormals().make_morph_n, tmp_path,
                       monkeypatch, default_weights=[0.25])
    return _writer_model(tmp_path, "spin.glb")


@pytest.mark.parametrize("kind", ["trs", "skin", "morph", "morph_normals",
                                  "knot_spin"])
def test_pose_meshes_equal_jax(tmp_path, monkeypatch, kind):
    path = _pose_case(kind, tmp_path, monkeypatch)
    own, ref = tgltf.load_gltf(path), JLOAD(path)
    assert_same(own, ref)
    moved = []
    for t in (0.0, 0.37, 1.0):
        assert_same(tgltf.sample_animation(own.animations[0], t),
                    jgltf.sample_animation(ref.animations[0], t))
        over = tgltf.sample_animation(own.animations[0], t)
        assert_same(tgltf.node_world_transforms(own, over),
                    jgltf.node_world_transforms(ref, over))
        posed = tgltf.pose_meshes(own, t)
        assert_same(posed, jgltf.pose_meshes(ref, t), f"pose t={t}")
        moved.append(posed[0][1])
    assert not np.array_equal(moved[0], moved[2])

"""The port's OBJ / PLY loader (`optix_raytracer_tpu_torch/io/meshio.py`)
and KTX2 codec (`io/ktx2.py`) against the JAX package's.

Each file loads through the native parser (`native/mesh_loader.cpp`, which
the port builds alone under `optix_raytracer_tpu_torch/_build/meshio-*/`)
and through the numpy parsers, in both packages: positions, indices,
normals and uvs bit-equal between the packages on each route. The JAX
package's native library is built under the lock of
`torch_parity.jax_native_sah`, and the port's own build moves a per-pid
file into place, so xdist workers never load a half-written library.
KTX2 files round-trip both ways between the packages for every channel
count, sRGB flag and supercompression scheme. A few seconds.
"""
import numpy as np
import pytest

from optix_raytracer_tpu.io import ktx2 as jktx2
from optix_raytracer_tpu.io import meshio as jmeshio
from optix_raytracer_tpu_torch.io import ktx2, meshio
from optix_raytracer_tpu_torch.tools import model_probe as mp

from torch_parity import jax_native_sah  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_native_sah")

OBJ_POLYGONS = """# quads, a pentagon, negative indices, mixed corners
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 1.5 0.25
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
vn 0 0.6 0.8
f 1/1/1 2/2/1 3/3/1 4/4/1
f -5/-4/-2 -3/-2/-1 -1/-1/-1
f 1 2 3 5 4
g ignored
s off
"""


def _model(tmp_path, kind):
    meshes, _, _ = mp.knot_model(7, 5, tex_size=8)
    knot = meshes[0]
    v, f = knot["positions"], knot["indices"]
    n, uv = knot["normals"], knot["uvs"]
    if kind == "obj":
        return mp.write_obj(tmp_path / "k.obj", v, f, n, uv)
    if kind == "obj_positions":
        return mp.write_obj(tmp_path / "p.obj", v, f)
    if kind == "obj_polygons":
        p = tmp_path / "poly.obj"
        p.write_text(OBJ_POLYGONS)
        return str(p)
    if kind == "ply_binary":
        return mp.write_ply(tmp_path / "b.ply", v, f, n, uv)
    if kind == "ply_binary_positions":
        return mp.write_ply(tmp_path / "bp.ply", v, f)
    if kind == "ply_ascii":
        return mp.write_ply(tmp_path / "a.ply", v, f, n, uv, binary=False)
    if kind == "ply_ascii_uvs":
        return mp.write_ply(tmp_path / "au.ply", v, f, None, uv,
                            binary=False)
    raise ValueError(kind)


def _assert_tuple_equal(own, ref, what):
    for name, a, b in zip(("positions", "indices", "normals", "uvs"), own,
                          ref):
        if a is None or b is None:
            assert a is None and b is None, (what, name)
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, (what, name)
        assert a.tobytes() == b.tobytes(), (what, name)


KINDS = ["obj", "obj_positions", "obj_polygons", "ply_binary",
         "ply_binary_positions", "ply_ascii", "ply_ascii_uvs"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("native", [True, False])
def test_load_mesh_equals_jax(tmp_path, kind, native):
    path = str(_model(tmp_path, kind))
    if native:
        assert meshio.native_available()
    own = meshio.load_mesh(path, prefer_native=native)
    ref = jmeshio.load_mesh(path, prefer_native=native)
    _assert_tuple_equal(own, ref, f"{kind} native={native}")
    assert own[1].shape[1] == 3 and own[1].max() < own[0].shape[0]
    if kind == "obj_polygons":
        assert own[1].shape == (6, 3)


def test_native_and_numpy_parsers_agree(tmp_path):
    """The two routes of the port give the same tuple on the writer's
    files (9-digit decimals: the parse rounds alike). On obj_polygons they
    differ in both packages: the numpy parser keys a corner by its text,
    so a negative index makes a second vertex where the native parser
    resolves it to the first."""
    for kind in KINDS:
        if kind == "obj_polygons":
            continue
        path = str(_model(tmp_path, kind))
        _assert_tuple_equal(meshio.load_mesh(path),
                            meshio.load_mesh(path, prefer_native=False),
                            kind)


@pytest.mark.parametrize("text,ext", [
    ("v 0 0 0\nv 1 0 0\n", ".obj"),
    ("ply\nformat binary_big_endian 1.0\nend_header\n", ".ply"),
    ("ply\nformat ascii 1.0\nelement vertex 3\nproperty float x\n"
     "property float y\nproperty float z\nelement face 1\nproperty list "
     "uchar int vertex_indices\nend_header\n0 0 0\n1 0 0\n0 1 0\n3 0 1 7\n",
     ".ply"),
    ("not a mesh", ".stl")])
def test_malformed_files_raise_like_jax(tmp_path, text, ext):
    p = tmp_path / f"bad{ext}"
    p.write_text(text)
    for native in (True, False):
        with pytest.raises(ValueError):
            meshio.load_mesh(str(p), prefer_native=native)
        with pytest.raises(ValueError):
            jmeshio.load_mesh(str(p), prefer_native=native)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("scheme", ["NONE", "ZLIB", "ZSTD"])
@pytest.mark.parametrize("srgb", [False, True])
def test_ktx2_round_trips_between_packages(tmp_path, channels, scheme, srgb):
    img = np.random.default_rng(channels).integers(
        0, 256, (9, 13, channels), dtype=np.uint8)
    for writer, reader, name in ((jktx2, ktx2, "jax_to_port"),
                                 (ktx2, jktx2, "port_to_jax")):
        p = str(tmp_path / f"{name}.ktx2")
        writer.write_ktx2(p, img, srgb=srgb, supercompression=scheme)
        back, s = reader.read_ktx2(p)
        assert s == srgb and back.dtype == np.uint8
        np.testing.assert_array_equal(back, img)
        with open(p, "rb") as f:
            raw = f.read()
        assert ktx2.is_ktx2(raw) and jktx2.is_ktx2(raw)
        np.testing.assert_array_equal(ktx2.read_ktx2_rgba(raw),
                                      jktx2.read_ktx2_rgba(raw))
    # both writers write the same bytes (zstd's frame aside)
    if scheme != "ZSTD":
        a, b = tmp_path / "a.ktx2", tmp_path / "b.ktx2"
        jktx2.write_ktx2(str(a), img, srgb=srgb, supercompression=scheme)
        ktx2.write_ktx2(str(b), img, srgb=srgb, supercompression=scheme)
        assert a.read_bytes() == b.read_bytes()


def test_ktx2_refusals_match_jax(tmp_path):
    p = str(tmp_path / "t.ktx2")
    ktx2.write_ktx2(p, np.zeros((4, 4, 4), np.uint8),
                    supercompression="NONE")
    raw = bytearray(open(p, "rb").read())
    raw[12:16] = (0).to_bytes(4, "little")          # vkFormat 0: BasisLZ
    for mod in (ktx2, jktx2):
        with pytest.raises(NotImplementedError):
            mod.read_ktx2(bytes(raw))
        with pytest.raises(ValueError):
            mod.read_ktx2(b"not a ktx2 file at all")
        with pytest.raises(ValueError):
            mod.read_ktx2(p, level=1)

"""Model files written in-process, and the loaded-model phases of
`chip_smoke.py` (s1-s4).

The repository ships no asset: a model is written here, as the reference's
tests write theirs (`tests/test_scene_gltf.py:14`,
`tests/test_gltf_animation.py:30`). `write_gltf` writes .gltf (a base64 or
an external buffer) or .glb with meshes of positions, indices and optional
normals and uvs, pbrMetallicRoughness materials, images as KTX2
(KHR_texture_basisu, `io/ktx2.py`, needing no image package) or PNG, a
perspective camera, a KHR_lights_punctual light and a rotation animation;
`write_obj` / `write_ply` write the other two formats. `knot_model` is the
25,202-triangle knot of `builtins.knot_mesh` with uvs and a base-colour map.
"""
from __future__ import annotations

import base64
import json
import os
import struct

import numpy as np

from ..io import ktx2
from ..scene.builtins import knot_mesh


def look_at_matrix(eye, lookat, up) -> np.ndarray:
    """[4, 4] node matrix whose -Z looks from `eye` toward `lookat` (the
    glTF camera / light convention)."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(lookat, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    up2 = np.cross(right, fwd)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, up2, -fwd, eye
    return m.astype(np.float32)


def axis_quat(axis, degrees) -> list:
    """The (x, y, z, w) quaternion of a rotation about `axis`."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    h = np.radians(degrees) / 2.0
    return [*(a * np.sin(h)).tolist(), float(np.cos(h))]


def _png(rgba) -> bytes:
    import io
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(np.asarray(rgba, np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


def _ktx2_bytes(rgba, supercompression="ZLIB") -> bytes:
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "t.ktx2")
        ktx2.write_ktx2(p, np.asarray(rgba, np.uint8),
                        supercompression=supercompression)
        with open(p, "rb") as f:
            return f.read()


def write_gltf(path, meshes, materials=(), images=(), image_format="ktx2",
               camera=None, light=None, animation=None,
               external_buffer=False):
    """Write a glTF 2.0 model: .glb when `path` ends so, else .gltf with a
    base64 buffer (or, with external_buffer, a .bin beside it).

    meshes: dicts of positions [V, 3], indices [M, 3], optional normals
    [V, 3], uvs [V, 2], material (index), matrix ([4, 4] node transform) or
    translation / rotation / scale, name. materials: dicts of base_color
    (4), metallic, roughness, emissive (3), emissive_strength, base_tex
    (image index), texture_transform (dict), alpha_mode, alpha_cutoff.
    images: uint8 [H, W, 4] written as KTX2 (ZLIB) or PNG. camera: dict of
    eye, lookat, up, yfov (radians), aspect. light: dict of kind ("point" /
    "directional"), eye, lookat (the node's -Z), color, intensity.
    animation: dict of mesh (index), times, rotations (x, y, z, w per
    key). → path."""
    blob = bytearray()
    views, accessors = [], []

    def add(arr, comp, type_, target=None):
        arr = np.ascontiguousarray(arr)
        while len(blob) % 4:
            blob.append(0)
        view = {"buffer": 0, "byteOffset": len(blob),
                "byteLength": arr.nbytes}
        if target is not None:
            view["target"] = target
        views.append(view)
        blob.extend(arr.tobytes())
        count = arr.shape[0] if arr.ndim else 1
        acc = {"bufferView": len(views) - 1, "componentType": comp,
               "count": int(count), "type": type_}
        if type_ == "VEC3" and comp == 5126 and target == 34962:
            acc["min"] = arr.min(axis=0).tolist()
            acc["max"] = arr.max(axis=0).tolist()
        accessors.append(acc)
        return len(accessors) - 1

    nodes, gl_meshes = [], []
    for i, m in enumerate(meshes):
        attrs = {"POSITION": add(np.asarray(m["positions"], np.float32),
                                 5126, "VEC3", 34962)}
        if m.get("normals") is not None:
            attrs["NORMAL"] = add(np.asarray(m["normals"], np.float32),
                                  5126, "VEC3", 34962)
        if m.get("uvs") is not None:
            attrs["TEXCOORD_0"] = add(np.asarray(m["uvs"], np.float32),
                                      5126, "VEC2", 34962)
        prim = {"attributes": attrs,
                "indices": add(np.asarray(m["indices"], np.uint32)
                               .reshape(-1), 5125, "SCALAR", 34963)}
        if m.get("material") is not None:
            prim["material"] = int(m["material"])
        gl_meshes.append({"name": m.get("name", f"mesh{i}"),
                          "primitives": [prim]})
        node = {"mesh": i}
        if m.get("matrix") is not None:
            node["matrix"] = np.asarray(m["matrix"], np.float32).T.reshape(
                -1).tolist()
        for key in ("translation", "rotation", "scale"):
            if m.get(key) is not None:
                node[key] = [float(x) for x in m[key]]
        nodes.append(node)

    doc = {"asset": {"version": "2.0"}, "scene": 0,
           "meshes": gl_meshes, "accessors": accessors,
           "bufferViews": views}
    gl_mats = []
    for m in materials:
        pbr = {"baseColorFactor": list(m.get("base_color", (1, 1, 1, 1))),
               "metallicFactor": float(m.get("metallic", 0.0)),
               "roughnessFactor": float(m.get("roughness", 1.0))}
        if m.get("base_tex", -1) >= 0:
            pbr["baseColorTexture"] = {"index": int(m["base_tex"])}
            if m.get("texture_transform"):
                pbr["baseColorTexture"]["extensions"] = {
                    "KHR_texture_transform": m["texture_transform"]}
        mat = {"pbrMetallicRoughness": pbr}
        if m.get("emissive") is not None:
            mat["emissiveFactor"] = list(m["emissive"])
        if m.get("emissive_strength") is not None:
            mat["extensions"] = {"KHR_materials_emissive_strength": {
                "emissiveStrength": float(m["emissive_strength"])}}
        if m.get("alpha_mode"):
            mat["alphaMode"] = m["alpha_mode"]
            mat["alphaCutoff"] = float(m.get("alpha_cutoff", 0.5))
        gl_mats.append(mat)
    if gl_mats:
        doc["materials"] = gl_mats
    ext_used = []
    if len(images):
        gl_images, gl_tex = [], []
        for k, img in enumerate(images):
            if image_format == "ktx2":
                raw, mime = _ktx2_bytes(img), "image/ktx2"
                gl_tex.append({"extensions": {
                    "KHR_texture_basisu": {"source": k}}})
            else:
                raw, mime = _png(img), "image/png"
                gl_tex.append({"source": k})
            while len(blob) % 4:
                blob.append(0)
            views.append({"buffer": 0, "byteOffset": len(blob),
                          "byteLength": len(raw)})
            blob.extend(raw)
            gl_images.append({"bufferView": len(views) - 1,
                              "mimeType": mime})
        doc["images"], doc["textures"] = gl_images, gl_tex
        if image_format == "ktx2":
            ext_used.append("KHR_texture_basisu")
    if camera is not None:
        doc["cameras"] = [{"type": "perspective", "perspective": {
            "yfov": float(camera["yfov"]),
            "aspectRatio": float(camera.get("aspect", 1.0)),
            "znear": 0.01}}]
        nodes.append({"camera": 0, "matrix": look_at_matrix(
            camera["eye"], camera["lookat"],
            camera.get("up", (0, 1, 0))).T.reshape(-1).tolist()})
    if light is not None:
        doc["extensions"] = {"KHR_lights_punctual": {"lights": [{
            "type": light["kind"], "color": list(light.get("color",
                                                           (1, 1, 1))),
            "intensity": float(light.get("intensity", 1.0))}]}}
        nodes.append({"extensions": {"KHR_lights_punctual": {"light": 0}},
                      "matrix": look_at_matrix(
                          light["eye"], light["lookat"],
                          light.get("up", (0, 1, 0))).T.reshape(-1)
                      .tolist()})
        ext_used.append("KHR_lights_punctual")
    if animation is not None:
        t_acc = add(np.asarray(animation["times"], np.float32), 5126,
                    "SCALAR")
        accessors[t_acc]["min"] = [float(min(animation["times"]))]
        accessors[t_acc]["max"] = [float(max(animation["times"]))]
        r_acc = add(np.asarray(animation["rotations"], np.float32), 5126,
                    "VEC4")
        doc["animations"] = [{"name": "spin", "channels": [
            {"sampler": 0, "target": {"node": int(animation["mesh"]),
                                      "path": "rotation"}}],
            "samplers": [{"input": t_acc, "output": r_acc,
                          "interpolation": "LINEAR"}]}]
    if ext_used:
        doc["extensionsUsed"] = ext_used
    doc["nodes"] = nodes
    doc["scenes"] = [{"nodes": list(range(len(nodes)))}]
    path = os.fspath(path)
    blob = bytes(blob) + b"\x00" * ((4 - len(blob) % 4) % 4)
    if path.lower().endswith(".glb"):
        doc["buffers"] = [{"byteLength": len(blob)}]
        js = json.dumps(doc).encode()
        js += b" " * ((4 - len(js) % 4) % 4)
        with open(path, "wb") as f:
            f.write(struct.pack("<III", 0x46546C67, 2,
                                12 + 8 + len(js) + 8 + len(blob)))
            f.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
            f.write(struct.pack("<II", len(blob), 0x004E4942) + blob)
        return path
    if external_buffer:
        name = os.path.splitext(os.path.basename(path))[0] + ".bin"
        with open(os.path.join(os.path.dirname(os.path.abspath(path)),
                               name), "wb") as f:
            f.write(blob)
        doc["buffers"] = [{"uri": name, "byteLength": len(blob)}]
    else:
        doc["buffers"] = [{"uri": "data:application/octet-stream;base64,"
                           + base64.b64encode(blob).decode(),
                           "byteLength": len(blob)}]
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def write_obj(path, positions, indices, normals=None, uvs=None):
    """An OBJ with v / vt / vn lines and faces indexing all three alike."""
    lines = [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in positions]
    if uvs is not None:
        lines += [f"vt {u:.9g} {v:.9g}" for u, v in uvs]
    if normals is not None:
        lines += [f"vn {x:.9g} {y:.9g} {z:.9g}" for x, y, z in normals]

    def corner(i):
        i += 1
        if normals is not None:
            return f"{i}/{i if uvs is not None else ''}/{i}"
        return f"{i}/{i}" if uvs is not None else f"{i}"

    lines += ["f " + " ".join(corner(int(i)) for i in tri)
              for tri in indices]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def write_ply(path, positions, indices, normals=None, uvs=None,
              binary=True):
    """A PLY (binary little-endian or ASCII) with x y z [nx ny nz] [u v]
    vertices and uchar-count int-index faces."""
    cols = [np.asarray(positions, np.float32)]
    props = ["x", "y", "z"]
    if normals is not None:
        cols.append(np.asarray(normals, np.float32))
        props += ["nx", "ny", "nz"]
    if uvs is not None:
        cols.append(np.asarray(uvs, np.float32))
        props += ["u", "v"]
    vert = np.concatenate(cols, axis=1)
    idx = np.asarray(indices, np.int32).reshape(-1, 3)
    fmt = "binary_little_endian" if binary else "ascii"
    head = (["ply", f"format {fmt} 1.0", f"element vertex {len(vert)}"]
            + [f"property float {p}" for p in props]
            + [f"element face {len(idx)}",
               "property list uchar int vertex_indices", "end_header"])
    with open(path, "wb") as f:
        f.write(("\n".join(head) + "\n").encode())
        if binary:
            f.write(vert.astype("<f4").tobytes())
            face = np.zeros(len(idx), dtype=[("n", "u1"), ("i", "<i4", 3)])
            face["n"], face["i"] = 3, idx
            f.write(face.tobytes())
        else:
            f.write("".join(" ".join(f"{x:.9g}" for x in row) + "\n"
                            for row in vert).encode())
            f.write("".join(f"3 {a} {b} {c}\n" for a, b, c in idx).encode())
    return path


def base_color_map(size=256, seed=5) -> np.ndarray:
    """uint8 [size, size, 4] base-colour map: a checker of two seeded
    colours with a soft gradient, alpha 255."""
    rng = np.random.default_rng(seed)
    c0, c1 = rng.integers(40, 250, (2, 3))
    y, x = np.mgrid[0:size, 0:size]
    check = ((x // (size // 8)) + (y // (size // 8))) % 2
    img = np.where(check[..., None] == 0, c0, c1).astype(np.float32)
    img *= (0.6 + 0.4 * x / max(size - 1, 1))[..., None]
    out = np.full((size, size, 4), 255, np.uint8)
    out[..., :3] = np.clip(img, 0, 255).astype(np.uint8)
    return out


# The knot model's camera (builtins.knot_camera's view) and light.
KNOT_CAMERA = dict(eye=(0.0, 2.5, -9.0), lookat=(0.0, 0.0, 0.0),
                   up=(0.0, 1.0, 0.0), yfov=float(np.radians(45.0)),
                   aspect=1.0)
KNOT_LIGHT = dict(kind="directional", eye=(0.0, 0.0, 0.0),
                  lookat=(-0.4, -0.7, -0.6), color=(1.0, 0.95, 0.9),
                  intensity=2.0)
KNOT_SPIN = dict(mesh=0, times=[0.0, 1.0],
                 rotations=[axis_quat((0, 1, 0), 0.0),
                            axis_quat((0, 1, 0), 90.0)])


def knot_model(segments=200, sides=63, tex_size=256):
    """builtins.knot_mesh's knot and floor as two meshes with vertex
    normals and uvs (around and along the tube; the floor's corners), a
    textured PBR material on the knot and a diffuse floor → (meshes,
    materials, images)."""
    verts, idx, normals, tri_mat, _ = knot_mesh(segments, sides)
    n_knot = segments * sides
    seg = np.repeat(np.arange(segments), sides)
    side = np.tile(np.arange(sides), segments)
    uv_knot = np.stack([seg / segments, side / sides], axis=1)
    knot_tris = idx[tri_mat == 0]
    floor_tris = idx[tri_mat == 1] - n_knot
    meshes = [
        dict(positions=verts[:n_knot], indices=knot_tris,
             normals=normals[:n_knot], uvs=uv_knot.astype(np.float32),
             material=0, name="knot"),
        dict(positions=verts[n_knot:], indices=floor_tris,
             normals=normals[n_knot:],
             uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
             material=1, name="floor")]
    materials = [dict(base_color=(1.0, 1.0, 1.0, 1.0), metallic=0.0,
                      roughness=0.6, base_tex=0),
                 dict(base_color=(0.65, 0.65, 0.70, 1.0), metallic=0.0,
                      roughness=1.0)]
    return meshes, materials, [base_color_map(tex_size)]


def write_knot_model(path, segments=200, sides=63, tex_size=256,
                     image_format="ktx2", animate=True):
    """The knot model with its camera, light and (animate) spin as a glTF
    file → (path, meshes, materials, images)."""
    meshes, materials, images = knot_model(segments, sides, tex_size)
    write_gltf(path, meshes, materials, images, image_format=image_format,
               camera=KNOT_CAMERA, light=KNOT_LIGHT,
               animation=KNOT_SPIN if animate else None)
    return path, meshes, materials, images


def added_scene(meshes, materials, images, camera):
    """The host Scene of the same arrays through add_material / add_texture
    / add_mesh / add_camera, with the materials `Scene.load` makes of the
    glTF ones (PBR where textured or metallic, else DIFFUSE)."""
    from ..scene.scene import Scene
    from ..shade import materials as mats
    sc = Scene()
    for m in materials:
        tex = int(m.get("base_tex", -1))
        metallic = float(m.get("metallic", 0.0))
        sc.add_material({
            "kind": mats.PBR if (metallic > 0.0 or tex >= 0)
            else mats.DIFFUSE,
            "base_color": tuple(m["base_color"][:3]),
            "metallic": metallic, "roughness": float(m["roughness"]),
            "emission": (0.0, 0.0, 0.0), "base_tex": tex, "normal_tex": -1,
            "mr_tex": -1, "emissive_tex": -1,
            "alpha_mode": mats.ALPHA_OPAQUE, "alpha_cutoff": 0.5,
            "cutout": mats.CUT_NONE})
    for img in images:
        sc.add_texture(img)
    for m in meshes:
        sc.add_mesh(m["positions"], m["indices"], m.get("normals"),
                    m.get("uvs"), material=int(m["material"]),
                    name=m.get("name", ""))
    sc.add_camera(camera)
    return sc


# ------------------------------------------------------------------------
# chip_smoke.py's phases s1-s4: each path at its app's CLI defaults.

# s1: the knot model through the meshviewer (its defaults: 768x768, 8
# samples, depth 3), and --animate 3 at 2 samples a frame.
S1 = dict(segments=200, sides=63, tex=256, width=768, height=768, spl=8,
          depth=3, frames=3, frame_spl=2)
# s2: the viewer's defaults (the Cornell box, 768x768, spf 2^2, depth 4, 8
# frames), then 4 frames of --model.
S2 = dict(width=768, height=768, spf_log2=2, depth=4, frames=8,
          model_frames=4)
# s3: four instances of the 25,202-triangle knot through the meshviewer's
# rig (768x768, 8 samples, depth 3) and one path-traced launch (16 spp,
# depth 4).
S3 = dict(segments=200, sides=63, width=768, height=768, spl=8, depth=3,
          pt_spl=16, pt_depth=4)
S3_CAMERA = dict(eye=(0.0, 9.0, -26.0), lookat=(0.0, 0.0, 0.0),
                 up=(0.0, 1.0, 0.0), fov_y=40.0)
S3_LIGHT = ((-12.0, 14.0, -12.0), (24.0, 0.0, 0.0), (0.0, 0.0, 24.0),
            (6.0, 6.0, 6.0))


def _sync(dev):
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def timed(dev, fn, *args, **kw):
    """(fn's result, seconds by the host clock, synchronised)."""
    import time
    _sync(dev)
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    _sync(dev)
    return out, time.perf_counter() - t0


def _busy_us(events):
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + (cur_e - cur_s if cur_e is not None else 0.0)


def profiled(dev, fn, *args, **kw):
    """fn under torch.profiler → (its result, dict(torch_kernels: device
    kernels and copies it ran, busy_ms: the union of their intervals)).
    Without a card both are 0: the CPU has no device timeline."""
    import torch
    if torch.device(dev).type != "cuda":
        return fn(*args, **kw), dict(torch_kernels=0, busy_ms=0.0)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    _sync(dev)
    with torch.profiler.profile(activities=acts) as prof:
        out = fn(*args, **kw)
        _sync(dev)
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    return out, dict(torch_kernels=len(ev), busy_ms=_busy_us(ev) / 1e3)


def device_share(prof, ms):
    """Kernels and idle share of one unit of work (a sample, a frame) whose
    unprofiled time is `ms`: idle = 1 - busy / ms."""
    return dict(torch_kernels=prof["torch_kernels"],
                busy_ms=prof["busy_ms"],
                idle_share=max(0.0, 1.0 - prof["busy_ms"] / ms) if ms else 0.0)


def launched() -> dict:
    from .. import kernels
    return {k: v for k, v in kernels.LAUNCHES.items() if v}


def reset_launches():
    from .. import kernels
    kernels.reset_launches()


def run_main(app, argv) -> str:
    """app.main(argv) with its standard output kept → its last line."""
    import io
    from contextlib import redirect_stdout
    buf = io.StringIO()
    with redirect_stdout(buf):
        ret = app.main(argv)
    lines = buf.getvalue().strip().splitlines()
    return (lines[-1] if lines else ""), ret


def _fail(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def knot_files(out_dir, cfg=S1):
    """The knot model as .glb (KTX2 map, camera, light, spin) and the same
    knot and floor as one OBJ → (glb, obj, meshes, materials, images)."""
    os.makedirs(out_dir, exist_ok=True)
    glb, meshes, materials, images = write_knot_model(
        os.path.join(out_dir, "knot.glb"), cfg["segments"], cfg["sides"],
        cfg["tex"])
    v, f, n, uv = merged(meshes)
    obj = write_obj(os.path.join(out_dir, "knot.obj"), v, f, n, uv)
    return glb, obj, meshes, materials, images


def merged(meshes):
    """The meshes' arrays concatenated → (positions, indices, normals,
    uvs)."""
    base, idx = 0, []
    for m in meshes:
        idx.append(np.asarray(m["indices"]) + base)
        base += len(m["positions"])
    return (np.concatenate([m["positions"] for m in meshes]),
            np.concatenate(idx),
            np.concatenate([m["normals"] for m in meshes]),
            np.concatenate([m["uvs"] for m in meshes]))


def obj_case(obj, meshes):
    """The OBJ through the native parser: every triangle corner's position,
    normal and uv bit-equal to the written arrays → dict."""
    import time
    from ..io import meshio
    from ..scene.scene import Scene
    _fail(meshio.native_available(), "s1: the native mesh parser is not "
                                     "available (no g++?)")
    t0 = time.perf_counter()
    pos, idx, nrm, uv = meshio.load_mesh(obj)
    load_s = time.perf_counter() - t0
    v, f, n, t = merged(meshes)
    for name, got, want in (("positions", pos, v), ("normals", nrm, n),
                            ("uvs", uv, t)):
        _fail(got is not None and np.array_equal(got[idx], want[f]),
              f"s1: the OBJ's {name} differ from the written arrays")
    host = Scene.load(obj)
    _fail(sum(len(m.indices) for m in host.meshes) == len(f),
          "s1: Scene.load of the OBJ lost triangles")
    return dict(triangles=int(len(f)), vertices=int(len(pos)),
                native_load_ms=1e3 * load_s)


def loaded_model_case(dev, out_dir, cfg=S1, query_check=None):
    """Phase s1 → (row, launches of the meshviewer's render of the .glb).
    query_check(cluster table, recorded call, what) → dict holds a first
    sample query against the kernels' plain versions (chip_smoke's
    whitted_query_parity); None skips it."""
    import torch
    from ..apps import meshviewer
    from ..io.image import load_image
    from ..scene.scene import Scene
    from ..wavefront.whitted import render_whitted
    from .whitted_probe import recorded_queries
    W, H, spl, depth = (cfg[k] for k in ("width", "height", "spl", "depth"))
    (glb, obj, meshes, materials, images), write_s = timed(
        dev, knot_files, out_dir, cfg)
    row = dict(write_s=write_s, **obj_case(obj, meshes))
    (host, load_s) = timed(dev, Scene.load, glb)
    cam = host.default_camera(W, H)
    scene, build_s = timed(dev, host.finalize, dev,
                           lights=meshviewer.headlight_rig(cam))
    _fail(scene.num_triangles == 2 * cfg["segments"] * cfg["sides"] + 2
          and scene.has_clusters and scene.has_textures,
          "s1: the loaded knot has no cluster table or no texture")
    cam_params = cam.params(dev)
    errs = []
    if query_check is not None:
        with recorded_queries() as calls:
            render_whitted(scene, cam_params, W, H, 1, max_depth=depth)
        _fail({c["route"] for c in calls} == {"clusters"},
              "s1: a first-sample query left the cluster table")
        for i, call in enumerate(calls):
            errs.append(query_check(scene.clusters, call,
                                    f"s1 query {i} ({call['kind']})"))
        del calls
    (_, rays_r), dt = timed(dev, render_whitted, scene, cam_params, W, H,
                            spl, max_depth=depth)
    _, prof = profiled(dev, render_whitted, scene, cam_params, W, H, 1,
                       max_depth=depth)
    reset_launches()
    (accum, film, rays), app_s = timed(dev, meshviewer.render, glb, W, H,
                                       samples=spl, max_depth=depth,
                                       device=dev)
    counts = launched()
    img = accum.cpu().numpy()
    _fail(np.isfinite(img).all() and img.mean() > 0 and int(rays)
          == int(rays_r), "s1: the loaded model's image is empty or its "
                          "ray count moved")
    added = added_scene(meshes, materials, images, host.cameras[0])
    (accum2, _, rays2), _ = timed(dev, meshviewer.render, None, W, H,
                                  samples=spl, max_depth=depth, scene=added,
                                  device=dev)
    _fail(torch.equal(accum, accum2) and int(rays) == int(rays2),
          "s1: the .glb's render differs from the same arrays added "
          "through Scene.add_mesh / add_texture")
    said, _ = run_main(meshviewer, [
        "--model", glb, "--dim", f"{W}x{H}", "--samples", "1", "--file",
        os.path.join(out_dir, "model.ppm"), "--device", str(dev)])
    stem = os.path.join(out_dir, "anim.ppm")
    (said_anim, _), anim_s = timed(dev, run_main, meshviewer, [
        "--model", glb, "--animate", str(cfg["frames"]), "--samples",
        str(cfg["frame_spl"]), "--dim", f"{W}x{H}", "--file", stem,
        "--device", str(dev)])
    frames = [load_image(os.path.join(out_dir, f"anim_{i:03d}.ppm"))
              for i in range(cfg["frames"])]
    _fail(all(not np.array_equal(a, b) for i, a in enumerate(frames)
              for b in frames[i + 1:]), "s1: animation frames repeat")
    ms = 1e3 * dt / spl
    row.update(glb_bytes=os.path.getsize(glb), load_s=load_s,
               finalize_s=build_s, triangles=scene.num_triangles,
               clusters=scene.clusters.num_clusters, ms_per_sample=ms,
               app_s=app_s, rays_per_sample=int(rays) // spl,
               image_mean=float(img.mean()), bit_equal_to_added=True,
               query_max_abs_err=max([e["max_abs_err"] for e in errs],
                                     default=None),
               queries_checked=len(errs), anim_frames=len(frames),
               anim_s=anim_s, anim_said=said_anim, said=said,
               **device_share(prof, ms))
    return row, counts


def viewer_case(dev, out_dir, glb, cfg=S2):
    """Phase s2 → (row, launches of the Cornell run, launches of the
    --model run). The headless viewer at its defaults: its film bit-equal
    to the same launches of render_accumulate on a new film and within the
    parity bars of one launch of all the samples; a --checkpoint /
    --resume split bit-equal to the straight run; then --model frames of
    the .glb through the Whitted integrator."""
    import torch
    from ..apps import viewer
    from ..core.film import Film
    from ..wavefront.engine import render_accumulate
    W, H, depth, frames = (cfg[k] for k in ("width", "height", "depth",
                                            "frames"))
    spf = 1 << cfg["spf_log2"]
    common = ["--dim", f"{W}x{H}", "--spf", str(cfg["spf_log2"]), "--depth",
              str(depth), "--device", str(dev)]
    ppm = os.path.join(out_dir, "viewer.ppm")
    reset_launches()
    (said, (v, img)), dt = timed(dev, run_main, viewer,
                                 common + ["--frames", str(frames), "--file",
                                           ppm])
    counts = launched()
    _fail(int(v.film.subframe) == frames * spf and img.shape == (H, W, 4),
          "s2: the viewer's film holds the wrong sample count")
    cam = v.camera.params(dev)
    film = Film.create(H, W, dev)
    for _ in range(frames):
        film, _ = render_accumulate(v.scene, cam, film, W, H,
                                    samples_per_launch=spf, max_depth=depth)
    _fail(torch.equal(film.accum, v.film.accum),
          "s2: the viewer's film differs from the same render_accumulate "
          "launches")
    one, _ = render_accumulate(v.scene, cam, Film.create(H, W, dev), W, H,
                               samples_per_launch=frames * spf,
                               max_depth=depth)
    a, b = one.accum.cpu().numpy(), v.film.accum.cpu().numpy()
    _fail(np.allclose(a, b, atol=2e-3, rtol=1e-3),
          f"s2: one launch of all the samples differs by "
          f"{np.abs(a - b).max()}")
    ck = os.path.join(out_dir, "viewer.npz")
    half = str(frames // 2)
    run_main(viewer, common + ["--frames", half, "--file", ppm,
                               "--checkpoint", ck])
    _, (v2, _) = run_main(viewer, common + ["--frames", half, "--file", ppm,
                                            "--resume", ck])
    _fail(torch.equal(v2.film.accum, v.film.accum)
          and int(v2.film.subframe) == int(v.film.subframe),
          "s2: the --checkpoint / --resume split differs from the straight "
          "run")
    _, prof = profiled(dev, v.step)
    ms = 1e3 * dt / frames
    row = dict(dim=f"{W}x{H}", spf=spf, depth=depth, frames=frames,
               ms_per_frame=ms, one_launch_max_abs_diff=float(
                   np.abs(a - b).max()), resume_bit_equal=True,
               said=said, **device_share(prof, ms))
    reset_launches()
    (said_m, (vm, img_m)), dt_m = timed(
        dev, run_main, viewer, common + [
            "--frames", str(cfg["model_frames"]), "--model", glb, "--file",
            os.path.join(out_dir, "viewer_model.ppm")])
    model_counts = launched()
    _fail(vm.integrator == "whitted" and img_m.mean() > 1.0
          and int(vm.film.subframe) == cfg["model_frames"],
          "s2: the --model viewer's frames are empty")
    _, prof_m = profiled(dev, vm.step)
    ms_m = 1e3 * dt_m / cfg["model_frames"]
    row.update(model_frames=cfg["model_frames"], model_ms_per_frame=ms_m,
               model_said=said_m,
               **{f"model_{k}": x for k, x in device_share(prof_m,
                                                           ms_m).items()})
    return row, counts, model_counts


def instanced_knot_hosts(cfg=S3):
    """Four instances of knot_mesh's 25,202 triangles (knot and floor)
    under distinct rotations, scales and offsets, each with its own sbt
    offset (0, 2, 4, 6 over eight materials), and the same scene with the
    transforms baked into one flat mesh → (instanced Scene, flat Scene),
    both with S3_CAMERA."""
    from ..core.camera import Camera
    from ..scene.scene import Scene
    verts, idx, normals, tri_mat, _ = knot_mesh(cfg["segments"],
                                                cfg["sides"])
    xfs = []
    for k, (pos, axis, deg, s) in enumerate((
            ((-5.5, 0.0, -2.0), (0, 1, 0), 20.0, 1.0),
            ((5.5, 0.5, -1.0), (1, 0, 0.3), -35.0, 0.8),
            ((-4.0, 1.0, 6.0), (0.2, 1, 0.5), 70.0, 0.9),
            ((4.5, -0.5, 7.0), (0, 0.4, 1), 120.0, 1.1))):
        x, y, z, w = axis_quat(axis, deg)
        r = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                       2 * (x * z + y * w)],
                      [2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                       2 * (y * z - x * w)],
                      [2 * (x * z - y * w), 2 * (y * z + x * w),
                       1 - 2 * (x * x + y * y)]])
        t = np.eye(4, dtype=np.float32)
        t[:3, :3] = r * s
        t[:3, 3] = pos
        xfs.append((t, 2 * k))
    rng = np.random.default_rng(3)
    mats = [{"kind": 0, "base_color": tuple(float(c) for c in
                                            rng.uniform(0.2, 0.9, 3))}
            for _ in range(8)]
    cam = Camera(**S3_CAMERA)
    inst, flat = Scene(), Scene()
    for sc in (inst, flat):
        for m in mats:
            sc.add_material(m)
        sc.add_camera(cam)
    mi = inst.add_mesh(verts, idx, normals=normals, material=tri_mat)
    for t, sbt in xfs:
        inst.add_instance(mi, t, sbt_offset=sbt)
        flat.add_mesh(verts, idx, normals=normals, material=tri_mat + sbt,
                      transform=t)
    return inst, flat


def instanced_case(dev, cfg=S3, query_check=None):
    """Phase s3 → (row, launches of the instanced Whitted render, launches
    of the instanced path-traced launch). query_check as
    loaded_model_case's, on each instance's first-bounce closest and
    any-hit sets."""
    import torch
    from ..apps import meshviewer
    from ..core.film import Film
    from ..shade.lights import ParallelogramLight
    from ..wavefront.engine import render_accumulate
    from ..wavefront.whitted import render_whitted
    from .whitted_probe import recorded_queries
    W, H, spl, depth = (cfg[k] for k in ("width", "height", "spl", "depth"))
    inst, flat = instanced_knot_hosts(cfg)
    cam = inst.default_camera(W, H)
    lights = meshviewer.headlight_rig(cam)
    scene, build_s = timed(dev, inst.finalize, dev, lights=lights)
    per = 2 * cfg["segments"] * cfg["sides"] + 2
    _fail(list(scene.instance_clusters) == [(0, per)]
          and scene.instances.num == 4, "s3: no per-mesh cluster table")
    cam_params = cam.params(dev)
    errs = []
    if query_check is not None:
        with recorded_queries() as calls:
            render_whitted(scene, cam_params, W, H, 1, max_depth=1)
        table = scene.instance_clusters[(0, per)]
        _fail(len(calls) == 4 * (1 + len(lights))
              and all(c["cl"] is table for c in calls),
              f"s3: {len(calls)} first-bounce queries, or one left the "
              f"instance table")
        for i, call in enumerate(calls):
            errs.append(query_check(table, call, f"s3 query {i} "
                                                 f"({call['kind']})"))
        del calls
    (_, rays_r), dt = timed(dev, render_whitted, scene, cam_params, W, H,
                            spl, max_depth=depth)
    _, prof = profiled(dev, render_whitted, scene, cam_params, W, H, 1,
                       max_depth=depth)
    flips = camera_hit_flips(scene, flat.finalize(dev, lights=lights),
                             cam_params, W, H, per)
    reset_launches()
    (accum, _, rays), app_s = timed(dev, meshviewer.render, None, W, H,
                                    samples=spl, max_depth=depth,
                                    scene=inst, device=dev)
    counts = launched()
    (ref, _, ref_rays), flat_s = timed(dev, meshviewer.render, None, W, H,
                                       samples=spl, max_depth=depth,
                                       scene=flat, device=dev)
    a, b = accum.cpu().numpy(), ref.cpu().numpy()
    bad = ~np.isclose(a, b, atol=2e-3, rtol=1e-3).all(axis=-1)
    light = ParallelogramLight.make(*S3_LIGHT, dev)
    pt_scene = inst.finalize(dev, area_light=light)
    pt_flat = flat.finalize(dev, area_light=light)
    reset_launches()
    (film, pt_rays), pt_s = timed(
        dev, render_accumulate, pt_scene, cam_params, Film.create(H, W, dev),
        W, H, samples_per_launch=cfg["pt_spl"], max_depth=cfg["pt_depth"])
    pt_counts = launched()
    (film_f, pt_rays_f), pt_flat_s = timed(
        dev, render_accumulate, pt_flat, cam_params, Film.create(H, W, dev),
        W, H, samples_per_launch=cfg["pt_spl"], max_depth=cfg["pt_depth"])
    c, d = film.accum.cpu().numpy(), film_f.accum.cpu().numpy()
    pt_bad = ~np.isclose(c, d, atol=2e-3, rtol=1e-3).all(axis=-1)
    _fail(np.isfinite(a).all() and a.mean() > 0 and np.isfinite(c).all()
          and c.mean() > 0, "s3: an instanced image is empty")
    ms = 1e3 * dt / spl
    row = dict(dim=f"{W}x{H}", spl=spl, depth=depth, instances=4,
               triangles_per_instance=per, finalize_s=build_s,
               ms_per_sample=ms, app_s=app_s, flat_app_s=flat_s,
               rays=int(rays), flat_rays=int(ref_rays),
               pixels_outside_bars=int(bad.sum()),
               bit_equal=bool(np.array_equal(a, b)),
               max_abs_diff=float(np.abs(a - b).max()),
               queries_checked=len(errs),
               query_max_abs_err=max([e["max_abs_err"] for e in errs],
                                     default=None), **flips,
               pt_spl=cfg["pt_spl"], pt_depth=cfg["pt_depth"],
               pt_ms_per_sample=1e3 * pt_s / cfg["pt_spl"],
               pt_flat_ms_per_sample=1e3 * pt_flat_s / cfg["pt_spl"],
               pt_rays=int(pt_rays), pt_flat_rays=int(pt_rays_f),
               pt_pixels_outside_bars=int(pt_bad.sum()),
               pt_max_abs_diff=float(np.abs(c - d).max()),
               **device_share(prof, ms))
    return row, counts, pt_counts


def camera_hit_flips(inst_scene, flat_scene, cam_params, w, h, per):
    """The pinhole camera rays' closest hits on the instanced scene and on
    its flat bake (instance k's triangles at rows k * per of the flat
    mesh) → dict(camera_rays, hit_flips: rays that hit in one and miss in
    the other or hit another triangle, max_t_diff over the rays that hit
    the same triangle in both)."""
    import torch
    from ..core.camera import generate_rays
    from ..wavefront.intersect import scene_closest
    rays, _ = generate_rays(cam_params, w, h, jitter=False)
    rays = rays.reshape(w * h)
    a = scene_closest(inst_scene, rays)
    b = scene_closest(flat_scene, rays)
    ida = torch.where(a.valid, a.inst_id.long() * per + a.prim_id, -1)
    idb = torch.where(b.valid, b.prim_id.long(), -1)
    same = (ida == idb) & a.valid
    dt = (a.t - b.t).abs()[same]
    return dict(camera_rays=w * h, hit_flips=int((ida != idb).sum()),
                max_t_diff=float(dt.max()) if dt.numel() else 0.0)


# s4: the apps' CLI defaults (--dim; console's fixed 96x64 at 4 samples).
S4 = dict(hello=(512, 384), triangle=(768, 768),
          custom_primitive=(768, 768), dynamic_materials=(512, 512),
          raycasting=(512, 512))


def small_apps_case(dev, out_dir, glb, dims=S4):
    """Phase s4: hello, triangle, console, custom_primitive,
    dynamic_materials and raycasting (the Cornell box and --model) at their
    CLI defaults through main() → rows, each with its wall time, kernel
    launches, torch kernels and idle share of its render, and where it
    launches a kernel its image held against the plain-version run (bit
    for bit through kernels 1-2 and 4-6's plain versions; the fused
    kernel's against render_sum_plain within the parity bars, equal ray
    counts)."""
    import torch
    from ..apps import (console, custom_primitive, dynamic_materials, hello,
                        raycasting, triangle)
    from ..scene.builtins import cornell_box
    from .whitted_probe import plain_queries
    rows = []

    def run(name, app, argv, render=None):
        reset_launches()
        (said, _), dt = timed(dev, run_main, app, argv + ["--device",
                                                          str(dev)])
        row = dict(app=name, seconds=dt, said=said, launches=launched())
        if render is not None:
            _, r_s = timed(dev, render)
            _, prof = profiled(dev, render)
            row.update(render_ms=1e3 * r_s, **device_share(prof, 1e3 * r_s))
        rows.append(row)
        return row

    def args(name, w, h):
        return ["--file", os.path.join(out_dir, f"{name}.ppm"), "--dim",
                f"{w}x{h}"]

    w, h = dims["hello"]
    run("hello", hello, args("hello", w, h),
        lambda: hello.render(w, h, device=dev))
    w, h = dims["triangle"]
    row = run("triangle", triangle, args("triangle", w, h),
              lambda: triangle.radiance(w, h, device=dev))
    out = triangle.radiance(w, h, device=dev)
    with plain_queries():
        ref = triangle.radiance(w, h, device=dev)
    _fail(torch.equal(out, ref), "s4: triangle differs from kernel 1's "
                                 "plain version")
    row["plain_bit_equal"] = True
    row = run("console", console, ["--samples", "4"],
              lambda: console.render(4, 3, device=dev))
    fused_vs_plain(dev, row, cornell_box(dev), console.WIDTH,
                   console.HEIGHT, 4, 3, console.render(4, 3, device=dev))
    w, h = dims["custom_primitive"]
    run("custom_primitive", custom_primitive,
        args("custom_primitive", w, h),
        lambda: custom_primitive.radiance(w, h, device=dev))
    w, h = dims["dynamic_materials"]
    row = run("dynamic_materials", dynamic_materials,
              args("dynamic_materials", w, h),
              lambda: dynamic_materials.render(w, h, phase=2, device=dev))
    accum, _ = dynamic_materials.render(w, h, phase=2, device=dev)
    fused_vs_plain(dev, row, dynamic_materials.scene_for_phase(2, dev), w, h,
                   8, 3, accum.cpu().numpy())
    w, h = dims["raycasting"]
    for name, model in (("raycasting", None), ("raycasting --model", glb)):
        scene, lo, hi = raycasting.build(model, dev)
        row = run(name, raycasting, args(name.replace(" --", "_"), w, h)
                  + (["--model", model] if model else []),
                  lambda scene=scene, lo=lo, hi=hi: raycasting.render(
                      scene, lo, hi, w, h))
        out, rays, off = raycasting.render(scene, lo, hi, w, h)
        with plain_queries():
            ref = raycasting.render(scene, lo, hi, w, h)[0]
        _fail(torch.equal(out, ref) and float(out.max()) > 0.5,
              f"s4: {name} differs from the plain versions' casts")
        serial, flight = raycasting.measure_overlap(scene, rays, off)
        row.update(plain_bit_equal=True, serial_ms=1e3 * serial,
                   in_flight_ms=1e3 * flight)
    return rows


def fused_vs_plain(dev, row, scene, w, h, spl, depth, img):
    """An app's image of one fused launch from subframe 0 (`img`, the
    film's mean) against the fused kernel and its plain version
    (render_sum_plain) on the same scene and the Cornell camera: all three
    within the parity bars, the kernel's and the plain version's rays
    equal."""
    from ..scene.builtins import cornell_camera
    from ..wavefront import pallas_pt
    cam = cornell_camera(w, h).params(dev)
    rad, rays = pallas_pt.render_sum_fused(scene, cam, w, h, 0,
                                           samples_per_launch=spl,
                                           max_depth=depth)
    ref, ref_rays = pallas_pt.render_sum_plain(scene, cam, w, h, 0, spl,
                                               max_depth=depth)
    a, b = (rad / spl).cpu().numpy(), (ref / spl).cpu().numpy()
    _fail(int(rays) == int(ref_rays)
          and np.allclose(a, b, atol=2e-3, rtol=1e-3)
          and np.allclose(np.asarray(img), a, atol=2e-3, rtol=1e-3),
          f"s4: {row['app']} differs from the fused kernel's plain version "
          f"by {np.abs(a - b).max()}")
    row.update(plain_max_abs_diff=float(np.abs(a - b).max()),
               plain_rays_equal=True)

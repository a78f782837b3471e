"""The two-level column test of the exact cull and the octet cull (kernels 4
and 7, `csrc/clusters.cu::cull_exact_kernel`) in its plain form,
`clusters.cull_admitted_pairs_plain`: a live ray slab-tests a member column
only where it crosses the column's group box (the exact min / max of the
group's regular members), a padding column takes the ray's one test of the
padding box, and a group with another inverted box is admitted whole.

Held here, on the CPU, for each group size the kernels are built for:

- the admitted pairs hold every (ray, column) pair whose exact slab test
  (`clusters._slab_cross`) crosses, on random rays with the edge cases
  (`torch_parity.cull_edge_rays`: +-0 and +-1e-12 direction components,
  rays along and from box faces and through corners, tmax at 3e38 or inf,
  dead lanes, a dead block, a block with one live ray) on the 25k knot's
  table and on a table with interleaved padding and other inverted boxes
  (`torch_parity.cull_edge_table`), and on the cluster queries of one
  sample-major strip of the 25k knot at 32x32, 4 samples, depth 3;
- a cull that tests only those pairs gives `exact_cull_plain`'s tn / gm and
  `oct_cull_plain`'s om bit for bit;
- on the edge-case sets the plain versions equal the JAX package's Pallas
  kernels (interpret mode, one 256-ray block a grid step).

The same inputs on the card: tests/test_torch_gpu.py::test_cull_kernels_*.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_raytracer_tpu.accel import clusters as jcl
from optix_raytracer_tpu.accel import qwalk as jqwalk
from optix_raytracer_tpu_torch.accel import clusters as tcl
from optix_raytracer_tpu_torch.accel import qwalk as tqwalk
from optix_raytracer_tpu_torch.scene.builtins import knot_camera, knot_scene
from optix_raytracer_tpu_torch.tools.knot_probe import (cull_counts,
                                                        main_path_strip_sets)

from torch_parity import cull_edge_rays, cull_edge_table

GROUPS = tcl.CULL_GROUPS
STRIP = dict(width=32, height=32, spl=4, depth=3)


@pytest.fixture(scope="module", autouse=True)
def one_block_per_step():
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jcl, jqwalk):
            mp.setattr(mod, "GROUPS", 1)
            mp.setattr(mod, "SUPER", jcl.SUB)
        jax.clear_caches()
        yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def knot():
    return knot_scene(200, 63, device="cpu")     # 25,202 triangles


@pytest.fixture(scope="module")
def tables(knot):
    return dict(knot25k=knot.clusters.aabb,
                edge=torch.as_tensor(cull_edge_table()))


@pytest.fixture(scope="module")
def strip_queries(knot):
    """The packed rays of the strip's six cluster queries (closest and
    any-hit, bounces 0-2)."""
    w, h = STRIP["width"], STRIP["height"]
    closest, shadow = main_path_strip_sets(
        knot, knot_camera(w, h).params("cpu"), w, h, STRIP["spl"],
        STRIP["depth"])
    return [tcl._pack_rays(r, tcl._padded(r.tmin.shape[0]))
            for r, _, _ in closest + shadow]


def edge_packed(aabb, seed=0):
    return torch.as_tensor(cull_edge_rays(aabb.numpy(), seed))


def exact_cross(packed, aabb):
    """Every (ray, column) pair's exact slab test → (cross, tn) [N, c_pad]."""
    boxes = aabb.transpose(1, 2).reshape(-1, 6)
    cross, tn = tcl._slab_cross(packed[None], boxes[:, 0:3].T[None],
                                boxes[:, 3:6].T[None])
    return cross[0], tn[0]


def two_level_cull(packed, aabb, group):
    """The cull of kernels 4 and 7 on the admitted pairs only → (tn, gm,
    om), each [n_blocks, c_pad]: a pair the group boxes do not admit is
    never tested, so it neither lowers an entry nor sets a bit."""
    adm = tcl.cull_admitted_pairs_plain(packed, aabb, group)
    cross, tn = exact_cross(packed, aabb)
    hit = (adm & cross).reshape(-1, tcl.SUB, adm.shape[1])
    tn = tn.reshape(hit.shape)
    tn_b = torch.where(hit, torch.clamp_min(tn, 0.0), tcl._BIG).amin(dim=1)

    def bits(rays):
        sub = hit.reshape(hit.shape[0], tcl.SUB // rays, rays, -1).any(dim=2)
        shifts = torch.arange(sub.shape[1], dtype=torch.int64)
        v = (sub.to(torch.int64) << shifts[None, :, None]).sum(dim=1)
        return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)
    return tn_b, bits(tcl.GROUP_ROWS), bits(tqwalk.OCT)


def assert_holds_crossings(packed, aabb, group):
    adm = tcl.cull_admitted_pairs_plain(packed, aabb, group)
    cross, _ = exact_cross(packed, aabb)
    assert adm.shape == cross.shape
    assert not (cross & ~adm).any(), (
        f"{int((cross & ~adm).sum())} crossing pairs not admitted")
    return adm, cross


def assert_cull_bit_equal(packed, aabb, group):
    n_blocks, c_pad = packed.shape[0] // tcl.SUB, aabb.shape[0] * tcl.LANES
    tn, gm, om = two_level_cull(packed, aabb, group)
    tn_p, gm_p = tcl.exact_cull_plain(aabb, packed, n_blocks, c_pad)
    om_p = tqwalk.oct_cull_plain(aabb, packed, n_blocks, c_pad)
    assert torch.equal(tn.view(torch.int32), tn_p.view(torch.int32))
    assert torch.equal(gm, gm_p)
    assert torch.equal(om, om_p)
    return tn_p, gm_p


def test_group_boxes_hold_their_members(tables):
    """Each group box is the exact min / max of its regular members; kinds:
    0 for padding alone, 2 where an inverted non-padding box sits."""
    aabb = tables["edge"]
    boxes, pad, regular = tcl._cull_columns(aabb)
    assert int(pad.sum()) == 46 and int((~pad & ~regular).sum()) == 2
    for group in GROUPS:
        lo, hi, kind = tcl.cull_group_boxes(aabb, group)
        for g in range(kind.numel()):
            cols = slice(g * group, (g + 1) * group)
            reg = regular[cols]
            irregular = bool((~pad[cols] & ~reg).any())
            assert int(kind[g]) == (2 if irregular else int(reg.any()))
            if reg.any():
                torch.testing.assert_close(
                    lo[g], boxes[cols][reg, 0:3].amin(dim=0), rtol=0, atol=0)
                torch.testing.assert_close(
                    hi[g], boxes[cols][reg, 3:6].amax(dim=0), rtol=0, atol=0)
        assert int(kind[-1]) == 0                  # the padded tail


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("table", ["knot25k", "edge"])
def test_admitted_pairs_hold_crossings_edge_rays(tables, table, group):
    aabb = tables[table]
    packed = edge_packed(aabb)
    adm, cross = assert_holds_crossings(packed, aabb, group)
    _, pad, _ = tcl._cull_columns(aabb)
    live = packed[:, 7] > packed[:, 6]
    assert not adm[~live].any() and cross[live].any()
    assert (cross[:, pad] == live[:, None]).all()  # padding: every live ray
    if table == "knot25k":                         # and the groups prune
        real = adm[live][:, ~pad]
        assert real.float().mean() < 0.5


@pytest.mark.parametrize("group", GROUPS)
def test_admitted_pairs_hold_crossings_strip(knot, strip_queries, group):
    for packed in strip_queries:
        assert_holds_crossings(packed, knot.clusters.aabb, group)


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("table", ["knot25k", "edge"])
def test_two_level_cull_bit_equal_edge_rays(tables, table, group):
    aabb = tables[table]
    tn, gm = assert_cull_bit_equal(edge_packed(aabb, seed=1), aabb, group)
    assert (gm[2] == 0).all() and (tn[2] == tcl._BIG).all()  # dead block
    assert ((gm[5] == 0) | (gm[5] == 1 << (77 // 32))).all()  # one ray
    assert (gm[5] != 0).any()


@pytest.mark.parametrize("group", GROUPS)
def test_two_level_cull_bit_equal_strip(knot, strip_queries, group):
    for packed in strip_queries:
        assert_cull_bit_equal(packed, knot.clusters.aabb, group)


def test_cull_counts(knot, strip_queries):
    """cull_counts against a direct count on one strip query: the crossed
    non-padding pairs, the groups a live ray crosses, its member tests."""
    packed, aabb = strip_queries[4], knot.clusters.aabb
    live = packed[:, 7] > packed[:, 6]
    cross, _ = exact_cross(packed, aabb)
    _, pad, _ = tcl._cull_columns(aabb)
    for group in GROUPS:
        c = cull_counts(aabb, packed, group, chunk=1000)
        adm = tcl.cull_admitted_pairs_plain(packed, aabb, group)
        _, _, kind = tcl.cull_group_boxes(aabb, group)
        assert c["live"] == int(live.sum()) > 0
        assert c["crossed"] == int(cross[:, ~pad].sum())
        assert c["member_tests"] == int(adm[:, ~pad].sum())
        assert c["groups_crossed"] * group >= c["member_tests"]
        assert c["group_tests"] == c["live"] * int((kind == 1).sum())
        assert 0 < c["live_blocks"] <= packed.shape[0] // tcl.SUB


@pytest.mark.parametrize("table", ["knot25k", "edge"])
def test_edge_rays_plain_matches_pallas(tables, table):
    """exact_cull_plain and oct_cull_plain against the reference's
    _exact_cull_kernel and _oct_cull_kernel (interpret) on the edge-case
    rays: masks and group / octet bits bit-equal, entries where crossed."""
    aabb = tables[table]
    packed = edge_packed(aabb)
    n_blocks, c_pad = packed.shape[0] // tcl.SUB, aabb.shape[0] * tcl.LANES
    jtable = types.SimpleNamespace(aabb=jnp.asarray(aabb.numpy()))
    jpacked = jnp.asarray(packed.numpy())
    tn, gm = tcl.exact_cull_plain(aabb, packed, n_blocks, c_pad)
    mask, tnear, gmask = jcl._exact_block_cull(jtable, jpacked, n_blocks,
                                               c_pad, interpret=True)
    jm = np.asarray(mask)
    np.testing.assert_array_equal(tn.numpy() < tcl._BIG, jm)
    np.testing.assert_array_equal(tn.numpy()[jm], np.asarray(tnear)[jm])
    np.testing.assert_array_equal(gm.numpy(), np.asarray(gmask))
    om = tqwalk.oct_cull_plain(aabb, packed, n_blocks, c_pad)
    jom = jqwalk._oct_cull(jtable, jpacked, n_blocks, c_pad, interpret=True)
    np.testing.assert_array_equal(om.numpy(), np.asarray(jom))


def test_cull_group_by_table_width():
    """The kernels' group size is a property of the table: 8 columns up to
    CULL_WIDE, 16 past it, one the kernels are built for at every width."""
    assert tcl.cull_group(256) == 8 and tcl.cull_group(tcl.CULL_WIDE) == 8
    assert tcl.cull_group(1024) == 16 and tcl.cull_group(3968) == 16
    assert all(tcl.cull_group(c) in GROUPS for c in range(128, 8193, 128))

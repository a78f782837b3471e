"""Cluster-culled intersection for large meshes: kernels 4-6 and their plain
versions (counterpart of `accel/clusters.py`; the kernels are
`csrc/clusters.cu`).

Triangles are chunked along a spatial order into clusters of 128
(`build_clusters`). A query packs its rays as [N, 8] (o, d, tmin, tmax) in
blocks of SUB = 256 and then:

1. culls every (block, cluster) pair: the interval cull (`_block_cull`,
   plain PyTorch) for tile-coherent primaries, or the exact per-ray slab
   test (kernel 4, `exact_cull`) for scattered wavefronts, which also emits
   one crossing bit per 32-ray group; the kernel tests a cluster only for
   the live rays that cross its group box of `cull_group(c_pad)` clusters
   (`cull_admitted_pairs_plain`);
2. sorts each block's crossed clusters front to back (`_cull`: one int32 sort
   whose key carries the cluster id and the group bits in the low bits of
   the entry distance);
3. walks each block's list (kernel 5, `walk_closest`; kernel 6, `walk_any`),
   pair-testing the block's rays against the cluster's 128 triangles, with
   the walk gated per 32-ray group where the exact cull's bits allow it.
   The kernels test only the pairs of the admission rule
   (`admitted_pairs_plain`: the ray's own slab test against the cluster's
   widened box, within the gate) and return the plain walks' rows and
   occlusion bit for bit.

Past MAX_STREAM_CLUSTERS clusters (1M triangles) the supercluster tier takes
over (clusters.py:740-1007): SC_CLUSTERS consecutive clusters form a
supercluster, steps 1-2 run unchanged on a view whose clusters are the
superclusters (`_sc_facade`), and the walk (kernel 5c, `walk_sc_closest`;
kernel 6c, `walk_sc_any`) slab-tests each listed supercluster's member
AABBs against the block and pair-tests only the members some ray crosses, in
ascending order. The kernels test only the pairs of the admission rule
(`sc_admitted_pairs_plain`: the ray's own slab test against the member's
widened box) and return the plain walks' rows and occlusion bit for bit. Up
to MAX_SUPERCLUSTERS superclusters (4.19M triangles).

Every function mirrors the JAX one of the same name and returns the same
values for the same inputs: the cluster table bit for bit, culls and lists bit
for bit, hit ids equal. The JAX package's grid of 16 blocks per step
(GROUPS) is kept in the padding and in the shapes of the cull outputs
([n_super, GROUPS, c_pad]) so the two can be compared directly. One
exception: the member mask is built with integer ops, where the reference's
`_member_bits` packs it with f32 `exp2` weights that are not exact for every
bit (see `_member_bits`).

On CUDA tensors the kernel wrappers launch the kernels; on CPU tensors they
run the plain versions. The tier caps (MAX_CLUSTERS, MAX_STREAM_CLUSTERS,
SC_CLUSTERS, MAX_SUPERCLUSTERS) are read at call time, so tests can lower
them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import kernels, telemetry
from ..core.rays import Hits, Rays
from ..core.vecmath import dot
from .geometry import TriangleGeometry
from .morton import interleave, morton3d, quantize

LANES = 128                 # triangles per cluster
SUB = 256                   # rays per block
GROUP_ROWS = 32             # rays per walk-gating group (8 per block)
GROUPS = 16                 # blocks per JAX grid step (padding unit: SUPER)
SUPER = SUB * GROUPS
MAX_CLUSTERS = 1024         # exact-cull / gated-walk cap (10 id bits)
MAX_STREAM_CLUSTERS = 8192  # per-cluster list cap (13 id bits)
SC_CLUSTERS = 32            # clusters per supercluster (4096 triangles)
MAX_SUPERCLUSTERS = 1024    # supercluster-tier cap (10 id bits, 4.19M tris)
MAX_MEMBERS = 32            # the sc kernels' member mask is one uint32
COMP_ROWS = 32              # constants per cluster slot, see ClusterSet
WALK_WINDOW = 4             # list entries a round of kernels 5 / 6 admits
CULL_GROUPS = (4, 8, 16, 32)  # group sizes kernels 4 / 7 are built for
CULL_WIDE = 512             # past this many columns, groups of 16 (not 8)

_DEGEN_EPS = 1e-12
_BIG = 3.0e38

# Host-side counts of the cluster path, from shapes alone (no sync): the
# engine's cluster launches (`launches`, bumped by engine.render_sum_sample_
# major / render_sum_wavefront on a cluster scene), the closest-hit and
# any-hit queries, and their rays and 256-ray blocks (padding included).
QUERIES = telemetry.counters("clusters.queries", ("launches", "closest",
                                                  "any", "rays", "blocks"))


def _count_query(kind: str, n: int, n_padded: int):
    QUERIES[kind] += 1
    QUERIES["rays"] += n
    QUERIES["blocks"] += n_padded // SUB


@dataclasses.dataclass
class ClusterSet:
    """Triangle clusters in pair-test layout (the JAX ClusterSet).

    comp:      [C, 32, 128] f32, per-slot constants as rows: 0-8 m_inv,
               9-11 offset, 12-14 unit face normal, 15 pad, 16 original
               prim id (-1 = padding), 17 material id, 18-20 corner-0
               shading normal, 21-23 corner 1 minus corner 0, 24-26 corner
               2 minus corner 0, 27-31 pad. Padding slots are all zero
               (never hit).
    aabb:      [C_rows, 6, 128] f32 cluster AABBs, 128 clusters per row
               (rows lox loy loz hix hiy hiz); padding clusters inverted.
    slot_prim: [C*128] int32 original triangle id per slot (-1 = padding).
    """
    comp: torch.Tensor
    aabb: torch.Tensor
    slot_prim: torch.Tensor
    num_clusters: int = 0

    @property
    def num_rows(self) -> int:
        return self.aabb.shape[0]

    @property
    def c_pad(self) -> int:
        return self.num_rows * LANES


def build_clusters(geom: TriangleGeometry, tri_mat=None,
                   order=None) -> ClusterSet:
    """Chunk a mesh into 128-triangle clusters along `order` ([M] triangle
    permutation, e.g. the SAH leaf order), or along the morton order of the
    triangle AABB centroids. tri_mat: optional [M] material ids, baked into
    the table."""
    dev = geom.tri_consts.device
    n = geom.num_triangles
    c = -(-n // LANES)
    c_rows = max(1, -(-c // LANES))
    # Past the per-cluster cap the supercluster tier walks the table in
    # SC_CLUSTERS-row slabs, so the row count is rounded up with never-hit
    # padding clusters (clusters.py:137-141).
    c_alloc = (-(-c // SC_CLUSTERS) * SC_CLUSTERS
               if c > MAX_STREAM_CLUSTERS else c)
    n_slots = c_alloc * LANES

    v0, e1, e2 = geom.v0, geom.e1, geom.e2
    tri_lo = torch.minimum(v0, torch.minimum(v0 + e1, v0 + e2))
    tri_hi = torch.maximum(v0, torch.maximum(v0 + e1, v0 + e2))
    if order is None:
        centroid = 0.5 * (tri_lo + tri_hi)
        codes = morton3d(centroid, tri_lo.amin(dim=0), tri_hi.amax(dim=0))
        order = torch.argsort(codes, stable=True).to(torch.int32)
    elif isinstance(order, torch.Tensor):
        order = order.to(device=dev, dtype=torch.int32)
    else:
        order = torch.tensor(np.asarray(order), dtype=torch.int32, device=dev)

    slot_prim = torch.cat([order, torch.full((n_slots - n,), -1,
                                             dtype=torch.int32, device=dev)])
    safe = torch.clamp_min(slot_prim, 0).to(torch.int64)
    live = (slot_prim >= 0).to(torch.float32)

    consts = geom.tri_consts[safe] * live[:, None]          # [n_slots, 16]
    mat = (torch.as_tensor(tri_mat, device=dev)[safe] if tri_mat is not None
           else torch.zeros((n_slots,), dtype=torch.int32, device=dev))
    extra = torch.stack([
        slot_prim.to(torch.float32),
        torch.where(slot_prim >= 0, mat.to(torch.float32), -1.0)], dim=1)
    cn = geom.corner_normal[safe] * live[:, None, None]     # [n_slots, 3, 3]
    nrows = torch.cat([cn[:, 0], cn[:, 1] - cn[:, 0], cn[:, 2] - cn[:, 0]],
                      dim=1)
    allc = torch.cat([consts, extra, nrows,
                      torch.zeros((n_slots, 5), dtype=torch.float32,
                                  device=dev)], dim=1)
    comp = allc.reshape(c_alloc, LANES, COMP_ROWS).transpose(1, 2)

    lo = torch.where(live[:, None] > 0, tri_lo[safe], _BIG)
    hi = torch.where(live[:, None] > 0, tri_hi[safe], -_BIG)
    cl_lo = lo.reshape(c_alloc, LANES, 3).amin(dim=1)
    cl_hi = hi.reshape(c_alloc, LANES, 3).amax(dim=1)
    c_pad = c_rows * LANES
    fill = c_pad - c_alloc
    cl_lo = torch.cat([cl_lo, torch.full((fill, 3), _BIG, device=dev)])
    cl_hi = torch.cat([cl_hi, torch.full((fill, 3), -_BIG, device=dev)])
    aabb = torch.cat([cl_lo, cl_hi], dim=1).reshape(c_rows, LANES, 6)
    return ClusterSet(comp=comp.contiguous(),
                      aabb=aabb.transpose(1, 2).contiguous(),
                      slot_prim=slot_prim, num_clusters=c)


def _aabb_rows(cl: ClusterSet) -> torch.Tensor:
    """[c_pad, 6] cluster AABBs (lo xyz, hi xyz)."""
    return cl.aabb.transpose(1, 2).reshape(-1, 6)


# ---------------------------------------------------------------------------
# Culling
# ---------------------------------------------------------------------------

def _pack_rays(rays: Rays, n_padded: int) -> torch.Tensor:
    """Rays → dense [n_padded, 8] (ox oy oz dx dy dz tmin tmax). Padding rays
    are all zero: an empty window, never hit. The `clusters.pack` span."""
    with telemetry.span("clusters.pack"):
        packed = torch.cat([rays.origin, rays.direction, rays.tmin[:, None],
                            rays.tmax[:, None]], dim=1).to(torch.float32)
        pad = n_padded - packed.shape[0]
        if pad:
            packed = torch.cat([packed, packed.new_zeros((pad, 8))])
        return packed.contiguous()


def _block_chunks(n_blocks: int, per_block: int, budget: int = 1 << 25):
    """Ranges of blocks whose [blocks, per_block] planes stay under budget."""
    step = max(1, budget // max(per_block, 1))
    return [(s, min(s + step, n_blocks)) for s in range(0, n_blocks, step)]


def _block_cull(cl: ClusterSet, packed, n_blocks: int, c_pad: int):
    """Conservative (block, cluster) slab test by interval arithmetic over
    each block's ray bundle (clusters.py:327-386) → (mask [n_blocks, c_pad]
    bool, tnear [n_blocks, c_pad] f32, a lower bound on every ray's entry).
    Plain PyTorch, in chunks of blocks to bound the [B, C, 3] planes."""
    blk = packed.reshape(n_blocks, SUB, 8)
    ab = _aabb_rows(cl)
    lo, hi = ab[None, :, 0:3], ab[None, :, 3:6]               # [1, C, 3]
    mask = torch.empty((n_blocks, c_pad), dtype=torch.bool,
                       device=packed.device)
    tnear = torch.empty((n_blocks, c_pad), dtype=torch.float32,
                        device=packed.device)
    for s, e in _block_chunks(n_blocks, 3 * c_pad):
        b = blk[s:e]
        o_lo = b[:, :, 0:3].amin(dim=1)[:, None, :]          # [B, 1, 3]
        o_hi = b[:, :, 0:3].amax(dim=1)[:, None, :]
        d_lo = b[:, :, 3:6].amin(dim=1)[:, None, :]
        d_hi = b[:, :, 3:6].amax(dim=1)[:, None, :]
        tmin_lo = b[:, :, 6].amin(dim=1)[:, None]            # [B, 1]
        tmax_hi = b[:, :, 7].amax(dim=1)[:, None]

        consistent = (d_lo > _DEGEN_EPS) | (d_hi < -_DEGEN_EPS)
        i_lo = 1.0 / torch.where(consistent, d_hi, 1.0)      # inv interval
        i_hi = 1.0 / torch.where(consistent, d_lo, 1.0)

        def plane_interval(p):
            a_lo = p - o_hi
            a_hi = p - o_lo
            p1, p2 = a_lo * i_lo, a_lo * i_hi
            p3, p4 = a_hi * i_lo, a_hi * i_hi
            t_lo = torch.minimum(torch.minimum(p1, p2), torch.minimum(p3, p4))
            t_hi = torch.maximum(torch.maximum(p1, p2), torch.maximum(p3, p4))
            return t_lo, t_hi

        t0_lo, t0_hi = plane_interval(lo)                    # [B, C, 3]
        t1_lo, t1_hi = plane_interval(hi)
        tn_axis_lo = torch.where(consistent, torch.minimum(t0_lo, t1_lo),
                                 -_BIG)
        tf_axis_hi = torch.where(consistent, torch.maximum(t0_hi, t1_hi),
                                 _BIG)
        L = torch.maximum(tn_axis_lo.amax(dim=2), tmin_lo)   # [B, C]
        U = torch.minimum(tf_axis_hi.amin(dim=2), tmax_hi)
        mask[s:e] = L <= U
        tnear[s:e] = torch.clamp_min(L, 0.0)
    return mask, tnear


def _slab_cross(a, lo, hi):
    """The exact per-ray slab test of `_exact_cull_kernel`
    (clusters.py:270-289) and `_member_cross` (:789-813): rays a [B, R, 8]
    against boxes lo, hi [B or 1, 3, C] → (cross [B, R, C] bool, tn
    [B, R, C] f32 entry distance). The +-1e12 pseudo-inverse for |d| <=
    1e-12 (-0.0 gets +1e12), the rule max(tn, tmin) <= min(tf, tmax), and
    live rays (tmax > tmin) only. One helper for the cull and the member
    test, so they agree on which boxes a ray crosses."""
    tmin, tmax = a[:, :, 6:7], a[:, :, 7:8]
    live = tmax > tmin
    shape = (a.shape[0], a.shape[1], lo.shape[2])
    tn = torch.full(shape, -_BIG, device=a.device)
    tf = torch.full(shape, _BIG, device=a.device)
    for ax in range(3):
        d = a[:, :, 3 + ax:4 + ax]
        inv = torch.where(torch.abs(d) > _DEGEN_EPS, 1.0 / d,
                          torch.where(d < 0, -1e12, 1e12))
        o = a[:, :, ax:ax + 1]
        t0 = (lo[:, None, ax, :] - o) * inv
        t1 = (hi[:, None, ax, :] - o) * inv
        tn = torch.maximum(tn, torch.minimum(t0, t1))
        tf = torch.minimum(tf, torch.maximum(t0, t1))
    return (torch.maximum(tn, tmin) <= torch.minimum(tf, tmax)) & live, tn


def exact_cull_plain(aabb, packed, n_blocks: int, c_pad: int):
    """Plain version of kernel 4: for each 256-ray block and each cluster,
    (tn [n_blocks, c_pad] f32, gm [n_blocks, c_pad] int32). tn is the
    minimum of max(t_entry, 0) over the block's live rays whose window
    crosses the cluster's AABB, or _BIG; bit g of gm is set when a ray of the
    block's g-th 32-ray group crosses (slab test: `_slab_cross`)."""
    ab = aabb.transpose(1, 2).reshape(c_pad, 6).T            # [6, c_pad]
    lo, hi = ab[None, 0:3], ab[None, 3:6]
    blk = packed.reshape(n_blocks, SUB, 8)
    tn_out = torch.empty((n_blocks, c_pad), dtype=torch.float32,
                         device=packed.device)
    gm_out = torch.empty((n_blocks, c_pad), dtype=torch.int32,
                         device=packed.device)
    shifts = torch.arange(SUB // GROUP_ROWS, device=packed.device,
                          dtype=torch.int32)
    for s, e in _block_chunks(n_blocks, SUB * c_pad):
        cross, tn = _slab_cross(blk[s:e], lo, hi)
        tn_out[s:e] = torch.where(cross, torch.clamp_min(tn, 0.0),
                                  _BIG).amin(dim=1)
        grp = cross.reshape(e - s, SUB // GROUP_ROWS, GROUP_ROWS,
                            c_pad).any(dim=2).to(torch.int32)
        gm_out[s:e] = (grp << shifts[None, :, None]).sum(dim=1,
                                                         dtype=torch.int32)
    return tn_out, gm_out


def cull_group(c_pad: int) -> int:
    """Columns a group box of kernels 4 / 7 covers on a table of c_pad
    columns: 8 up to CULL_WIDE, 16 past it. Measured on the H100
    (`tools/bench_sc_walks.py --cull --k`, PERF.md §6): 8 is within 5% of
    the best size on every 25k-knot set (c_pad 256), 16 the best on every
    set of the 4M facade (c_pad 1024) and the 500k table (3968). The
    kernels are built for CULL_GROUPS and refuse any other size."""
    return 8 if c_pad <= CULL_WIDE else 16


def exact_cull(aabb, packed, n_blocks: int, c_pad: int):
    """Kernel 4 (replaces `_exact_cull_kernel`, clusters.py:231-302): see
    exact_cull_plain for what it computes. The kernel slab-tests a member
    column only for the live rays that cross its group box of
    `cull_group(c_pad)` columns (`cull_admitted_pairs_plain`)."""
    dev = packed.device
    if dev.type == "cpu":
        return exact_cull_plain(aabb, packed, n_blocks, c_pad)
    if dev.type != "cuda":
        raise ValueError(f"exact_cull: unsupported device {dev}")
    if c_pad > MAX_CLUSTERS or c_pad % LANES:
        raise ValueError(f"exact_cull: c_pad {c_pad} must be a multiple of "
                         f"{LANES} up to {MAX_CLUSTERS}")
    kernels.require(aabb, "aabb", torch.float32, (c_pad // LANES, 6, LANES),
                    dev)
    kernels.require(packed, "packed rays", torch.float32, (n_blocks * SUB, 8),
                    dev)
    tn = torch.empty((n_blocks, c_pad), dtype=torch.float32, device=dev)
    gm = torch.empty((n_blocks, c_pad), dtype=torch.int32, device=dev)
    if n_blocks == 0:
        return tn, gm
    with torch.cuda.device(dev), kernels.launch("cluster_cull_exact"):
        err = kernels.lib().ort_cluster_cull_exact(
            aabb.data_ptr(), c_pad, packed.data_ptr(), n_blocks,
            tn.data_ptr(), gm.data_ptr(), cull_group(c_pad),
            kernels.stream_ptr(dev))
    kernels.check(err, "cluster_cull_exact")
    return tn, gm


def _cull_columns(aabb):
    """The columns of a cull table aabb [c_pad / 128, 6, 128] as kernels 4
    and 7 class them → (boxes [c_pad, 6], pad [c_pad] bool: the canonical
    padding box lo = _BIG, hi = -_BIG, regular [c_pad] bool: lo <= hi on
    every axis). A column that is neither (another inverted box, or NaN)
    is irregular."""
    boxes = aabb.transpose(1, 2).reshape(-1, 6)
    lo, hi = boxes[:, 0:3], boxes[:, 3:6]
    pad = (lo == _BIG).all(dim=1) & (hi == -_BIG).all(dim=1)
    regular = (lo <= hi).all(dim=1)
    return boxes, pad, regular


def cull_group_boxes(aabb, group: int):
    """The group boxes of kernels 4 and 7: each run of `group` consecutive
    columns → (lo, hi [G, 3], the exact min / max of the group's regular
    members' boxes, kind [G] int: 0 no member to test (all padding), 1
    test the box, 2 admit the group whole (an irregular member: an
    inverted box crosses every live ray, so no box can hold it))."""
    boxes, pad, regular = _cull_columns(aabb)
    g = boxes.shape[0] // group
    lo = torch.where(regular[:, None], boxes[:, 0:3], _BIG)
    hi = torch.where(regular[:, None], boxes[:, 3:6], -_BIG)
    irregular = (~pad & ~regular).reshape(g, group).any(dim=1)
    kind = torch.where(irregular, 2,
                       regular.reshape(g, group).any(dim=1).to(torch.int64))
    return (lo.reshape(g, group, 3).amin(dim=1),
            hi.reshape(g, group, 3).amax(dim=1), kind)


def cull_admitted_pairs_plain(packed, aabb, group: int):
    """The pairs kernels 4 and 7 slab-test, in plain PyTorch: rays packed
    [N, 8] against the columns of aabb [c_pad / 128, 6, 128] → bool
    [N, c_pad]. A live ray tests a member column only where it crosses
    the column's group box (`cull_group_boxes`; a group of kind 2 whole,
    one of kind 0 never); a padding column takes the ray's own test of the
    padding box, made once. Every crossing pair of `_slab_cross` is
    admitted: a regular member's box lies in its group box, round-to-
    nearest is monotone and the ray's reciprocal is fixed, so the ray's
    slab interval for the group box holds the member's."""
    glo, ghi, kind = cull_group_boxes(aabb, group)
    _, pad, _ = _cull_columns(aabb)
    a = packed[None]
    gcross, _ = _slab_cross(a, glo.T[None], ghi.T[None])      # [1, N, G]
    live = (packed[:, 7] > packed[:, 6])[:, None]
    gadm = ((gcross[0] & (kind == 1)[None]) | ((kind == 2)[None] & live))
    adm = gadm.repeat_interleave(group, dim=1)                # [N, c_pad]
    big = torch.full((1, 3, 1), _BIG, device=packed.device)
    pad_cross = _slab_cross(a, big, -big)[0][0]               # [N, 1]
    return torch.where(pad[None], pad_cross, adm)


def _cull_tables(tn, gm):
    """Kernel 4's outputs → (mask bool, tnear f32, gmask int32), each
    [n_blocks, c_pad] (clusters.py:323-324). A zero entry is made +0.0, so
    `_compact`'s sort key never sees a sign bit."""
    mask = tn < _BIG
    return mask, torch.where(mask, tn, 0.0) + 0.0, gm


def _exact_block_cull(cl: ClusterSet, packed, n_blocks: int, c_pad: int):
    """Kernel 4 → (mask, tnear, gmask) (clusters.py:305-324)."""
    return _cull_tables(*exact_cull(cl.aabb, packed, n_blocks, c_pad))


def _cull(cl: ClusterSet, packed, n_super: int, c_pad: int,
          exact: bool = False):
    """Cull + compaction (clusters.py:1028-1084) → (counts [S, G, 1] int32,
    lists [S, G, c_pad] int32, tnear_sorted [S, G, c_pad] f32). A list entry
    packs the cluster id in bits 0-15 and the walk's 8 group bits in bits
    16-23 (0xFF when the cull gives none). The exact cull runs only when
    `exact` and c_pad <= MAX_CLUSTERS; otherwise the interval cull. The
    cull is the `clusters.cull` span, tagged "exact" or "interval", the
    compaction the `clusters.compact` span."""
    n_blocks = n_super * GROUPS
    if exact and c_pad <= MAX_CLUSTERS:
        with telemetry.span("clusters.cull", "exact"):
            mask, tnear, gmask = _exact_block_cull(cl, packed, n_blocks,
                                                   c_pad)
    else:
        with telemetry.span("clusters.cull", "interval"):
            mask, tnear = _block_cull(cl, packed, n_blocks, c_pad)
        gmask = None
    with telemetry.span("clusters.compact"):
        return _compact(cl, mask, tnear, gmask, n_super)


def _compact(cl: ClusterSet, mask, tnear, gmask, n_super: int):
    """Each block's crossed clusters, front to back: one int32 sort whose key
    carries the id (and the group bits) in the low mantissa bits of the
    non-negative entry distance, whose bit pattern sorts like its value;
    truncating those bits lowers the bound, which stays a lower bound on
    the entry of every ray whose slab test crosses the box (the kernels
    read only the order: a grazing ray can hit a cluster before it)."""
    c_pad = mask.shape[1]
    ids = torch.arange(c_pad, dtype=torch.int32, device=mask.device)[None, :]
    hit = mask & (ids < cl.num_clusters)
    counts = hit.sum(dim=1, dtype=torch.int32)
    key = torch.clamp_min(torch.where(hit, tnear, _BIG), 0.0)
    bits = key.view(torch.int32)
    id_bits = 10 if c_pad <= 1024 else 13
    if c_pad > (1 << id_bits):
        raise ValueError(f"{c_pad} clusters do not fit the {id_bits} id bits "
                         f"of the cull's sort key")
    if gmask is not None:
        low = ids | (torch.where(hit, gmask, 0) << id_bits)
        low_bits = id_bits + 8
    else:
        low = ids
        low_bits = id_bits
    low_mask = (1 << low_bits) - 1
    skey = torch.sort((bits & ~low_mask) | low, dim=1).values
    id_mask = (1 << id_bits) - 1
    gm_sorted = ((skey >> id_bits) & 0xFF if gmask is not None
                 else torch.full_like(skey, 0xFF))
    order = (skey & id_mask) | (gm_sorted << 16)
    tnear_sorted = (skey & ~low_mask).view(torch.float32)
    shape = (n_super, GROUPS, c_pad)
    return (counts.reshape(n_super, GROUPS, 1), order.reshape(shape),
            tnear_sorted.reshape(shape))


# ---------------------------------------------------------------------------
# The walks: kernels 5 and 6 and their plain versions
# ---------------------------------------------------------------------------

def _pair_test(blk, ox, oy, oz, dx, dy, dz):
    """Woop test of ray columns [B, R, 1] against cluster constant rows
    blk [B, 32, 128] (`_pair_test`, clusters.py:206-224) → (tt, uu, vv, dpz),
    each [B, R, 128]."""
    def row(j):
        return blk[:, None, j, :]
    opx = ox * row(0) + oy * row(1) + oz * row(2) + row(9)
    opy = ox * row(3) + oy * row(4) + oz * row(5) + row(10)
    opz = ox * row(6) + oy * row(7) + oz * row(8) + row(11)
    dpx = dx * row(0) + dy * row(1) + dz * row(2)
    dpy = dx * row(3) + dy * row(4) + dz * row(5)
    dpz = dx * row(6) + dy * row(7) + dz * row(8)
    inv = 1.0 / dpz
    tt = -opz * inv
    uu = opx + tt * dpx
    vv = opy + tt * dpy
    return tt, uu, vv, dpz


def _group_bits(gm):
    """Each ray's bit of its block's gate bits gm [B] (bit g for the g-th
    32-ray group) → bool [B, 256]."""
    group = torch.arange(SUB, device=gm.device) // GROUP_ROWS
    return ((gm[:, None] >> group[None, :].to(gm.dtype)) & 1) > 0


def _pair_ok(blk, a, gm, gate):
    """Pair tests of the rays a [B, 256, 8] against their blocks' current
    clusters blk [B, 32, 128], with the group gate gm [B] applied →
    (ok, tt, uu, vv), each [B, 256, 128]."""
    cols = [a[:, :, j:j + 1] for j in range(8)]
    tt, uu, vv, dpz = _pair_test(blk, *cols[:6])
    ok = ((torch.abs(dpz) > _DEGEN_EPS)
          & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
          & (tt > cols[6]) & (tt < cols[7]))
    if gate:
        ok = ok & _group_bits(gm)[:, :, None]
    return ok, tt, uu, vv


def _walk_inputs(counts, lists, packed):
    nb = counts.numel()
    return (counts.reshape(nb), lists.reshape(nb, -1),
            packed.reshape(nb, SUB, 8))


def _list_steps(counts, lists, block_chunk: int):
    """The plain walks' schedule: for each list position k, front to back,
    the blocks whose lists reach it, in chunks → (blocks [B], entries [B])."""
    max_count = int(counts.max()) if counts.numel() else 0
    for k in range(max_count):
        walking = torch.nonzero(counts > k)[:, 0]
        for s in range(0, walking.shape[0], block_chunk):
            b = walking[s:s + block_chunk]
            yield b, lists[b, k]


class _ClosestState:
    """The plain closest walk's running best per ray: t, lane, (u, v,
    normal) and (prim, mat) of blocks [nb] of 256 rays."""

    def __init__(self, rays):
        nb, dev = rays.shape[0], rays.device
        self.bt = rays[:, :, 7].clone()
        self.blane = torch.full((nb, SUB), LANES, dtype=torch.int64,
                                device=dev)
        self.rec = torch.zeros((nb, SUB, 5), dtype=torch.float32, device=dev)
        self.ids = torch.full((nb, SUB, 2), -1.0, dtype=torch.float32,
                              device=dev)

    def step(self, b, blk, a, gm, gate: bool, allow=None):
        """Pair-test the rays a [B, 256, 8] of blocks b against one cluster
        each (blk [B, 32, 128]) and keep the better hit: smaller t, or equal
        t at a lower lane; an equal hit of a later step never wins. allow
        [B, 256] bool, if given, leaves the other rays untested."""
        ok, tt, uu, vv = _pair_ok(blk, a, gm, gate)
        if allow is not None:
            ok = ok & allow[:, :, None]
        tk, lane = torch.where(ok, tt, torch.inf).min(dim=2)
        bt, blane = self.bt[b], self.blane[b]
        better = ok.any(dim=2) & ((tk < bt) | ((tk == bt) & (lane < blane)))
        li = lane[:, :, None]
        u = uu.gather(2, li)[:, :, 0]
        v = vv.gather(2, li)[:, :, 0]
        c = blk.gather(2, li[:, None, :, 0].expand(-1, COMP_ROWS, -1))
        n0, d10, d20 = c[:, 18:21], c[:, 21:24], c[:, 24:27]  # [B, 3, 256]
        nrm = n0 + u[:, None] * d10 + v[:, None] * d20
        new_rec = torch.cat([u[..., None], v[..., None],
                             nrm.transpose(1, 2)], dim=2)
        new_ids = c[:, 16:18].transpose(1, 2)
        self.bt[b] = torch.where(better, tk, bt)
        self.blane[b] = torch.where(better, lane, blane)
        self.rec[b] = torch.where(better[..., None], new_rec, self.rec[b])
        self.ids[b] = torch.where(better[..., None], new_ids, self.ids[b])

    def rows(self):
        rows = torch.cat([self.bt[..., None], self.rec, self.ids], dim=2)
        return rows.reshape(-1, 8)


def _entry_boxes(aabb):
    """The cluster boxes aabb [c_pad / 128, 6, 128] as [c_pad, 6, 1]: one box
    per cluster, in the layout the admission rule takes."""
    return aabb.transpose(1, 2).reshape(-1, 6)[:, :, None]


def walk_closest_plain(counts, lists, tnear, comp, aabb, packed, gate: bool,
                       block_chunk: int = 256, admitted: bool = False):
    """Plain version of kernel 5 → rows [n_padded, 8] f32 (t u v nx ny nz
    prim mat; a miss is t = tmax, zeros, prim = mat = -1).

    Each block walks its whole list in order. A pair counts when it passes
    the Woop test with tmin < t < tmax. The winner is the smallest t; among
    equal t the lowest slot (lane) wins, and among equal lanes the earlier
    cluster: exactly the running per-lane minimum with a strict `<` and the
    lowest-winning-lane pick of `_step_closest` / `_emit_closest`
    (clusters.py:393-450). The normal is n0 + u*d10 + v*d20, unnormalised.
    `tnear` is not read: the plain walk has no early exit.

    admitted=True (for tests) tests only the pairs of the kernel's admission
    rule (`admitted_pairs_plain` on the cluster boxes `aabb`, at each ray's
    best t when the walk reaches the entry; the rule carries the gate) and
    must give the same rows."""
    del tnear
    counts, lists, rays = _walk_inputs(counts, lists, packed)
    boxes = _entry_boxes(aabb)
    st = _ClosestState(rays)
    for b, entry in _list_steps(counts, lists, block_chunk):
        c, gm = (entry & 0xFFFF).to(torch.int64), (entry >> 16) & 0xFF
        allow = (admitted_pairs_plain(rays[b], boxes[c], gm, gate, st.bt[b])
                 if admitted else None)
        st.step(b, comp[c], rays[b], gm, gate and not admitted, allow)
    return st.rows()


def walk_any_plain(counts, lists, tnear, comp, aabb, packed, gate: bool,
                   block_chunk: int = 256, admitted: bool = False):
    """Plain version of kernel 6 → occ [n_padded] int32: 1 where some pair of
    the ray's block's whole list passes the Woop test with tmin < t < tmax
    (dead rays never do). `tnear` is not read: no early exit.
    admitted=True (for tests) the admitted pairs only, rays occluded before
    the entry dropped, as walk_closest_plain."""
    del tnear
    counts, lists, rays = _walk_inputs(counts, lists, packed)
    boxes = _entry_boxes(aabb)
    occ = torch.zeros(rays.shape[:2], dtype=torch.bool, device=packed.device)
    for b, entry in _list_steps(counts, lists, block_chunk):
        c, gm = (entry & 0xFFFF).to(torch.int64), (entry >> 16) & 0xFF
        ok, _, _, _ = _pair_ok(comp[c], rays[b], gm, gate and not admitted)
        if admitted:
            allow = admitted_pairs_plain(rays[b], boxes[c], gm, gate) & ~occ[b]
            ok = ok & allow[:, :, None]
        occ[b] = occ[b] | ok.any(dim=2)
    return occ.reshape(-1).to(torch.int32)


def _walk_args(name, counts, lists, tnear, comp, packed):
    dev = packed.device
    nb = counts.numel()
    c_pad = lists.shape[-1]
    kernels.require(counts, "counts", torch.int32, counts.shape, dev)
    kernels.require(lists, "lists", torch.int32, lists.shape, dev)
    kernels.require(tnear, "tnear", torch.float32, lists.shape, dev)
    if lists.numel() != nb * c_pad or tnear.numel() != nb * c_pad:
        raise ValueError(f"{name}: lists / tnear must hold {nb} x {c_pad}")
    kernels.require(comp, "comp", torch.float32,
                    (comp.shape[0], COMP_ROWS, LANES), dev)
    kernels.require(packed, "packed rays", torch.float32, (nb * SUB, 8), dev)
    if comp.data_ptr() % 16:
        raise ValueError(f"{name}: comp must be 16-byte aligned (the cluster "
                         f"slabs are bulk-copied)")
    return nb, c_pad


def _resident_walk(name, counts, lists, tnear, comp, aabb, packed, gate,
                   out):
    """Launch kernel 5 (out: rows) or 6 (out: occlusion) on the card."""
    dev = packed.device
    nb, c_pad = _walk_args(name, counts, lists, tnear, comp, packed)
    kernels.require(aabb, "aabb", torch.float32, (aabb.shape[0], 6, LANES),
                    dev)
    if aabb.shape[0] * LANES < comp.shape[0]:
        raise ValueError(f"{name}: aabb holds {aabb.shape[0] * LANES} boxes "
                         f"for {comp.shape[0]} clusters")
    win = WALK_WINDOW
    if not 1 <= win <= MAX_MEMBERS:
        raise ValueError(f"{name}: WALK_WINDOW {win} must lie in [1, "
                         f"{MAX_MEMBERS}]")
    if nb == 0:
        return out
    entry = getattr(kernels.lib(), f"ort_{name}")
    with torch.cuda.device(dev), kernels.launch(name):
        err = entry(counts.data_ptr(), lists.data_ptr(), comp.data_ptr(),
                    comp.shape[0], aabb.data_ptr(), packed.data_ptr(), nb,
                    c_pad, int(gate), win, out.data_ptr(),
                    kernels.stream_ptr(dev))
    kernels.check(err, name)
    return out


def walk_closest(counts, lists, tnear, comp, aabb, packed, gate: bool):
    """Kernel 5 (replaces `_closest_kernel` and `_closest_kernel_stream`,
    clusters.py:453, 537; pallas_call at :1150): see walk_closest_plain,
    whose rows it returns bit for bit. It tests only the pairs of the
    admission rule (`admitted_pairs_plain`, on the cluster boxes `aabb`),
    WALK_WINDOW list entries a round, and keeps each ray's best as one (t,
    slot, list position) key."""
    dev = packed.device
    if dev.type == "cpu":
        return walk_closest_plain(counts, lists, tnear, comp, aabb, packed,
                                  gate)
    if dev.type != "cuda":
        raise ValueError(f"walk_closest: unsupported device {dev}")
    rows = torch.empty((counts.numel() * SUB, 8), dtype=torch.float32,
                       device=dev)
    return _resident_walk("cluster_closest", counts, lists, tnear, comp, aabb,
                          packed, gate, rows)


def walk_any(counts, lists, tnear, comp, aabb, packed, gate: bool):
    """Kernel 6 (replaces `_any_kernel` and `_any_kernel_stream`,
    clusters.py:669, 603; pallas_call at :1372): see walk_any_plain; the
    admitted pairs only, as kernel 5."""
    dev = packed.device
    if dev.type == "cpu":
        return walk_any_plain(counts, lists, tnear, comp, aabb, packed, gate)
    if dev.type != "cuda":
        raise ValueError(f"walk_any: unsupported device {dev}")
    occ = torch.empty((counts.numel() * SUB,), dtype=torch.int32, device=dev)
    return _resident_walk("cluster_any", counts, lists, tnear, comp, aabb,
                          packed, gate, occ)


# ---------------------------------------------------------------------------
# The supercluster tier: kernels 5c and 6c and their plain versions
# ---------------------------------------------------------------------------

def _sc_tables(cl: ClusterSet):
    """Supercluster tables of a cluster set built for this tier
    (clusters.py:754-786) → (cull_aabb [SC_rows, 6, 128] f32, the
    superclusters' AABBs 128 per row, padding inverted; member_aabb
    [sc_pad, 6, SC_CLUSTERS] f32, each supercluster's member-cluster AABBs,
    padding rows inverted; n_sc). The reference keeps member_aabb 128 lanes
    wide; its first SC_CLUSTERS lanes are these."""
    sc = SC_CLUSTERS
    if not 1 <= sc <= MAX_MEMBERS:
        raise ValueError(f"SC_CLUSTERS must lie in [1, {MAX_MEMBERS}], "
                         f"got {sc}")
    rows = cl.comp.shape[0]
    if rows % sc:
        raise ValueError(f"{rows} cluster rows are not whole superclusters "
                         f"of {sc}: the table was built for another tier")
    n_sc = rows // sc
    if n_sc > MAX_SUPERCLUSTERS:
        raise NotImplementedError(
            f"{n_sc} superclusters: the cluster path stops at "
            f"{MAX_SUPERCLUSTERS} ({MAX_SUPERCLUSTERS * sc * LANES} "
            f"triangles); a scene past it builds no cluster table and "
            f"walks its BVH (accel/traverse.py)")
    dev = cl.aabb.device
    mem = _aabb_rows(cl)[:n_sc * sc].reshape(n_sc, sc, 6)
    sc_rows = -(-n_sc // LANES)
    fill = sc_rows * LANES - n_sc
    lo = torch.cat([mem[:, :, 0:3].amin(dim=1),
                    torch.full((fill, 3), _BIG, device=dev)])
    hi = torch.cat([mem[:, :, 3:6].amax(dim=1),
                    torch.full((fill, 3), -_BIG, device=dev)])
    cull_aabb = torch.cat([lo, hi], dim=1).reshape(sc_rows, LANES, 6)
    inv_rows = torch.cat([torch.full((fill, 3, sc), _BIG, device=dev),
                          torch.full((fill, 3, sc), -_BIG, device=dev)], dim=1)
    member = torch.cat([mem.transpose(1, 2), inv_rows])
    return (cull_aabb.transpose(1, 2).contiguous(), member.contiguous(),
            n_sc)


def _sc_facade(cl: ClusterSet, cull_aabb, n_sc: int) -> ClusterSet:
    """A ClusterSet view whose clusters are the superclusters, so the cull
    and compaction run unchanged at the coarse tier (clusters.py:1003)."""
    return ClusterSet(comp=cl.comp[:0], aabb=cull_aabb,
                      slot_prim=cl.slot_prim[:0], num_clusters=n_sc)


def _member_cross(a, member):
    """Exact slab test of each block's supercluster member AABBs member
    [B, 6, M] against its rays a [B, 256, 8] → bool [B, 256, M]
    (clusters.py:789-813): `_slab_cross`, the exact cull's own test."""
    return _slab_cross(a, member[:, 0:3], member[:, 3:6])[0]


# The pair admission rule of kernels 5 / 6 and 5c / 6c (csrc/clusters.cu
# kMarginRel, kMarginFloor): the cluster box is widened on every side by
#   margin = extent * SC_MARGIN_REL + magnitude * SC_MARGIN_FLOOR,
# extent the box's largest side, magnitude its largest |coordinate|. A pair
# whose Woop test accepts a hit has that hit within a few ulps of the
# triangle, which lies in the unwidened box; the f32 slab test's own error
# is a few ulps of the distance along the ray. The floor (2^9 ulps of the
# box's largest coordinate) covers both for rays that start in the scene,
# and the relative term (1/64 of the box) the Woop test's growth on thin
# triangles. Powers of two, so the kernel and this form round alike.
SC_MARGIN_REL = 2.0 ** -6
SC_MARGIN_FLOOR = 2.0 ** -14


def sc_widened_boxes(member):
    """Cluster boxes member [B, 6, M] (supercluster members, or the list
    entries of kernels 5 / 6) → (lo, hi [B, 3, M] widened by the admission
    margin, real [B, M] bool: the box holds a triangle, i.e. is not
    inverted). The kernels' order of operations."""
    lo, hi = member[:, 0:3], member[:, 3:6]
    ext = (hi - lo).amax(dim=1)
    mag = torch.maximum(lo.abs(), hi.abs()).amax(dim=1)
    margin = (ext * SC_MARGIN_REL + mag * SC_MARGIN_FLOOR)[:, None]
    return lo - margin, hi + margin, (lo <= hi).all(dim=1)


def _widened_cross(a, boxes, best_t):
    """The admission rule's own term: rays a [B, 256, 8] against boxes
    [B, 6, M] → bool [B, 256, M], set where the box is real, the ray is
    live and its slab test (`_slab_cross`) crosses the box widened by the
    margin, and, with best_t [B, 256], where that box's entry distance is
    not above best_t."""
    lo, hi, real = sc_widened_boxes(boxes)
    cross, tn = _slab_cross(a, lo, hi)
    adm = cross & real[:, None, :]
    if best_t is not None:
        adm = adm & (tn <= best_t[:, :, None])
    return adm


def sc_admitted_pairs_plain(a, member, best_t=None):
    """The pair admission rule of kernels 5c / 6c in plain PyTorch: rays a
    [B, 256, 8] against their blocks' member boxes member [B, 6, M] → bool
    [B, 256, M]. A (ray, member) pair is tested only when the member is in
    the block union (some live ray of the block crosses its box: the plain
    walks test no other member), its box is real, the ray is live and its
    own slab test (`_slab_cross`) crosses the box widened by the margin;
    for the closest walk (best_t [B, 256], the ray's running best t) also
    when that box's entry distance is not above best_t. The any-hit walk
    also drops the pairs of a ray already occluded (the caller's part). No
    pair of the plain walks that could change a row or an occlusion flag is
    dropped: tests/test_torch_supercluster.py and chip_smoke.py's
    dropped-pair audit hold the rule to that."""
    union = _member_cross(a, member).any(dim=1)              # [B, M]
    return _widened_cross(a, member, best_t) & union[:, None, :]


def admitted_pairs_plain(a, boxes, gm, gate: bool, best_t=None):
    """The pair admission rule of kernels 5 / 6 in plain PyTorch: rays a
    [B, 256, 8] against their blocks' list entries, cluster boxes boxes
    [B, 6, 1] with gate bits gm [B] → bool [B, 256]. A (ray, cluster) pair
    is tested only when the ray is live and its own slab test crosses the
    box widened by the margin of the supercluster tier
    (`sc_widened_boxes`), for the closest walk (best_t [B, 256]) only when
    that box's entry distance is not above the ray's running best t, and on
    a gated walk only when the ray's 32-ray group bit is set in gm: the
    gated plain walk never tests a ray whose bit is clear, even one that
    grazes the widened box. The any-hit walk also drops the pairs of a ray
    already occluded (the caller's part). No pair of the plain walks that
    could change a row or an occlusion flag is dropped:
    tests/test_torch_walks.py and chip_smoke.py's dropped-pair audit hold
    the rule to that."""
    adm = _widened_cross(a, boxes, best_t)[:, :, 0]
    if gate:
        adm = adm & _group_bits(gm)
    return adm


def _member_bits(cross):
    """Member crossings [B, R, M] (M <= 32) → int64 [B] holding a 32-bit
    mask: bit c is set when some ray of the block crosses member c. Integer
    shifts of distinct bits, so the sum is their OR, exactly.

    The reference (`_member_bits`, clusters.py:816-831) sums f32 `exp2`
    weights instead. `exp2` is not exact for every integer on XLA:CPU
    (exp2(13) = 8192.0039, exp2(15) = 32767.984), so past 13 members its
    masks name wrong members and its walk can drop hits; the port is held
    to it only at SC_CLUSTERS <= 8."""
    hv = cross.any(dim=1).to(torch.int64)
    shifts = torch.arange(cross.shape[2], dtype=torch.int64,
                          device=cross.device)
    return (hv << shifts).sum(dim=1)


def _lowest_bit(m):
    """Index of the lowest set bit of each 32-bit mask in m (int64, > 0):
    five integer mask tests, as `__ffs` - 1."""
    low = m & -m
    c = torch.zeros_like(m)
    for mask, width in ((0xFFFF0000, 16), (0xFF00FF00, 8), (0xF0F0F0F0, 4),
                        (0xCCCCCCCC, 2), (0xAAAAAAAA, 1)):
        c += ((low & mask) != 0).to(m.dtype) * width
    return c


def _for_each_set_member(bits, fn):
    """Pop each block's mask lowest bit first (clusters.py:834-855): call
    fn(sel, c) with the blocks sel [K] that still have a bit set and their
    lowest member c [K], then clear it. So every block visits its members
    in ascending order, the reference's and the kernels' order."""
    m = bits.clone()
    while True:
        sel = torch.nonzero(m)[:, 0]
        if sel.numel() == 0:
            return
        ms = m[sel]
        fn(sel, _lowest_bit(ms))
        m[sel] = ms & (ms - 1)


def _sc_visits(counts, lists, member_aabb, packed, block_chunk,
               admit=None):
    """The plain sc walks' schedule: for each list position, front to back,
    and each member of the entry's block-union mask, ascending →
    (blocks [K], member rows of comp [K], rays [K, 256, 8], allow). With
    `admit` (fn(blocks, rays, boxes) → admitted pairs [K, 256, M], called
    when the walk reaches the entry) the members are those of the admitted
    pairs' union and allow [K, 256] is each visit's admitted rays; else
    allow is None (every ray of the block is tested)."""
    counts, lists, rays = _walk_inputs(counts, lists, packed)
    sc = member_aabb.shape[2]
    for b, entry in _list_steps(counts, lists, block_chunk):
        s = (entry & 0xFFFF).to(torch.int64)     # group bits are ignored
        a = rays[b]
        cross = (_member_cross(a, member_aabb[s]) if admit is None
                 else admit(b, a, member_aabb[s]))
        visits = []
        _for_each_set_member(_member_bits(cross),
                             lambda sel, c: visits.append((sel, c)))
        for sel, c in visits:
            allow = None if admit is None else cross[sel, :, c]
            yield b[sel], s[sel] * sc + c, a[sel], allow


def walk_sc_closest_plain(counts, lists, tnear, comp, member_aabb, packed,
                          block_chunk: int = 256, admitted: bool = False):
    """Plain version of kernel 5c (`_sc_closest_kernel`, clusters.py:858) →
    rows [n_padded, 8] as walk_closest_plain. For each block, each list
    entry s (a supercluster) and each member c of the entry's block-union
    mask, ascending: the pair test against comp[s * SC + c], with
    walk_closest_plain's tie rule (smallest t, then lowest lane, then the
    earlier visit). No early exit; `tnear` is not read.

    admitted=True (for tests) tests only the pairs of the kernel's admission
    rule (`sc_admitted_pairs_plain`, at each ray's best t when the walk
    reaches the entry) and must give the same rows."""
    del tnear
    st = _ClosestState(packed.reshape(-1, SUB, 8))

    def admit(b, a, boxes):
        return sc_admitted_pairs_plain(a, boxes, st.bt[b])

    for b, rows, a, allow in _sc_visits(counts, lists, member_aabb, packed,
                                        block_chunk,
                                        admit if admitted else None):
        st.step(b, comp[rows], a, None, False, allow)
    return st.rows()


def walk_sc_any_plain(counts, lists, tnear, comp, member_aabb, packed,
                      block_chunk: int = 256, admitted: bool = False):
    """Plain version of kernel 6c (`_sc_any_kernel`, clusters.py:933) → occ
    [n_padded] int32, over the same visits as walk_sc_closest_plain;
    admitted=True (for tests) the admitted pairs only, rays occluded before
    the entry dropped."""
    del tnear
    occ = torch.zeros((counts.numel(), SUB), dtype=torch.bool,
                      device=packed.device)

    def admit(b, a, boxes):
        return sc_admitted_pairs_plain(a, boxes) & ~occ[b][:, :, None]

    for b, rows, a, allow in _sc_visits(counts, lists, member_aabb, packed,
                                        block_chunk,
                                        admit if admitted else None):
        ok, _, _, _ = _pair_ok(comp[rows], a, None, False)
        if allow is not None:
            ok = ok & allow[:, :, None]
        occ[b] = occ[b] | ok.any(dim=2)
    return occ.reshape(-1).to(torch.int32)


def _sc_walk_args(name, counts, lists, tnear, comp, member_aabb, packed):
    nb, c_pad = _walk_args(name, counts, lists, tnear, comp, packed)
    sc = member_aabb.shape[2] if member_aabb.ndim == 3 else 0
    if not 1 <= sc <= MAX_MEMBERS:
        raise ValueError(f"{name}: {sc} members per supercluster; the "
                         f"kernel takes 1 to {MAX_MEMBERS}")
    kernels.require(member_aabb, "member_aabb", torch.float32,
                    (member_aabb.shape[0], 6, sc), packed.device)
    return nb, c_pad, sc


def walk_sc_closest(counts, lists, tnear, comp, member_aabb, packed):
    """Kernel 5c (replaces `_sc_closest_kernel`, clusters.py:858; pallas_call
    at :1150): see walk_sc_closest_plain, whose rows it returns bit for bit.
    It tests only the pairs of the admission rule (`sc_admitted_pairs_plain`)
    and keeps each ray's best as one (t, slot, visit) key."""
    dev = packed.device
    if dev.type == "cpu":
        return walk_sc_closest_plain(counts, lists, tnear, comp, member_aabb,
                                     packed)
    if dev.type != "cuda":
        raise ValueError(f"walk_sc_closest: unsupported device {dev}")
    nb, c_pad, sc = _sc_walk_args("walk_sc_closest", counts, lists, tnear,
                                  comp, member_aabb, packed)
    rows = torch.empty((nb * SUB, 8), dtype=torch.float32, device=dev)
    if nb == 0:
        return rows
    with torch.cuda.device(dev), kernels.launch("cluster_sc_closest"):
        err = kernels.lib().ort_cluster_sc_closest(
            counts.data_ptr(), lists.data_ptr(),
            comp.data_ptr(), comp.shape[0], member_aabb.data_ptr(),
            member_aabb.shape[0], sc, packed.data_ptr(), nb, c_pad,
            rows.data_ptr(), kernels.stream_ptr(dev))
    kernels.check(err, "cluster_sc_closest")
    return rows


def walk_sc_any(counts, lists, tnear, comp, member_aabb, packed):
    """Kernel 6c (replaces `_sc_any_kernel`, clusters.py:933; pallas_call at
    :1372): see walk_sc_any_plain; the admitted pairs only, as kernel 5c."""
    dev = packed.device
    if dev.type == "cpu":
        return walk_sc_any_plain(counts, lists, tnear, comp, member_aabb,
                                 packed)
    if dev.type != "cuda":
        raise ValueError(f"walk_sc_any: unsupported device {dev}")
    nb, c_pad, sc = _sc_walk_args("walk_sc_any", counts, lists, tnear, comp,
                                  member_aabb, packed)
    occ = torch.empty((nb * SUB,), dtype=torch.int32, device=dev)
    if nb == 0:
        return occ
    with torch.cuda.device(dev), kernels.launch("cluster_sc_any"):
        err = kernels.lib().ort_cluster_sc_any(
            counts.data_ptr(), lists.data_ptr(),
            comp.data_ptr(), comp.shape[0], member_aabb.data_ptr(),
            member_aabb.shape[0], sc, packed.data_ptr(), nb, c_pad,
            occ.data_ptr(), kernels.stream_ptr(dev))
    kernels.check(err, "cluster_sc_any")
    return occ


# ---------------------------------------------------------------------------
# Queries
# ---------------------------------------------------------------------------

def _padded(n: int) -> int:
    return -(-n // SUPER) * SUPER


def _tier_cull(cl: ClusterSet, packed, exact: bool):
    """The cull of the table's tier (clusters.py:1104-1134) → (counts,
    lists, tnear, member_aabb). Up to MAX_STREAM_CLUSTERS clusters the lists
    hold clusters and member_aabb is None; past it they hold superclusters,
    culled through `_sc_facade` (c_pad <= 1024, so `exact` takes the exact
    cull there too)."""
    n_super = packed.shape[0] // SUPER
    if cl.num_clusters <= MAX_STREAM_CLUSTERS:
        return (*_cull(cl, packed, n_super, cl.c_pad, exact=exact), None)
    cull_aabb, member, n_sc = _sc_tables(cl)
    facade = _sc_facade(cl, cull_aabb, n_sc)
    return (*_cull(facade, packed, n_super, facade.c_pad, exact=exact),
            member)


def _closest_core(cl: ClusterSet, packed, exact=False, group_walk=False):
    """Cull + walk over packed [n_padded, 8] rays → (rows [n_padded, 8],
    counts [n_super, GROUPS, 1]). The walk is gated only on the exact cull
    of the resident tier, as `_closest_core` (clusters.py:1095-1164)."""
    counts, lists, tnear, member = _tier_cull(cl, packed, exact)
    with telemetry.span("clusters.walk", "closest"):
        if member is not None:
            return walk_sc_closest(counts, lists, tnear, cl.comp, member,
                                   packed), counts
        gate = bool(exact and group_walk and cl.num_clusters <= MAX_CLUSTERS)
        return walk_closest(counts, lists, tnear, cl.comp, cl.aabb, packed,
                            gate), counts


def _any_core(cl: ClusterSet, packed, exact=False, group_walk=False):
    """Cull + occlusion walk → int32 [n_padded], empty blocks cleared
    (clusters.py:1329-1388)."""
    counts, lists, tnear, member = _tier_cull(cl, packed, exact)
    with telemetry.span("clusters.walk", "any"):
        if member is not None:
            occ = walk_sc_any(counts, lists, tnear, cl.comp, member, packed)
        else:
            gate = bool(exact and group_walk
                        and cl.num_clusters <= MAX_CLUSTERS)
            occ = walk_any(counts, lists, tnear, cl.comp, cl.aabb, packed,
                           gate)
    live = torch.repeat_interleave(counts.reshape(-1) > 0, SUB)
    return torch.where(live, occ, 0)


def _hits_from_rows(rows, live, tmax) -> Hits:
    """Hits from per-ray rows [N, 8] and the live-block mask [N]
    (clusters.py:1167-1194): the interpolated normal is normalised, with a
    length under 1e-8 giving a zero normal."""
    t, u, v = rows[:, 0], rows[:, 1], rows[:, 2]
    normal = rows[:, 3:6]
    nlen = torch.sqrt(dot(normal, normal))[:, None]
    normal = torch.where(nlen > 1e-8, normal / torch.clamp_min(nlen, 1e-12),
                         0.0)
    prim = torch.where(live, rows[:, 6], -1.0).to(torch.int32)
    mat = torch.where(live, rows[:, 7], -1.0).to(torch.int32)
    hit = prim >= 0
    hit3 = hit[:, None]
    return Hits(t=torch.where(hit, t, tmax), prim_id=prim,
                inst_id=torch.where(hit, 0, -1).to(torch.int32), mat_id=mat,
                uv=torch.where(hit3, torch.stack([u, v], dim=-1), 0.0),
                normal=torch.where(hit3, normal, 0.0))


def closest_hit(cl: ClusterSet, rays: Rays, exact: bool = False,
                group_walk: bool = False) -> Hits:
    """Closest hit of a flat [N] ray batch. exact=True for scattered
    wavefronts; group_walk gates the walk per 32-ray group (exact only)."""
    n = rays.tmin.shape[0]
    _count_query("closest", n, _padded(n))
    packed = _pack_rays(rays, _padded(n))
    rows, counts = _closest_core(cl, packed, exact=exact,
                                 group_walk=group_walk)
    live = torch.repeat_interleave(counts.reshape(-1) > 0, SUB)[:n]
    return _hits_from_rows(rows[:n], live, rays.tmax)


def any_hit(cl: ClusterSet, rays: Rays, exact: bool = False,
            group_walk: bool = False) -> torch.Tensor:
    """Occlusion of a flat [N] ray batch → bool [N]."""
    n = rays.tmin.shape[0]
    _count_query("any", n, _padded(n))
    packed = _pack_rays(rays, _padded(n))
    return _any_core(cl, packed, exact=exact, group_walk=group_walk)[:n] != 0


def coherence_key(cl: ClusterSet, rays: Rays, okey_bits: int = 2,
                  dkey_bits: int = 5) -> torch.Tensor:
    """[N] int64 sort key holding a 32-bit word: origin-cell morton (major)
    | direction morton (minor), 0xFFFFFFFF for dead rays so they sort to the
    tail (clusters.py:1220-1249)."""
    ab = _aabb_rows(cl)
    real = (torch.arange(ab.shape[0], device=ab.device)
            < cl.num_clusters)[:, None]
    lo = torch.where(real, ab[:, 0:3], _BIG).amin(dim=0)
    hi = torch.where(real, ab[:, 3:6], -_BIG).amax(dim=0)
    extent = torch.clamp_min(hi - lo, 1e-12)
    okey = interleave(quantize((rays.origin - lo) / extent, okey_bits))
    dkey = interleave(quantize(rays.direction * 0.5 + 0.5, dkey_bits))
    key = (okey << (3 * dkey_bits)) | dkey
    return torch.where(rays.tmax <= rays.tmin, 0xFFFFFFFF, key)


def _sorted_perm(cl: ClusterSet, rays: Rays, n_padded: int):
    """Stable coherence permutation over the padded ray count."""
    n = rays.tmin.shape[0]
    key = coherence_key(cl, rays)
    key = torch.cat([key, key.new_full((n_padded - n,), 0xFFFFFFFF)])
    return torch.argsort(key, stable=True)


def closest_hit_sorted(cl: ClusterSet, rays: Rays,
                       group_walk: bool = False) -> Hits:
    """closest_hit of scattered rays: coherence-sorted, exact cull, then
    scattered back (clusters.py:1262-1283)."""
    n = rays.tmin.shape[0]
    n_padded = _padded(n)
    _count_query("closest", n, n_padded)
    packed = _pack_rays(rays, n_padded)
    perm = _sorted_perm(cl, rays, n_padded)
    rows, counts = _closest_core(cl, packed[perm], exact=True,
                                 group_walk=group_walk)
    live = torch.repeat_interleave(counts.reshape(-1) > 0, SUB)
    cols = torch.cat([rows, live[:, None].to(torch.float32)], dim=1)
    back = torch.zeros_like(cols)
    back[perm] = cols
    return _hits_from_rows(back[:n, :8], back[:n, 8] > 0.0, rays.tmax)


def any_hit_sorted(cl: ClusterSet, rays: Rays,
                   group_walk: bool = False) -> torch.Tensor:
    """any_hit of scattered rays with the coherence pre-sort."""
    n = rays.tmin.shape[0]
    n_padded = _padded(n)
    _count_query("any", n, n_padded)
    packed = _pack_rays(rays, n_padded)
    perm = _sorted_perm(cl, rays, n_padded)
    occ = _any_core(cl, packed[perm], exact=True, group_walk=group_walk)
    back = torch.empty_like(occ)
    back[perm] = occ
    return back[:n] != 0


def traversal_stats(cl: ClusterSet, rays: Rays) -> dict:
    """How many clusters (superclusters, on that tier) each 256-ray block
    walks under the interval cull (clusters.py:1299-1326) → dict of Python
    floats; a supercluster counts SC_CLUSTERS * 128 triangles."""
    packed = _pack_rays(rays, _padded(rays.tmin.shape[0]))
    counts, _, _, member = _tier_cull(cl, packed, exact=False)
    per_item = LANES if member is None else member.shape[2] * LANES
    c = counts.reshape(-1).to(torch.float64)
    return {
        "mean_clusters_per_block": float(c.mean()),
        "max_clusters_per_block": float(c.max()),
        "mean_tris_tested_per_ray": float(c.mean() * per_item),
        "empty_block_fraction": float((c == 0).to(torch.float64).mean()),
    }


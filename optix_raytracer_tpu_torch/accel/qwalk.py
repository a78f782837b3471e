"""Cluster-major queue traversal: kernels 7 and 8 and their plain versions
(counterpart of `accel/qwalk.py`; the kernels are `csrc/clusters.cu`).

The gated walk of `accel/clusters.py` is ray-block-major: each 256-ray block
walks the union of its rays' crossed clusters, every lane through every
listed cluster. The queue turns the loop around. A query

1. culls every (8-ray octet, cluster) pair with the exact per-ray slab test
   (kernel 7, `_oct_cull`): one 32-bit octet mask per (256-ray block,
   cluster), bit j set when some live ray of rows 8j..8j+7 crosses;
2. lays the crossing (octet, cluster) pairs out as a flat work list
   (`_build_queue`), cluster-major: cluster id ascending, then octet
   ascending, each cluster's run padded to ITEMS = 32 items, so that every
   step of 32 items (256 rays) serves one cluster;
3. gathers each work item's 8 packed rays into a dense planar [8, K*8]
   array (`_marshal`);
4. pair-tests each step's 256 marshalled rays against its cluster's 128
   triangle slots (kernel 8, `_run_queue`): a closest candidate row or an
   occlusion flag per marshalled ray. The kernel tests only the rays its
   admission rule lets through (`queue_admitted_plain`: live, and crossing
   the cluster's box widened by the walks' margin) and writes the miss row
   for the others, which is what the plain versions give there;
5. reduces the candidates per source ray with PyTorch scatter ops: the
   minimum t among hit rows, ties to the lowest marshalled row (that is the
   lowest cluster id, then the lowest slot), or the OR of the flags.

The work list holds at most k_cap = qf items per octet of the padded batch
(qf = 6, as in the reference). A query whose list is longer overflows and
is answered by the ungated exact-cull walk (`clusters.closest_hit` /
`any_hit` with exact=True), as the reference's `lax.cond` does; kernel 8 is
then not launched, and `STATS` counts the query as an overflow.

The reference's import-time constants (GROUPS, SUPER, ... from its
clusters module) are read here from the port's `accel/clusters.py` at call
time, so a test that patches the padding there patches it here too.

On CUDA tensors the wrappers launch the kernels; on CPU tensors they run the
plain versions.
"""
from __future__ import annotations

import torch

from .. import kernels, telemetry
from ..core.rays import Hits, Rays
from . import clusters as C

OCT = 8          # rays per work-item octet
ITEMS = 32       # work items per step
ROWS = ITEMS * OCT               # 256 marshalled rays per step

# Queries answered by the queue and by the overflow walk, per kind.
STATS = telemetry.counters("qwalk.queries", (
    "closest_queue", "closest_overflow", "any_queue", "any_overflow"))


def reset_stats():
    telemetry.reset_counters("qwalk.queries")


# ---------------------------------------------------------------------------
# Stage 1: the octet cull (kernel 7)
# ---------------------------------------------------------------------------

def _to_int32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) → int32 with the same 32 bits."""
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def oct_cull_plain(aabb, packed, n_blocks: int, c_pad: int):
    """Plain version of kernel 7 → om [n_blocks, c_pad] int32: bit j of
    om[b, c] is set when a live ray of rows 8j..8j+7 of block b crosses
    cluster c's AABB (the exact slab test, `clusters._slab_cross`). Padding
    clusters (inverted boxes) cross every live ray, as in the reference."""
    ab = aabb.transpose(1, 2).reshape(c_pad, 6).T            # [6, c_pad]
    lo, hi = ab[None, 0:3], ab[None, 3:6]
    blk = packed.reshape(n_blocks, C.SUB, 8)
    om = torch.empty((n_blocks, c_pad), dtype=torch.int32,
                     device=packed.device)
    n_oct = C.SUB // OCT
    shifts = torch.arange(n_oct, device=packed.device, dtype=torch.int64)
    for s, e in C._block_chunks(n_blocks, C.SUB * c_pad):
        cross, _ = C._slab_cross(blk[s:e], lo, hi)
        octs = cross.reshape(e - s, n_oct, OCT, c_pad).any(dim=2)
        bits = (octs.to(torch.int64) << shifts[None, :, None]).sum(dim=1)
        om[s:e] = _to_int32_bits(bits)
    return om


def _oct_cull(cl: C.ClusterSet, packed, n_blocks: int, c_pad: int):
    """Kernel 7 (replaces `_oct_cull_kernel`, qwalk.py:69; pallas_call at
    :117): see oct_cull_plain. Kernel 4's template with octet bits: a
    member column is slab-tested only for the live rays that cross its
    group box (`clusters.cull_admitted_pairs_plain`,
    `clusters.cull_group(c_pad)` columns a group)."""
    dev = packed.device
    if dev.type == "cpu":
        return oct_cull_plain(cl.aabb, packed, n_blocks, c_pad)
    if dev.type != "cuda":
        raise ValueError(f"_oct_cull: unsupported device {dev}")
    if c_pad % C.LANES:
        raise ValueError(f"_oct_cull: c_pad {c_pad} is not a multiple of "
                         f"{C.LANES}")
    kernels.require(cl.aabb, "aabb", torch.float32,
                    (c_pad // C.LANES, 6, C.LANES), dev)
    kernels.require(packed, "packed rays", torch.float32,
                    (n_blocks * C.SUB, 8), dev)
    om = torch.empty((n_blocks, c_pad), dtype=torch.int32, device=dev)
    if n_blocks == 0:
        return om
    with torch.cuda.device(dev), kernels.launch("qwalk_oct_cull"):
        err = kernels.lib().ort_qwalk_oct_cull(
            cl.aabb.data_ptr(), c_pad, packed.data_ptr(), n_blocks,
            om.data_ptr(), C.cull_group(c_pad), kernels.stream_ptr(dev))
    kernels.check(err, "qwalk_oct_cull")
    return om


# ---------------------------------------------------------------------------
# Stages 2-3: the work list and the marshalled rays (PyTorch)
# ---------------------------------------------------------------------------

def _build_queue(om, n_clusters: int, n_padded: int, k_cap: int):
    """om [n_blocks, c_pad] int32 octet masks → (steps [3, n_steps] int32:
    per step its cluster id, its output column block and its qrays column
    block (a dead step past n_items points at block 0 and at the spill
    column n_steps); work_oct [k_cap] int32, the octet of each work item,
    -1 for padding; overflow (n_items > k_cap); n_items), as
    `_build_queue` (qwalk.py:135-175).

    The items are the set bits of the cluster-major [C, n_oct] crossing
    matrix in row-major order, found with `torch.nonzero` over the nonzero
    mask words and then over their bits: the reference's order, without its
    dense [C, n_oct] cumsum (tens of GB at 31k clusters)."""
    dev = om.device
    cm = om.T[:n_clusters].contiguous()                      # [C, n_blocks]
    c_idx, b_idx = torch.nonzero(cm, as_tuple=True)          # cluster-major
    words = cm[c_idx, b_idx]
    j = torch.arange(32, device=dev, dtype=torch.int32)
    e_idx, bit = torch.nonzero(((words[:, None] >> j) & 1) != 0,
                               as_tuple=True)
    cluster = c_idx[e_idx]
    octet = b_idx[e_idx] * (C.SUB // OCT) + bit
    cnt_c = torch.bincount(cluster, minlength=n_clusters)    # [C] int64
    pad_c = -(-cnt_c // ITEMS) * ITEMS                       # run lengths
    run_end = torch.cumsum(pad_c, 0)
    base_c = run_end - pad_c                                 # run starts
    n_items = int(run_end[-1])
    first = torch.cumsum(cnt_c, 0) - cnt_c                   # first item
    rank = torch.arange(cluster.shape[0], device=dev) - first[cluster]
    slot = base_c[cluster] + rank
    keep = slot < k_cap
    work_oct = torch.full((k_cap,), -1, dtype=torch.int32, device=dev)
    work_oct[slot[keep]] = octet[keep].to(torch.int32)
    n_steps = k_cap // ITEMS
    sidx = torch.arange(n_steps, device=dev, dtype=torch.int64)
    step_cluster = torch.clamp_max(
        torch.searchsorted(run_end, sidx * ITEMS, right=True), n_clusters - 1)
    live = sidx * ITEMS < n_items
    steps = torch.stack([step_cluster,
                         torch.where(live, sidx, n_steps),
                         torch.where(live, sidx, 0)]).to(torch.int32)
    return steps, work_oct, n_items > k_cap, n_items


def _marshal(packed, work_oct, n_padded: int):
    """Each work item's 8 packed rays → (qrays [8, K*8] f32, planar: one row
    per ray component, K = len(work_oct); qrow [K*8] int32, each marshalled
    ray's source row). Padding items get an empty window (tmax = tmin - 1)
    and the drop row n_padded (qwalk.py:178-193)."""
    k = work_oct.shape[0]
    octs = packed.reshape(n_padded // OCT, OCT, 8)
    dead = work_oct < 0
    q = octs[torch.clamp(work_oct, 0, octs.shape[0] - 1).to(torch.int64)]
    q[:, :, 7] = torch.where(dead[:, None], q[:, :, 6] - 1.0, q[:, :, 7])
    lane = torch.arange(OCT, dtype=torch.int32, device=packed.device)
    qrow = torch.where(dead[:, None], n_padded,
                       work_oct[:, None] * OCT + lane[None, :])
    return q.reshape(k * OCT, 8).T.contiguous(), qrow.reshape(k * OCT)


# ---------------------------------------------------------------------------
# Stage 4: the queue kernels (kernel 8) and their plain versions
# ---------------------------------------------------------------------------

def _step_chunks(steps, qrays, step_chunk: int):
    """The plain queue's schedule: chunks of live steps → (steps' cluster
    ids [S], output column blocks [S], their rays [S, 256, 8]). A step whose
    output column is past the last step (a dead step) is skipped."""
    n_steps = steps.shape[1]
    live = torch.nonzero(steps[1] < n_steps)[:, 0]
    lane = torch.arange(ROWS, device=qrays.device)
    for s in range(0, live.shape[0], step_chunk):
        idx = live[s:s + step_chunk]
        cols = steps[2, idx].to(torch.int64)[:, None] * ROWS + lane[None]
        rays = qrays[:, cols.reshape(-1)].T.reshape(idx.shape[0], ROWS, 8)
        yield (steps[0, idx].to(torch.int64), steps[1, idx].to(torch.int64),
               rays)


def _scatter_cols(out, o, vals):
    """Write vals [S*256, R] to the column blocks o [S] of out [R, *]."""
    lane = torch.arange(ROWS, device=out.device)
    out[:, (o[:, None] * ROWS + lane[None]).reshape(-1)] = vals.T


def queue_closest_plain(steps, qrays, comp, step_chunk: int = 64):
    """Plain version of kernel 8's closest variant (`_q_closest_kernel`,
    qwalk.py:227) → cand [8, n_steps*256] f32: for each live step s and
    lane r, marshalled ray steps[2, s]*256 + r tested against the 128 slots
    of cluster steps[0, s], written to column steps[1, s]*256 + r as
    (t u v nx ny nz prim mat): the smallest t with tmin < t < tmax, the
    lowest slot among equal t, and the unnormalised normal n0 + u*d10 +
    v*d20; t = tmax, zeros and prim = mat = -1 on a miss. Columns of dead
    steps stay zero."""
    n_steps = steps.shape[1]
    out = torch.zeros((8, n_steps * ROWS), dtype=torch.float32,
                      device=qrays.device)
    for c, o, rays in _step_chunks(steps, qrays, step_chunk):
        st = C._ClosestState(rays)
        st.step(torch.arange(c.shape[0], device=rays.device), comp[c], rays,
                None, False)
        _scatter_cols(out, o, st.rows())
    return out


def queue_any_plain(steps, qrays, comp, step_chunk: int = 64):
    """Plain version of kernel 8's any-hit variant (`_q_any_kernel`,
    qwalk.py:208) → occ [1, n_steps*256] f32: 1.0 where the marshalled ray
    hits one of its step's cluster's 128 slots with tmin < t < tmax, else
    0.0; columns of dead steps stay zero."""
    n_steps = steps.shape[1]
    out = torch.zeros((1, n_steps * ROWS), dtype=torch.float32,
                      device=qrays.device)
    for c, o, rays in _step_chunks(steps, qrays, step_chunk):
        ok, _, _, _ = C._pair_ok(comp[c], rays, None, False)
        _scatter_cols(out, o, ok.any(dim=2).to(torch.float32).reshape(-1, 1))
    return out


def queue_admitted_plain(steps, qrays, aabb, step_chunk: int = 256):
    """Kernel 8's admission rule in plain PyTorch → bool [n_steps*256], by
    output column as the candidates: lane r of live step s (column
    steps[1, s]*256 + r) is admitted when its marshalled ray is live and
    its own slab test (`clusters._slab_cross`) crosses the box of cluster
    steps[0, s] (aabb [c_pad / 128, 6, 128]) widened by the walks' margin
    (`clusters.sc_widened_boxes`, the kernels' rounding); a box that is
    not real (inverted) admits every live ray. A Woop hit lies inside the
    widened box, so a ray left out has no hit in that cluster: its plain
    candidate is the miss row (flag 0.0), which the kernel writes without
    a test. Columns of dead steps are False."""
    n_steps = steps.shape[1]
    out = torch.zeros((1, n_steps * ROWS), dtype=torch.bool,
                      device=qrays.device)
    boxes = C._entry_boxes(aabb)                             # [c_pad, 6, 1]
    for c, o, rays in _step_chunks(steps, qrays, step_chunk):
        lo, hi, real = C.sc_widened_boxes(boxes[c])
        cross = C._slab_cross(rays, lo, hi)[0][:, :, 0]
        live = rays[:, :, 7] > rays[:, :, 6]
        _scatter_cols(out, o, (cross | (live & ~real)).reshape(-1, 1))
    return out[0]


def _run_queue(closest: bool, comp, steps, qrays, aabb=None):
    """Kernel 8 (replaces `_q_closest_kernel` / `_q_any_kernel`, qwalk.py:
    227, 208; pallas_call at :283): see queue_closest_plain and
    queue_any_plain. steps [3, n_steps] int32, qrays [8, Q] f32 planar,
    comp [C, 32, 128] f32 → [8 or 1, n_steps*256] f32. The kernel also
    takes the table's cluster boxes aabb [c_pad / 128, 6, 128] for its
    admission rule (`queue_admitted_plain`); the plain versions test every
    ray and do not read them."""
    dev = qrays.device
    if dev.type == "cpu":
        plain = queue_closest_plain if closest else queue_any_plain
        return plain(steps, qrays, comp)
    if dev.type != "cuda":
        raise ValueError(f"_run_queue: unsupported device {dev}")
    if aabb is None:
        raise ValueError("_run_queue: kernel 8 needs the cluster boxes")
    n_steps = steps.shape[1]
    kernels.require(steps, "steps", torch.int32, (3, n_steps), dev)
    kernels.require(qrays, "qrays", torch.float32, (8, qrays.shape[1]), dev)
    kernels.require(comp, "comp", torch.float32,
                    (comp.shape[0], C.COMP_ROWS, C.LANES), dev)
    kernels.require(aabb, "aabb", torch.float32, (aabb.shape[0], 6, C.LANES),
                    dev)
    if aabb.shape[0] * C.LANES < comp.shape[0]:
        raise ValueError(f"_run_queue: aabb holds {aabb.shape[0] * C.LANES} "
                         f"boxes for {comp.shape[0]} clusters")
    out = torch.zeros((8 if closest else 1, n_steps * ROWS),
                      dtype=torch.float32, device=dev)
    if n_steps == 0:
        return out
    name = "qwalk_closest" if closest else "qwalk_any"
    with torch.cuda.device(dev), kernels.launch(name):
        err = getattr(kernels.lib(), f"ort_{name}")(
            steps.data_ptr(), n_steps, qrays.data_ptr(), qrays.shape[1],
            comp.data_ptr(), comp.shape[0], aabb.data_ptr(), out.data_ptr(),
            kernels.stream_ptr(dev))
    kernels.check(err, name)
    return out


# ---------------------------------------------------------------------------
# Queries
# ---------------------------------------------------------------------------

def _prep(cl: C.ClusterSet, rays: Rays, qf: int):
    """→ (n, n_padded, packed, n_blocks, c_pad, k_cap), qwalk.py:297-304,
    with the padding of the port's clusters module."""
    n = rays.tmin.shape[0]
    n_padded = -(-n // C.SUPER) * C.SUPER
    packed = C._pack_rays(rays, n_padded)
    n_blocks = n_padded // C.SUB
    c_pad = cl.aabb.shape[0] * C.LANES
    k_cap = max(ITEMS, (qf * (n_padded // OCT) // ITEMS) * ITEMS)
    return n, n_padded, packed, n_blocks, c_pad, k_cap


def _queue(cl: C.ClusterSet, rays: Rays, qf: int, closest: bool):
    """Stages 1-4 → (n, n_padded, cand [R, n_items*8] or None on overflow,
    qrow [n_items*8])."""
    n, n_padded, packed, n_blocks, c_pad, k_cap = _prep(cl, rays, qf)
    om = _oct_cull(cl, packed, n_blocks, c_pad)
    steps, work_oct, overflow, n_items = _build_queue(
        om, cl.num_clusters, n_padded, k_cap)
    if overflow:
        return n, n_padded, None, None
    qrays, qrow = _marshal(packed, work_oct[:n_items], n_padded)
    cand = _run_queue(closest, cl.comp,
                      steps[:, :n_items // ITEMS].contiguous(), qrays,
                      cl.aabb)
    return n, n_padded, cand, qrow


def any_hit(cl: C.ClusterSet, rays: Rays, qf: int = 6) -> torch.Tensor:
    """Occlusion of a flat [N] ray batch through the queue → bool [N]
    (qwalk.py:307-329). On overflow, the ungated exact-cull walk."""
    n, n_padded, occ, qrow = _queue(cl, rays, qf, closest=False)
    if occ is None:
        STATS["any_overflow"] += 1
        return C.any_hit(cl, rays, exact=True, group_walk=False)
    STATS["any_queue"] += 1
    acc = torch.zeros((n_padded + 1,), dtype=torch.float32,
                      device=occ.device)
    acc.scatter_reduce_(0, qrow.to(torch.int64), occ[0], "amax")
    return acc[:n] > 0.0


def closest_hit(cl: C.ClusterSet, rays: Rays, qf: int = 6) -> Hits:
    """Closest hit of a flat [N] ray batch through the queue → Hits
    (qwalk.py:332-372). Per source ray: the minimum t over its hit rows,
    ties to the lowest marshalled row, whose 8 fields are scattered to the
    ray's row. On overflow, the ungated exact-cull walk."""
    n, n_padded, cand, qrow = _queue(cl, rays, qf, closest=True)
    if cand is None:
        STATS["closest_overflow"] += 1
        return C.closest_hit(cl, rays, exact=True, group_walk=False)
    STATS["closest_queue"] += 1
    dev = cand.device
    seg = qrow.to(torch.int64)
    keys = torch.where(cand[6] >= 0.0, cand[0], C._BIG)     # miss → BIG
    tbest = torch.full((n_padded + 1,), C._BIG, dtype=torch.float32,
                       device=dev).scatter_reduce_(0, seg, keys, "amin")
    is_best = (keys == tbest[seg]) & (keys < C._BIG)
    ridx = torch.arange(keys.shape[0], device=dev)
    big = torch.iinfo(torch.int64).max
    rbest = torch.full((n_padded + 1,), big, dtype=torch.int64,
                       device=dev).scatter_reduce_(
        0, seg, torch.where(is_best, ridx, big), "amin")
    win = is_best & (ridx == rbest[seg])
    rows = torch.zeros((n_padded, 8), dtype=torch.float32, device=dev)
    rows[:, 6:8] = -1.0                                      # default miss
    rows.index_put_((seg[win],), cand[:, win].T)
    # rays with no winning row keep the miss default; _hits_from_rows then
    # gives them t = tmax
    live = torch.ones((n,), dtype=torch.bool, device=dev)
    return C._hits_from_rows(rows[:n], live, rays.tmax)


def queue_stats(cl: C.ClusterSet, rays: Rays, qf: int = 6) -> dict:
    """Work-list statistics (qwalk.py:375-388): items, capacity, overflow,
    rays, live rays and items per live octet, as Python numbers."""
    n, n_padded, packed, n_blocks, c_pad, k_cap = _prep(cl, rays, qf)
    om = _oct_cull(cl, packed, n_blocks, c_pad)
    _, _, overflow, n_items = _build_queue(om, cl.num_clusters, n_padded,
                                           k_cap)
    live = int((rays.tmax > rays.tmin).sum())
    return dict(n_items=n_items, k_cap=k_cap, overflow=bool(overflow),
                n_rays=n, live_rays=live,
                items_per_live_octet=float(n_items) / max(live / OCT, 1.0))

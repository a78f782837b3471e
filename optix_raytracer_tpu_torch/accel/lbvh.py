"""On-device LBVH construction (Karras 2012) in the threaded (skip-pointer)
layout (counterpart of `accel/lbvh.py`).

Morton-code sort, binary radix tree topology, bottom-up AABB refit and the
DFS reordering with escape ("skip") pointers, each a fixed-depth torch
program over the whole mesh, so the build runs on the device the geometry
lives on, per frame for dynamic geometry (`api/accel.py::refit_gas`). A
ray's walk carries one node index: "descend" is ptr + 1, "skip the subtree"
is the node's escape index (`accel/traverse.py`).

The node arrays equal the JAX build's bit for bit: the sort is stable, so
equal codes keep their index order (the tie-break `_delta` assumes);
`_log2_floor` is exact integer arithmetic (a float log2 rounds up just
below powers of two, lbvh.py:71-80, tests/test_lbvh.py:55); the sweeps are
the reference's fixed `min(64, n) + 2` Jacobi passes, each reading the
previous pass's arrays; min / max are exact.
"""
from __future__ import annotations

import dataclasses

import torch

from .geometry import TriangleGeometry
from .morton import morton3d

_MAX_DEPTH_SWEEPS = 64  # >= the radix tree's depth for n <= 2^32 leaves


@dataclasses.dataclass
class LBVH:
    """Threaded BVH over one TriangleGeometry, in DFS order, held once as
    `nodes` [2n-1, 8] f32 rows (lo x, y, z, skip bits, hi x, y, z, prim
    bits): the walk kernel's table, two 16-byte loads a node. The
    reference's arrays are views of it: node_lo / node_hi [2n-1, 3] f32
    boxes, node_skip [2n-1] int32 escape index (2n-1 is END, past the last
    node), node_prim [2n-1] int32 leaf triangle id (-1 for internal nodes).
    """
    nodes: torch.Tensor

    @property
    def node_lo(self) -> torch.Tensor:
        return self.nodes[:, 0:3]

    @property
    def node_hi(self) -> torch.Tensor:
        return self.nodes[:, 4:7]

    @property
    def node_skip(self) -> torch.Tensor:
        return self.nodes.view(torch.int32)[:, 3]

    @property
    def node_prim(self) -> torch.Tensor:
        return self.nodes.view(torch.int32)[:, 7]

    @property
    def num_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def device(self):
        return self.nodes.device

    @classmethod
    def from_arrays(cls, lo, hi, skip, prim, at=None) -> "LBVH":
        """The table of boxes lo, hi [k, 3], escape indices skip and leaf
        ids prim [k], row at[i] taking entry i (rows in order where at is
        None)."""
        k = prim.shape[0]
        nodes = torch.empty((k, 8), dtype=torch.float32, device=lo.device)
        rows = slice(None) if at is None else at
        bits = nodes.view(torch.int32)
        nodes[rows, 0:3] = lo.to(torch.float32)
        nodes[rows, 4:7] = hi.to(torch.float32)
        bits[rows, 3] = skip.to(torch.int32)
        bits[rows, 7] = prim.to(torch.int32)
        return cls(nodes=nodes)

    @classmethod
    def empty(cls, device) -> "LBVH":
        return cls(nodes=torch.zeros((0, 8), dtype=torch.float32,
                                     device=device))

    @classmethod
    def from_numpy(cls, arrays: dict, device) -> "LBVH":
        """The native SAH builder's dict of numpy arrays
        (`native.build_bvh_sah`) → LBVH on `device`."""
        return cls.from_arrays(*(torch.as_tensor(arrays[k], device=device)
                                 for k in ("node_lo", "node_hi", "node_skip",
                                           "node_prim")))


def _log2_floor(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) of int64 values in [0, 2^32), -1 for 0: a binary
    search by shifts, exact (lbvh.py:71-80 take count-leading-zeros)."""
    x = x.to(torch.int64)
    r = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        big = (x >> s) > 0
        x = torch.where(big, x >> s, x)
        r = r + big.to(torch.int64) * s
    return torch.where(x == 0, -1, r)


def _delta(codes: torch.Tensor, i, j, n: int) -> torch.Tensor:
    """Common-prefix length of sorted keys i and j, -1 out of range
    (lbvh.py:52-68). Keys are (morton, index) pairs, so equal codes stay
    distinct: clz(m_i ^ m_j), or 32 + clz(i ^ j) on equal codes."""
    oob = (j < 0) | (j >= n)
    j_c = torch.clamp(j, 0, n - 1)
    x = codes[i] ^ codes[j_c]
    d = torch.where(x == 0, 32 + (31 - _log2_floor(i ^ j_c)),
                    31 - _log2_floor(x))
    return torch.where(oob, -1, d)


def _build_topology(codes: torch.Tensor, n: int):
    """Karras radix tree over n sorted keys (lbvh.py:83-125): the children
    (left, right) [n-1] of internal nodes 0..n-2, internal node j as j, leaf
    j as (n-1) + j. The range length and the split are found by descending
    power-of-two binary searches of 31 fixed steps."""
    dev = codes.device
    codes = codes.to(torch.int64)
    i = torch.arange(n - 1, dtype=torch.int64, device=dev)
    d = torch.sign(_delta(codes, i, i + 1, n) - _delta(codes, i, i - 1, n))
    d = torch.where(d == 0, 1, d)
    delta_min = _delta(codes, i, i - d, n)

    # range length: the largest l with delta(i, i + l d) > delta_min
    l = torch.zeros_like(i)
    for k in range(30, -1, -1):
        cand = l + (1 << k)
        l = torch.where(_delta(codes, i, i + cand * d, n) > delta_min, cand,
                        l)
    j = i + l * d

    # split: the largest s <= l - 1 with delta(i, i + s d) > delta(i, j)
    delta_node = _delta(codes, i, j, n)
    s = torch.zeros_like(i)
    for k in range(30, -1, -1):
        cand = s + (1 << k)
        ok = (cand <= l - 1) & (_delta(codes, i, i + cand * d, n)
                                > delta_node)
        s = torch.where(ok, cand, s)
    gamma = i + s * d + torch.clamp_max(d, 0)

    low = torch.minimum(i, j)
    high = torch.maximum(i, j)
    left = torch.where(low == gamma, (n - 1) + gamma, gamma)
    right = torch.where(high == gamma + 1, (n - 1) + gamma + 1, gamma + 1)
    return left, right


def _tri_bounds(geom: TriangleGeometry):
    v0, e1, e2 = geom.v0, geom.e1, geom.e2
    v1, v2 = v0 + e1, v0 + e2
    return (torch.minimum(v0, torch.minimum(v1, v2)),
            torch.maximum(v0, torch.maximum(v1, v2)))


def build_lbvh(geom: TriangleGeometry) -> LBVH:
    """The threaded LBVH of a triangle geometry, on its device
    (lbvh.py:128-220)."""
    dev = geom.tri_consts.device
    n = geom.num_triangles
    if n == 0:
        return LBVH.empty(dev)
    tri_lo, tri_hi = _tri_bounds(geom)
    if n == 1:
        return LBVH.from_arrays(
            tri_lo, tri_hi, torch.ones((1,), dtype=torch.int32, device=dev),
            torch.zeros((1,), dtype=torch.int32, device=dev))
    centroid = 0.5 * (tri_lo + tri_hi)
    codes = morton3d(centroid, tri_lo.amin(dim=0), tri_hi.amax(dim=0))
    codes_sorted, order = torch.sort(codes, stable=True)
    left, right = _build_topology(codes_sorted, n)

    ni = n - 1                      # internal nodes
    nn = 2 * n - 1                  # all nodes
    ar = torch.arange(ni, dtype=torch.int64, device=dev)
    parent = torch.full((nn,), -1, dtype=torch.int64, device=dev)
    parent[left] = ar
    parent[right] = ar
    is_left = torch.zeros((nn,), dtype=torch.bool, device=dev)
    is_left[left] = True

    # bottom-up boxes and subtree sizes, fixed Jacobi sweeps
    lo = torch.full((nn, 3), torch.inf, dtype=torch.float32, device=dev)
    hi = torch.full((nn, 3), -torch.inf, dtype=torch.float32, device=dev)
    lo[ni:] = tri_lo[order]
    hi[ni:] = tri_hi[order]
    size = torch.zeros((nn,), dtype=torch.int64, device=dev)
    size[ni:] = 1
    sweeps = min(_MAX_DEPTH_SWEEPS, n) + 2
    for _ in range(sweeps):
        new_lo = torch.minimum(lo[left], lo[right])
        new_hi = torch.maximum(hi[left], hi[right])
        new_size = size[left] + size[right]
        lo[:ni] = new_lo
        hi[:ni] = new_hi
        size[:ni] = new_size

    # DFS position and skip pointer, fixed top-down sweeps:
    # dfs(root) = 0, dfs(left) = dfs(p) + 1, dfs(right) = dfs(p) + 1 +
    # nodes of the left sibling's subtree; skip(root) = END, skip(left) =
    # dfs(right sibling), skip(right) = skip(p).
    sibling = torch.zeros((nn,), dtype=torch.int64, device=dev)
    sibling[left] = right
    sibling[right] = left
    has_parent = parent >= 0
    p = torch.clamp_min(parent, 0)
    dfs = torch.zeros((nn,), dtype=torch.int64, device=dev)
    skip = torch.full((nn,), nn, dtype=torch.int64, device=dev)
    sib_nodes = 2 * size[sibling] - 1
    for _ in range(sweeps):
        new_dfs = torch.where(is_left, dfs[p] + 1, dfs[p] + 1 + sib_nodes)
        new_skip = torch.where(is_left, dfs[sibling], skip[p])
        dfs = torch.where(has_parent, new_dfs, dfs)
        skip = torch.where(has_parent, new_skip, skip)

    prim = torch.cat([torch.full((ni,), -1, dtype=torch.int32, device=dev),
                      order.to(torch.int32)])
    return LBVH.from_arrays(lo, hi, skip, prim, at=dfs)

"""BVH: host-side build + stackless device traversal.

The reference declares `bvh_node` with a correct ordered traversal but an
empty build constructor ("To be implemented later", src/bvh.h:12-14) and
never instantiates it — its only acceleration is the linear closest-hit scan
(src/hittable_list.h:25-39). This module completes the design:

- Build on host (numpy): top-down median split on the centroid of the
  longest axis, leaf size <= LEAF_SIZE. Sphere boxes follow the reference:
  center +/- r, union of t0/t1 boxes for moving spheres (src/sphere.h:9-28).
- Flatten to arrays in DFS pre-order with *miss links* (escape pointers):
  traversal needs no stack — each ray carries one node pointer; on AABB hit
  it advances to the next node in pre-order, on miss it jumps the subtree.
  This is the divergence-free formulation SIMD lanes want (SURVEY.md §7
  "hard parts").
- Traverse on device with `lax.while_loop` over per-ray pointers, vectorized
  across the ray batch; leaves test <= LEAF_SIZE spheres with the exact
  reference quadratic (ops/intersect.sphere_hit_t math).

The traversal is forward-path acceleration; the differentiable path keeps
the brute-force masked argmin (grad/inverse.py) whose reverse-mode is
well-defined.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from raytracingproject_tpu.config import T_MIN, T_MAX
from raytracingproject_tpu.ops.intersect import HitRecord
from raytracingproject_tpu.ops.vecmath import dot
from raytracingproject_tpu.scene import Scene

LEAF_SIZE = 4
SENTINEL = -1  # miss link of the root's escape: traversal done


class FlatBVH(NamedTuple):
    """DFS pre-order flattened BVH. M nodes; inner nodes have
    leaf_count == 0. `prim_order` permutes the original sphere arrays so
    each leaf's primitives are contiguous [leaf_start, leaf_start+leaf_count).
    """

    node_min: jnp.ndarray    # [M, 3]
    node_max: jnp.ndarray    # [M, 3]
    miss_link: jnp.ndarray   # [M] int32 — node to jump to when AABB missed
    leaf_start: jnp.ndarray  # [M] int32 — first primitive (sorted order)
    leaf_count: jnp.ndarray  # [M] int32 — 0 for inner nodes
    prim_order: jnp.ndarray  # [N] int32 — sorted -> original sphere index


def sphere_bounds(scene: Scene) -> tuple[np.ndarray, np.ndarray]:
    """Per-sphere AABBs incl. motion (src/sphere.h:9-28): center +/- r,
    unioned over both endpoints for moving spheres."""
    # Single bulk device->host fetch: per-leaf numpy indexing on device
    # arrays would round-trip to the device per access.
    c0_d, cd_d, r_d = jax.device_get((scene.center0, scene.center_delta, scene.radius))
    c0 = np.asarray(c0_d, np.float64)
    c1 = c0 + np.asarray(cd_d, np.float64)
    r = np.abs(np.asarray(r_d, np.float64))[:, None]
    bmin = np.minimum(c0 - r, c1 - r)
    bmax = np.maximum(c0 + r, c1 + r)
    return bmin, bmax


def build_bvh(scene: Scene, leaf_size: int = LEAF_SIZE) -> FlatBVH:
    """Host-side top-down build, flattened with miss links.

    Uses the native binned-SAH builder (native/bvh_builder.cpp) when the
    toolchain is available, else the Python median-split build below. Both
    produce the same FlatBVH layout and are traversal-equivalent (tree
    shapes differ; closest-hit results are identical)."""
    native = _build_bvh_native(scene, leaf_size)
    if native is not None:
        return native
    return _build_bvh_python(scene, leaf_size)


def _build_bvh_native(scene: Scene, leaf_size: int) -> FlatBVH | None:
    import ctypes

    from raytracingproject_tpu.native import load_library

    lib = load_library("bvh_builder")
    if lib is None:
        return None
    c0_d, cd_d, r_d = jax.device_get((scene.center0, scene.center_delta, scene.radius))
    c0 = np.ascontiguousarray(c0_d, np.float32)
    cd = np.ascontiguousarray(cd_d, np.float32)
    rad = np.ascontiguousarray(r_d, np.float32)
    n = c0.shape[0]
    cap = 2 * n + 2
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    miss = np.empty(cap, np.int32)
    lstart = np.empty(cap, np.int32)
    lcount = np.empty(cap, np.int32)
    order = np.empty(n, np.int32)

    fn = lib.build_bvh_native
    fn.restype = ctypes.c_int
    ptr = np.ctypeslib.ndpointer
    fn.argtypes = [
        ctypes.c_int,
        ptr(np.float32), ptr(np.float32), ptr(np.float32),
        ctypes.c_int,
        ptr(np.float32), ptr(np.float32),
        ptr(np.int32), ptr(np.int32), ptr(np.int32), ptr(np.int32),
    ]
    m = fn(n, c0.reshape(-1), cd.reshape(-1), rad, leaf_size,
           node_min.reshape(-1), node_max.reshape(-1), miss, lstart, lcount, order)
    if m <= 0:
        return None
    return FlatBVH(
        node_min=jnp.asarray(node_min[:m]),
        node_max=jnp.asarray(node_max[:m]),
        miss_link=jnp.asarray(miss[:m]),
        leaf_start=jnp.asarray(lstart[:m]),
        leaf_count=jnp.asarray(lcount[:m]),
        prim_order=jnp.asarray(order),
    )


def _build_bvh_python(scene: Scene, leaf_size: int = LEAF_SIZE) -> FlatBVH:
    """Pure-Python fallback build (median split)."""
    bmin, bmax = sphere_bounds(scene)
    n = bmin.shape[0]
    centroid = 0.5 * (bmin + bmax)

    # Recursive build into python lists, then flatten.
    nodes_min: list[np.ndarray] = []
    nodes_max: list[np.ndarray] = []
    nodes_leaf: list[tuple[int, int]] = []  # (start, count); (0,0) for inner
    nodes_right_subtree_size: list[int] = []  # subtree size for miss links
    order: list[int] = []

    def rec(idx: np.ndarray) -> int:
        """Append the subtree over primitive ids `idx`; return node count."""
        me = len(nodes_min)
        nodes_min.append(bmin[idx].min(axis=0))
        nodes_max.append(bmax[idx].max(axis=0))
        nodes_leaf.append((0, 0))
        nodes_right_subtree_size.append(0)
        if idx.size <= leaf_size:
            nodes_leaf[me] = (len(order), idx.size)
            order.extend(idx.tolist())
            return 1
        ext = nodes_max[me] - nodes_min[me]
        axis = int(np.argmax(ext))
        mid = idx.size // 2
        part = idx[np.argsort(centroid[idx, axis], kind="stable")]
        left, right = part[:mid], part[mid:]
        size = 1 + rec(left)
        size += rec(right)
        return size

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 4 * n + 64))
    try:
        total = rec(np.arange(n))
    finally:
        sys.setrecursionlimit(old_limit)

    m = len(nodes_min)
    assert total == m

    # Miss links: in DFS pre-order, node i's subtree occupies [i, i+size_i).
    # miss_link[i] = i + size_i (the node after the subtree), SENTINEL at end.
    # Recompute subtree sizes with an explicit pass.
    sizes = np.ones(m, np.int64)
    leaf_counts = np.array([c for (_, c) in nodes_leaf], np.int64)

    # children of inner node i start at i+1; reconstruct sizes by walking
    # pre-order backwards with a stack of (node, remaining-children).
    # Simpler: recompute sizes recursively in the same order.
    sizes_list: list[int] = [0] * m
    pos = 0

    def size_of(i_node: int) -> int:
        nonlocal pos
        if leaf_counts[i_node] > 0:
            sizes_list[i_node] = 1
            return 1
        left_child = i_node + 1
        ls = size_of(left_child)
        rs = size_of(left_child + ls)
        sizes_list[i_node] = 1 + ls + rs
        return sizes_list[i_node]

    sys.setrecursionlimit(max(old_limit, 4 * n + 64))
    try:
        size_of(0)
    finally:
        sys.setrecursionlimit(old_limit)

    miss = np.array([i + s for i, s in enumerate(sizes_list)], np.int64)
    miss[miss >= m] = SENTINEL

    return FlatBVH(
        node_min=jnp.asarray(np.stack(nodes_min), jnp.float32),
        node_max=jnp.asarray(np.stack(nodes_max), jnp.float32),
        miss_link=jnp.asarray(miss, jnp.int32),
        leaf_start=jnp.asarray([s for (s, _) in nodes_leaf], jnp.int32),
        leaf_count=jnp.asarray(leaf_counts, jnp.int32),
        prim_order=jnp.asarray(order, jnp.int32),
    )


def reorder_scene(scene: Scene, bvh: FlatBVH) -> Scene:
    """Permute sphere arrays into BVH leaf order so leaves are contiguous."""
    p = bvh.prim_order
    return Scene(
        center0=jnp.take(scene.center0, p, axis=0),
        center_delta=jnp.take(scene.center_delta, p, axis=0),
        radius=jnp.take(scene.radius, p),
        mat_type=jnp.take(scene.mat_type, p),
        albedo=jnp.take(scene.albedo, p, axis=0),
        fuzz=jnp.take(scene.fuzz, p),
        ior=jnp.take(scene.ior, p),
    )


def bvh_closest_hit(
    origin: jnp.ndarray,     # [R, 3]
    direction: jnp.ndarray,  # [R, 3]
    time: jnp.ndarray,       # [R]
    scene: Scene,            # MUST be reorder_scene(scene, bvh)
    bvh: FlatBVH,
    t_min: float = T_MIN,
) -> HitRecord:
    """Stackless closest-hit traversal, vectorized over rays.

    Equivalent to ops.intersect.closest_hit on the reordered scene (returns
    indices into the *reordered* arrays). The while_loop runs until every
    ray's pointer hits the sentinel; per-iteration work is one node AABB
    test + (for leaf lanes) LEAF_SIZE sphere tests.
    """
    R = origin.shape[0]
    inv_d = 1.0 / jnp.where(jnp.abs(direction) > 1e-20, direction, 1e-20)
    a_quad = jnp.maximum(dot(direction, direction), 1e-20)

    # pad leaf primitive window: gather LEAF_SIZE spheres per leaf visit
    leaf_offsets = jnp.arange(LEAF_SIZE, dtype=jnp.int32)
    n_prims = scene.radius.shape[0]

    def cond(state):
        ptr, _, _ = state
        return jnp.any(ptr != SENTINEL)

    def body(state):
        ptr, best_t, best_idx = state
        active = ptr != SENTINEL
        node = jnp.where(active, ptr, 0)

        nmin = jnp.take(bvh.node_min, node, axis=0)   # [R, 3]
        nmax = jnp.take(bvh.node_max, node, axis=0)
        t0 = (nmin - origin) * inv_d
        t1 = (nmax - origin) * inv_d
        tn = jnp.maximum(jnp.max(jnp.minimum(t0, t1), axis=-1), t_min)
        tf = jnp.minimum(jnp.min(jnp.maximum(t0, t1), axis=-1), best_t)
        box_hit = active & (tf > tn)

        lcount = jnp.take(bvh.leaf_count, node)
        is_leaf = lcount > 0

        # Leaf test: LEAF_SIZE spheres per lane (masked beyond count).
        start = jnp.take(bvh.leaf_start, node)
        prim = jnp.minimum(start[:, None] + leaf_offsets[None, :], n_prims - 1)
        pvalid = (leaf_offsets[None, :] < lcount[:, None]) & box_hit[:, None] & is_leaf[:, None]

        c = jnp.take(scene.center0, prim, axis=0) + time[:, None, None] * jnp.take(
            scene.center_delta, prim, axis=0
        )                                             # [R, L, 3]
        r = jnp.take(scene.radius, prim)              # [R, L]
        oc = origin[:, None, :] - c
        half_b = jnp.sum(oc * direction[:, None, :], axis=-1)
        cq = jnp.sum(oc * oc, axis=-1) - r * r
        disc = half_b * half_b - a_quad[:, None] * cq
        dpos = disc > 0.0
        sq = jnp.sqrt(jnp.where(dpos, disc, 1.0))
        r0 = (-half_b - sq) / a_quad[:, None]
        r1 = (-half_b + sq) / a_quad[:, None]
        in0 = (r0 > t_min) & (r0 < best_t[:, None])
        in1 = (r1 > t_min) & (r1 < best_t[:, None])
        root = jnp.where(in0, r0, r1)
        valid = pvalid & dpos & (in0 | in1)
        root = jnp.where(valid, root, T_MAX)

        lane_best = jnp.argmin(root, axis=-1)
        lane_t = jnp.take_along_axis(root, lane_best[:, None], axis=-1)[:, 0]
        better = lane_t < best_t
        best_t = jnp.where(better, lane_t, best_t)
        best_idx = jnp.where(
            better,
            jnp.take_along_axis(prim, lane_best[:, None], axis=-1)[:, 0],
            best_idx,
        )

        # Advance: inner hit -> first child (ptr+1); leaf hit or any miss ->
        # skip via miss link.
        descend = box_hit & ~is_leaf
        nxt = jnp.where(descend, node + 1, jnp.take(bvh.miss_link, node))
        ptr = jnp.where(active, nxt, SENTINEL)
        return ptr, best_t, best_idx

    ptr0 = jnp.zeros((R,), jnp.int32)
    best_t0 = jnp.full((R,), T_MAX, origin.dtype)
    best_idx0 = jnp.zeros((R,), jnp.int32)
    _, t, idx = jax.lax.while_loop(cond, body, (ptr0, best_t0, best_idx0))

    hit = jnp.isfinite(t)
    t_safe = jnp.where(hit, t, 1.0)
    p = origin + t_safe[:, None] * direction
    hit_center = jnp.take(scene.center0, idx, axis=0) + time[:, None] * jnp.take(
        scene.center_delta, idx, axis=0
    )
    r_sel = jnp.take(scene.radius, idx)
    r_safe = jnp.where(r_sel != 0.0, r_sel, 1.0)
    outward = (p - hit_center) / r_safe[:, None]
    front_face = dot(direction, outward) < 0.0
    normal = jnp.where(front_face[:, None], outward, -outward)
    return HitRecord(t=t, idx=idx, hit=hit, p=p, normal=normal, front_face=front_face)

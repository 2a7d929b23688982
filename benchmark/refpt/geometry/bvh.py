# Frozen copy of fountain_tpu_torch/geometry/bvh.py (commit 6354002), the numpy node build in place of the native one: the benchmark's plain reference; edit never.
"""LBVH: Morton-ordered build, the per-face tables and the threaded walk.

Counterpart of ``fountain_tpu/geometry/bvh.py``. Faces are reordered by
the 30-bit Morton code of their centroids (stable sort, ``leaf_order``),
so contiguous 128-face blocks are spatially tight for the sweeps' block
cull and leaves are contiguous face ranges. ``build_lbvh`` (numpy, the
reference) and ``native.lbvh_build`` (C++) emit the nodes in DFS order
with miss links: a walk needs one node pointer per ray and no stack.
``attach_bvh`` attaches the sweeps' face table, the packed hit attributes
and the walk's packed nodes and leaf-ordered vertices to every scene with
faces. ``bvh_intersect`` is the plain PyTorch walk; the kernels that walk
on a card are in ``bvh_walk``.
"""
from __future__ import annotations

import sys
import time
from dataclasses import replace

import numpy as np
import torch

from refpt.core.vecmath import V3, gamma
from refpt.geometry.tri_sweep import pack_sweep_table
from refpt.geometry.triangle import (build_tri_attr,
                                                  woop_intersect_v3)
from refpt.scene.types import Scene

LEAF_SIZE = 4
# the slab test's t_far widening (1 + 2 gamma(3)), so it errs towards a hit
SLAB_SCALE = 1.0 + 2.0 * gamma(3)


def _expand_bits(v: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of v so consecutive bits are 3 apart."""
    v = v.astype(np.uint32)
    v = (v * np.uint32(0x00010001)) & np.uint32(0xFF0000FF)
    v = (v * np.uint32(0x00000101)) & np.uint32(0x0F00F00F)
    v = (v * np.uint32(0x00000011)) & np.uint32(0xC30C30C3)
    v = (v * np.uint32(0x00000005)) & np.uint32(0x49249249)
    return v


def morton3(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """30-bit Morton code from coordinates in [0, 1024)."""
    return (_expand_bits(z) << np.uint32(2)) \
        | (_expand_bits(y) << np.uint32(1)) | _expand_bits(x)


def morton_codes(bounds_min: np.ndarray, bounds_max: np.ndarray
                 ) -> np.ndarray:
    """[F] uint32: box centroids quantized to a 2^10 lattice, Morton-coded."""
    centroids = (bounds_min + bounds_max) * 0.5
    lo = centroids.min(0)
    extent = np.maximum(centroids.max(0) - lo, 1e-12)
    q = np.clip(((centroids - lo) / extent) * 1023.0, 0, 1023
                ).astype(np.uint32)
    return morton3(q[:, 0], q[:, 1], q[:, 2])


def leaf_order(bounds_min: np.ndarray, bounds_max: np.ndarray) -> np.ndarray:
    """Face permutation into LBVH leaf order: the stable sort of the Morton
    codes. [F] int32."""
    codes = morton_codes(bounds_min, bounds_max)
    return np.argsort(codes, kind="stable").astype(np.int32)


def build_lbvh(bounds_min: np.ndarray, bounds_max: np.ndarray,
               leaf_size: int = LEAF_SIZE):
    """Build the threaded LBVH over primitive boxes (numpy, the reference
    of ``native.lbvh_build``).

    Splits at the highest differing bit of the sorted Morton codes (the
    middle of the range where all codes are equal); nodes in DFS order;
    ``meta`` rows are (miss link, first face, face count), count 0 for an
    interior node (a hit goes on to node i + 1). Returns (nodes_min [M, 3],
    nodes_max [M, 3], meta [M, 3] int32, order [F] int32).
    """
    f = len(bounds_min)
    order = leaf_order(bounds_min, bounds_max) if f else \
        np.zeros(0, np.int32)
    if f == 0:
        return (np.zeros((1, 3), np.float32), np.zeros((1, 3), np.float32),
                np.asarray([[1, 0, 0]], np.int32), order)
    codes = morton_codes(bounds_min, bounds_max)[order]
    bmin = bounds_min[order]
    bmax = bounds_max[order]

    nodes_min, nodes_max, meta = [], [], []

    def emit(n_min, n_max, first, count):
        nodes_min.append(n_min)
        nodes_max.append(n_max)
        meta.append([0, first, count])
        return len(meta) - 1

    sys.setrecursionlimit(1 << 16)

    def split_pos(start, end):
        """Morton split: highest differing bit within [start, end)."""
        c0, c1 = codes[start], codes[end - 1]
        if c0 == c1:
            return (start + end) // 2
        split_bit = int(c0 ^ c1).bit_length() - 1
        mask = np.uint32(1 << split_bit)
        vals = (codes[start:end] & mask) != (c0 & mask)
        return start + max(int(np.argmax(vals)), 1)

    def rec(start, end):
        n_min = bmin[start:end].min(0)
        n_max = bmax[start:end].max(0)
        if end - start <= leaf_size:
            emit(n_min, n_max, start, end - start)
            return
        mid = split_pos(start, end)
        emit(n_min, n_max, 0, 0)
        rec(start, mid)
        rec(mid, end)

    rec(0, f)

    # node i's subtree occupies [i, i + size_i), so its miss link is
    # i + size_i; sizes from a reverse sweep with a stack
    m = len(meta)
    meta_np = np.asarray(meta, np.int64)
    sizes = np.ones(m, np.int64)
    stack = []
    for i in range(m - 1, -1, -1):
        if meta_np[i, 2] > 0:
            stack.append(1)
        else:
            sizes[i] = 1 + stack.pop() + stack.pop()
            stack.append(int(sizes[i]))
    miss = np.arange(m, dtype=np.int64) + sizes
    meta_out = np.stack([miss, meta_np[:, 1] * (meta_np[:, 2] > 0),
                         meta_np[:, 2]], axis=1).astype(np.int32)
    return (np.stack(nodes_min).astype(np.float32),
            np.stack(nodes_max).astype(np.float32), meta_out, order)


def pack_nodes(nodes_min: np.ndarray, nodes_max: np.ndarray,
               meta: np.ndarray) -> np.ndarray:
    """One 8-float row per node: [min.xyz, max.xyz, bitcast(miss),
    bitcast(first << 3 | count)]; the last two are int32 bit patterns."""
    miss = meta[:, 0].astype(np.int32)
    fc = ((meta[:, 1].astype(np.int64) << 3)
          | meta[:, 2].astype(np.int64)).astype(np.int32)
    assert int(meta[:, 1].max(initial=0)) < (1 << 28), "face count overflow"
    assert int(meta[:, 2].max(initial=0)) <= 7, "leaf size must be <= 7"
    return np.concatenate([
        nodes_min.astype(np.float32), nodes_max.astype(np.float32),
        miss.view(np.float32)[:, None], fc.view(np.float32)[:, None]],
        axis=1)


def attach_bvh(scene: Scene, times: dict | None = None) -> Scene:
    """Build the LBVH (numpy) and return the scene with its triangle table
    in leaf order and every per-face table attached: the sweeps' face
    table (``tri_sweep``), the packed hit attributes (``tri_attr``), the
    walk's node rows (``bvh_nodes8``) and leaf-ordered vertices
    (``bvh_tri_verts``). ``times`` (optional) receives the host seconds of
    the node build (``nodes_s``) and of the tables (``tables_s``)."""
    tris = scene.triangles
    if tris.count == 0:
        return scene
    dev = scene.device
    pos = tris.positions.cpu().numpy()
    idx = tris.indices.cpu().numpy()
    v = pos[idx]                                   # [F, 3, 3]
    t0 = time.perf_counter()
    nodes_min, nodes_max, meta, order = build_lbvh(
        v.min(1), v.max(1), LEAF_SIZE)
    t1 = time.perf_counter()
    perm = torch.as_tensor(order.astype(np.int64), device=dev)
    reordered = replace(
        tris, indices=tris.indices[perm], has_normals=tris.has_normals[perm],
        mat_id=tris.mat_id[perm], light_id=tris.light_id[perm],
        flip_normal=tris.flip_normal[perm], mesh_id=tris.mesh_id[perm])
    np_of = lambda t: t.cpu().numpy()              # noqa: E731
    attr = build_tri_attr(
        idx[order], pos, np_of(tris.normals), np_of(tris.uv),
        np_of(tris.mat_id)[order], np_of(tris.light_id)[order],
        np_of(tris.has_normals)[order], np_of(tris.flip_normal)[order], dev)
    tv = v[order]
    out = replace(
        scene, triangles=reordered, tri_sweep=pack_sweep_table(tv, dev),
        tri_attr=attr,
        bvh_nodes8=torch.as_tensor(pack_nodes(nodes_min, nodes_max, meta),
                                   device=dev),
        bvh_tri_verts=torch.as_tensor(tv, device=dev))
    if times is not None:
        times.update(nodes_s=t1 - t0, tables_s=time.perf_counter() - t1)
    return out


# ---------------------------------------------------------------------------
# The walk (plain PyTorch)
# ---------------------------------------------------------------------------


def _max3(a, b, c):
    return torch.maximum(torch.maximum(a, b), c)


def _min3(a, b, c):
    return torch.minimum(torch.minimum(a, b), c)


def slab_test(row, o, inv_d, t_best):
    """Conservative slab test of [n, 8] node rows against [n, 3] rays: the
    1 + 2 gamma(3) widening of t_far errs towards a hit; a NaN anywhere
    makes every comparison false, so a non-finite ray misses."""
    t0 = (row[:, 0:3] - o) * inv_d
    t1 = (row[:, 3:6] - o) * inv_d
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1)
    t_near = _max3(lo[:, 0], lo[:, 1], lo[:, 2])
    t_far = _min3(hi[:, 0], hi[:, 1], hi[:, 2]) * SLAB_SCALE
    return (t_near <= t_far) & (t_far > 0.0) & (t_near < t_best)


def bvh_intersect(nodes8: torch.Tensor, tri_verts: torch.Tensor, o, d, t_max,
                  any_hit: bool = False, stats: dict | None = None):
    """Threaded-BVH walk over the packed layout (``attach_bvh``).

    o, d: [N, 3]; t_max: [N] (a non-finite limit becomes 3e38). Each ray
    carries (node pointer, best t, best face, found) and steps through one
    node row at a time: the slab test; on a leaf hit, up to LEAF_SIZE Woop
    tests in slot order, each against the best t so far (a strict limit,
    so the first face in walk order wins a tie); then node i + 1 after an
    interior hit, else the miss link. Any hit stops a ray at the end of
    the leaf where it found one. Returns (t, face_idx, found) with t = inf
    where nothing was found (face_idx 0 there).

    Rays that are done drop out of the step, and a ray with t_max <= 0
    never starts (rays are independent, and such a ray can never hit, so
    the result is the all-lanes loop's). ``stats`` (optional) receives the
    work these rays needed: ``node_visits``, ``woop_tests`` (leaf slots
    tested), ``nodes_touched`` and ``faces_touched`` (distinct rows read),
    ``steps``.
    """
    m, f = nodes8.shape[0], tri_verts.shape[0]
    n, dev = o.shape[0], o.device
    bits = nodes8.view(torch.int32)
    inv_d = 1.0 / torch.where(d == 0.0, 1e-20, d)
    t_best = torch.where(torch.isfinite(t_max), t_max,
                         torch.full_like(t_max, 3e38))
    i_best = torch.zeros(n, dtype=torch.int32, device=dev)
    found = torch.zeros(n, dtype=torch.bool, device=dev)
    # a ray with t_max <= 0 can never be accepted (the Woop in-range test
    # needs t_scaled < det * t_max with t_scaled of det's sign): it starts
    # done, with its miss
    ptr = torch.where(t_best > 0.0, 0, m).to(torch.int64)
    if stats is not None:
        visits = woops = steps = 0
        node_seen = torch.zeros(m, dtype=torch.bool, device=dev)
        face_seen = torch.zeros(f, dtype=torch.bool, device=dev)
    while bool((ptr < m).any()):
        live = (ptr < m).nonzero()[:, 0]
        p = ptr[live]
        ol, tb = o[live], t_best[live]
        hit = slab_test(nodes8[p], ol, inv_d[live], tb)
        miss = bits[p, 6].long()
        fc = bits[p, 7]
        first, count = (fc >> 3).long(), fc & 7
        leaf = (count > 0) & hit
        nxt = torch.where(hit & ~leaf, p + 1, miss)
        lf = leaf.nonzero()[:, 0]
        if lf.numel():
            lanes = live[lf]
            ov, dv = o[lanes], d[lanes]
            o3, d3 = V3(ov[:, 0], ov[:, 1], ov[:, 2]), \
                V3(dv[:, 0], dv[:, 1], dv[:, 2])
            tl, il, fl = tb[lf], i_best[lanes], found[lanes]
            for s in range(LEAF_SIZE):
                fidx = torch.clamp(first[lf] + s, max=f - 1)
                pv = tri_verts[fidx]
                t, _, _, _, ok = woop_intersect_v3(
                    *(V3(pv[:, k, 0], pv[:, k, 1], pv[:, k, 2])
                      for k in range(3)), o3, d3, tl)
                slot = s < count[lf]
                ok = ok & slot
                tl = torch.where(ok, t, tl)
                il = torch.where(ok, fidx.to(torch.int32), il)
                fl = fl | ok
                if stats is not None:
                    woops += int(slot.sum())
                    face_seen[fidx[slot]] = True
            t_best[lanes], i_best[lanes], found[lanes] = tl, il, fl
            if any_hit:
                nxt[lf] = torch.where(fl, m, nxt[lf])
        ptr[live] = nxt
        if stats is not None:
            visits += live.numel()
            steps += 1
            node_seen[p] = True
    if stats is not None:
        stats.update(node_visits=visits, woop_tests=woops, steps=steps,
                     nodes_touched=int(node_seen.sum()),
                     faces_touched=int(face_seen.sum()))
    return torch.where(found, t_best, float("inf")), i_best, found

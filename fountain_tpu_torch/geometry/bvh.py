"""LBVH leaf order and the per-face tables attached to a scene.

Counterpart of the Morton leaf order of ``build_lbvh``'s numpy path and of
``attach_bvh`` in ``fountain_tpu/geometry/bvh.py``: faces are reordered by
the 30-bit Morton code of their centroids (stable sort), so contiguous
128-face blocks are spatially tight for the sweeps' block cull. The BVH
walk itself is not ported: the sweeps replace it.
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from fountain_tpu_torch.geometry.tri_sweep import pack_sweep_table
from fountain_tpu_torch.geometry.triangle import build_tri_attr
from fountain_tpu_torch.scene.types import Scene


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


def leaf_order(bounds_min: np.ndarray, bounds_max: np.ndarray) -> np.ndarray:
    """Face permutation into LBVH leaf order: centroids quantized to a
    2^10 lattice, Morton-coded, stable-sorted. [F] int32."""
    centroids = (bounds_min + bounds_max) * 0.5
    lo = centroids.min(0)
    extent = np.maximum(centroids.max(0) - lo, 1e-12)
    q = np.clip(((centroids - lo) / extent) * 1023.0, 0, 1023
                ).astype(np.uint32)
    codes = morton3(q[:, 0], q[:, 1], q[:, 2])
    return np.argsort(codes, kind="stable").astype(np.int32)


def attach_bvh(scene: Scene) -> Scene:
    """Reorder the triangle table to leaf order and attach the sweeps' face
    table (``tri_sweep``) and the packed hit attributes (``tri_attr``)."""
    tris = scene.triangles
    if tris.count == 0:
        return scene
    dev = scene.device
    pos = tris.positions.cpu().numpy()
    idx = tris.indices.cpu().numpy()
    v = pos[idx]                                   # [F, 3, 3]
    order = leaf_order(v.min(1), v.max(1))
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
    return replace(scene, triangles=reordered,
                   tri_sweep=pack_sweep_table(v[order], dev), tri_attr=attr)


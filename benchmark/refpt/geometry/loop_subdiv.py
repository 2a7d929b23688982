# Frozen copy of fountain_tpu_torch/geometry/loop_subdiv.py (commit 6354002): the benchmark's plain reference; edit never.
"""Loop subdivision surfaces (host-side mesh refinement, numpy).

Counterpart of ``fountain_tpu/geometry/loop_subdiv.py``, copied rather
than imported (the port imports nothing of the JAX package): the full
PBRT-3ed algorithm (pbrt section 3.8), a per-level 1:4 face split with
Loop's masks, then a push to the limit surface with analytic limit
tangents for shading normals. ``weld_vertices`` merges the duplicated
vertices of meshes exported with per-face normals first.

Masks:
- interior even (old) vertex, valence n: (1 - n·β)·v + β·Σ neighbors,
  β = 3/16 if n == 3 else 3/(8n)
- boundary even vertex: 3/4·v + 1/8·(two boundary neighbors)
- interior odd (edge) vertex: 3/8·(edge ends) + 1/8·(opposite verts)
- boundary odd vertex: 1/2·(edge ends)
- limit position: interior uses loop_gamma(n) = 1/(n + 3/(8β)); boundary
  uses 1/5·(neighbors) + 3/5·v
- limit tangents (interior): T1 = Σ cos(2πi/n)·vᵢ, T2 = Σ sin(2πi/n)·vᵢ
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def weld_vertices(positions: np.ndarray, indices: np.ndarray,
                  tol: float = 0.0):
    """Merge positionally-identical vertices and remap face indices.

    PLY exports with per-face normals duplicate every shared vertex (e.g.
    data/rounded_cube.ply: all 10,830 edges look like boundaries), which
    makes topology-based algorithms (Loop subdivision boundary rules)
    open cracks along every seam. Welding restores the closed 2-manifold.
    ``tol > 0`` quantizes coordinates to that grid before matching;
    ``tol = 0`` requires exact float equality. Degenerate faces produced
    by the merge are dropped. Returns (positions, indices)."""
    p = np.asarray(positions)
    if tol > 0.0:
        key = np.round(p / tol).astype(np.int64)
    else:
        key = p
    _, first, inv = np.unique(key, axis=0, return_index=True,
                              return_inverse=True)
    new_p = p[first]
    new_f = inv[np.asarray(indices)]
    ok = ((new_f[:, 0] != new_f[:, 1]) & (new_f[:, 1] != new_f[:, 2])
          & (new_f[:, 2] != new_f[:, 0]))
    return new_p, np.ascontiguousarray(new_f[ok], np.int32)


def _build_topology(indices: np.ndarray, n_verts: int):
    """Per-vertex ordered one-rings + boundary flags.

    Returns (rings, boundary) where rings[v] is the list of neighbor
    vertices ordered around v (open chain starting/ending at boundary
    neighbors when v is a boundary vertex)."""
    # edge -> [faces]
    edge_faces: Dict[Tuple[int, int], List[int]] = {}
    for fi, (a, b, c) in enumerate(indices):
        for u, v in ((a, b), (b, c), (c, a)):
            key = (min(u, v), max(u, v))
            edge_faces.setdefault(key, []).append(fi)

    # vertex -> neighbor adjacency via edges
    nbr: List[Dict[int, int]] = [dict() for _ in range(n_verts)]
    # for ring ordering: per vertex, map neighbor -> faces of that edge
    vert_edge_faces: List[Dict[int, List[int]]] = [dict()
                                                   for _ in range(n_verts)]
    for (u, v), faces in edge_faces.items():
        vert_edge_faces[u][v] = faces
        vert_edge_faces[v][u] = faces

    boundary = np.zeros(n_verts, bool)
    for (u, v), faces in edge_faces.items():
        if len(faces) == 1:
            boundary[u] = True
            boundary[v] = True

    # order each ring by walking faces around the vertex
    face_verts = [set(f) for f in indices.tolist()]
    rings: List[List[int]] = []
    for v in range(n_verts):
        nbrs = list(vert_edge_faces[v].keys())
        if not nbrs:
            rings.append([])
            continue
        # start at a boundary edge if the vertex is on the boundary
        start = nbrs[0]
        if boundary[v]:
            for u in nbrs:
                if len(vert_edge_faces[v][u]) == 1:
                    start = u
                    break
        ring = [start]
        used_faces = set()
        cur = start
        while len(ring) < len(nbrs):
            advanced = False
            for fi in vert_edge_faces[v][cur]:
                if fi in used_faces:
                    continue
                others = face_verts[fi] - {v, cur}
                if len(others) != 1:
                    continue
                nxt = next(iter(others))
                if nxt in ring:
                    used_faces.add(fi)
                    continue
                used_faces.add(fi)
                ring.append(nxt)
                cur = nxt
                advanced = True
                break
            if not advanced:
                # non-manifold or isolated fan remainder: append leftovers
                for u in nbrs:
                    if u not in ring:
                        ring.append(u)
                break
        rings.append(ring)
    return rings, boundary, edge_faces


def _beta(n: int) -> float:
    return 3.0 / 16.0 if n == 3 else 3.0 / (8.0 * n)


def _loop_gamma(n: int) -> float:
    return 1.0 / (n + 3.0 / (8.0 * _beta(n)))


def loop_subdivide(positions: np.ndarray, indices: np.ndarray,
                   n_levels: int = 3
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Subdivide a control mesh `n_levels` times and push to the limit
    surface. Returns (positions [V',3], indices [F',3], normals [V',3])."""
    p = np.asarray(positions, np.float64)
    f = np.asarray(indices, np.int64)

    for _ in range(n_levels):
        n_verts = len(p)
        rings, boundary, edge_faces = _build_topology(f, n_verts)

        # --- even (old) vertices
        new_even = np.empty_like(p)
        for v in range(n_verts):
            ring = rings[v]
            n = len(ring)
            if n == 0:
                new_even[v] = p[v]
            elif boundary[v]:
                ends = [u for u in ring
                        if len(edge_faces[(min(u, v), max(u, v))]) == 1]
                if len(ends) >= 2:
                    new_even[v] = 0.75 * p[v] + 0.125 * (p[ends[0]]
                                                         + p[ends[1]])
                else:
                    new_even[v] = p[v]
            else:
                b = _beta(n)
                new_even[v] = (1.0 - n * b) * p[v] + b * p[ring].sum(0)

        # --- odd (edge) vertices
        edge_vert: Dict[Tuple[int, int], int] = {}
        odd_pts = []
        for (u, v), faces in edge_faces.items():
            if len(faces) == 1:
                q = 0.5 * (p[u] + p[v])
            else:
                opp = []
                for fi in faces[:2]:
                    other = set(f[fi]) - {u, v}
                    opp.append(next(iter(other)))
                q = 0.375 * (p[u] + p[v]) + 0.125 * (p[opp[0]] + p[opp[1]])
            edge_vert[(u, v)] = n_verts + len(odd_pts)
            odd_pts.append(q)

        # --- 1:4 face split
        new_faces = []
        for a, b, c in f:
            ab = edge_vert[(min(a, b), max(a, b))]
            bc = edge_vert[(min(b, c), max(b, c))]
            ca = edge_vert[(min(c, a), max(c, a))]
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc],
                          [ab, bc, ca]]
        p = np.concatenate([new_even, np.asarray(odd_pts)])
        f = np.asarray(new_faces, np.int64)

    # --- push to limit surface + limit tangents
    n_verts = len(p)
    rings, boundary, edge_faces = _build_topology(f, n_verts)
    limit = np.empty_like(p)
    normals = np.zeros((n_verts, 3), np.float64)
    for v in range(n_verts):
        ring = rings[v]
        n = len(ring)
        if n == 0:
            limit[v] = p[v]
            continue
        if boundary[v]:
            ends = [u for u in ring
                    if len(edge_faces[(min(u, v), max(u, v))]) == 1]
            if len(ends) >= 2:
                limit[v] = 0.2 * (p[ends[0]] + p[ends[1]]) + 0.6 * p[v]
                t1 = p[ends[0]] - p[ends[1]]         # along tangent
                t2 = (0.5 * (p[ends[0]] + p[ends[1]]) - p[v])
            else:
                limit[v] = p[v]
                t1 = t2 = np.zeros(3)
        else:
            g = _loop_gamma(n)
            limit[v] = (1.0 - n * g) * p[v] + g * p[ring].sum(0)
            ang = 2.0 * np.pi * np.arange(n) / n
            t1 = (np.cos(ang)[:, None] * p[ring]).sum(0)
            t2 = (np.sin(ang)[:, None] * p[ring]).sum(0)
        nrm = np.cross(t1, t2)
        ln = np.linalg.norm(nrm)
        normals[v] = nrm / ln if ln > 1e-20 else 0.0

    # orient limit normals with the face winding (the tangent masks are
    # computed over rings whose walk direction is arbitrary, so the sign of
    # T1 x T2 is arbitrary per vertex) and fill degenerate ones
    fn = np.cross(limit[f[:, 1]] - limit[f[:, 0]],
                  limit[f[:, 2]] - limit[f[:, 0]])
    acc = np.zeros_like(normals)
    for k in range(3):
        np.add.at(acc, f[:, k], fn)
    ln = np.linalg.norm(acc, axis=-1, keepdims=True)
    acc = acc / np.maximum(ln, 1e-20)
    flip = (normals * acc).sum(-1) < 0.0
    normals[flip] = -normals[flip]
    zero = np.linalg.norm(normals, axis=-1) < 0.5
    normals[zero] = acc[zero]

    return (limit.astype(np.float32), f.astype(np.int32),
            normals.astype(np.float32))

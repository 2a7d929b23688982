"""Port parity: Loop subdivision, vertex welding and the spectrum helpers.

``fountain_tpu_torch.geometry.loop_subdiv`` is the port's own copy of the
JAX package's numpy host code. Each of ``tests/test_loop_subdiv.py``'s six
cases runs here on the port, with its property checks, and every array
the port returns must equal the JAX package's (positions, faces and
normals bit for bit: the same numpy operations in the same order). The
six spectrum helpers are held to the JAX package's on random inputs (rtol
1e-6: a 3 x 3 product and a power, rounded by two libraries).
The file takes a few seconds on one CPU thread.
"""
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fountain_tpu.core import spectrum as jspec
from fountain_tpu.geometry import loop_subdiv as jls
from fountain_tpu_torch.core import spectrum as tspec
from fountain_tpu_torch.geometry import loop_subdiv as tls


def _icosahedron():
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float32)
    verts /= np.linalg.norm(verts, axis=-1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int32)
    return verts, faces


def _subdivide(v, f, levels):
    """The port's subdivision, held to the JAX package's array for array."""
    out = tls.loop_subdivide(v, f, levels)
    for a, b in zip(out, jls.loop_subdivide(v, f, levels)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    return out


def _boundary_edges(f):
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    _, cnt = np.unique(np.sort(e, axis=1), axis=0, return_counts=True)
    return int((cnt != 2).sum())


def test_face_count_quadruples():
    v, f = _icosahedron()
    for levels in (1, 2, 3):
        _, f2, _ = _subdivide(v, f, levels)
        assert len(f2) == len(f) * 4 ** levels


def test_icosahedron_rounds_toward_sphere():
    """A nearly spherical limit surface with radial limit normals."""
    v, f = _icosahedron()
    for levels in (1, 2, 3):
        pos, _, nrm = _subdivide(v, f, levels)
        r = np.linalg.norm(pos, axis=-1)
        assert r.max() - r.min() < 0.05
        radial = pos / np.linalg.norm(pos, axis=-1, keepdims=True)
        assert (radial * nrm).sum(-1).min() > 0.99


def test_closed_mesh_stays_closed():
    v, f = _icosahedron()
    _, faces, _ = _subdivide(v, f, 2)
    edges = Counter()
    for a, b, c in faces:
        for u, w in ((a, b), (b, c), (c, a)):
            edges[(min(u, w), max(u, w))] += 1
    assert set(edges.values()) == {2}


def test_flat_grid_stays_flat():
    n = 5
    xx, yy = np.meshgrid(np.arange(n, dtype=np.float32),
                         np.arange(n, dtype=np.float32))
    pos = np.stack([xx, yy, np.zeros_like(xx)], -1).reshape(-1, 3)
    faces = []
    for j in range(n - 1):
        for i in range(n - 1):
            a = j * n + i
            faces += [[a, a + 1, a + n], [a + 1, a + n + 1, a + n]]
    pos2, _, nrm = _subdivide(pos, np.asarray(faces, np.int32), 2)
    np.testing.assert_allclose(pos2[:, 2], 0.0, atol=1e-6)
    assert np.abs(nrm[:, 2]).min() > 0.99


def test_boundary_edges_preserved():
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.float32)
    faces = np.array([[0, 1, 2], [1, 3, 2]], np.int32)
    pos2, _, _ = _subdivide(pos, faces, 2)
    assert pos2[:, 0].min() >= -1e-6 and pos2[:, 0].max() <= 1.0 + 1e-6
    assert pos2[:, 1].min() >= -1e-6 and pos2[:, 1].max() <= 1.0 + 1e-6


def test_weld_vertices_closes_duplicated_mesh():
    """A tetrahedron with every face's vertices duplicated looks open
    along every edge; welding (equal to the JAX package's) closes it, and
    its subdivision stays closed."""
    base = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]],
                    np.float32)
    faces = np.array([[0, 2, 1], [0, 1, 3], [1, 2, 3], [2, 0, 3]],
                     np.int32)
    dup_p = base[faces].reshape(-1, 3)
    dup_f = np.arange(12, dtype=np.int32).reshape(4, 3)
    assert _boundary_edges(dup_f) == 12
    wp, wf = tls.weld_vertices(dup_p, dup_f)
    jp, jf = jls.weld_vertices(dup_p, dup_f)
    np.testing.assert_array_equal(wp, jp)
    np.testing.assert_array_equal(wf, jf)
    assert len(wp) == 4 and len(wf) == 4
    assert _boundary_edges(wf) == 0
    _, f2, _ = _subdivide(wp, wf, 2)
    assert _boundary_edges(np.asarray(f2)) == 0


def test_weld_rounded_cube_equals_jax():
    """The large-scene gate's first step: data/rounded_cube.ply welded
    (2,168 vertices, 4,332 faces) and subdivided once, both packages."""
    from fountain_tpu_torch.io.ply import load_ply
    mesh = load_ply("data/rounded_cube.ply")
    wp, wf = tls.weld_vertices(mesh.positions, mesh.indices)
    jp, jf = jls.weld_vertices(mesh.positions, mesh.indices)
    np.testing.assert_array_equal(wp, jp)
    np.testing.assert_array_equal(wf, jf)
    assert (len(wp), len(wf)) == (2168, 4332)
    _, f1, _ = _subdivide(wp, wf, 1)
    assert len(f1) == 4 * 4332 and _boundary_edges(f1) == 0


@pytest.mark.parametrize("name", [
    "xyz_to_rgb", "rgb_to_xyz", "luminance", "is_black", "max_component",
    "gamma_correct", "inverse_gamma_correct"])
def test_spectrum_helpers(name):
    rng = np.random.default_rng(3)
    x = rng.uniform(-0.2, 2.0, (257, 3)).astype(np.float32)
    x[::7] = 0.0           # black rows for is_black
    x[1::11, 0] = 0.003    # both sides of the sRGB curve's knees
    x[2::13, 1] = 0.04
    j = np.asarray(getattr(jspec, name)(jnp.asarray(x)))
    t = getattr(tspec, name)(torch.as_tensor(x)).numpy()
    assert j.shape == t.shape and j.dtype == t.dtype
    if j.dtype == bool:
        np.testing.assert_array_equal(j, t)
    else:
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-7)

"""Port parity: the LBVH build and the plain BVH walk (geometry/bvh.py).

The port's numpy ``build_lbvh`` and ``pack_nodes`` against the JAX
package's (its numpy path) on the same boxes, and the port's native build
against its numpy build, byte for byte; the build's order is the leaf
order of the sweeps' tables. The plain walk ``bvh_intersect`` against the
JAX package's (packed layout) on the same scene and rays, against the
port's brute force ``intersect_triangles``, and through the rounded
cube's interior. The CUDA walk kernels run only on a card
(tests/test_torch_gpu.py).

Observed on the CPU when this file was written: ``found`` and ``idx``
equal to JAX's walk on every case below, but ``t`` not bit for bit: up
to 3 ulp apart (about half the hits differ). JAX compiles its walk's
while_loop body with XLA, which fuses the Woop test's products and sums;
run op by op (eagerly), JAX's Woop test gives the port's bits exactly
(``test_woop_equals_jax_op_by_op``). Hence the gate on t: rtol 1e-6.
"""
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fountain_tpu import native as jnative
from fountain_tpu.geometry import bvh as jbvh
from fountain_tpu_torch import native
from fountain_tpu_torch.core.vecmath import V3
from fountain_tpu_torch.geometry import bvh, bvh_walk
from fountain_tpu_torch.geometry.triangle import (intersect_triangles,
                                                  intersect_triangles_any)
from tests.test_torch_scene import bridged_config3, jax_config3, port_config3

T_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_boxes(n, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 100, (n, 3)).astype(np.float32)
    h = rng.uniform(0.01, 0.5, (n, 3)).astype(np.float32)
    return c - h, c + h


def _cube_boxes():
    from fountain_tpu_torch.io.ply import load_ply
    mesh = load_ply("data/rounded_cube.ply")
    v = mesh.positions[mesh.indices]
    return v.min(1), v.max(1)


BOXES = {"n1": lambda: _random_boxes(1), "n2": lambda: _random_boxes(2),
         "n5": lambda: _random_boxes(5), "n137": lambda: _random_boxes(137),
         "n10000": lambda: _random_boxes(10000),
         "rounded_cube": _cube_boxes}


@pytest.mark.parametrize("case", sorted(BOXES))
def test_build_equals_jax_and_native_equals_numpy(case, monkeypatch):
    """build_lbvh and pack_nodes equal the JAX package's numpy build; the
    port's native build equals its numpy build, byte for byte."""
    bmin, bmax = BOXES[case]()
    py = bvh.build_lbvh(bmin, bmax)
    cc = native.lbvh_build(bmin, bmax, bvh.LEAF_SIZE)
    monkeypatch.setattr(jnative, "lbvh_build", lambda *a, **k: None)
    ref = jbvh.build_lbvh(bmin, bmax)
    for name, a, b, r in zip(("nodes_min", "nodes_max", "meta", "order"),
                             py, cc, ref):
        assert a.dtype == b.dtype == r.dtype, name
        assert a.shape == b.shape == r.shape, name
        assert a.tobytes() == b.tobytes() == r.tobytes(), name
    assert bvh.pack_nodes(*py[:3]).tobytes() == \
        jbvh.pack_nodes(*ref[:3]).tobytes()
    np.testing.assert_array_equal(py[3], bvh.leaf_order(bmin, bmax))


def test_order_is_the_sweeps_leaf_order():
    """attach_bvh reorders the faces by leaf_order, and the walk's
    vertices, the sweeps' face table and the hit attributes all follow
    that one order; the tables equal the JAX package's."""
    from fountain_tpu_torch.geometry.tri_sweep import pack_sweep_table
    from fountain_tpu_torch.io.ply import load_ply
    scene, _ = port_config3()
    mesh = load_ply("data/rounded_cube.ply")
    v = mesh.positions[mesh.indices]
    order = bvh.leaf_order(v.min(1), v.max(1))
    np.testing.assert_array_equal(scene.triangles.indices.numpy(),
                                  mesh.indices[order])
    np.testing.assert_array_equal(scene.bvh_tri_verts.numpy(), v[order])
    np.testing.assert_array_equal(scene.tri_attr[:, 0:9].numpy(),
                                  v[order].reshape(-1, 9))
    table = pack_sweep_table(v[order], "cpu")
    assert torch.equal(table.coef, scene.tri_sweep.coef)
    js = jax_config3()[0]
    assert scene.bvh_nodes8.numpy().tobytes() == \
        np.asarray(js.bvh_nodes8).tobytes()
    np.testing.assert_array_equal(scene.bvh_tri_verts.numpy(),
                                  np.asarray(js.bvh_tri_verts))


def _rays(kind, n=600, seed=0):
    """Rays at the rounded cube (|v| < ~10): from outside with no limit,
    with dead lanes (t_max < 0) and non-finite rays, or with a finite t_max
    window that cuts some hits off."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-25, 25, (n, 3)).astype(np.float32)
    d = (rng.uniform(-16, 16, (n, 3)) - o).astype(np.float32)
    t_max = np.full(n, np.inf, np.float32)
    if kind == "dead_and_non_finite":
        t_max[::3] = -1.0
        o[1::7, 0] = np.nan
        d[2::11, 1] = np.inf
        d[4::13, 2] = np.nan
        t_max[5::17] = np.nan            # a non-finite limit: no limit
        d[6::19] = 0.0                   # a zero direction
        d[8::23, 0] = 0.0                # axis-parallel in x
    elif kind == "window":
        t_max = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return o, d, t_max


RAY_CASES = ("outside", "dead_and_non_finite", "window")


def _jax_walk(js, o, d, t_max, any_hit):
    t, i, f = jbvh.bvh_intersect(
        js.triangles, js.bvh_nodes_min, js.bvh_nodes_max, js.bvh_meta,
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max), any_hit=any_hit,
        nodes8=js.bvh_nodes8, tri_verts=js.bvh_tri_verts)
    return np.asarray(t), np.asarray(i), np.asarray(f)


@pytest.mark.parametrize("kind", RAY_CASES)
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_plain_walk_equals_jax(kind, any_hit):
    """Gates: found and idx equal (idx on found lanes), t within rtol 1e-6
    on found lanes, t = inf elsewhere, on the bridged config-3 scene."""
    js, scene = jax_config3()[0], bridged_config3()
    o, d, t_max = _rays(kind, seed=RAY_CASES.index(kind))
    jt, ji, jf = _jax_walk(js, o, d, t_max, any_hit)
    t, i, f = bvh.bvh_intersect(scene.bvh_nodes8, scene.bvh_tri_verts,
                                torch.as_tensor(o), torch.as_tensor(d),
                                torch.as_tensor(t_max), any_hit=any_hit)
    f = f.numpy()
    np.testing.assert_array_equal(f, jf)
    assert 20 < f.sum() < len(f) - 20, f.sum()
    np.testing.assert_array_equal(i.numpy()[f], ji[f])
    np.testing.assert_allclose(t.numpy()[f], jt[f], rtol=T_RTOL, atol=0)
    assert np.isinf(t.numpy()[~f]).all()


def test_woop_equals_jax_op_by_op():
    """The Woop test the walk runs (``woop_intersect_v3``) equals JAX's
    ``woop_intersect`` run eagerly, bit for bit, on the faces the walk
    hits: t, the barycentrics and the acceptance."""
    from fountain_tpu.geometry.triangle import woop_intersect
    from fountain_tpu_torch.geometry.triangle import woop_intersect_v3
    js, scene = jax_config3()[0], bridged_config3()
    o, d, t_max = _rays("outside", seed=0)
    _, idx, f = bvh.bvh_intersect(scene.bvh_nodes8, scene.bvh_tri_verts,
                                  torch.as_tensor(o), torch.as_tensor(d),
                                  torch.as_tensor(t_max))
    f = f.numpy()
    tv = scene.bvh_tri_verts.numpy()[idx.numpy()[f]]
    o, d = o[f], d[f]
    lim = np.full(len(o), 3e38, np.float32)
    ref = woop_intersect(*(jnp.asarray(tv[:, k]) for k in range(3)),
                         jnp.asarray(o), jnp.asarray(d), jnp.asarray(lim))
    cols = lambda a: V3(*(torch.as_tensor(np.ascontiguousarray(a[:, k]))
                          for k in range(3)))             # noqa: E731
    out = woop_intersect_v3(*(cols(tv[:, k]) for k in range(3)), cols(o),
                            cols(d), torch.as_tensor(lim))
    assert np.asarray(ref[4]).all()
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("kind", ("outside", "window"))
def test_plain_walk_equals_brute_force(kind):
    """The walk against the brute-force Woop sweep over every face of the
    original (unordered) table: hit masks equal, t within rtol 1e-6, the
    face the same (through the leaf order), any hit equal to the closest
    hit's mask."""
    from fountain_tpu_torch.io.ply import load_ply
    scene, _ = port_config3()
    mesh = load_ply("data/rounded_cube.ply")
    order = bvh.leaf_order(*(lambda v: (v.min(1), v.max(1)))(
        mesh.positions[mesh.indices]))
    o, d, t_max = (torch.as_tensor(a) for a in _rays(kind, n=400, seed=9))
    t, i, f = bvh.bvh_intersect(scene.bvh_nodes8, scene.bvh_tri_verts, o, d,
                                t_max)
    raw = replace(scene.triangles,
                  positions=torch.as_tensor(mesh.positions),
                  indices=torch.as_tensor(mesh.indices))
    bt, bi, bf = intersect_triangles(raw, o, d, t_max)
    np.testing.assert_array_equal(f.numpy(), bf.numpy())
    assert f.sum() > 50
    np.testing.assert_allclose(t[f].numpy(), bt[f].numpy(), rtol=T_RTOL)
    np.testing.assert_array_equal(order[i[f].numpy()], bi[f].numpy())
    occ = bvh.bvh_intersect(scene.bvh_nodes8, scene.bvh_tri_verts, o, d,
                            t_max, any_hit=True)[2]
    np.testing.assert_array_equal(occ.numpy(), f.numpy())
    np.testing.assert_array_equal(
        intersect_triangles_any(raw, o, d, t_max).numpy(), f.numpy())


def test_walk_watertight_rounded_cube():
    """0 leaks in 2,000 rays from the cube's interior, closest and any
    hit, through the walk's wrapper on the CPU (the plain walk)."""
    scene, _ = port_config3()
    rng = np.random.default_rng(42)
    n = 2000
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    zero = torch.zeros(n)
    d = V3(*(torch.as_tensor(dirs[:, k].copy()) for k in range(3)))
    inf = torch.full((n,), float("inf"))
    _, _, hit = bvh_walk.walk_intersect(scene.bvh_nodes8,
                                        scene.bvh_tri_verts,
                                        V3(zero, zero, zero), d, inf)
    _, _, occ = bvh_walk.walk_intersect(scene.bvh_nodes8,
                                        scene.bvh_tri_verts,
                                        V3(zero, zero, zero), d, inf,
                                        any_hit=True)
    assert int((~hit).sum()) == 0 and int((~occ).sum()) == 0


def test_walk_stats_count_the_work():
    """The plain walk's work counts: every visit reads a node row, every
    leaf slot tested reads a face, and distinct rows never exceed the
    table."""
    scene, _ = port_config3()
    o, d, t_max = (torch.as_tensor(a) for a in _rays("outside", n=300))
    stats = {}
    bvh.bvh_intersect(scene.bvh_nodes8, scene.bvh_tri_verts, o, d, t_max,
                      stats=stats)
    m, f = scene.bvh_nodes8.shape[0], scene.bvh_tri_verts.shape[0]
    assert stats["node_visits"] >= 300
    assert 0 < stats["nodes_touched"] <= min(m, stats["node_visits"])
    assert 0 < stats["faces_touched"] <= min(f, stats["woop_tests"])
    assert stats["steps"] <= m


def test_walk_refuses_other_devices():
    scene, _ = port_config3()
    z = torch.zeros(4, device="meta")
    with pytest.raises(ValueError):
        bvh_walk.walk_intersect(scene.bvh_nodes8, scene.bvh_tri_verts,
                                V3(z, z, z), V3(z, z, z), z)

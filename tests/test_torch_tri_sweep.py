"""Port parity: the triangle sweeps (geometry/tri_sweep.py).

On the CPU the sweep wrappers take the plain PyTorch version; it is held
against the JAX dense path (tensor_tri.mt_intersect) and the Pallas kernel
in interpret mode on the same meshes and rays. The CUDA kernels themselves
run only on a card (tests/test_torch_gpu.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fountain_tpu.core.vecmath import V3 as JV3
from fountain_tpu.geometry import pallas_tri as jpt
from fountain_tpu.geometry.tensor_tri import build_tri_features, mt_intersect
from fountain_tpu_torch.core.vecmath import V3
from fountain_tpu_torch.geometry import tri_sweep as ts

T_RTOL = 3e-5   # f32 sums in another order (BLAS vs XLA dot vs bf16x6)


def _random_mesh(n_tris, seed, spread=10.0):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-spread, spread, (n_tris, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    return np.stack([v0, v1, v2], axis=1)


def _random_rays(n, seed, spread=12.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _tv3(a):
    return V3(*[torch.as_tensor(a[:, k].copy()) for k in range(3)])


def _jv3(a):
    return JV3(*[jnp.asarray(a[:, k]) for k in range(3)])


# the first two cases of tests/test_pallas_tri.py
CASES = {
    "multi_block_ray_padding": (jpt.BC + 37, 3, jpt.BN + 61, 4, np.inf,
                                False),
    "t_cap_any_hit": (200, 5, jpt.BN, 6, 8.0, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_sweep_matches_tensor_path_and_pallas(case):
    """Gates: hit masks and idx equal, t within rtol 3e-5, any-hit equal,
    against both JAX paths."""
    nf, ms, nr, rs, cap, any_only = CASES[case]
    tv = _random_mesh(nf, ms)
    o, d = _random_rays(nr, rs)
    table = ts.pack_sweep_table(tv, "cpu")
    t_max = np.full(nr, cap, np.float32)
    tt, ti, tok = ts.mt_intersect_kernel(table, _tv3(o), _tv3(d),
                                         torch.as_tensor(t_max))
    _, _, tocc = ts.mt_intersect_kernel(table, _tv3(o), _tv3(d),
                                        torch.as_tensor(t_max), any_hit=True)
    jt, ji, jok = map(np.asarray, mt_intersect(
        build_tri_features(tv), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(t_max)))
    _, _, pocc = jpt.mt_intersect_pallas(
        jpt.pack_features_pallas(tv), _jv3(o), _jv3(d), jnp.asarray(t_max),
        any_hit=True, interpret=True)
    np.testing.assert_array_equal(tocc.numpy(), np.asarray(pocc))
    np.testing.assert_array_equal(tocc.numpy(), jok)
    if any_only:
        return
    pt, pi, pok = map(np.asarray, jpt.mt_intersect_pallas(
        jpt.pack_features_pallas(tv), _jv3(o), _jv3(d), jnp.asarray(t_max),
        interpret=True))
    assert jok.sum() > 20
    for rt, ri, rok in ((jt, ji, jok), (pt, pi, pok)):
        np.testing.assert_array_equal(tok.numpy(), rok)
        np.testing.assert_array_equal(ti.numpy()[rok], ri[rok])
        np.testing.assert_allclose(tt.numpy()[rok], rt[rok], rtol=T_RTOL)
    # a miss is (inf, 0, False), as in mt_intersect_pallas
    assert np.isinf(tt.numpy()[~jok]).all() and (ti.numpy()[~jok] == 0).all()


def test_interior_rays_do_not_leak():
    """20,000 rays from the rounded cube's interior all hit (watertight)."""
    from tests.test_torch_scene import port_config3
    scene, _ = port_config3(8)
    rng = np.random.default_rng(11)
    d = rng.normal(size=(20_000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    z = torch.zeros(20_000)
    _, _, ok = ts.mt_intersect_kernel(scene.tri_sweep, V3(z, z, z), _tv3(d),
                                      torch.full((20_000,), float("inf")))
    assert int((~ok).sum()) == 0


def test_face_table_layout_and_conservative_bounds():
    tv = _random_mesh(300, 1)
    table = ts.pack_sweep_table(tv, "cpu")
    packed = np.asarray(build_tri_features(tv).packed)
    np.testing.assert_array_equal(table.feat.packed.numpy(), packed)
    # each face's 16 non-zero coefficients as 4 rows of 4, row-major within
    # each 128-face block: [block][row][face][4]
    assert table.coef.shape == (3, 4, ts.BLOCK_FACES, 4)
    faces = ts.dense_coefficients(table.coef.permute(0, 2, 1, 3).reshape(
        3 * ts.BLOCK_FACES, ts.COEF_PER_FACE)).numpy()
    np.testing.assert_array_equal(faces[:, :300], packed)
    assert not faces[:, 300:].any()        # padding faces: det = 0
    b = table.bounds.numpy()
    for k in range(3):
        blk = tv[k * 128:(k + 1) * 128].reshape(-1, 3)
        assert (b[k, 0:3] < blk.min(0)).all() and (b[k, 3:6] > blk.max(0)
                                                   ).all()


def test_face_table_refuses_other_coefficients():
    """The kernels read only the 16 coefficients that build_tri_features
    can make non-zero; a table with others raises instead of being
    swept wrongly."""
    packed = np.array(build_tri_features(_random_mesh(20, 2)).packed)
    bad = packed.copy()
    bad[5, 3, 0] = 1.0                     # det gains a (o x d) term
    with pytest.raises(ValueError):
        ts.compact_coefficients(torch.as_tensor(bad))
    np.testing.assert_array_equal(
        ts.dense_coefficients(ts.compact_coefficients(
            torch.as_tensor(packed))).numpy(), packed)


def test_sort_keys_match_pallas_morton():
    """The Morton ray order that chip_smoke.py measures against lane order
    is the JAX package's."""
    from chip_smoke import sort_keys
    o, d = _random_rays(3000, 2, 30.0)
    np.testing.assert_array_equal(
        sort_keys(_tv3(o), _tv3(d)).numpy(),
        np.asarray(jpt.sort_keys(_jv3(o), _jv3(d))))


@pytest.mark.parametrize("any_hit", [False, True])
def test_dead_lanes_miss_like_pallas(any_hit):
    """t_max < 0 marks a dead lane: it misses in both modes, as in
    mt_intersect_pallas; live lanes keep their hits."""
    n = 1536
    tv = _random_mesh(jpt.BC + 37, 3)
    o, d = _random_rays(n, 4, 6.0)
    table = ts.pack_sweep_table(tv, "cpu")
    t_max = np.where(np.arange(n) % 3 == 0, -1.0, np.inf).astype(np.float32)
    dead = t_max < 0
    _, ti, tok = ts.mt_intersect_kernel(table, _tv3(o), _tv3(d),
                                        torch.as_tensor(t_max),
                                        any_hit=any_hit)
    _, _, all_ok = ts.mt_intersect_kernel(table, _tv3(o), _tv3(d),
                                          torch.full((n,), float("inf")),
                                          any_hit=any_hit)
    _, pi, pok = map(np.asarray, jpt.mt_intersect_pallas(
        jpt.pack_features_pallas(tv), _jv3(o), _jv3(d), jnp.asarray(t_max),
        any_hit=any_hit, interpret=True))
    tok, all_ok = tok.numpy(), all_ok.numpy()
    assert not tok[dead].any() and all_ok[dead].sum() > 10
    np.testing.assert_array_equal(tok[~dead], all_ok[~dead])
    np.testing.assert_array_equal(tok, pok)
    if not any_hit:
        np.testing.assert_array_equal(ti.numpy()[pok], pi[pok])


def test_sweep_refuses_other_devices():
    table = ts.pack_sweep_table(_random_mesh(10, 1), "cpu")
    z = torch.zeros(4, device="meta")
    with pytest.raises(ValueError):
        ts.mt_intersect_kernel(table, V3(z, z, z), V3(z, z, z), z)


@pytest.mark.parametrize("where", ["one_block", "two_blocks"])
def test_coincident_faces_lower_index_wins(where):
    """Two copies of one triangle, in one 128-face block or in two: the
    port's plain version and the JAX dense path both give the lower
    index (the tie rule the kernels keep)."""
    from tests.test_torch_gpu import COINCIDENT, coincident_case
    tv, o, d = coincident_case(where)
    t_max = np.full(o.shape[0], np.inf, np.float32)
    table = ts.pack_sweep_table(tv, "cpu")
    tt, ti, tok = ts.mt_intersect_kernel(table, _tv3(o), _tv3(d),
                                         torch.as_tensor(t_max))
    jt, ji, jok = map(np.asarray, mt_intersect(
        build_tri_features(tv), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(t_max)))
    lo = min(COINCIDENT[where])
    assert tok.numpy().all() and jok.all()
    assert (ti.numpy() == lo).all() and (ji == lo).all()
    np.testing.assert_allclose(tt.numpy(), 5.0, rtol=T_RTOL)
    np.testing.assert_allclose(tt.numpy(), jt, rtol=T_RTOL)


def test_shadow_rays_match_pallas():
    """Shadow rays in the main path's form (unnormalised target - o,
    caps 1 - SHADOW_EPSILON, ~90% of lanes dead): the port's any-hit
    sweep equals the Pallas kernel in interpret mode."""
    from tests.test_torch_gpu import shadow_case
    tv, o, d, t_max = shadow_case(jpt.BC + 37, jpt.BN, 5)
    assert 0.05 < (t_max > 0).mean() < 0.15
    table = ts.pack_sweep_table(tv, "cpu")
    _, _, tocc = ts.mt_intersect_kernel(table, _tv3(o), _tv3(d),
                                        torch.as_tensor(t_max), any_hit=True)
    _, _, pocc = jpt.mt_intersect_pallas(
        jpt.pack_features_pallas(tv), _jv3(o), _jv3(d), jnp.asarray(t_max),
        any_hit=True, interpret=True)
    tocc = tocc.numpy()
    assert tocc.sum() > 5 and not tocc[t_max < 0].any()
    np.testing.assert_array_equal(tocc, np.asarray(pocc))


def test_non_finite_rays_miss():
    """A ray with a non-finite component misses in the port's plain
    version and in the JAX dense path (the kernels keep this rule)."""
    from tests.test_torch_gpu import non_finite_rays
    tv = _random_mesh(300, 1)
    o, d, bad = non_finite_rays(1024, 4)
    t_max = np.full(1024, np.inf, np.float32)
    table = ts.pack_sweep_table(tv, "cpu")
    _, ti, tok = ts.mt_intersect_kernel(table, _tv3(o), _tv3(d),
                                        torch.as_tensor(t_max))
    _, _, tocc = ts.mt_intersect_kernel(table, _tv3(o), _tv3(d),
                                        torch.as_tensor(t_max), any_hit=True)
    _, ji, jok = map(np.asarray, mt_intersect(
        build_tri_features(tv), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(t_max)))
    assert not tok.numpy()[bad].any() and not jok[bad].any()
    assert not tocc.numpy()[bad].any()
    np.testing.assert_array_equal(tok.numpy(), jok)
    np.testing.assert_array_equal(ti.numpy()[jok], ji[jok])

"""Port parity: spheres, sphere area lights, the film and the furnace.

The furnace (BASELINE config 1's scene) is a camera inside an emitting
sphere (L = 1, reverse orientation) whose inside is matte with albedo
rho = 0.5: path tracing gives L = 1 / (1 - rho) = 2, one NEE bounce
1 + rho = 1.5. Here the port is held to the JAX package module by module
on random inputs (spheres, their hit records, the sphere light's sampling
and pdf, the film's splat), to the furnace's analytic values
(``tests/test_furnace.py``), and its gradients to the analytic ones and to
central differences (``tests/test_grad.py:41-95``, the same sizes and
tolerances).

Observed on the CPU when this file was written: the module outputs
within the gates below (the sphere light's pdf past 1e-4 on 13 and 9 of
2,048 lanes, see ``_close_pdf``); furnace means 1.99901 (no RR, largest
pixel error 0.0029), 1.99824 (RR, 0.078) and 1.49999 (0.0020); gradient
3.92188 against central difference 3.92163 (rel 6.3e-5); 3.99316 against
the truncated series 3.99634 (rel 7.9e-4); emitter gradient 1.99999.
The file takes about 100 s on one CPU thread, 70 of them the two 16x16
furnace renders of 128 and 256 samples.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fountain_tpu.core.vecmath import V3 as JV3
from fountain_tpu_torch.core import transform as tf
from fountain_tpu_torch.core.vecmath import V3
from fountain_tpu_torch.integrator.path import PathConfig
from fountain_tpu_torch.integrator.render import render
from fountain_tpu_torch.scene.build import SceneBuilder, scene_from_arrays
from fountain_tpu_torch.scene.camera import make_perspective_camera
from tests.test_torch_scene import jax_arrays

TOL = dict(rtol=1e-5, atol=1e-5)
N_RAYS = 2048


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny tensors: one intra-op thread beats eight that contend with
    the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close_pdf(j, t):
    """A sphere light's solid-angle pdf is d^2 / (|cos| area) at the first
    hit along wi: at grazing hits (small cos, pdf in the hundreds) it
    amplifies the ulps by which the two packages' matrix products differ
    (a near-tangent hit moves by about the square root of a perturbation).
    Gate: rtol 1e-4 on >= 99% of lanes, 5e-2 on all (observed: 13 and 9 of
    2,048 lanes past 1e-4; the worst 3.3e-2, at pdf 445)."""
    a, b = _np(j).astype(np.float64), _np(t).astype(np.float64)
    assert np.isclose(a, b, rtol=1e-4, atol=1e-5).mean() >= 0.99
    np.testing.assert_allclose(a, b, rtol=5e-2, atol=1e-5)


def _close(j, t, mask=None, **tol):
    tol = tol or TOL
    pairs = zip(j, t) if isinstance(j, JV3) else [(j, t)]
    for a, b in pairs:
        a, b = _np(a), _np(b)
        if mask is not None:
            a, b = a[mask], b[mask]
        if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, **tol)


@pytest.fixture(scope="module")
def sphere_scenes():
    """Three spheres (a rotated, scaled and moved one that emits; a clipped
    one; a large emitting enclosure seen from inside) and a small mesh, in
    the JAX package and bridged to the port."""
    from fountain_tpu.geometry.bvh import attach_bvh
    from fountain_tpu.scene.build import SceneBuilder as JB
    b = JB()
    mat = b.add_matte(kd=[0.5, 0.4, 0.3])
    c, s = np.cos(0.5), np.sin(0.5)
    o2w = np.array([[1.2 * c, -1.2 * s, 0, 1.0], [1.2 * s, 1.2 * c, 0, 0.5],
                    [0, 0, 1.2, -0.3], [0, 0, 0, 1]], np.float32)
    a = b.add_sphere(radius=1.5, o2w=o2w, mat_id=mat)
    b.add_sphere(radius=0.8, o2w=np.array(
        [[1, 0, 0, -2.5], [0, 1, 0, 0], [0, 0, 1, 0.5], [0, 0, 0, 1]],
        np.float32), mat_id=mat, z_min=-0.4, z_max=0.6, phi_max_deg=270.0)
    e = b.add_sphere(radius=10.0, mat_id=mat, reverse_orientation=True)
    b.add_area_light_sphere(a, [2.0, 1.5, 1.0])
    b.add_area_light_sphere(e, [1.0, 0.8, 0.6])
    p = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0],
                  [0, -1, 0], [0, 0, 1], [0, 0, -1]], np.float32) * 1.6
    f = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                  [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int32)
    b.add_triangle_mesh(p + np.float32([0.0, -3.0, 0.0]), f, mat_id=mat)
    jscene = attach_bvh(b.build())
    return jscene, scene_from_arrays(jax_arrays(jscene), device="cpu")


def _rays(seed, n=N_RAYS):
    r = np.random.default_rng(seed)
    o = r.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.where(r.uniform(size=n) < 0.2, r.uniform(0.5, 6.0, n),
                     np.inf).astype(np.float32)
    t_max[::17] = -1.0                     # dead lanes
    return o, d, t_max


def _jv3(a):
    return JV3(*[jnp.asarray(a[:, k]) for k in range(3)])


def _tv3(a):
    return V3(*[torch.as_tensor(a[:, k].copy()) for k in range(3)])


def test_intersect_spheres_and_hit_info(sphere_scenes):
    from fountain_tpu.geometry import intersect as ji
    from fountain_tpu_torch.geometry import intersect as ti
    jscene, tscene = sphere_scenes
    o, d, t_max = _rays(1)
    jt, jidx, jok = ji.intersect_spheres(jscene.spheres, jnp.asarray(o),
                                         jnp.asarray(d), jnp.asarray(t_max))
    tt, tidx, tok = ti.intersect_spheres(tscene.spheres, torch.as_tensor(o),
                                         torch.as_tensor(d),
                                         torch.as_tensor(t_max))
    ok = np.asarray(jok)
    assert 300 < ok.sum() < N_RAYS - 300
    np.testing.assert_array_equal(ok, _np(tok))
    _close(jidx, tidx, ok)
    _close(jt, tt, ok)
    np.testing.assert_array_equal(
        np.asarray(ji.intersect_spheres_any(jscene.spheres, jnp.asarray(o),
                                            jnp.asarray(d),
                                            jnp.asarray(t_max))),
        _np(ti.intersect_spheres_any(tscene.spheres, torch.as_tensor(o),
                                     torch.as_tensor(d),
                                     torch.as_tensor(t_max))))
    cap = np.where(ok, np.asarray(jt), t_max)
    jh = ji.sphere_hit_info(jscene.spheres, jidx, jnp.asarray(o),
                            jnp.asarray(d), jnp.asarray(cap), jok)
    th = ti.sphere_hit_info(tscene.spheres, tidx, torch.as_tensor(o),
                            torch.as_tensor(d), torch.as_tensor(cap), tok)
    for f in ti.Hit.__dataclass_fields__:
        _close(getattr(jh, f), getattr(th, f), ok)


def test_scene_intersect_spheres_then_triangles(sphere_scenes):
    """Closest hit over spheres and the mesh (the sweep capped at the
    sphere's t), and the occlusion query over both."""
    from fountain_tpu.geometry import intersect as ji
    from fountain_tpu_torch.geometry import intersect as ti
    jscene, tscene = sphere_scenes
    o, d, t_max = _rays(2)
    jh = ji.scene_intersect(jscene, _jv3(o), _jv3(d), jnp.asarray(t_max))
    th = ti.scene_intersect(tscene, _tv3(o), _tv3(d), torch.as_tensor(t_max))
    ok = np.asarray(jh.valid)
    kinds = np.asarray(jh.prim_kind)[ok]
    assert (kinds == ti.PRIM_TRIANGLE).sum() > 50
    assert (kinds == ti.PRIM_SPHERE).sum() > 300
    for f in ti.Hit.__dataclass_fields__:
        _close(getattr(jh, f), getattr(th, f), ok)
    np.testing.assert_array_equal(
        np.asarray(ji.scene_intersect_any(jscene, _jv3(o), _jv3(d),
                                          jnp.asarray(t_max))),
        _np(ti.scene_intersect_any(tscene, _tv3(o), _tv3(d),
                                   torch.as_tensor(t_max))))


def test_sphere_light_sample_pdf_and_emission(sphere_scenes):
    """sample_light, light_pdf and emitted_radiance of the two sphere
    lights, from points inside the enclosure, against the JAX package."""
    from fountain_tpu.geometry.intersect import scene_intersect as jsi
    from fountain_tpu.lights import lights as jl
    from fountain_tpu_torch.geometry.intersect import scene_intersect as tsi
    from fountain_tpu_torch.lights import lights as tl
    jscene, tscene = sphere_scenes
    r = np.random.default_rng(3)
    p = r.uniform(-5, 5, (N_RAYS, 3)).astype(np.float32)
    u1, u2 = r.random((2, N_RAYS)).astype(np.float32)
    li = r.integers(0, 2, N_RAYS).astype(np.int32)
    js = jl.sample_light(jscene, jnp.asarray(li), _jv3(p), jnp.asarray(u1),
                         jnp.asarray(u2))
    ts_ = tl.sample_light(tscene, torch.as_tensor(li), _tv3(p),
                          torch.as_tensor(u1), torch.as_tensor(u2))
    assert (np.asarray(js.pdf) > 0).mean() > 0.5
    for f in tl.LightSample.__dataclass_fields__:
        if f != "pdf":
            _close(getattr(js, f), getattr(ts_, f))
    _close_pdf(js.pdf, ts_.pdf)
    d = r.normal(size=(N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jpdf = jl.light_pdf(jscene, jnp.asarray(li), _jv3(p), _jv3(d))
    assert (np.asarray(jpdf) > 0).mean() > 0.5
    _close_pdf(jpdf, tl.light_pdf(tscene, torch.as_tensor(li), _tv3(p),
                                  _tv3(d)))
    inf = np.full(N_RAYS, np.inf, np.float32)
    jh = jsi(jscene, _jv3(p), _jv3(d), jnp.asarray(inf))
    th = tsi(tscene, _tv3(p), _tv3(d), torch.as_tensor(inf))
    je = jl.emitted_radiance(jscene, jh)
    assert (np.asarray(je.x) > 0).mean() > 0.5
    _close(je, tl.emitted_radiance(tscene, th))


@pytest.mark.parametrize("radius", [0.5, 1.0])
def test_film_splat_and_finalize(radius):
    """The box splat (one tap at radius 0.5, a 3x3 window at 1.0), with
    non-finite samples dropped, and finalize, against the JAX film."""
    from fountain_tpu.scene import film as jf
    from fountain_tpu_torch.scene import film as tfm
    h, w = 6, 8
    r = np.random.default_rng(int(radius * 10))
    fx, fy = r.random((2, h * w)).astype(np.float32)
    rad = r.uniform(0, 2, (h * w, 3)).astype(np.float32)
    rad[5, 1] = np.inf
    rad[9, 0] = np.nan
    jfilm = jf.add_samples_aligned(jf.make_film(w, h), jnp.asarray(fx),
                                   jnp.asarray(fy), _jv3(rad),
                                   radius=radius)
    tfilm = tfm.add_samples_aligned(tfm.make_film(w, h, "cpu"),
                                    torch.as_tensor(fx), torch.as_tensor(fy),
                                    _tv3(rad), radius=radius)
    for f in ("r_sum", "g_sum", "b_sum", "weight_sum"):
        _close(getattr(jfilm, f), getattr(tfilm, f))
    _close(jf.finalize(jfilm), tfm.finalize(tfilm))
    assert np.isfinite(_np(tfm.finalize(tfilm))).all()


# --- the furnace ------------------------------------------------------------


def furnace_scene(albedo=0.5, emit=1.0):
    b = SceneBuilder()
    mat = b.add_matte(kd=[albedo] * 3, sigma=0.0)
    sph = b.add_sphere(radius=100.0, mat_id=mat, reverse_orientation=True)
    b.add_area_light_sphere(sph, [emit] * 3)
    return b.build(device="cpu")


def furnace_camera(res):
    return make_perspective_camera(
        tf.look_at([0.0, -2.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 1.0]),
        (res, res), fov_deg=60.0)


def test_furnace_scene_build_equals_jax():
    """The port's SceneBuilder makes the JAX package's sphere, light,
    material and bound tables for the furnace (a sphere with o2w and
    reverse orientation, a sphere area light)."""
    from fountain_tpu.scene.build import SceneBuilder as JB
    o2w = np.array([[0, -2, 0, 1], [2, 0, 0, 0], [0, 0, 2, 3], [0, 0, 0, 1]],
                   np.float32)
    built = []
    for builder in (JB(), SceneBuilder()):
        mat = builder.add_matte(kd=[0.5] * 3, sigma=0.0)
        sph = builder.add_sphere(radius=100.0, o2w=o2w, mat_id=mat,
                                 reverse_orientation=True)
        builder.add_area_light_sphere(sph, [1.0, 0.5, 0.25])
        built.append(builder.build() if isinstance(builder, JB)
                     else builder.build(device="cpu"))
    jscene, tscene = built
    for grp in ("spheres", "lights", "materials"):
        a, b = getattr(jscene, grp), getattr(tscene, grp)
        for name in b.__dataclass_fields__:
            _close(getattr(a, name), getattr(b, name), rtol=1e-6, atol=1e-6)
    _close(jscene.world_center, tscene.world_center)
    _close(jscene.world_radius, tscene.world_radius)


@pytest.mark.parametrize("case", [
    # (max_depth, rr_threshold, spp, expected, atol), as test_furnace.py
    (10, 0.0, 128, 2.0, 0.01),     # no Russian roulette: tight
    (10, 1.0, 256, 2.0, 0.1),      # Russian roulette: some variance
    (1, 0.0, 128, 1.5, 0.01),      # emitted + one NEE bounce = 1 + rho
], ids=["path_no_rr", "path_with_rr", "direct_lighting"])
def test_furnace_values(case):
    depth, rr, spp, expected, atol = case
    cfg = PathConfig(max_depth=depth, rr_threshold=rr, nee=True)
    img = _np(render(furnace_scene(), furnace_camera(16), 16, 16, spp, cfg))
    assert np.isfinite(img).all()
    np.testing.assert_allclose(img, expected, atol=atol)


def test_furnace_deterministic():
    cfg = PathConfig(max_depth=5, rr_threshold=0.0, nee=True)
    scene, cam = furnace_scene(), furnace_camera(16)
    np.testing.assert_array_equal(_np(render(scene, cam, 16, 16, 4, cfg)),
                                  _np(render(scene, cam, 16, 16, 4, cfg)))


def _albedo_loss(scene, cam, cfg, res, spp):
    def loss(tex_value):
        s = dataclasses.replace(scene, textures=dataclasses.replace(
            scene.textures, value=tex_value))
        return render(s, cam, res, res, spp, cfg).mean()
    return loss


def test_albedo_grad_matches_finite_difference():
    res, scene = 8, furnace_scene(0.5)
    loss = _albedo_loss(scene, furnace_camera(res),
                        PathConfig(max_depth=8, rr_threshold=0.0, nee=True),
                        res, 16)
    tv = scene.textures.value.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss(tv), tv)
    kd_row = int(np.argmax(_np(tv).sum(-1) > 0.4))
    h = 1e-3
    with torch.no_grad():
        bump = torch.zeros_like(tv)
        bump[kd_row] = h
        fd = (float(loss(tv + bump)) - float(loss(tv - bump))) / (2 * h)
    g_row = float(g[kd_row].sum())
    assert np.isfinite(g_row)
    np.testing.assert_allclose(g_row, fd, rtol=5e-3, atol=1e-4)


def test_albedo_grad_near_analytic():
    """The detached gradient against the depth-truncated series
    d/drho sum_{k<=D+1} rho^k (4 untruncated, at rho = 0.5)."""
    res, depth, rho = 8, 12, 0.5
    scene = furnace_scene(rho)
    loss = _albedo_loss(scene, furnace_camera(res),
                        PathConfig(max_depth=depth, rr_threshold=0.0,
                                   nee=True), res, 16)
    tv = scene.textures.value.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss(tv), tv)
    analytic = sum(k * rho ** (k - 1) for k in range(1, depth + 2))
    np.testing.assert_allclose(float(g.sum()), analytic, rtol=0.05)


def test_emitter_grad():
    """L = emit / (1 - rho), so dL/d(emit) = 2 at rho = 0.5."""
    res, scene = 8, furnace_scene(0.5)
    cam = furnace_camera(res)
    cfg = PathConfig(max_depth=16, rr_threshold=0.0, nee=True)
    emit = torch.tensor(1.0, requires_grad=True)
    s = dataclasses.replace(scene, lights=dataclasses.replace(
        scene.lights, emit=torch.ones_like(scene.lights.emit) * emit))
    (g,) = torch.autograd.grad(render(s, cam, res, res, 8, cfg).mean(), emit)
    np.testing.assert_allclose(float(g), 2.0, rtol=0.02)

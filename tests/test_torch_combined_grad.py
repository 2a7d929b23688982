"""Port parity: gradients on tests/test_grad.py's combined scene.

The scene of ``tests/test_grad.py:98-130`` (a matte octahedron, a GGX
metal sphere, an emitting enclosure and an image env light, BASELINE
config 4's material on a sphere), bridged through ``scene_from_arrays``:

- the detached estimator's gradients with respect to the texture values,
  the emitter scale and the env texels against the JAX package's
  ``value_and_grad`` (8x8, 1 spp, depth 2, run eagerly: compiling it
  takes XLA on the CPU longer than 15 minutes), rel 1e-3;
- the attached estimator's roughness gradient against the port's own
  central differences (8x8, 4 spp, depth 2, rtol 5e-2:
  ``tests/test_grad.py:199-204``'s settings and gate);
- the JAX package's NaN there (ROADMAP.md section C), on the scene's own
  camera rays: every ray that misses the metal sphere has a NaN
  d hit / d ray in JAX and a finite one in the port. (The JAX package's
  whole attached gradient of this scene at 4x4, 1 spp, depth 1 or 2 is
  NaN on the metal's rough_u row, texture row 4, and finite elsewhere;
  another eager run of about 100 s, so it is recorded, not repeated.)

Why the roughness gate bumps both rows: ``add_metal(roughness=0.2)``
gives the sphere's rough_u and rough_v slots one constant texture each,
and the isotropic branch of ``tr_sample_wh`` (alpha_u == alpha_v) shapes
the sampled direction with alpha_u alone, in both packages: the
estimator drops d wh / d alpha_v there, a bias of each row's gradient.
Bumping one row leaves that branch, so its difference quotient is the
anisotropic map's partial derivative: the port's rough_u row -0.0388
against its one-row difference -0.0244 (rough_v -0.0162 against
-0.0307), but both rows summed -0.05506 against -0.05519 with both
bumped together (8x8, 4 spp). The material's roughness, both rows
bumped together, stays on the isotropic branch; the per-row bias is
pinned, so that a change of the estimator shows as a test change.

Observed on the CPU when this file was written: loss 1.8071917 in both
(rel 1.3e-7); gradients within 7.3e-8 relative (texture rows), 1.3e-7
(emitter) and 1.2e-6 (texels); the attached roughness -0.0550640
against its central difference -0.0551939 (rel 2.4e-3). About 150 s on
one CPU thread, 125 of them the JAX package's eager render.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fountain_tpu.core.vecmath import V3 as JV3
from fountain_tpu_torch.core.vecmath import V3
from tests.test_torch_scene import jax_arrays

LOOK = ([0.0, -4.0, 1.0], [0.3, 0.0, 0.0], [0.0, 0.0, 1.0])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def combined():
    """tests/test_grad.py's combined scene, in the JAX package and bridged
    to the port."""
    from fountain_tpu.geometry.bvh import attach_bvh
    from fountain_tpu.scene.build import SceneBuilder
    from fountain_tpu_torch.scene.build import scene_from_arrays
    p = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0],
                  [0, -1, 0], [0, 0, 1], [0, 0, -1]], np.float32) * 0.8
    f = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                  [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int32)
    img = np.full((8, 16, 3), 0.8, np.float32)
    img[2:5, 3:9] = 2.0
    b = SceneBuilder()
    env_tex = b.add_image_texture(b.add_image(img))
    matte = b.add_matte(kd=[0.5, 0.4, 0.3])
    metal = b.add_metal(roughness=0.2)
    b.add_triangle_mesh(p, f, mat_id=matte)
    b.add_sphere(radius=0.5, o2w=np.array(
        [[1, 0, 0, 1.5], [0, 1, 0, 0.5], [0, 0, 1, 0], [0, 0, 0, 1]],
        np.float32), mat_id=metal)
    es = b.add_sphere(radius=50.0, mat_id=-1, reverse_orientation=True)
    b.add_area_light_sphere(es, [0.3] * 3)
    b.add_infinite_light([1.0] * 3, env_tex=env_tex)
    js = attach_bvh(b.build())
    return js, scene_from_arrays(jax_arrays(js), device="cpu")


def _port_loss(ts, res, spp, depth, detach_sampling, tv=None, emit=None,
               texels=None):
    from fountain_tpu_torch.core import transform as ttf
    from fountain_tpu_torch.integrator.path import PathConfig
    from fountain_tpu_torch.integrator.render import render
    from fountain_tpu_torch.scene.camera import make_perspective_camera
    s = dataclasses.replace(
        ts, textures=dataclasses.replace(
            ts.textures, value=ts.textures.value if tv is None else tv),
        lights=dataclasses.replace(
            ts.lights, emit=ts.lights.emit * (1.0 if emit is None else emit)),
        env_images=dataclasses.replace(
            ts.env_images,
            texels=ts.env_images.texels if texels is None else texels))
    cam = make_perspective_camera(ttf.look_at(*LOOK), (res, res), 50.0)
    cfg = PathConfig(max_depth=depth, rr_threshold=0.0, nee=True)
    return render(s, cam, res, res, spp, cfg,
                  detach_sampling=detach_sampling).mean()


def test_combined_detached_gradients_match_jax(combined):
    """Detached estimator, 8x8, 1 spp, depth 2: the loss and the
    gradients with respect to the texture values, the emitter scale and
    the env texels against the JAX package (rel 1e-3)."""
    from fountain_tpu.core import transform as jtf
    from fountain_tpu.integrator.path import PathConfig as JConfig
    from fountain_tpu.integrator.render import render as jrender
    from fountain_tpu.scene.camera import make_perspective_camera as jcam
    js, ts = combined
    res = 8
    jc = jcam(jtf.look_at(*[jnp.asarray(x) for x in LOOK]), (res, res),
              fov_deg=50.0)

    def jloss(tv, emit, texels):
        s = js._replace(
            textures=js.textures._replace(value=tv),
            lights=js.lights._replace(emit=js.lights.emit * emit),
            env_images=js.env_images._replace(texels=texels))
        return jnp.mean(jrender(s, jc, res, res, 1,
                                JConfig(max_depth=2, rr_threshold=0.0)))
    with jax.disable_jit():
        jv, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
            js.textures.value, jnp.float32(1.0), js.env_images.texels)
    params = [ts.textures.value.clone().requires_grad_(True),
              torch.tensor(1.0, requires_grad=True),
              ts.env_images.texels.clone().requires_grad_(True)]
    loss = _port_loss(ts, res, 1, 2, True, *params)
    tg = torch.autograd.grad(loss, params)
    np.testing.assert_allclose(float(loss), float(jv), rtol=1e-5)
    kd = int(ts.materials.kd_tex[0])
    rough = [int(ts.materials.rough_u_tex[1]),
             int(ts.materials.rough_v_tex[1])]
    j_tv = np.asarray(jg[0])
    assert (j_tv[kd] != 0).all() and (j_tv[rough, 0] != 0).all()
    for a, b in zip(jg, tg):
        a = np.asarray(a)
        assert np.isfinite(a).all()
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-3,
                                   atol=1e-6 * np.abs(a).max())


def test_combined_attached_roughness_matches_central_differences(combined):
    """Attached estimator at tests/test_grad.py's settings (8x8, 4 spp,
    depth 2, no Russian roulette): the metal's roughness gradient (its
    rough_u and rough_v rows, module docstring) against central
    differences of the same fixed-random-stream loss, h = 1e-3, rtol
    5e-2; every gradient entry finite."""
    _, ts = combined
    rows = [int(ts.materials.rough_u_tex[1]),
            int(ts.materials.rough_v_tex[1])]
    tv = ts.textures.value.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(_port_loss(ts, 8, 4, 2, False, tv), tv)
    assert torch.isfinite(g).all() and bool((g[rows, 0] != 0).all())
    h = 1e-3
    bump = torch.zeros_like(tv)
    bump[rows, 0] = h
    with torch.no_grad():
        fd = (float(_port_loss(ts, 8, 4, 2, False, tv + bump))
              - float(_port_loss(ts, 8, 4, 2, False, tv - bump))) / (2 * h)
    np.testing.assert_allclose(float(g[rows, 0].sum()), fd, rtol=5e-2,
                               atol=1e-5)
    # the estimator's bias per row, shared with the JAX package (ROADMAP.md
    # section C): the isotropic branch drops d wh / d alpha_v, so each
    # row's gradient is far from its one-row difference. Pinned, so that
    # a change of the estimator shows here.
    pinned = ((-0.0388394, -0.0243783), (-0.0162246, -0.0306964))
    for row, (want_g, want_fd) in zip(rows, pinned):
        bump = torch.zeros_like(tv)
        bump[row, 0] = h
        with torch.no_grad():
            fd_row = (float(_port_loss(ts, 8, 4, 2, False, tv + bump))
                      - float(_port_loss(ts, 8, 4, 2, False, tv - bump))
                      ) / (2 * h)
        np.testing.assert_allclose(float(g[row, 0]), want_g, rtol=1e-4)
        np.testing.assert_allclose(fd_row, want_fd, rtol=1e-3)
        assert abs(float(g[row, 0]) - fd_row) > 0.3 * abs(fd_row)


def test_combined_jax_nan_on_rays_missing_the_sphere(combined):
    """The recorded divergence on this scene: d (hit point) / d (ray
    direction) of the camera rays, through scene_intersect. JAX is NaN on
    exactly the rays that miss the metal sphere (its quadratic's root,
    intersect.py:96), the port finite on every ray; on the rays that hit
    the sphere the two agree."""
    from fountain_tpu.core import transform as jtf
    from fountain_tpu.geometry.intersect import scene_intersect as jsi
    from fountain_tpu.scene.camera import generate_rays as jgen
    from fountain_tpu.scene.camera import make_perspective_camera as jcam
    from fountain_tpu_torch.geometry.intersect import scene_intersect as tsi
    js, ts = combined
    res = 8
    jc = jcam(jtf.look_at(*[jnp.asarray(x) for x in LOOK]), (res, res),
              fov_deg=50.0)
    px = np.arange(res * res) % res + 0.5
    py = np.arange(res * res) // res + 0.5
    half = np.full(res * res, 0.5, np.float32)
    r = jgen(jc, *[jnp.asarray(a, jnp.float32) for a in (px, py, half,
                                                        half)])
    o = np.stack([np.asarray(c) for c in r.o], 1)
    d = np.stack([np.asarray(c) for c in r.d], 1)
    t_max = np.full(res * res, np.inf, np.float32)

    def jl(d_):
        h = jsi(js, JV3(*[jnp.asarray(o[:, k]) for k in range(3)]),
                JV3(d_[:, 0], d_[:, 1], d_[:, 2]), jnp.asarray(t_max))
        return jnp.sum(jnp.where(h.valid, h.p.x + h.p.y + h.p.z, 0.0))
    jg = np.asarray(jax.grad(jl)(jnp.asarray(d)))
    dt = torch.tensor(d, requires_grad=True)
    h = tsi(ts, V3(*[torch.as_tensor(o[:, k].copy()) for k in range(3)]),
            V3(dt[:, 0], dt[:, 1], dt[:, 2]), torch.as_tensor(t_max))
    tl = torch.where(h.valid, h.p.x + h.p.y + h.p.z, 0.0).sum()
    tg = torch.autograd.grad(tl, dt)[0].numpy()
    on_metal = (h.prim_kind.numpy() == 1) & (h.prim_id.numpy() == 0)
    assert 0 < on_metal.sum() < res * res
    assert np.isfinite(tg).all()
    np.testing.assert_array_equal(np.isfinite(jg).all(1), on_metal)
    np.testing.assert_allclose(tg[on_metal], jg[on_metal], rtol=1e-4,
                               atol=1e-5)

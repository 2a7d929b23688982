"""Port parity: gradients on the flagship, testscenes/logo_cube.pbrt.

BASELINE config 5's scene (metal cube, metal sphere with logo.png as its
roughness map, glass sphere, checkerboard ground, sky.exr), in both
estimators. Its whole JAX render's gradient costs more than 170 s eagerly
even at 4x4 and depth 2 (XLA on the CPU does not compile it), so the
modules are held instead, on its own tables at 256 random hits:
``gather_shading`` (the checker/scale walk, both images), then
``bsdf_sample`` and ``bsdf_f_pdf`` on its parameters, and the env light's
sample, pdf and radiance. Texture-row and atlas-texel gradients, and
those of the hit's uv, filter width and wo, where JAX is finite. The
port's flagship step (``bench.measure_flagship``) is checked at 8x8.

Observed on the CPU when this file was written, on the entries above
1e-3 of the largest: texture rows within rel 4.5e-7 in both estimators,
atlas texels within 9.5e-5 (detached) and 2.7e-4 (attached; bilinear
weights of one texel summed over many hits). Detached, JAX is finite
everywhere; attached, it is NaN on the roughness entries that the
refraction candidate's total internal reflection reaches (see
tests/test_torch_attached.py). About 105 s on one CPU thread, almost all
of it the JAX package's eager gradients.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fountain_tpu.core.vecmath import V3 as JV3
from fountain_tpu_torch.core.vecmath import V3
from tests.test_torch_scene import jax_arrays


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def flagship():
    from fountain_tpu.io.pbrt import load_pbrt
    from fountain_tpu_torch.scene.build import scene_from_arrays
    js, _, _ = load_pbrt("testscenes/logo_cube.pbrt")
    return js, scene_from_arrays(jax_arrays(js), device="cpu")


def _flagship_modules(pkg, scene, n, rng, detach):
    """A function of (texture values, atlas texels, u, v, width, wo) over
    ``n`` random hits of the flagship's materials, in the JAX package
    (``pkg == "jax"``) or the port: the outputs of bsdf_sample and
    bsdf_f_pdf on gather_shading's parameters, and the env light's
    sample, pdf and radiance. (Not the raw shading parameters: the port
    leaves the slots that no material type of the scene reads at zero,
    where the JAX package evaluates them.)"""
    mat = rng.integers(0, 4, n).astype(np.int32)
    u0, u1, u2 = rng.uniform(size=(3, n)).astype(np.float32)
    wi = rng.normal(size=(n, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    ref = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    z = np.zeros(n, np.float32)
    if pkg == "jax":
        from fountain_tpu.geometry.intersect import miss_hit
        from fountain_tpu.lights import lights as lt
        from fountain_tpu.shading import bsdf
        arr, v3, where, replace = jnp.asarray, JV3, jnp.where, \
            lambda s, **k: s._replace(**k)
        tex_rep = lambda s, tv, tx: s._replace(  # noqa: E731
            textures=s.textures._replace(value=tv),
            env_images=s.env_images._replace(texels=tx))
    else:
        from fountain_tpu_torch.geometry.intersect import miss_hit
        from fountain_tpu_torch.lights import lights as lt
        from fountain_tpu_torch.shading import bsdf
        arr, v3, where = torch.as_tensor, V3, torch.where
        replace = dataclasses.replace
        tex_rep = lambda s, tv, tx: dataclasses.replace(  # noqa: E731
            s, textures=dataclasses.replace(s.textures, value=tv),
            env_images=dataclasses.replace(s.env_images, texels=tx))

    def fn(tv, tx, u, v, width, wo):
        s = tex_rep(scene, tv, tx)
        zz = arr(z)
        hit = replace(miss_hit(v3(zz, zz, zz), v3(zz, zz, zz + 1.0)),
                      valid=arr(mat) >= 0, mat_id=arr(mat), u=u, v=v)
        sp = bsdf.gather_shading(s, hit, tex_width=width)
        wo3 = v3(wo[:, 0], wo[:, 1], wo[:, 2])
        bs = bsdf.bsdf_sample(sp, wo3, arr(u0), arr(u1), arr(u2),
                              detach_wi=detach)
        f, pdf = bsdf.bsdf_f_pdf(sp, wo3, v3(*[arr(wi[:, k].copy())
                                               for k in range(3)]))
        li = arr(np.zeros(n, np.int32))
        ls = lt.sample_light(s, li, v3(*[arr(ref[:, k].copy())
                                         for k in range(3)]), arr(u1),
                             arr(u2))
        wi3 = v3(*[arr(wi[:, k].copy()) for k in range(3)])
        lp = lt.light_pdf(s, li, v3(*[arr(ref[:, k].copy())
                                      for k in range(3)]), wi3)
        le = lt.environment_light_radiance(s, 0, wi3)
        ok = bs.valid
        return (*[where(ok, x, 0.0) for x in (*bs.wi, *bs.f, bs.pdf)],
                *f, pdf, *ls.radiance, ls.pdf, lp, *le)
    return fn


@pytest.mark.parametrize("detach", [True, False], ids=["detached",
                                                       "attached"])
def test_flagship_module_gradients_match_jax(flagship, detach):
    """The flagship's modules at 256 random hits, both estimators: the
    gradients with respect to the texture values, the atlas texels (both
    images), the hit's uv and the filter width, and wo, against the JAX
    package's, on the entries where JAX is finite (per-lane inputs: the
    lanes; tables: the entries), within 1e-5 of the largest JAX gradient
    (the texture rows and texels: also rel 1e-3 each); the port finite
    everywhere. Detached, JAX is finite on every entry."""
    js, ts = flagship
    n = 256
    rng = np.random.default_rng(20)
    u, v = rng.uniform(0, 1, (2, n)).astype(np.float32)
    width = np.exp(rng.uniform(np.log(1e-4), np.log(0.05), n)).astype(
        np.float32)
    wo = rng.normal(size=(n, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    args = [np.asarray(js.textures.value), np.asarray(js.env_images.texels),
            u, v, width, wo]
    seed_rng = lambda: np.random.default_rng(21)  # noqa: E731
    tfn = _flagship_modules("port", ts, n, seed_rng(), detach)
    jfn = _flagship_modules("jax", js, n, seed_rng(), detach)
    ta = [torch.tensor(a, requires_grad=True) for a in args]
    tout = tfn(*ta)
    w = [np.random.default_rng(22 + k).normal(size=tuple(o.shape)).astype(
        np.float32) for k, o in enumerate(tout)]
    tl = sum((o * torch.as_tensor(wk)).sum() for o, wk in zip(tout, w))
    tg = [g.numpy() for g in torch.autograd.grad(tl, ta)]
    jg = jax.grad(lambda *a: sum(jnp.sum(o * wk)
                                 for o, wk in zip(jfn(*a), w)),
                  argnums=tuple(range(len(args))))(
        *[jnp.asarray(a) for a in args])
    jg = [np.asarray(g) for g in jg]
    for g in tg:
        assert np.isfinite(g).all()
    for k, (a, b) in enumerate(zip(jg, tg)):
        fin = np.isfinite(a)
        if detach:
            assert fin.all()
        lanes = fin if k < 2 else fin.reshape(n, -1).all(1)
        a, b = a[lanes].astype(np.float64), b[lanes].astype(np.float64)
        scale = np.abs(a).max()
        assert np.abs(a - b).max() <= 1e-5 * scale, (k, np.abs(a - b).max()
                                                      / scale)
        if k < 2:
            big = np.abs(a) > 1e-3 * scale
            np.testing.assert_allclose(b[big], a[big], rtol=1e-3)
    assert (jg[0] != 0).sum() > 10 and (jg[1] != 0).sum() > 100
    if not detach:                 # the roughness image's texels
        assert np.isfinite(jg[0]).mean() > 0.5


@pytest.mark.parametrize("detach", [True, False], ids=["detached",
                                                       "attached"])
def test_flagship_step_numbers_on_the_cpu(detach):
    """``bench.measure_flagship`` at 8x8 lanes (the file's camera with an
    8x8 film), one timed step: a JSON-ready record whose loss equals
    ``flagship_step``'s at the same seed, gradients finite and non-zero,
    no sweep launches on the CPU (the plain versions run there)."""
    from fountain_tpu_torch import bench
    scene, cam = bench.build_flagship("cpu", film_res=8)
    rec = bench.measure_flagship(scene, cam, 8, 1, detach_sampling=detach)
    assert json.loads(json.dumps(rec)) == rec
    assert rec["estimator"] == ("detached" if detach else "attached")
    assert rec["rays_per_wave"] > 64 and rec["rays_per_s_fwd_bwd"] > 0
    assert rec["grad_finite"] and rec["grad_texels_sum"] != 0.0
    assert rec["launches_fwd"] == {"tri_sweep_closest": 0,
                                   "tri_sweep_any": 0}
    assert rec["launches_bwd"] == rec["launches_fwd"]
    loss, g_tv, g_tx = bench.flagship_step(scene, cam, 8, 1, detach)
    assert float(loss) == rec["loss"]
    assert float(g_tx.sum()) == rec["grad_texels_sum"]
    assert torch.isfinite(g_tv).all() and bool((g_tv != 0).any())

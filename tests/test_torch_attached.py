"""Port parity: the attached-sampling estimator (``detach_sampling=False``).

Module by module, the gradient of one random linear functional of each
function's outputs, with respect to its differentiable inputs, in the JAX
package (``jax.grad``) and in the port (autograd), on the same inputs
drawn from a numpy seed: the microfacet half-vector samplers, attached
``bsdf_sample`` of every material type, the vector helpers that spawn
rays, the watertight triangle re-intersection (its compensated products),
the trilinear mip lookup's filter width, light sampling and pdfs, and the
sphere intersection and hit record. Then a whole attached render of a
sphere-free mesh + env-image scene against the JAX package's
``value_and_grad``.

Where the two packages differ, and why (recorded in ROADMAP.md section C):
JAX's ``jnp.sqrt(jnp.maximum(x, 0.0))`` has a NaN gradient where x <= 0
(the unselected sqrt's infinite slope times a zero cotangent), where the
port's ``core.vecmath.sqrt0`` gives 0. Attached sampling reaches such
ops in the JAX package: the sphere quadratic's root
(``fountain_tpu/geometry/intersect.py:96``) on every ray that misses a
sphere, and ``refract``'s cos_t (``fountain_tpu/core/vecmath.py:280``) on
every lane whose GGX refraction candidate is totally reflected (the JAX
package builds that candidate on every lane, whatever its material). So
the comparisons run on the lanes where JAX's gradient is finite, the port
is finite on every lane, and ``test_jax_nan_ops_are_finite_in_the_port``
shows both ops. A ray through a sphere's centre (``length`` of a zero
vector) is NaN in both.

Gates: modules, the largest absolute difference over the lanes where JAX
is finite within 1e-5 of the largest JAX gradient there. Observed on the
CPU when this file was written (compared lanes of 512): half-vector
samplers 1.0e-6 (GGX) and 7.3e-7 (Beckmann); attached ``bsdf_sample``
2.5e-7 matte (282), 1.2e-9 mirror (298), 1.1e-7 glass (303), 2.4e-6
rough glass (296), 7.1e-7 metal (285), 3.5e-7 plastic (302); spawn
helpers 1.4e-7; triangle re-intersection 3.2e-8; trilinear lookup
4.2e-7; light sampling 5.1e-6 sphere (370), 2.1e-7 env; sphere hits
7.4e-6 (347). The whole render: loss rel 1e-5 (observed equal) and each
gradient entry where JAX is finite within rel 1e-3, atol 1e-7 (observed
7.8e-7 on the texture rows, 5.2e-7 on the texels). About 170 s on one
CPU thread, 110 of them the JAX package's eager render (its compile did
not finish in 15 minutes).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fountain_tpu.core.vecmath import V3 as JV3
from fountain_tpu_torch.core.vecmath import V3
from tests.test_torch_materials import _MATS, _dirs
from tests.test_torch_scene import jax_arrays

N = 512
REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jv3(a):
    return JV3(a[:, 0], a[:, 1], a[:, 2])


def _tv3(a):
    return V3(a[:, 0], a[:, 1], a[:, 2])


def _grads(jfn, tfn, args, seed=0):
    """Gradients of sum_k w_k . out_k with respect to every numpy array of
    ``args`` ([N] or [N, 3]), for the JAX function ``jfn`` and the port's
    ``tfn`` (each returns a tuple of [N] float outputs). Returns (JAX
    gradients, port gradients) as numpy arrays."""
    ta = [torch.tensor(a, requires_grad=True) for a in args]
    tout = tfn(*ta)
    rng = np.random.default_rng(seed)
    w = [rng.normal(size=tuple(o.shape)).astype(np.float32) for o in tout]
    tl = sum((o * torch.as_tensor(wk)).sum() for o, wk in zip(tout, w))
    tg = torch.autograd.grad(tl, ta, allow_unused=True)

    def jl(*a):
        return sum(jnp.sum(o * wk) for o, wk in zip(jfn(*a), w))
    jg = jax.grad(jl, argnums=tuple(range(len(args))))(
        *[jnp.asarray(a) for a in args])
    tg = [np.zeros_like(a) if g is None else g.numpy()
          for a, g in zip(args, tg)]
    return [np.asarray(g) for g in jg], tg


def _finite_lanes(gs):
    ok = np.ones(gs[0].shape[0], bool)
    for g in gs:
        ok &= np.isfinite(g.reshape(g.shape[0], -1)).all(1)
    return ok


def _agree(jg, tg, min_finite=0.5, rel=REL, lanes=None):
    """The port is finite on every lane; on the lanes where every JAX
    gradient is finite (at least ``min_finite`` of them; and among
    ``lanes`` if given) each port gradient is within ``rel`` of the
    largest JAX gradient there. Returns the compared lanes' mask and the
    largest relative difference."""
    ok = _finite_lanes(jg)
    assert _finite_lanes(tg).all()
    if lanes is not None:
        ok &= lanes
    assert ok.mean() >= min_finite, ok.mean()
    worst = 0.0
    for a, b in zip(jg, tg):
        a, b = a[ok].astype(np.float64), b[ok].astype(np.float64)
        scale = np.abs(a).max()
        if scale == 0.0:
            assert np.abs(b).max() == 0.0
            continue
        worst = max(worst, np.abs(a - b).max() / scale)
    assert worst <= rel, worst
    print(f"compared {int(ok.sum())}/{ok.size} lanes, worst {worst:.2e}")
    return ok, worst


@pytest.mark.parametrize("model", ["tr", "beckmann"])
def test_half_vector_sampling_gradients(model):
    """tr_sample_wh (the pole-free ellipse map) and beckmann_sample_wh:
    d wh / d (alpha_u, alpha_v, u1, u2), isotropic and anisotropic
    lanes."""
    from fountain_tpu.shading import microfacet as jmf
    from fountain_tpu_torch.shading import microfacet as tmf
    name = f"{model}_sample_wh"
    rng = np.random.default_rng(1)
    ax = rng.uniform(0.02, 1.0, N).astype(np.float32)
    ay = np.where(rng.uniform(size=N) < 0.5, ax,
                  rng.uniform(0.02, 1.0, N)).astype(np.float32)
    u1, u2 = rng.uniform(0.01, 0.99, (2, N)).astype(np.float32)

    def run(mod):
        return lambda a, b, c, d: tuple(getattr(mod, name)(c, d, a, b))
    jg, tg = _grads(run(jmf), run(tmf), [ax, ay, u1, u2])
    _agree(jg, tg, min_finite=0.95)


def _shade_params(rng, kind, ax, ay):
    """ShadeParams of one material kind of ``_MATS`` on every lane: two
    functions of (alpha_u, alpha_v), one making the JAX package's, one
    the port's."""
    m, r = _MATS[kind]
    col = lambda lo, hi: rng.uniform(lo, hi, (N, 3)).astype(  # noqa: E731
        np.float32)
    f = dict(mtype=np.full(N, m, np.int32),
             kd=col(0, 1), ks=col(0, 1), kr=col(0, 1), kt=col(0, 1),
             sigma=np.where(rng.uniform(size=N) < 0.5, 0.0,
                            rng.uniform(5, 30, N)).astype(np.float32),
             eta=rng.uniform(1.2, 2.0, N).astype(np.float32),
             eta3=col(0.1, 2.0), k3=col(0.5, 5.0),
             rough_raw=np.full(N, r, np.float32))

    def jsp(au, av):
        from fountain_tpu.shading.bsdf import ShadeParams
        return ShadeParams(alpha_u=au, alpha_v=av, **{
            k: _jv3(jnp.asarray(v)) if v.ndim == 2 else jnp.asarray(v)
            for k, v in f.items()})

    def tsp(au, av):
        from fountain_tpu_torch.shading.bsdf import ShadeParams
        return ShadeParams(alpha_u=au, alpha_v=av, **{
            k: _tv3(torch.as_tensor(v)) if v.ndim == 2
            else torch.as_tensor(v) for k, v in f.items()})
    return jsp, tsp


@pytest.mark.parametrize("kind", range(len(_MATS)), ids=[
    "matte", "mirror", "glass", "rough_glass", "metal", "plastic"])
def test_bsdf_sample_attached_gradients(kind):
    """Attached bsdf_sample: d (wi, f, pdf on valid lanes) / d (alpha_u,
    alpha_v, wo), for every material type, on isotropic and anisotropic
    lanes. JAX is NaN on the lanes whose GGX refraction candidate is
    totally reflected (module docstring)."""
    from fountain_tpu.shading import bsdf as jb
    from fountain_tpu_torch.shading import bsdf as tb
    rng = np.random.default_rng(10 + kind)
    ax = rng.uniform(0.05, 0.8, N).astype(np.float32)
    ay = np.where(np.arange(N) % 2 == 0, ax,
                  ax * rng.uniform(0.5, 1.0, N)).astype(np.float32)
    wo = _dirs(rng, N)
    u = rng.uniform(size=(3, N)).astype(np.float32)
    jsp, tsp = _shade_params(rng, kind, ax, ay)

    def run(bsdf, sp, v3, asarr):
        def fn(a, b, w):
            s = bsdf.bsdf_sample(sp(a, b), v3(w), *asarr(u),
                                 detach_wi=False)
            where = jnp.where if bsdf is jb else torch.where
            return tuple(where(s.valid, x, 0.0)
                         for x in (*s.wi, *s.f, s.pdf))
        return fn
    jg, tg = _grads(run(jb, jsp, _jv3, lambda x: jnp.asarray(x)),
                    run(tb, tsp, _tv3, lambda x: torch.as_tensor(x)),
                    [ax, ay, wo], seed=kind)
    _agree(jg, tg)


def test_spawn_helpers_gradients():
    """offset_ray_origin (next_float_up/down pass a tangent of 1, as the
    JAX package's custom_jvp), normalize, length and refract on lanes
    without total internal reflection."""
    from fountain_tpu.core import vecmath as jvm
    from fountain_tpu_torch.core import vecmath as tvm
    rng = np.random.default_rng(2)
    p = rng.uniform(-5, 5, (N, 3)).astype(np.float32)
    err = rng.uniform(0, 1e-4, (N, 3)).astype(np.float32)
    n = _dirs(rng, N)
    w = rng.normal(size=(N, 3)).astype(np.float32)
    eta = rng.uniform(0.5, 0.95, N).astype(np.float32)  # no TIR

    def run(vm, v3):
        def fn(p_, e_, n_, w_, eta_):
            o = vm.offset_ray_origin(v3(p_), v3(e_), v3(n_), v3(w_))
            nw = vm.normalize(v3(w_))
            wt, _ = vm.refract(nw, v3(n_), eta_)
            return (*o, *nw, vm.length(v3(w_)), *wt)
        return fn
    jg, tg = _grads(run(jvm, _jv3), run(tvm, _tv3), [p, err, n, w, eta])
    ok, _ = _agree(jg, tg, min_finite=1.0)
    assert ok.all()


def test_triangle_reintersection_gradients():
    """woop_intersect_v3 (edge functions as compensated products, the
    Veltkamp split): d (t, b0, b1, b2) / d (o, d) on rays that hit their
    face."""
    from fountain_tpu.geometry import triangle as jt
    from fountain_tpu_torch.geometry import triangle as tt
    rng = np.random.default_rng(3)
    p0, p1, p2 = rng.uniform(-1, 1, (3, N, 3)).astype(np.float32)
    bary = rng.dirichlet([1, 1, 1], N).astype(np.float32)
    target = bary[:, :1] * p0 + bary[:, 1:2] * p1 + bary[:, 2:] * p2
    o = (target + rng.normal(size=(N, 3)) * 3).astype(np.float32)
    d = (target - o).astype(np.float32)
    t_max = np.full(N, np.inf, np.float32)

    def run(tri, v3, asarr):
        def fn(o_, d_):
            t, b0, b1, b2, _ = tri.woop_intersect_v3(
                v3(asarr(p0)), v3(asarr(p1)), v3(asarr(p2)), v3(o_),
                v3(d_), asarr(t_max))
            return t, b0, b1, b2
        return fn
    jg, tg = _grads(run(jt, _jv3, jnp.asarray),
                    run(tt, _tv3, torch.as_tensor), [o, d])
    _agree(jg, tg, min_finite=1.0)


def test_trilinear_lookup_width_gradient():
    """lookup_trilinear: d rgb / d (u, v, width) through the lerp between
    two mip levels (the ray cone's width carries a gradient in attached
    mode)."""
    from fountain_tpu.scene.build import SceneBuilder
    from fountain_tpu.shading.mipmap import lookup_trilinear as jlook
    from fountain_tpu_torch.scene.build import scene_from_arrays
    from fountain_tpu_torch.shading.mipmap import lookup_trilinear as tlook
    rng = np.random.default_rng(4)
    b = SceneBuilder()
    b.add_image(rng.uniform(0, 1, (32, 64, 3)).astype(np.float32))
    b.add_image(rng.uniform(0, 1, (16, 16, 3)).astype(np.float32))
    b.add_matte()
    js = b.build()
    ts = scene_from_arrays(jax_arrays(js), device="cpu")
    iid = rng.integers(0, 2, N).astype(np.int32)
    u, v = rng.uniform(-0.5, 1.5, (2, N)).astype(np.float32)
    width = np.exp(rng.uniform(np.log(1e-3), np.log(0.5), N)).astype(
        np.float32)

    jg, tg = _grads(
        lambda a, b_, c: tuple(jlook(js.env_images, jnp.asarray(iid), a, b_,
                                     c)),
        lambda a, b_, c: tuple(tlook(ts.env_images, torch.as_tensor(iid),
                                     a, b_, c)), [u, v, width])
    _agree(jg, tg, min_finite=1.0)
    assert np.abs(tg[2]).max() > 0.0


def _bridge(js):
    from fountain_tpu_torch.scene.build import scene_from_arrays
    return js, scene_from_arrays(jax_arrays(js), device="cpu")


_SPHERE_O2W = np.array([[1.2 * np.cos(0.5), -1.2 * np.sin(0.5), 0, 1.0],
                        [1.2 * np.sin(0.5), 1.2 * np.cos(0.5), 0, 0.5],
                        [0, 0, 1.2, 6.0], [0, 0, 0, 1]], np.float32)
_SPHERE_CENTRE = np.float32([1.0, 0.5, 6.0])    # world radius 1.8


def _light_scene(kind):
    """A triangle and either a transformed sphere area light or an image
    env light (sampled through its alias table), in the JAX package and
    bridged to the port. Each has one kind of light only: the JAX
    package's light pdf intersects a sphere on every lane, and is NaN
    where that misses (module docstring)."""
    from fountain_tpu.geometry.bvh import attach_bvh
    from fountain_tpu.scene.build import SceneBuilder
    rng = np.random.default_rng(5)
    b = SceneBuilder()
    mat = b.add_matte()
    if kind == "sphere":
        sph = b.add_sphere(radius=1.5, o2w=_SPHERE_O2W, mat_id=mat)
        b.add_area_light_sphere(sph, [2.0, 1.5, 1.0])
    else:
        env = b.add_image_texture(b.add_image(
            rng.uniform(0.2, 3.0, (16, 32, 3)).astype(np.float32)))
        b.add_infinite_light([1.0, 1.0, 1.0], env_tex=env)
    b.add_triangle_mesh(np.eye(3, dtype=np.float32), np.array([[0, 1, 2]]),
                        mat_id=mat)
    return _bridge(attach_bvh(b.build()))


@pytest.mark.parametrize("light", ["sphere", "env"])
def test_light_sampling_gradients(light):
    """sample_light's (radiance, wi, pdf, endpoint) and light_pdf with
    respect to the reference point and the direction, for a sphere area
    light (directions towards it) and an image env light. A point sampled
    on the sphere's silhouette makes a tangent ray (disc = 0), where JAX's
    root has an infinite slope and a NaN gradient (1 of 512 lanes here)
    and the port's ``sqrt0`` a zero one. Near it the slope,
    1 / sqrt(disc), amplifies the ulps by which the packages' transforms
    differ (as in the forward, tests/test_torch_furnace.py's
    ``_close_pdf``): the sphere's lanes are compared where the sampled
    direction passes the centre within 0.95 of the radius (72% of them;
    observed 4.0e-6, against 2.5e-5 within 0.99 and 0.11 on all)."""
    from fountain_tpu.lights import lights as jl
    from fountain_tpu_torch.lights import lights as tl
    js, ts = _light_scene(light)
    rng = np.random.default_rng(6)
    ref = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    if light == "sphere":
        wi = _SPHERE_CENTRE + rng.uniform(-1.0, 1.0, (N, 3)) - ref
    else:
        wi = rng.normal(size=(N, 3))
    wi = (wi / np.linalg.norm(wi, axis=1, keepdims=True)).astype(np.float32)
    u1, u2 = rng.uniform(size=(2, N)).astype(np.float32)
    li = np.zeros(N, np.int32)

    def run(lmod, scene, v3, asarr):
        def fn(p, w):
            s = lmod.sample_light(scene, asarr(li), v3(p), asarr(u1),
                                  asarr(u2))
            pdf = lmod.light_pdf(scene, asarr(li), v3(p), v3(w))
            return (*s.radiance, *s.wi, s.pdf, *s.p_light, pdf)
        return fn
    jg, tg = _grads(run(jl, js, _jv3, jnp.asarray),
                    run(tl, ts, _tv3, torch.as_tensor), [ref, wi])
    lanes = None
    if light == "sphere":
        s = tl.sample_light(ts, torch.as_tensor(li),
                            _tv3(torch.as_tensor(ref)), torch.as_tensor(u1),
                            torch.as_tensor(u2))
        w = s.wi.stack().numpy()
        c = _SPHERE_CENTRE - ref
        miss = np.linalg.norm(c - (c * w).sum(1, keepdims=True) * w, axis=1)
        lanes = miss <= 0.95 * 1.8
    _agree(jg, tg, min_finite=0.7, lanes=lanes)
    assert all(np.nanmax(np.abs(g)) > 0.0 for g in tg)


def test_sphere_intersection_and_hit_gradients():
    """intersect_spheres' t and sphere_hit_info's point, frame, uv and
    uv scale with respect to the ray, on the rays that hit the sphere
    (JAX is NaN on the rays that miss, module docstring)."""
    from fountain_tpu.geometry import intersect as ji
    from fountain_tpu_torch.geometry import intersect as ti
    js, ts = _light_scene("sphere")
    rng = np.random.default_rng(8)
    o = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    d = (_SPHERE_CENTRE + rng.normal(size=(N, 3)) * 1.2 - o).astype(
        np.float32)
    t_max = np.full(N, np.inf, np.float32)

    def run(mod, scene, v3, asarr):
        def fn(o_, d_):
            t, idx, ok = mod.intersect_spheres(scene.spheres, o_, d_,
                                               asarr(t_max))
            h = mod.sphere_hit_info(scene.spheres, idx, o_, d_, t, ok)
            w = jnp.where if mod is ji else torch.where
            outs = (t, *v3(h.p), *v3(h.n), *v3(h.ns), *v3(h.ss), h.u, h.v,
                    *v3(h.wo), h.inv_uv_scale)
            return tuple(w(ok, x, 0.0) for x in outs)
        return fn
    conv = lambda a: a if isinstance(a, JV3) else _jv3(a)  # noqa: E731
    tconv = lambda a: a if isinstance(a, V3) else _tv3(a)  # noqa: E731
    jg, tg = _grads(run(ji, js, conv, jnp.asarray),
                    run(ti, ts, tconv, torch.as_tensor), [o, d])
    _agree(jg, tg, min_finite=0.3)


def test_jax_nan_ops_are_finite_in_the_port():
    """The recorded divergence (ROADMAP.md section C): on a ray that
    misses a sphere, d t / d d is NaN in the JAX package (the root's
    sqrt(maximum(disc, 0)), intersect.py:96) and 0 in the port; on a
    totally reflected refraction, d wt / d wi is NaN in JAX
    (vecmath.py:280) and finite in the port. A ray through the centre of
    a sphere at the origin (length of the zero vector v, exactly) is NaN
    in both."""
    from fountain_tpu.core import vecmath as jvm
    from fountain_tpu.geometry import intersect as ji
    from fountain_tpu.scene.build import SceneBuilder
    from fountain_tpu_torch.core import vecmath as tvm
    from fountain_tpu_torch.geometry import intersect as ti
    b = SceneBuilder()
    b.add_sphere(radius=1.0, mat_id=b.add_matte())
    js, ts = _bridge(b.build())
    o = np.float32([[0.0, 0.0, -3.0], [0.0, 0.0, -3.0]])
    d = np.float32([[0.6, 0.0, 0.8], [0.0, 0.0, 1.0]])   # miss, centre
    t_max = np.full(2, np.inf, np.float32)

    def jgrad(lane):
        def t_of(d_):
            return ji.intersect_spheres(js.spheres, jnp.asarray(o), d_,
                                        jnp.asarray(t_max))[0][lane]
        return np.asarray(jax.grad(t_of)(jnp.asarray(d)))[lane]

    def tgrad(lane):
        dt = torch.tensor(d, requires_grad=True)
        t = ti.intersect_spheres(ts.spheres, torch.as_tensor(o), dt,
                                 torch.as_tensor(t_max))[0][lane]
        return torch.autograd.grad(t, dt)[0].numpy()[lane]
    assert np.isnan(jgrad(0)).all()
    assert (tgrad(0) == 0).all()
    assert np.isnan(jgrad(1)).all() and np.isnan(tgrad(1)).all()

    wi = np.float32([[0.8, 0.0, 0.6]])          # 53 degrees off the normal
    n, eta = np.float32([[0.0, 0.0, 1.0]]), np.float32([1.5])   # TIR

    def jr(w):
        return jvm.refract(_jv3(w), _jv3(jnp.asarray(n)), eta)[0].x.sum()
    assert not bool(jvm.refract(_jv3(wi), _jv3(n), eta)[1][0])
    assert np.isnan(np.asarray(jax.grad(jr)(jnp.asarray(wi)))).all()
    wt = torch.tensor(wi, requires_grad=True)
    out = tvm.refract(_tv3(wt), _tv3(torch.as_tensor(n)),
                      torch.as_tensor(eta))[0].x.sum()
    assert np.isfinite(torch.autograd.grad(out, wt)[0].numpy()).all()


def test_sqrt0_ties_have_zero_gradient():
    """The ties behind the NaN that the attached flagship step met on the
    card (ROADMAP.md section C), in the port: ``sqrt0``'s gradient is
    exactly 0 where x <= 0 and the plain sqrt's where x > 0; the
    half-vector samplers' alpha gradients are finite at u1 = 0 and at
    u1 = 1e-8 (cos theta rounds to 1, so 1 - cos^2 is exactly 0); and a
    ray tangent to a sphere (disc exactly 0) has a finite gradient of its
    t and of the sphere light's pdf. ``torch.sqrt(x.clamp_min(0))`` is
    non-finite in each of these."""
    from fountain_tpu_torch.core.vecmath import sqrt0
    from fountain_tpu_torch.geometry import intersect as ti
    from fountain_tpu_torch.lights import lights as tl
    from fountain_tpu_torch.scene.build import SceneBuilder
    from fountain_tpu_torch.shading import microfacet as tmf
    x = torch.tensor([0.0, -1.0, 4.0, 1e-30], requires_grad=True)
    (g,) = torch.autograd.grad(sqrt0(x).sum(), x)
    assert g.tolist() == [0.0, 0.0, 0.25, float(0.5 / torch.tensor(1e-15))]

    u1 = torch.tensor([0.0, 1e-8, 0.0, 1e-8])
    u2 = torch.tensor([0.3, 0.3, 0.7, 0.7])
    for name in ("tr_sample_wh", "beckmann_sample_wh"):
        ax = torch.tensor([0.3, 0.3, 0.3, 0.3], requires_grad=True)
        ay = torch.tensor([0.3, 0.3, 0.6, 0.6], requires_grad=True)
        wh = getattr(tmf, name)(u1, u2, ax, ay)
        assert (wh.z == 1.0).all()
        gs = torch.autograd.grad((wh.x + wh.y + wh.z).sum(), (ax, ay))
        assert all(torch.isfinite(g).all() for g in gs), (name, gs)

    b = SceneBuilder()
    sph = b.add_sphere(radius=1.0, mat_id=b.add_matte())
    b.add_area_light_sphere(sph, [1.0, 1.0, 1.0])
    scene = b.build(device="cpu")
    o = torch.tensor([[1.0, 0.0, -3.0]], requires_grad=True)
    d = torch.tensor([[0.0, 0.0, 1.0]], requires_grad=True)
    t, _, ok = ti.intersect_spheres(scene.spheres, o, d,
                                    torch.full((1,), float("inf")))
    assert bool(ok[0]) and float(t[0].detach()) == 3.0
    gs = torch.autograd.grad(t.sum(), (o, d))
    assert all(torch.isfinite(g).all() for g in gs), gs
    pdf = tl.light_pdf(scene, torch.zeros(1, dtype=torch.int32),
                       V3(o[:, 0], o[:, 1], o[:, 2]),
                       V3(d[:, 0], d[:, 1], d[:, 2]))
    gs = torch.autograd.grad(pdf.sum(), (o, d))
    assert all(torch.isfinite(g).all() for g in gs), gs


def _free_scene():
    """A sphere-free scene: a matte octahedron and a smaller GGX metal one
    (roughness 0.2) under an image env light, and a 4x4 camera."""
    from fountain_tpu.geometry.bvh import attach_bvh
    from fountain_tpu.scene.build import SceneBuilder
    p = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0],
                  [0, -1, 0], [0, 0, 1], [0, 0, -1]], np.float32) * 0.8
    f = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                  [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int32)
    img = np.full((8, 16, 3), 0.8, np.float32)
    img[2:5, 3:9] = 2.0
    b = SceneBuilder()
    env = b.add_image_texture(b.add_image(img))
    matte = b.add_matte(kd=[0.5, 0.4, 0.3])
    metal = b.add_metal(roughness=0.2)
    b.add_triangle_mesh(p, f, mat_id=matte)
    b.add_triangle_mesh(p * 0.6 + np.float32([0.9, -0.6, 0.0]), f,
                        mat_id=metal)
    b.add_infinite_light([1.0] * 3, env_tex=env)
    return attach_bvh(b.build())


def test_attached_render_matches_jax_sphere_free():
    """An attached render (4x4, 1 spp, depth 2, no Russian roulette) of a
    sphere-free scene: loss and d loss / d (texture values, env texels)
    against the JAX package's value_and_grad, run eagerly. JAX is NaN on
    the rough_u rows of both materials (the GGX refraction candidate,
    built on every lane, reaches alpha_u, which alone shapes an isotropic
    lobe's sampled direction; module docstring); the port is finite
    everywhere, and non-zero on the metal's rough_u row."""
    from fountain_tpu.core import transform as jtf
    from fountain_tpu.integrator.path import PathConfig as JConfig
    from fountain_tpu.integrator.render import render as jrender
    from fountain_tpu.scene.camera import make_perspective_camera as jcam
    from fountain_tpu_torch.core import transform as ttf
    from fountain_tpu_torch.integrator.path import PathConfig
    from fountain_tpu_torch.integrator.render import render
    from fountain_tpu_torch.scene.camera import make_perspective_camera
    res = 4
    js, ts = _bridge(_free_scene())
    look = ([0.0, -4.0, 1.0], [0.3, 0.0, 0.0], [0.0, 0.0, 1.0])
    jc = jcam(jtf.look_at(*[jnp.asarray(x) for x in look]), (res, res),
              fov_deg=50.0)
    tc = make_perspective_camera(ttf.look_at(*look), (res, res), 50.0)

    def jloss(tv, texels):
        s = js._replace(textures=js.textures._replace(value=tv),
                        env_images=js.env_images._replace(texels=texels))
        return jnp.mean(jrender(s, jc, res, res, 1,
                                JConfig(max_depth=2, rr_threshold=0.0),
                                detach_sampling=False))
    with jax.disable_jit():
        jv, (jg_tv, jg_tx) = jax.value_and_grad(jloss, argnums=(0, 1))(
            js.textures.value, js.env_images.texels)
    jg_tv, jg_tx = np.asarray(jg_tv), np.asarray(jg_tx)

    tv = ts.textures.value.clone().requires_grad_(True)
    tx = ts.env_images.texels.clone().requires_grad_(True)
    s = dataclasses.replace(
        ts, textures=dataclasses.replace(ts.textures, value=tv),
        env_images=dataclasses.replace(ts.env_images, texels=tx))
    loss = render(s, tc, res, res, 1, PathConfig(max_depth=2,
                                                 rr_threshold=0.0),
                  detach_sampling=False).mean()
    loss.backward()
    g_tv, g_tx = tv.grad.numpy(), tx.grad.numpy()

    np.testing.assert_allclose(float(loss), float(jv), rtol=1e-5)
    assert np.isfinite(g_tv).all() and np.isfinite(g_tx).all()
    nan = ~np.isfinite(jg_tv)
    rough_u = ts.materials.rough_u_tex.numpy()
    assert nan.sum() == 2 and nan[rough_u, 0].all()
    assert g_tv[rough_u[1], 0] != 0.0 and np.isfinite(jg_tx).all()
    kd = int(ts.materials.kd_tex[0])
    rough_v = int(ts.materials.rough_v_tex[1])
    assert (jg_tv[kd] != 0).all() and jg_tv[rough_v, 0] != 0.0
    assert (jg_tx != 0).any()
    for a, b in ((jg_tv[~nan], g_tv[~nan]), (jg_tx, g_tx)):
        np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-7)


@pytest.mark.parametrize("entry", ["render", "render_samples",
                                   "render_regen", "trace_paths_regen"])
def test_attached_sampling_runs_through_every_entry_point(entry):
    """detach_sampling=False through each render entry point of the port
    (the fixed wave is ``render``'s): finite gradients, the metal's
    roughness gradient changed by the sampling term, the same image as
    the detached estimator."""
    from fountain_tpu_torch import bench
    from fountain_tpu_torch.core import transform as ttf
    from fountain_tpu_torch.integrator import render as rd
    from fountain_tpu_torch.integrator.path import PathConfig, trace_paths
    from fountain_tpu_torch.scene.camera import make_perspective_camera
    from fountain_tpu_torch.scene.film import finalize, make_film
    _, ts = _bridge(_free_scene())
    res, cfg = 4, PathConfig(max_depth=3, rr_threshold=1.0)
    cam = make_perspective_camera(
        ttf.look_at([0.0, -4.0, 1.0], [0.3, 0.0, 0.0], [0.0, 0.0, 1.0]),
        (res, res), 50.0)

    def run(detach):
        tv = ts.textures.value.clone().requires_grad_(True)
        s = dataclasses.replace(ts, textures=dataclasses.replace(
            ts.textures, value=tv))
        kw = dict(detach_sampling=detach)
        if entry == "render":
            img = rd.render(s, cam, res, res, 2, cfg, **kw)
        elif entry == "render_samples":
            img = finalize(rd.render_samples(s, cam, res, res, 0, 2, 2,
                                             make_film(res, res, "cpu"),
                                             cfg, **kw))
        elif entry == "render_regen":
            img = finalize(rd.render_regen(s, cam, res, res, 8, cfg,
                                           spp_total=2, **kw))
        else:
            n = res * res
            lane = torch.arange(n, dtype=torch.int32)
            ray_fn = bench.make_ray_fn(cam, res, 0)
            o, d, _ = ray_fn(lane, torch.zeros(n, dtype=torch.int32))
            img = trace_paths(s, o, d, lane, torch.zeros_like(lane), cfg,
                              regen_fn=ray_fn, n_iters=8, **kw).accum.x
        img.mean().backward()
        return img.detach(), tv.grad
    img_d, g_d = run(True)
    img_a, g_a = run(False)
    assert torch.equal(img_a, img_d)
    assert torch.isfinite(g_a).all()
    rough_u = int(ts.materials.rough_u_tex[1])
    assert g_a[rough_u, 0] != 0 and g_a[rough_u, 0] != g_d[rough_u, 0]

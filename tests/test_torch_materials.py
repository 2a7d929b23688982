"""Port parity: Fresnel, microfacet distributions, the five materials,
nested textures and the thin-lens camera.

Every input is drawn from a numpy seed and goes through the JAX function
and the port's. Observed on the CPU when this file was written (largest
absolute difference, and largest relative difference where the JAX value
exceeds 1e-3): Fresnel 4.8e-7 / 5.8e-7 (gate rtol = atol = 2e-6);
GGX/Beckmann D, lambda, sampled half vectors and the alpha remap 7.6e-6
/ 1.7e-5; bsdf_f_pdf 1.2e-7 / 8.0e-6; nested textures and
gather_shading 4.8e-7 / 2.5e-6; thin-lens rays and differentials 1.9e-6
/ 1.3e-6 (gates rtol = atol = 1e-5); bsdf_sample wi, f and pdf 3.2e-3
(on f values near 100) / 3.2e-5 (gate rtol 1e-4, atol 1e-5), with
is_specular and valid equal on every lane.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fountain_tpu.core.vecmath import V3 as JV3
from fountain_tpu.shading import bsdf as jb
from fountain_tpu.shading import fresnel as jfr
from fountain_tpu.shading import microfacet as jmf
from fountain_tpu_torch.core.vecmath import V3
from fountain_tpu_torch.shading import bsdf as tb
from fountain_tpu_torch.shading import fresnel as tfr
from fountain_tpu_torch.shading import microfacet as tmf
from tests.test_torch_scene import jax_arrays

TOL = dict(rtol=1e-5, atol=1e-5)
N = 4096


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(j, t, **tol):
    tol = tol or TOL
    if isinstance(j, JV3):
        for a, b in zip(j, t):
            np.testing.assert_allclose(_np(b), _np(a), **tol)
    else:
        np.testing.assert_allclose(_np(t), _np(j), **tol)


def _pair(a):
    """One numpy array as a JAX array and a torch tensor."""
    a = np.ascontiguousarray(a)
    return jnp.asarray(a), torch.as_tensor(a)


def _pair3(a):
    j = JV3(*[jnp.asarray(a[:, k]) for k in range(3)])
    t = V3(*[torch.as_tensor(np.ascontiguousarray(a[:, k]))
             for k in range(3)])
    return j, t


def _dirs(rng, n, z_sign=None):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    if z_sign is not None:
        d[:, 2] = np.abs(d[:, 2]) * z_sign
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def test_fresnel_dielectric_and_conductor():
    rng = np.random.default_rng(0)
    cos_i = rng.uniform(-1.0, 1.0, N).astype(np.float32)  # both sides
    jc, tc = _pair(cos_i)
    eta = rng.uniform(1.1, 2.5, N).astype(np.float32)
    je, te = _pair(eta)
    tol = dict(rtol=2e-6, atol=2e-6)
    _close(jfr.fresnel_dielectric(jc, 1.0, je),
           tfr.fresnel_dielectric(tc, 1.0, te), **tol)
    _close(jfr.fresnel_dielectric(jc, 1.5, 1.0),
           tfr.fresnel_dielectric(tc, 1.5, 1.0), **tol)
    e3 = rng.uniform(0.1, 2.0, (N, 3)).astype(np.float32)
    k3 = rng.uniform(0.5, 5.0, (N, 3)).astype(np.float32)
    ones = np.ones((N, 3), np.float32)
    (je3, te3), (jk3, tk3), (j1, t1) = _pair3(e3), _pair3(k3), _pair3(ones)
    _close(jfr.fresnel_conductor(jc, j1, je3, jk3),
           tfr.fresnel_conductor(tc, t1, te3, tk3), **tol)


@pytest.mark.parametrize("model", ["tr", "beckmann"])
def test_microfacet_d_lambda_sample(model):
    rng = np.random.default_rng(1)
    (jw, tw) = _pair3(_dirs(rng, N))
    ax = rng.uniform(0.01, 1.0, N).astype(np.float32)
    ay = np.where(rng.uniform(size=N) < 0.5, ax,
                  rng.uniform(0.01, 1.0, N)).astype(np.float32)
    (jax_, tax), (jay, tay) = _pair(ax), _pair(ay)
    u1, u2 = rng.uniform(size=(2, N)).astype(np.float32)
    (ju1, tu1), (ju2, tu2) = _pair(u1), _pair(u2)
    d, lam, wh = (("tr_d", "tr_lambda", "tr_sample_wh") if model == "tr"
                  else ("beckmann_d", "beckmann_lambda",
                        "beckmann_sample_wh"))
    _close(getattr(jmf, d)(jw, jax_, jay), getattr(tmf, d)(tw, tax, tay),
           rtol=1e-5, atol=1e-6)
    _close(getattr(jmf, lam)(jw, jax_, jay), getattr(tmf, lam)(tw, tax, tay))
    _close(getattr(jmf, wh)(ju1, ju2, jax_, jay),
           getattr(tmf, wh)(tu1, tu2, tax, tay))
    r = rng.uniform(0.0, 1.0, N).astype(np.float32)
    jr, tr = _pair(r)
    _close(jmf.roughness_to_alpha(jr), tmf.roughness_to_alpha(tr))


# lanes of each material: (mtype, rough_raw) with glass both smooth and rough
_MATS = [(0, 0.0), (1, 0.0), (2, 0.0), (2, 0.3), (3, 0.2), (4, 0.1)]


def _shade_params(rng):
    """Random per-lane shading parameters of all five materials, as JAX
    and port ShadeParams."""
    kind = rng.integers(0, len(_MATS), N)
    mtype = np.array([_MATS[k][0] for k in kind], np.int32)
    rough = np.array([_MATS[k][1] for k in kind], np.float32) \
        * rng.uniform(0.5, 2.0, N).astype(np.float32)
    aniso = rng.uniform(0.6, 1.0, N).astype(np.float32)
    alpha_u = np.maximum(rough, 1e-3).astype(np.float32)
    alpha_v = np.where(rng.uniform(size=N) < 0.5, alpha_u,
                       alpha_u * aniso).astype(np.float32)
    col = lambda lo, hi: rng.uniform(lo, hi, (N, 3)).astype(  # noqa: E731
        np.float32)
    sigma = np.where(rng.uniform(size=N) < 0.5, 0.0,
                     rng.uniform(5, 30, N)).astype(np.float32)
    fields = dict(mtype=mtype, kd=col(0, 1), ks=col(0, 1), kr=col(0, 1),
                  kt=col(0, 1), sigma=sigma,
                  eta=rng.uniform(1.2, 2.0, N).astype(np.float32),
                  eta3=col(0.1, 2.0), k3=col(0.5, 5.0), alpha_u=alpha_u,
                  alpha_v=alpha_v, rough_raw=rough)
    j, t = {}, {}
    for k, v in fields.items():
        if v.ndim == 2:
            j[k], t[k] = _pair3(v)
        else:
            j[k], t[k] = _pair(v)
    return jb.ShadeParams(**j), tb.ShadeParams(**t)


def test_bsdf_f_pdf_all_materials():
    rng = np.random.default_rng(2)
    jsp, tsp = _shade_params(rng)
    jwo, two = _pair3(_dirs(rng, N))
    jwi, twi = _pair3(_dirs(rng, N))
    jf, jp = jb.bsdf_f_pdf(jsp, jwo, jwi)
    tf_, tp = tb.bsdf_f_pdf(tsp, two, twi)
    _close(jf, tf_)
    _close(jp, tp)
    assert (_np(tp) > 0).mean() > 0.3
    np.testing.assert_array_equal(_np(jb.has_non_specular(jsp)),
                                  _np(tb.has_non_specular(tsp)))


def test_bsdf_sample_all_materials():
    rng = np.random.default_rng(3)
    jsp, tsp = _shade_params(rng)
    jwo, two = _pair3(_dirs(rng, N))
    u = rng.uniform(size=(3, N)).astype(np.float32)
    (ju0, tu0), (ju1, tu1), (ju2, tu2) = (_pair(x) for x in u)
    js = jb.bsdf_sample(jsp, jwo, ju0, ju1, ju2)
    ts = tb.bsdf_sample(tsp, two, tu0, tu1, tu2)
    np.testing.assert_array_equal(_np(js.is_specular), _np(ts.is_specular))
    np.testing.assert_array_equal(_np(js.valid), _np(ts.valid))
    ok = _np(ts.valid)
    assert ok.mean() > 0.5
    tol = dict(rtol=1e-4, atol=1e-5)
    for name in ("wi", "f"):
        for a, b in zip(getattr(js, name), getattr(ts, name)):
            np.testing.assert_allclose(_np(b)[ok], _np(a)[ok], **tol,
                                       err_msg=name)
    np.testing.assert_allclose(_np(ts.pdf)[ok], _np(js.pdf)[ok], **tol)
    for m, _ in _MATS:                 # every material sampled validly
        assert ok[_np(tsp.mtype) == m].any(), m


def _nested_scenes():
    """A JAX scene whose materials use checker and scale graphs over an
    image, a uv texture and constants, and the port's bridge of it."""
    from fountain_tpu.geometry.bvh import attach_bvh
    from fountain_tpu.scene.build import SceneBuilder
    from fountain_tpu_torch.scene.build import scene_from_arrays
    rng = np.random.default_rng(4)
    b = SceneBuilder()
    img = b.add_image(rng.uniform(0, 1, (16, 32, 3)).astype(np.float32))
    t_img = b.add_image_texture(img, uscale=2.0, vscale=3.0, uoffset=0.25)
    t_uv = b.add_uv_texture()
    t_scale = b.add_scale_texture(t_img, [0.5, 2.0, 1.5])
    t_c = b.add_constant_texture([0.2, 0.3, 0.4])
    t_chk = b.add_checkerboard_texture(t_scale, t_c, uscale=16, vscale=8)
    t_chk2 = b.add_checkerboard_texture(t_uv, t_chk, uscale=3, vscale=5)
    b.add_matte(kd=t_chk)
    b.add_plastic(kd=t_chk2, ks=t_scale)
    b.add_metal(rough_u=t_img, rough_v=t_scale)
    b.add_glass(kr=t_chk, kt=t_scale)
    b.add_mirror(kr=t_chk2)
    b.add_triangle_mesh(np.eye(3, dtype=np.float32),
                        np.array([[0, 1, 2]]), mat_id=0)
    js = attach_bvh(b.build())
    return js, scene_from_arrays(jax_arrays(js), device="cpu"), \
        [t_img, t_uv, t_scale, t_c, t_chk, t_chk2]


def test_nested_textures_eval_and_gather_shading():
    from fountain_tpu.geometry.intersect import miss_hit as jmiss
    from fountain_tpu.shading.mipmap import lookup_trilinear as jlook
    from fountain_tpu.shading.textures import eval_texture as jeval
    from fountain_tpu_torch.geometry.intersect import miss_hit as tmiss
    from fountain_tpu_torch.shading.mipmap import lookup_trilinear as tlook
    from fountain_tpu_torch.shading.textures import eval_texture as teval
    js, ts, tids = _nested_scenes()
    assert ts.textures.has_nested
    rng = np.random.default_rng(5)
    (ju, tu), (jv, tv) = (_pair(rng.uniform(0, 1, N).astype(np.float32))
                          for _ in range(2))
    (jw, tw) = _pair(rng.uniform(0, 0.05, N).astype(np.float32))
    jl = lambda i, u, v, w=None: jlook(js.env_images, i, u, v, w)  # noqa
    tl = lambda i, u, v, w=None: tlook(ts.env_images, i, u, v, w)  # noqa
    for tid in tids:
        (jt, tt) = _pair(np.full(N, tid, np.int32))
        _close(jeval(js.textures, jt, ju, jv, tex_lookup=jl, width=jw),
               teval(ts.textures, tt, tu, tv, tex_lookup=tl, width=tw))
    mid = rng.integers(0, 5, N).astype(np.int32)
    d = _dirs(rng, N)
    jo, to = _pair3(np.zeros((N, 3), np.float32))
    jd, td = _pair3(d)
    jm, tm = _pair(mid)
    jh = jmiss(jo, jd)._replace(mat_id=jm, u=ju, v=jv)
    th = dataclasses.replace(tmiss(to, td), mat_id=tm, u=tu, v=tv)
    jsp = jb.gather_shading(js, jh, tex_width=jw)
    tsp = tb.gather_shading(ts, th, tex_width=tw)
    np.testing.assert_array_equal(_np(jsp.mtype), _np(tsp.mtype))
    for f in ("kd", "ks", "kr", "kt", "sigma", "eta", "eta3", "k3",
              "alpha_u", "alpha_v", "rough_raw"):
        _close(getattr(jsp, f), getattr(tsp, f))


def _graph_names(t):
    seen, stack, names = set(), [t.grad_fn], set()
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(fn.name())
        stack.extend(f for f, _ in fn.next_functions)
    return names


def test_table_gathers_are_index_select():
    """The shading rows, the texture value rows, the light emission rows
    and the atlas texels are gathered by index_select (backward
    index_add_); no tensor[idx] gather (IndexBackward0, whose backward is
    an accumulating index_put_) is in the graph of a shaded image."""
    from fountain_tpu_torch.geometry.intersect import miss_hit as tmiss
    _, ts, _ = _nested_scenes()
    tv = ts.textures.value.clone().requires_grad_(True)
    texels = ts.env_images.texels.clone().requires_grad_(True)
    s = dataclasses.replace(
        ts, textures=dataclasses.replace(ts.textures, value=tv),
        env_images=dataclasses.replace(ts.env_images, texels=texels))
    rng = np.random.default_rng(6)
    n = 256
    th = dataclasses.replace(
        tmiss(_pair3(np.zeros((n, 3), np.float32))[1],
              _pair3(_dirs(rng, n))[1]),
        mat_id=torch.as_tensor(rng.integers(0, 5, n).astype(np.int32)),
        u=torch.rand(n), v=torch.rand(n))
    rows = tb.shading_rows(s, th.mat_id)
    assert rows.grad_fn.name() == "IndexSelectBackward0"
    sp = tb.gather_shading(s, th, tex_width=torch.full((n,), 0.01))
    out = sum(c.sum() for c in (*sp.kd, *sp.ks, sp.alpha_u))
    names = _graph_names(out)
    assert "IndexSelectBackward0" in names
    assert "IndexBackward0" not in names, names
    out.backward()
    assert bool((tv.grad != 0).any()) and bool((texels.grad != 0).any())

    from fountain_tpu_torch.io.pbrt import load_pbrt
    from fountain_tpu_torch.lights.lights import emitted_radiance
    furnace, _, _ = load_pbrt("testscenes/furnace_empty.pbrt", device="cpu")
    emit = furnace.lights.emit.clone().requires_grad_(True)
    lit = dataclasses.replace(th, valid=torch.ones(n, dtype=torch.bool),
                              light_id=torch.zeros(n, dtype=torch.int32),
                              n=th.wo)
    le = emitted_radiance(dataclasses.replace(furnace, lights=dataclasses
                                              .replace(furnace.lights,
                                                       emit=emit)), lit)
    names = _graph_names(le.x.sum())
    assert "IndexSelectBackward0" in names and "IndexBackward0" not in names


def test_thin_lens_rays_and_differentials():
    from fountain_tpu.core import transform as jtf
    from fountain_tpu.scene.camera import generate_rays as jgen
    from fountain_tpu.scene.camera import make_perspective_camera as jmk
    from fountain_tpu_torch.core import transform as ttf
    from fountain_tpu_torch.scene.camera import generate_rays as tgen
    from fountain_tpu_torch.scene.camera import make_perspective_camera \
        as tmk
    res = 64
    jc = jmk(jtf.look_at(jnp.asarray([28.0, -32.0, 20.0]),
                         jnp.asarray([0.0, 0.0, 2.0]),
                         jnp.asarray([0.0, 0.0, 1.0])),
             (res, res), fov_deg=40.0, lens_radius=0.6, focal_dist=47.0)
    tc = tmk(ttf.look_at([28.0, -32.0, 20.0], [0.0, 0.0, 2.0],
                         [0.0, 0.0, 1.0]), (res, res), 40.0,
             lens_radius=0.6, focal_dist=47.0)
    rng = np.random.default_rng(7)
    px, py, lu, lv = (rng.uniform(0, s, N).astype(np.float32)
                      for s in (res, res, 1.0, 1.0))
    jr = jgen(jc, *(jnp.asarray(a) for a in (px, py, lu, lv)))
    tr = tgen(tc, *(torch.as_tensor(a) for a in (px, py, lu, lv)))
    for f in ("o", "d", "rx_o", "rx_d", "ry_o", "ry_d"):
        _close(getattr(jr, f), getattr(tr, f), rtol=1e-5, atol=1e-5)
    # the lens spreads the origins over a disk of radius 0.6
    o = np.stack([_np(c) for c in tr.o], 1)
    r = np.linalg.norm(o - np.array([28.0, -32.0, 20.0]), axis=1)
    assert r.max() <= 0.6 + 1e-4 and r.max() > 0.5


def test_absent_material_types_change_nothing():
    """Shading builds the candidates of the scene's material types only
    (``Materials.present``); on lanes of those types the results are
    bitwise those of the full build."""
    rng = np.random.default_rng(8)
    _, tsp = _shade_params(rng)
    two = _pair3(_dirs(rng, N))[1]
    twi = _pair3(_dirs(rng, N))[1]
    u = [torch.as_tensor(x) for x in rng.uniform(size=(3, N)).astype(
        np.float32)]
    full_f, full_p = tb.bsdf_f_pdf(tsp, two, twi)
    full_s = tb.bsdf_sample(tsp, two, *u)
    for m, _ in _MATS:
        sub = dataclasses.replace(tsp, present=frozenset([m]))
        lanes = (tsp.mtype == m).numpy()
        f, p = tb.bsdf_f_pdf(sub, two, twi)
        s = tb.bsdf_sample(sub, two, *u)
        for a, b in ((f, full_f), (s.wi, full_s.wi), (s.f, full_s.f)):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(_np(x)[lanes], _np(y)[lanes])
        for a, b in ((p, full_p), (s.pdf, full_s.pdf),
                     (s.valid, full_s.valid),
                     (s.is_specular, full_s.is_specular)):
            np.testing.assert_array_equal(_np(a)[lanes], _np(b)[lanes])

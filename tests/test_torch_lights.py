"""Port parity: point, distant and mesh area lights (BASELINE config 2).

The JAX package and the port on the same scene tables (the JAX scene's
leaves bridged through ``scene_from_arrays``): ``sample_light``,
``light_pdf`` (a mesh light's pdf from the traced hit along wi) and
``emitted_radiance`` on 2,048 random lanes over every light type; the
mis_box (tools/bench_all.py's config 2) and a pbrt text with point,
distant, area-light trianglemesh, plymesh and loopsubdiv statements,
built by both packages into equal tables; a 16x16 mis_box render against
the JAX package's; the mesh-area-light furnace of tests/test_lights.py;
and the light branches the port builds only for the scene's light types
(``Lights.present``), held bitwise to the full build.

Observed on the CPU when this file was written: the sampled fields within
rtol 1e-5 (a far endpoint 1.2e-5 off on one lane of 2,048); equal tables;
the render within rtol 2.5e-4 on every pixel (see its test).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fountain_tpu.core.vecmath import V3 as JV3
from fountain_tpu_torch.core.vecmath import V3
from fountain_tpu_torch.scene.build import scene_from_arrays
from fountain_tpu_torch.scene.types import (LIGHT_AREA_TRI, LIGHT_DISTANT,
                                            LIGHT_INFINITE, LIGHT_POINT)
from tests.test_torch_scene import jax_arrays

TOL = dict(rtol=1e-5, atol=1e-6)
N = 2048
W = 556.0   # the mis_box's side


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(j, t, mask=None, **tol):
    tol = tol or TOL
    pairs = zip(j, t) if isinstance(j, (JV3, V3)) else [(j, t)]
    for a, b in pairs:
        a, b = _np(a), _np(b)
        if mask is not None:
            a, b = a[mask], b[mask]
        if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(b, a, **tol)


def _close_pdf(j, t):
    """A mesh light's solid-angle pdf is d^2 / (|cos| area): near grazing
    it amplifies the ulps by which the two packages' sampled points
    differ. Gate: rtol 1e-5 on >= 99% of lanes, 1e-3 on all."""
    a, b = _np(j).astype(np.float64), _np(t).astype(np.float64)
    assert np.isclose(b, a, rtol=1e-5, atol=1e-7).mean() >= 0.99
    np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-7)


def _quads(b, ceiling_light: bool):
    """The mis_box's five walls and its light quad (bench_all config 2),
    with any SceneBuilder; a second, downward-facing quad light when
    ``ceiling_light`` (the mis_box's own light faces the ceiling)."""
    def quad(p0, p1, p2, p3, mat):
        return b.add_triangle_mesh(
            np.asarray([p0, p1, p2, p3], np.float32),
            np.asarray([[0, 1, 2], [0, 2, 3]], np.int32), mat_id=mat)
    white = b.add_matte(kd=[0.73, 0.73, 0.73])
    red = b.add_matte(kd=[0.65, 0.05, 0.05])
    green = b.add_matte(kd=[0.12, 0.45, 0.15])
    s, w = 278.0, W
    quad([0, 0, 0], [w, 0, 0], [w, w, 0], [0, w, 0], white)
    quad([0, 0, w], [0, w, w], [w, w, w], [w, 0, w], white)
    quad([0, w, 0], [w, w, 0], [w, w, w], [0, w, w], white)
    quad([0, 0, 0], [0, w, 0], [0, w, w], [0, 0, w], red)
    quad([w, 0, 0], [w, 0, w], [w, w, w], [w, w, 0], green)
    lm = quad([s - 65, s - 52, w - 1], [s + 65, s - 52, w - 1],
              [s + 65, s + 52, w - 1], [s - 65, s + 52, w - 1], white)
    b.add_area_light_mesh(lm, [15.0, 15.0, 15.0])
    if ceiling_light:
        lm2 = quad([100, 100, 500], [100, 300, 500], [250, 300, 480],
                   [250, 100, 480], white)
        b.add_area_light_mesh(lm2, [4.0, 3.0, 2.0])


def jax_mis_box():
    """The JAX package's mis_box, as tools/bench_all.py builds it."""
    from fountain_tpu.geometry.bvh import attach_bvh
    from fountain_tpu.scene.build import SceneBuilder
    b = SceneBuilder()
    _quads(b, False)
    return attach_bvh(b.build())


def _all_lights_scene():
    """The mis_box with a second mesh light facing down, a point light, a
    distant light and a uniform infinite light: every type but the
    sphere's (tests/test_torch_furnace.py holds that one)."""
    from fountain_tpu.geometry.bvh import attach_bvh
    from fountain_tpu.scene.build import SceneBuilder
    b = SceneBuilder()
    _quads(b, True)
    b.add_point_light([200.0, 250.0, 400.0], [2e4, 3e4, 1e4])
    b.add_distant_light([0.3, 0.2, -1.0], [0.5, 0.6, 0.7])
    b.add_infinite_light([0.2, 0.3, 0.4])
    js = attach_bvh(b.build())
    return js, scene_from_arrays(jax_arrays(js), device="cpu")


@pytest.fixture(scope="module")
def all_lights():
    return _all_lights_scene()


def _inputs(seed, n_lights):
    r = np.random.default_rng(seed)
    p = r.uniform(20.0, W - 20.0, (N, 3)).astype(np.float32)
    li = r.integers(0, n_lights, N).astype(np.int32)
    u = r.uniform(size=(2, N)).astype(np.float32)
    jv = JV3(*[jnp.asarray(p[:, k]) for k in range(3)])
    tv = V3(*[torch.as_tensor(p[:, k].copy()) for k in range(3)])
    return jv, tv, li, u


def _sample_both(all_lights, seed):
    from fountain_tpu.lights import lights as jl
    from fountain_tpu_torch.lights import lights as tl
    js, ts = all_lights
    jp, tp, li, u = _inputs(seed, ts.lights.count)
    jls = jl.sample_light(js, jnp.asarray(li), jp, jnp.asarray(u[0]),
                          jnp.asarray(u[1]))
    tls = tl.sample_light(ts, torch.as_tensor(li), tp,
                          torch.as_tensor(u[0]), torch.as_tensor(u[1]))
    return jls, tls, jp, tp, li


def test_sample_light_all_types(all_lights):
    jls, tls, _, _, li = _sample_both(all_lights, 1)
    types = _np(all_lights[1].lights.ltype)[li]
    for t in (LIGHT_POINT, LIGHT_DISTANT, LIGHT_INFINITE, LIGHT_AREA_TRI):
        assert (types == t).sum() > 200
    for f in ("radiance", "wi", "p_light_err", "n_light", "is_delta",
              "is_infinite"):
        _close(getattr(jls, f), getattr(tls, f))
    # endpoints lie up to 2 world radii (~960) away: atol 1e-3 is ~1e-6
    # of that, a few ulps of the direction's scaling
    _close(jls.p_light, tls.p_light, rtol=1e-5, atol=1e-3)
    _close_pdf(jls.pdf, tls.pdf)
    # mesh lights: the sampled point lies on one of the light's faces
    on_tri = types == LIGHT_AREA_TRI
    assert (_np(tls.pdf)[on_tri] > 0).mean() > 0.3


def test_light_pdf_and_emission_at_traced_hits(all_lights):
    """The BSDF-sampling branch's queries: trace the sampled direction in
    each package, then the mesh light's pdf from that hit and the
    emission there."""
    from fountain_tpu.geometry import intersect as ji
    from fountain_tpu.lights import lights as jl
    from fountain_tpu_torch.geometry import intersect as ti
    from fountain_tpu_torch.lights import lights as tl
    js, ts = all_lights
    jls, tls, jp, tp, li = _sample_both(all_lights, 2)
    inf = np.full(N, np.inf, np.float32)
    jh = ji.scene_intersect(js, jp, jls.wi, jnp.asarray(inf))
    th = ti.scene_intersect(ts, tp, tls.wi, torch.as_tensor(inf))
    ok = _np(jh.valid)
    np.testing.assert_array_equal(ok, _np(th.valid))
    _close(jh.light_id, th.light_id, ok)
    on_light = ok & (_np(jh.light_id) >= 0)
    assert on_light.sum() > 100
    _close_pdf(jl.light_pdf(js, jnp.asarray(li), jp, jls.wi, hit=jh),
               tl.light_pdf(ts, torch.as_tensor(li), tp, tls.wi, hit=th))
    # without the hit a mesh light's pdf is 0, as in the JAX package
    _close(jl.light_pdf(js, jnp.asarray(li), jp, jls.wi),
           tl.light_pdf(ts, torch.as_tensor(li), tp, tls.wi))
    _close(jl.emitted_radiance(js, jh), tl.emitted_radiance(ts, th))
    assert (_np(tl.emitted_radiance(ts, th).x) > 0).sum() > 50


def test_absent_light_types_change_nothing(all_lights):
    """Sampling and pdf queries build the branches of the scene's light
    types only (``Lights.present``); on lanes of those types the results
    are bitwise those of the full build."""
    from fountain_tpu_torch.geometry import intersect as ti
    from fountain_tpu_torch.lights import lights as tl
    _, ts = all_lights
    _, tp, li, u = _inputs(3, ts.lights.count)
    tli, u1, u2 = (torch.as_tensor(a) for a in (li, u[0], u[1]))
    full = tl.sample_light(ts, tli, tp, u1, u2)
    hit = ti.scene_intersect(ts, tp, full.wi,
                             torch.full((N,), float("inf")))
    full_pdf = tl.light_pdf(ts, tli, tp, full.wi, hit=hit)
    types = _np(ts.lights.ltype)[li]
    for t in sorted(ts.lights.present):
        lights = dataclasses.replace(ts.lights)
        lights.present = frozenset([t])
        sub = dataclasses.replace(ts, lights=lights)
        lanes = types == t
        s = tl.sample_light(sub, tli, tp, u1, u2)
        for f in ("radiance", "wi", "p_light", "p_light_err", "n_light"):
            for x, y in zip(getattr(s, f), getattr(full, f)):
                np.testing.assert_array_equal(_np(x)[lanes], _np(y)[lanes])
        for a, b in ((s.pdf, full.pdf),
                     (tl.light_pdf(sub, tli, tp, full.wi, hit=hit),
                      full_pdf)):
            np.testing.assert_array_equal(_np(a)[lanes], _np(b)[lanes])


_TABLES = ("lights.ltype", "lights.emit", "lights.pos", "lights.dir",
           "lights.shape_id", "lights.tri_start", "lights.tri_count",
           "lights.env_tex", "lights.area", "lights.env_slot", "light_tri",
           "triangles.positions", "triangles.indices", "triangles.normals",
           "triangles.has_normals", "triangles.mat_id",
           "triangles.light_id", "triangles.flip_normal",
           "triangles.mesh_id", "tri_attr", "materials.mtype",
           "textures.value", "world_center", "world_radius")


def _assert_same_tables(jscene, tscene, keys=_TABLES):
    arrays = jax_arrays(jscene)
    for key in keys:
        t = tscene
        for part in key.split("."):
            t = getattr(t, part)
        a, b = arrays[key], _np(t)
        assert a.shape == b.shape, key
        if key == "tri_attr" or a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=key)
        else:
            np.testing.assert_array_equal(b, a, err_msg=key)


def test_mis_box_tables_equal_jax():
    from fountain_tpu_torch import bench
    scene, _ = bench.build_mis_box("cpu", 16)
    _assert_same_tables(jax_mis_box(), scene)
    assert scene.lights.present == {LIGHT_AREA_TRI}
    np.testing.assert_array_equal(_np(scene.tri_sweep.feat.packed),
                                  np.asarray(jax_mis_box().tri_features[0]))


_PBRT = """
LookAt 0 -10 2  0 0 0  0 0 1
Camera "perspective" "float fov" [50]
Film "image" "integer xresolution" [8] "integer yresolution" [8]
WorldBegin
AttributeBegin
  Translate 1 2 3
  LightSource "point" "rgb I" [5 6 7] "point from" [0.5 0 1]
    "rgb scale" [2 2 2]
AttributeEnd
AttributeBegin
  Rotate 30 0 0 1
  LightSource "distant" "point from" [0 0 5] "point to" [1 0 0]
    "rgb L" [0.5 0.5 0.4]
AttributeEnd
LightSource "infinite" "rgb L" [0.1 0.1 0.1]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [4 4 4]
  Translate 0 0 6
  Shape "trianglemesh" "integer indices" [0 2 1 0 3 2]
    "point P" [-1 -1 0  1 -1 0  1 1 0  -1 1 0]
AttributeEnd
AttributeBegin
  Material "plastic" "rgb Kd" [0.3 0.4 0.5]
  AreaLightSource "diffuse" "rgb L" [1 2 3]
  Translate 3 0 0
  Shape "loopsubdiv" "integer levels" [2]
    "integer indices" [0 1 2  0 2 3  0 3 1  1 3 2]
    "point P" [0 0 0  1 0 0  0 1 0  0 0 1]
AttributeEnd
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [0.2 0.2 0.2]
  Translate -3 0 0
  Scale 0.1 0.1 0.1
  Shape "plymesh" "string filename" "{ply}"
AttributeEnd
Material "matte" "rgb Kd" [0.5 0.5 0.5]
Shape "loopsubdiv" "integer nlevels" [1]
  "integer indices" [0 1 2  0 2 3  0 3 1  1 3 2]
  "point P" [0 0 -3  2 0 -3  0 2 -3  0 0 -1]
WorldEnd
"""


def test_pbrt_lights_and_loopsubdiv_equal_jax(tmp_path):
    """Point (the CTM moves it) and distant lights, area lights on a
    trianglemesh, a loopsubdiv and a plymesh, and a plain loopsubdiv:
    both parsers build equal tables (the faces in leaf order, the lights'
    face table in the original order)."""
    import pathlib
    from fountain_tpu.io.pbrt import load_pbrt as jload
    from fountain_tpu_torch.io.pbrt import load_pbrt as tload
    ply = pathlib.Path("data/rounded_cube.ply").resolve()
    path = tmp_path / "lights.pbrt"
    path.write_text(_PBRT.replace("{ply}", str(ply)))
    js, _, _ = jload(str(path))
    ts, cam, st = tload(str(path), device="cpu")
    _assert_same_tables(js, ts)
    assert ts.lights.types == (LIGHT_POINT, LIGHT_DISTANT, LIGHT_INFINITE,
                               LIGHT_AREA_TRI, LIGHT_AREA_TRI,
                               LIGHT_AREA_TRI)
    # 2 + 4 * 16 + 4,332 emitting faces, 4 * 4 plain ones
    assert int((ts.triangles.light_id >= 0).sum()) == 2 + 64 + 4332
    assert ts.triangles.count == 2 + 64 + 4332 + 16


def _jax_render(jscene, jcam, res, spp, jcfg, **kw):
    from fountain_tpu.integrator.render import render as jrender
    return np.asarray(jrender(jscene, jcam, res, res, spp, jcfg, **kw))


def _cams(res, eye, target, fov):
    from fountain_tpu.core import transform as jtf
    from fountain_tpu.scene.camera import make_perspective_camera as jmk
    from fountain_tpu_torch.core import transform as ttf
    from fountain_tpu_torch.scene.camera import make_perspective_camera
    up = [0.0, 0.0, 1.0]
    return (jmk(jtf.look_at(eye, target, up), (res, res), fov_deg=fov),
            make_perspective_camera(ttf.look_at(eye, target, up),
                                    (res, res), fov_deg=fov))


def test_mis_box_render_matches_jax():
    """16x16, 4 spp, depth 5, NEE with MIS, RR: the port's own build of
    the mis_box against the JAX package's render. Gates: every pixel
    within rtol 1e-3 (atol 1e-8), the mean within rel 1e-4. (Observed:
    3 of 256 pixels past 1e-4, the worst 2.5e-4, mean rel 2.6e-5: a mesh
    light's pdf d^2 / (|cos| area) amplifies the ulps of grazing
    samples.)"""
    from fountain_tpu.integrator.path import PathConfig as JConfig
    from fountain_tpu_torch import bench
    from fountain_tpu_torch.integrator.path import PathConfig
    from fountain_tpu_torch.integrator.render import render
    res, spp = 16, 4
    jcam, _ = _cams(res, [278.0, -800.0, 278.0], [278.0, 0.0, 278.0], 40.0)
    j = _jax_render(jax_mis_box(), jcam, res, spp,
                    JConfig(max_depth=5, rr_threshold=1.0, nee=True))
    scene, cam = bench.build_mis_box("cpu", res)
    t = render(scene, cam, res, res, spp,
               PathConfig(max_depth=5, rr_threshold=1.0, nee=True)).numpy()
    assert np.isfinite(t).all() and t.max() > 0.0
    np.testing.assert_allclose(t, j, rtol=1e-3, atol=1e-8)
    assert abs(t.mean() - j.mean()) <= 1e-4 * abs(j.mean())


def _icosphere(n_sub=2, radius=1.0):
    from tests.test_lights import _icosphere as ico
    return ico(n_sub, radius)


def test_mesh_area_light_furnace():
    """tests/test_lights.py's furnace of a mesh enclosure (an inward-wound
    icosphere of 1,280 faces, albedo 0.5, L = 1) at its 16x16, 64 spp,
    depth 10, no RR: the mean must be 2 within 0.05, every pixel within
    0.35."""
    from fountain_tpu_torch.core import transform as tf
    from fountain_tpu_torch.geometry.bvh import attach_bvh
    from fountain_tpu_torch.integrator.path import PathConfig
    from fountain_tpu_torch.integrator.render import render
    from fountain_tpu_torch.scene.build import SceneBuilder
    from fountain_tpu_torch.scene.camera import make_perspective_camera
    verts, faces = _icosphere(3, radius=50.0)
    b = SceneBuilder()
    mat = b.add_matte(kd=[0.5] * 3)
    mid = b.add_triangle_mesh(verts, faces[:, ::-1], mat_id=mat)
    b.add_area_light_mesh(mid, [1.0] * 3)
    scene = attach_bvh(b.build(device="cpu"))
    cam = make_perspective_camera(
        tf.look_at([0.0, -2.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 1.0]),
        (16, 16), fov_deg=60.0)
    img = render(scene, cam, 16, 16, 64,
                 PathConfig(max_depth=10, rr_threshold=0.0, nee=True))
    img = img.numpy()
    assert np.isfinite(img).all()
    np.testing.assert_allclose(img.mean(), 2.0, atol=0.05)
    assert np.abs(img - 2.0).max() < 0.35

"""Port parity on BASELINE config 3: scene tables and per-module outputs.

Config 3 is rounded_cube.ply (leaf order) with a matte material under the
sky.exr env light, as bench.py builds it. The JAX scene's leaves reach the
port through ``scene_from_arrays``; the port's own SceneBuilder +
attach_bvh must produce the same tables. Per-module outputs on a 32x32
camera wave are compared field by field (allclose 1e-5: f32 elementwise
math, with transcendentals that differ by an ulp between backends).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fountain_tpu.core import rng as jrng
from fountain_tpu.core.vecmath import V3 as JV3
from fountain_tpu_torch.core import rng as trng
from fountain_tpu_torch.core.vecmath import V3

RES = 32
TOL = dict(rtol=1e-5, atol=1e-5)


@functools.lru_cache(maxsize=None)
def jax_config3(res=RES):
    from bench import build_scene
    return build_scene(res)


def jax_arrays(scene) -> dict:
    """The JAX scene's leaves as numpy arrays under dotted field paths."""
    leaves = jax.tree_util.tree_flatten_with_path(scene)[0]
    return {".".join(str(getattr(k, "name", getattr(k, "idx", k)))
                     for k in path): np.asarray(v) for path, v in leaves}


@functools.lru_cache(maxsize=None)
def port_config3(res=RES, device="cpu"):
    """The port's own build of config 3 (and the bench.py camera)."""
    from fountain_tpu_torch.core import transform as tf
    from fountain_tpu_torch.geometry.bvh import attach_bvh
    from fountain_tpu_torch.io.exr import read_exr
    from fountain_tpu_torch.io.ply import load_ply
    from fountain_tpu_torch.scene.build import SceneBuilder
    from fountain_tpu_torch.scene.camera import make_perspective_camera
    mesh = load_ply("data/rounded_cube.ply")
    b = SceneBuilder()
    env_tex = b.add_image_texture(b.add_image(read_exr("data/sky.exr")))
    mat = b.add_matte(kd=[0.6, 0.5, 0.4])
    b.add_triangle_mesh(mesh.positions, mesh.indices, normals=mesh.normals,
                        mat_id=mat)
    b.add_infinite_light([1.0, 1.0, 1.0], env_tex=env_tex)
    scene = attach_bvh(b.build(device=device))
    cam = make_perspective_camera(
        tf.look_at([25.0, -30.0, 18.0], [0.0, 0.0, 0.0], [0.0, 0.0, 1.0]),
        (res, res), fov_deg=45.0)
    return scene, cam


@functools.lru_cache(maxsize=None)
def bridged_config3(res=RES):
    from fountain_tpu_torch.scene.build import scene_from_arrays
    return scene_from_arrays(jax_arrays(jax_config3(res)[0]), device="cpu")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(j, t, **tol):
    tol = tol or TOL
    if isinstance(j, JV3):
        for a, b in zip(j, t):
            np.testing.assert_allclose(_np(a), _np(b), **tol)
    else:
        np.testing.assert_allclose(_np(j), _np(t), **tol)


def test_scene_from_arrays_equals_port_build():
    """Leaf order equal; float tables allclose 1e-6; int tables equal."""
    built, _ = port_config3()
    bridged = bridged_config3()
    eq = np.testing.assert_array_equal
    close = functools.partial(np.testing.assert_allclose, rtol=1e-6,
                              atol=1e-6)
    for grp in ("triangles", "materials", "textures", "lights"):
        a, b = getattr(built, grp), getattr(bridged, grp)
        for name in a.__dataclass_fields__:
            x, y = getattr(a, name), getattr(b, name)
            if not isinstance(x, torch.Tensor):
                assert x == y, (grp, name)
            elif x.dtype.is_floating_point:
                close(_np(x), _np(y), err_msg=f"{grp}.{name}")
            else:
                eq(_np(x), _np(y), err_msg=f"{grp}.{name}")
    assert built.spheres.count == bridged.spheres.count == 0
    close(_np(built.tri_attr), _np(bridged.tri_attr))
    close(_np(built.tri_sweep.feat.packed), _np(bridged.tri_sweep.feat.packed))
    close(_np(built.tri_sweep.coef), _np(bridged.tri_sweep.coef))
    close(_np(built.tri_sweep.bounds), _np(bridged.tri_sweep.bounds))
    for name in built.env_images.__dataclass_fields__:
        close(_np(getattr(built.env_images, name)),
              _np(getattr(bridged.env_images, name)))
    for name in built.env_dist.__dataclass_fields__:
        close(_np(getattr(built.env_dist, name)),
              _np(getattr(bridged.env_dist, name)))
    close(_np(built.world_center), _np(bridged.world_center))
    close(_np(built.world_radius), _np(bridged.world_radius))


def _camera_wave(seed=0):
    """Jittered camera rays of the 32x32 wave in both packages."""
    from fountain_tpu.scene.camera import generate_rays as jgen
    from fountain_tpu_torch.scene.camera import generate_rays as tgen
    _, jcam = jax_config3()
    _, tcam = port_config3()
    lane = np.arange(RES * RES, dtype=np.int32)
    px, py = (lane % RES).astype(np.float32), (lane // RES).astype(
        np.float32)
    ju = jrng.uniform4(jnp.asarray(lane), 0, 1 << 20, seed)
    tu = trng.uniform4(torch.as_tensor(lane), 0, 1 << 20, seed)
    jr = jgen(jcam, jnp.asarray(px) + ju[0], jnp.asarray(py) + ju[1],
              ju[2], ju[3])
    tr = tgen(tcam, torch.as_tensor(px) + tu[0], torch.as_tensor(py) + tu[1],
              tu[2], tu[3])
    return jr, tr


def test_generate_rays():
    jr, tr = _camera_wave()
    for f in ("o", "d", "rx_d", "ry_d"):
        _close(getattr(jr, f), getattr(tr, f))


@functools.lru_cache(maxsize=None)
def _hits():
    from fountain_tpu.geometry.intersect import scene_intersect as jsi
    from fountain_tpu_torch.geometry.intersect import scene_intersect as tsi
    jr, tr = _camera_wave()
    n = RES * RES
    jh = jsi(jax_config3()[0], jr.o, jr.d, jnp.full((n,), jnp.inf))
    th = tsi(bridged_config3(), tr.o, tr.d, torch.full((n,), float("inf")))
    return jh, th


def test_scene_intersect():
    jh, th = _hits()
    assert np.asarray(jh.valid).sum() > 100
    for f in ("valid", "prim_kind", "prim_id", "mat_id", "light_id"):
        np.testing.assert_array_equal(_np(getattr(jh, f)),
                                      _np(getattr(th, f)), err_msg=f)
    m = np.asarray(jh.valid)
    for f in ("t", "p", "n", "ns", "ss", "ts", "u", "v", "wo",
              "inv_uv_scale", "p_err"):
        a, b = getattr(jh, f), getattr(th, f)
        if isinstance(a, JV3):
            for x, y in zip(a, b):
                np.testing.assert_allclose(_np(x)[m], _np(y)[m], **TOL,
                                           err_msg=f)
        else:
            np.testing.assert_allclose(_np(a)[m], _np(b)[m], **TOL,
                                       err_msg=f)


def test_gather_shading_with_mip_footprints():
    from fountain_tpu.shading.bsdf import gather_shading as jgs
    from fountain_tpu_torch.shading.bsdf import gather_shading as tgs
    jh, th = _hits()
    w = np.random.default_rng(4).uniform(0.0, 0.05, RES * RES).astype(
        np.float32)
    js = jgs(jax_config3()[0], jh, tex_width=jnp.asarray(w))
    tsp = tgs(bridged_config3(), th, tex_width=torch.as_tensor(w))
    np.testing.assert_array_equal(_np(js.mtype), _np(tsp.mtype))
    _close(js.kd, tsp.kd)
    _close(js.sigma, tsp.sigma)


def test_sample_light_light_pdf_and_env_radiance():
    from fountain_tpu.lights import lights as jl
    from fountain_tpu_torch.lights import lights as tl
    jh, th = _hits()
    n = RES * RES
    r = np.random.default_rng(5)
    u1, u2 = r.random(n).astype(np.float32), r.random(n).astype(np.float32)
    li = np.zeros(n, np.int32)
    jscene, tscene = jax_config3()[0], bridged_config3()
    js = jl.sample_light(jscene, jnp.asarray(li), jh.p, jnp.asarray(u1),
                         jnp.asarray(u2))
    tsm = tl.sample_light(tscene, torch.as_tensor(li), th.p,
                          torch.as_tensor(u1), torch.as_tensor(u2))
    for f in ("radiance", "wi", "pdf", "p_light", "is_delta",
              "is_infinite"):
        _close(getattr(js, f), getattr(tsm, f))
    _close(jl.light_pdf(jscene, jnp.asarray(li), jh.p, js.wi),
           tl.light_pdf(tscene, torch.as_tensor(li), th.p, tsm.wi))
    d = r.normal(size=(n, 3)).astype(np.float32)
    jd = JV3(*[jnp.asarray(d[:, k]) for k in range(3)])
    td = V3(*[torch.as_tensor(d[:, k].copy()) for k in range(3)])
    _close(jl.light_pdf(jscene, jnp.asarray(li), jh.p, jd),
           tl.light_pdf(tscene, torch.as_tensor(li), th.p, td))
    _close(jl.environment_radiance(jscene, jd),
           tl.environment_radiance(tscene, td))
    _close(jl.emitted_radiance(jscene, jh), tl.emitted_radiance(tscene, th))


def test_unsupported_content_raises(tmp_path):
    """The port refuses what the JAX package refuses (object instancing),
    instead of computing something else; a point light, refused before
    its port, now bridges with its light row."""
    from fountain_tpu.scene.build import SceneBuilder as JB
    from fountain_tpu.geometry.bvh import attach_bvh as jattach
    from fountain_tpu_torch.io.pbrt import load_pbrt
    from fountain_tpu_torch.scene.build import scene_from_arrays
    b = JB()
    m = b.add_mirror()
    b.add_triangle_mesh(np.eye(3, dtype=np.float32),
                        np.array([[0, 1, 2]]), mat_id=m)
    b.add_point_light([0.0, 0.0, 5.0], [1.0, 1.0, 1.0])
    scene = scene_from_arrays(jax_arrays(jattach(b.build())), device="cpu")
    assert scene.lights.types == (0,)
    np.testing.assert_array_equal(scene.lights.pos.numpy(), [[0, 0, 5]])
    path = tmp_path / "instance.pbrt"
    path.write_text('WorldBegin\nObjectBegin "a"\nWorldEnd\n')
    with pytest.raises(NotImplementedError):
        load_pbrt(str(path), device="cpu")

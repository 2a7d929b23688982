"""The slice as a whole: config 3 rendered through the BVH walk.

Off the TPU the JAX package intersects a mesh above
``tensor_tri.MAX_DENSE_FACES`` faces with its BVH walk, and the port does
the same (``intersect.intersect_faces``). With the threshold set to 0 in
both packages (``monkeypatch``, which edits no file), config 3's rounded
cube (4,332 faces) takes the walk in both. The scene is config 3 under
the uniform infinite light of the 277,248-face gate
(``bench.build_large_scene``) instead of sky.exr: JAX compiles that
render in ~15 s on the CPU, the sky's in ~45. Here: the port's forward
render against the JAX package's, the port's render of the JAX scene carried
across by ``scene_from_arrays`` (which then has no dense table) against
its own build's, the dispatch on both sides of the threshold, and a
differentiable step through the walk.

Observed on the CPU when this file was written: the port's image within
rtol 3.4e-7 of JAX's (max abs 1.2e-7; the walk's t differs from JAX's
compiled walk by up to 3 ulp, see tests/test_torch_bvh.py); the bridged
scene's image equal to the port build's bit for bit.
"""
import functools

import numpy as np
import pytest
import torch

import fountain_tpu.geometry.tensor_tri as jtt
import fountain_tpu_torch.geometry.tensor_tri as ttt
from fountain_tpu.integrator.path import PathConfig as JConfig
from fountain_tpu_torch.geometry import bvh_walk, tri_sweep
from fountain_tpu_torch.integrator.path import PathConfig
from tests.test_torch_scene import jax_arrays

RES = 16
SPP = 2
SEED = 3
# rtol of the images, as tests/test_torch_render.py: the walk's t differs
# from JAX's compiled walk by up to 3 ulp, and the hit points carry that
IMG_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def walk_everywhere():
    """MAX_DENSE_FACES = 0 in both packages for this module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtt, "MAX_DENSE_FACES", 0)
        mp.setattr(ttt, "MAX_DENSE_FACES", 0)
        yield


@pytest.fixture(scope="module")
def jax_scene(walk_everywhere):
    """The JAX package's config 3 under a uniform light, built while the
    threshold is 0: no dense table, so its scene_intersect takes the walk
    on the CPU."""
    from bench import build_scene
    scene, cam = build_scene(RES, env_image=False)
    assert scene.tri_features is None and scene.bvh_nodes8 is not None
    return scene, cam


@functools.lru_cache(maxsize=None)
def port_scene(res=RES):
    """The port's own build of the same scene and camera."""
    from fountain_tpu_torch.core import transform as tf
    from fountain_tpu_torch.geometry.bvh import attach_bvh
    from fountain_tpu_torch.io.ply import load_ply
    from fountain_tpu_torch.scene.build import SceneBuilder
    from fountain_tpu_torch.scene.camera import make_perspective_camera
    mesh = load_ply("data/rounded_cube.ply")
    b = SceneBuilder()
    mat = b.add_matte(kd=[0.6, 0.5, 0.4])
    b.add_triangle_mesh(mesh.positions, mesh.indices, normals=mesh.normals,
                        mat_id=mat)
    b.add_infinite_light([1.0, 1.0, 1.0])
    cam = make_perspective_camera(
        tf.look_at([25.0, -30.0, 18.0], [0.0, 0.0, 0.0], [0.0, 0.0, 1.0]),
        (res, res), fov_deg=45.0)
    return attach_bvh(b.build(device="cpu")), cam


@pytest.fixture(scope="module")
def jax_image(jax_scene):
    from fountain_tpu.integrator.render import render as jrender
    scene, cam = jax_scene
    cfg = JConfig(max_depth=3, rr_threshold=1.0, nee=True)
    return np.asarray(jrender(scene, cam, RES, RES, SPP, cfg, seed=SEED))


CFG = PathConfig(max_depth=3, rr_threshold=1.0, nee=True)


def _render(scene, cam):
    from fountain_tpu_torch.integrator.render import render
    return render(scene, cam, RES, RES, SPP, CFG, seed=SEED).numpy()


class _Calls:
    """Counts the calls of the walk and of the sweeps under a patch."""

    def __init__(self, mp):
        self.walk = self.sweep = 0
        walk, sweep = bvh_walk.walk_intersect, tri_sweep.mt_intersect_kernel

        def counted_walk(*a, **k):
            self.walk += 1
            return walk(*a, **k)

        def counted_sweep(*a, **k):
            self.sweep += 1
            return sweep(*a, **k)
        mp.setattr(bvh_walk, "walk_intersect", counted_walk)
        mp.setattr(tri_sweep, "mt_intersect_kernel", counted_sweep)


def test_render_through_the_walk_matches_jax(walk_everywhere, jax_image):
    """16x16, 2 spp, depth 3, NEE: every pixel within rtol IMG_RTOL of the
    JAX package's image, and only the walk ran."""
    scene, cam = port_scene(RES)
    with pytest.MonkeyPatch.context() as mp:
        calls = _Calls(mp)
        img = _render(scene, cam)
    assert calls.walk > 0 and calls.sweep == 0
    assert np.isfinite(img).all() and img.mean() > 0.0
    np.testing.assert_allclose(img, jax_image, rtol=IMG_RTOL, atol=0)


def test_bridged_scene_renders_like_the_port_build(walk_everywhere,
                                                   jax_scene):
    """scene_from_arrays of the JAX scene without a dense table brings its
    BVH across: the same node rows and vertices as the port's build, and
    the same image (rtol 1e-6, as tests/test_torch_render.py)."""
    from fountain_tpu_torch.scene.build import scene_from_arrays
    arrays = jax_arrays(jax_scene[0])
    assert "tri_features.packed" not in arrays
    bridged = scene_from_arrays(arrays, device="cpu")
    scene, cam = port_scene(RES)
    assert torch.equal(bridged.bvh_nodes8, scene.bvh_nodes8)
    assert torch.equal(bridged.bvh_tri_verts, scene.bvh_tri_verts)
    np.testing.assert_allclose(_render(bridged, cam), _render(scene, cam),
                               rtol=1e-6, atol=1e-6)


def test_bridge_refuses_a_node_table_that_disagrees_with_meta(jax_scene):
    from fountain_tpu_torch.scene.build import scene_from_arrays
    arrays = jax_arrays(jax_scene[0])
    arrays["bvh_meta"] = np.asarray(arrays["bvh_meta"]).copy()
    arrays["bvh_meta"][0, 0] += 1
    with pytest.raises(ValueError):
        scene_from_arrays(arrays, device="cpu")


@pytest.mark.parametrize("above", [True, False], ids=["above", "at"])
def test_dispatch_follows_the_threshold(above):
    """A scene above MAX_DENSE_FACES faces goes through the walk only, a
    scene at it through the sweeps only (closest and any hit: a camera
    wave at depth 1 with NEE)."""
    from fountain_tpu_torch.geometry.intersect import (scene_intersect,
                                                       scene_intersect_any)
    from fountain_tpu_torch.scene.camera import generate_rays
    scene, cam = port_scene(RES)
    n = 64
    px = torch.arange(n, dtype=torch.float32) % 8 * 2.0
    rays = generate_rays(cam, px, px, torch.zeros(n), torch.zeros(n))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttt, "MAX_DENSE_FACES",
                   scene.triangles.count - (1 if above else 0))
        calls = _Calls(mp)
        hit = scene_intersect(scene, rays.o, rays.d,
                              torch.full((n,), float("inf")))
        scene_intersect_any(scene, rays.o, rays.d, torch.full((n,), 1e3))
    assert (calls.walk, calls.sweep) == ((2, 0) if above else (0, 2))
    assert bool(hit.valid.any())


def test_step_through_the_walk_has_a_finite_gradient(walk_everywhere):
    """bench.step (the wave, then autograd of the mean radiance with
    respect to the texture values) through the walk: a finite, non-zero
    gradient; the walk's outputs carry no autograd graph."""
    from fountain_tpu_torch import bench
    from fountain_tpu_torch.core.vecmath import V3
    scene, cam = port_scene(8)
    with pytest.MonkeyPatch.context() as mp:
        calls = _Calls(mp)
        loss, grad = bench.step(scene, cam, 8, scene.textures.value, 1,
                                regen=False)
    assert calls.walk > 0 and calls.sweep == 0
    assert bool(torch.isfinite(loss)) and bool(torch.isfinite(grad).all())
    assert float(grad.abs().sum()) > 0.0
    g = lambda *v: torch.tensor(v, requires_grad=True)      # noqa: E731
    o = V3(g(30.0, 0.5), g(0.2, 0.0), g(0.1, 40.0))
    d = V3(g(-1.0, 0.0), g(0.0, 0.1), g(0.0, -1.0))
    for out in bvh_walk.walk_intersect(scene.bvh_nodes8, scene.bvh_tri_verts,
                                       o, d, g(1e9, 1e9) * 1.0):
        assert out.grad_fn is None and not out.requires_grad

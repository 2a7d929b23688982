"""Port parity: the differentiable step of BASELINE config 3.

``fountain_tpu_torch.bench.step`` (the bench loss, the mean completed
radiance of a regeneration wave, and its gradient with respect to the
texture value table, by autograd) against the JAX package's
``jax.value_and_grad`` of the same loss (``bench.py:207-218``) on the same
tables (bridged through ``scene_from_arrays``), and against its own central
differences. Also: the geometric carry and the sweeps' rays are detached,
``python -m fountain_tpu_torch.bench`` prints bench.py's JSON line, and
what is not ported raises.

Observed on the CPU when this file was written: loss 0.6029406 in both
packages (equal to the last digit); kd row gradient (0.0221467, 0.0207112,
0.0218417) in both, the largest relative difference 1e-7; the other rows
exactly 0 in both. Central differences at 16x16 within 1.9e-3 relative per
channel, 8.4e-5 summed. The file takes about 5 minutes on the CPU, 4.7 of
them the one compile of JAX's gradient (the fixture's setup).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fountain_tpu.core import rng as jrng
from fountain_tpu.integrator.path import DIM_CAMERA
from fountain_tpu.integrator.path import PathConfig as JConfig
from fountain_tpu.integrator.path import trace_paths as jtrace
from fountain_tpu.scene.camera import generate_rays as jgen
from fountain_tpu_torch import bench
from fountain_tpu_torch.core.vecmath import V3
from fountain_tpu_torch.integrator import path
from tests.test_torch_scene import bridged_config3, jax_config3, port_config3

RES = 8
ITERS = 12
SEED = 3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny tensors: one intra-op thread beats eight that contend with
    the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_value_and_grad():
    """bench.py's step in the JAX package at 8x8, depth 5, 12 iterations:
    compiled once (minutes on the CPU) and run once."""
    scene, cam = jax_config3(RES)
    cfg = JConfig(max_depth=5, rr_threshold=1.0, nee=True)
    n = RES * RES

    def ray_fn(lane_ids, sample_ids):
        px = (lane_ids % RES).astype(jnp.float32)
        py = (lane_ids // RES).astype(jnp.float32)
        u = jrng.uniform4(lane_ids, sample_ids, DIM_CAMERA, SEED)
        r = jgen(cam, px + u[0], py + u[1], u[2], u[3])
        return r.o, r.d, jnp.zeros_like(px)

    @jax.jit
    def step(tex_value):
        def loss_fn(tv):
            s = scene._replace(textures=scene.textures._replace(value=tv))
            lane = jnp.arange(n, dtype=jnp.int32)
            sample = jnp.zeros((n,), jnp.int32)
            o, d, _ = ray_fn(lane, sample)
            out = jtrace(s, o, d, lane, sample, cfg, seed=SEED,
                         regen_fn=ray_fn, n_iters=ITERS)
            n_done = jnp.maximum(out.n_done.sum(), 1)
            return jnp.sum(out.accum.sum()) / (3.0 * n_done.astype(
                jnp.float32))
        return jax.value_and_grad(loss_fn)(tex_value)

    loss, grad = step(scene.textures.value)
    return float(loss), np.asarray(grad)


def test_step_matches_jax_value_and_grad(jax_value_and_grad):
    """Gates: loss rtol 1e-5; gradient rtol 1e-4, atol 1e-7; the rows that
    are zero in JAX are exactly zero in the port."""
    j_loss, j_grad = jax_value_and_grad
    scene = bridged_config3(RES)
    _, cam = port_config3(RES)
    loss, grad = bench.step(scene, cam, RES, scene.textures.value, SEED,
                            n_iters=ITERS)
    grad = grad.numpy()
    np.testing.assert_allclose(float(loss), j_loss, rtol=1e-5)
    assert (j_grad != 0).any()
    np.testing.assert_allclose(grad, j_grad, rtol=1e-4, atol=1e-7)
    assert (grad[j_grad == 0] == 0).all()


def test_step_grad_matches_central_differences():
    """The kd row's gradient, each channel and summed, against central
    differences of the same fixed-random-stream loss (h = 1e-3; rtol 5e-3,
    atol 1e-4, as tests/test_grad.py:61) at 16x16, 12 iterations."""
    res = 16
    scene, cam = bench.build_scene(res, "cpu")
    tv = scene.textures.value
    _, grad = bench.step(scene, cam, res, tv, SEED, n_iters=ITERS)
    kd_row = int(scene.materials.kd_tex[0])

    def loss(t):
        s = dataclasses.replace(scene, textures=dataclasses.replace(
            scene.textures, value=t))
        with torch.no_grad():
            return float(bench.loss_of(bench.wave(s, cam, res, SEED,
                                                  ITERS)))
    h = 1e-3
    for chans in ([0], [1], [2], [0, 1, 2]):
        bump = torch.zeros_like(tv)
        bump[kd_row, chans] = h
        fd = (loss(tv + bump) - loss(tv - bump)) / (2 * h)
        np.testing.assert_allclose(float(grad[kd_row, chans].sum()), fd,
                                   rtol=5e-3, atol=1e-4)


def _camera_wave(cam, res):
    lane = torch.arange(res * res, dtype=torch.int32)
    sample = torch.zeros(res * res, dtype=torch.int32)
    ray_fn = bench.make_ray_fn(cam, res, SEED)
    o, d, _ = ray_fn(lane, sample)
    o = V3(*(c.clone().requires_grad_(True) for c in o))
    d = V3(*(c.clone().requires_grad_(True) for c in d))
    return lane, sample, ray_fn, o, d


def test_no_gradient_reaches_the_camera_rays():
    """The carry is detached on entry to every iteration, so the loss has
    no gradient with respect to the camera rays' origins and directions,
    while it keeps the texture table's. Without the detach the graph does
    reach them (through the shading normal and the spawned origins)."""
    scene = bridged_config3(RES)
    _, cam = port_config3(RES)
    tv = scene.textures.value.clone().requires_grad_(True)
    s = dataclasses.replace(scene, textures=dataclasses.replace(
        scene.textures, value=tv))
    lane, sample, ray_fn, o, d = _camera_wave(cam, RES)
    out = path.trace_paths(s, o, d, lane, sample, bench.CFG, seed=SEED,
                           regen_fn=ray_fn, n_iters=ITERS)
    grads = torch.autograd.grad(bench.loss_of(out), [tv, *o, *d],
                                allow_unused=True)
    assert bool((grads[0] != 0).any())
    assert all(g is None for g in grads[1:])


def test_without_the_detach_the_graph_reaches_the_rays(monkeypatch):
    """The counterfactual of the test above: with the carry's detach
    removed, the camera rays are in the loss's graph."""
    monkeypatch.setattr(path, "_detach_geometry", lambda st: None)
    scene = bridged_config3(RES)
    _, cam = port_config3(RES)
    lane, sample, ray_fn, o, d = _camera_wave(cam, RES)
    out = path.trace_paths(scene, o, d, lane, sample, bench.CFG, seed=SEED,
                           regen_fn=ray_fn, n_iters=ITERS)
    assert bench.loss_of(out).grad_fn is not None


@pytest.mark.parametrize("any_hit", [False, True])
def test_sweep_detaches_its_rays(any_hit):
    """The sweep wrapper detaches its inputs on the CPU branch too, so no
    graph is built through the plain version."""
    from fountain_tpu_torch.geometry.tri_sweep import mt_intersect_kernel
    scene = bridged_config3(RES)
    r = np.random.default_rng(0)
    o = V3(*(torch.full((64,), v, requires_grad=True)
             for v in (25.0, -30.0, 18.0)))
    d = V3(*(torch.as_tensor(r.normal(size=64).astype(np.float32) - c)
             .requires_grad_(True) for c in (25.0, -30.0, 18.0)))
    t_max = torch.full((64,), float("inf"), requires_grad=True)
    outs = mt_intersect_kernel(scene.tri_sweep, o, d, t_max,
                               any_hit=any_hit)
    assert not any(x.requires_grad for x in outs)
    assert bool(outs[2].any())


@pytest.mark.parametrize("wave", [[], ["--no-regen"]],
                         ids=["regen", "fixed_wave"])
def test_bench_main_prints_bench_json_line(capsys, monkeypatch, wave):
    """``python -m fountain_tpu_torch.bench --cpu`` prints one JSON line
    with bench.py's keys and a '#' line on stderr, for the regeneration
    wave and the fixed wave; without ``--cpu`` and with no card it
    raises."""
    assert bench.main(["--res", "8", "--steps", "1", "--cpu", *wave]) == 0
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline"}
    assert rec["metric"] == "rays_per_s_fwd_bwd" and rec["value"] > 0
    assert err.startswith("# device=cpu res=8 depth=5 rays/wave=")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--res", "8", "--steps", "1"])


def _furnace():
    from fountain_tpu_torch.scene.build import SceneBuilder
    b = SceneBuilder()
    sph = b.add_sphere(radius=10.0, mat_id=b.add_matte(kd=[0.5] * 3),
                       reverse_orientation=True)
    b.add_area_light_sphere(sph, [1.0] * 3)
    return b.build(device="cpu")


@pytest.mark.parametrize("case", [
    "direct_mode", "whitted_mode", "nee_off",
    "triangle_filter", "point_light", "mesh_area_light"])
def test_unported_options_raise(case):
    """Options that raised before their port now render: each gives a
    finite image (the test keeps the name it had when they raised; their
    parity with the JAX package is held in
    tests/test_torch_modes.py, test_torch_film.py and
    test_torch_lights.py)."""
    from fountain_tpu_torch.core import transform as tf
    from fountain_tpu_torch.integrator.path import PathConfig
    from fountain_tpu_torch.integrator.render import render
    from fountain_tpu_torch.scene.camera import make_perspective_camera
    from fountain_tpu_torch.scene.film import FILTER_TRIANGLE
    cam = make_perspective_camera(
        tf.look_at([0.0, -2.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 1.0]),
        (4, 4), fov_deg=60.0)
    kw, cfg, scene = {}, PathConfig(max_depth=2), _furnace()
    if case in ("point_light", "mesh_area_light"):
        from fountain_tpu.geometry.bvh import attach_bvh
        from fountain_tpu.scene.build import SceneBuilder as JB
        from fountain_tpu_torch.scene.build import scene_from_arrays
        from tests.test_torch_scene import jax_arrays
        b = JB()
        m = b.add_matte()
        mesh = b.add_triangle_mesh(np.eye(3, dtype=np.float32),
                                   np.array([[0, 1, 2]]), mat_id=m)
        if case == "point_light":
            b.add_point_light([0.0, 0.0, 5.0], [1.0, 1.0, 1.0])
        else:
            b.add_area_light_mesh(mesh, [1.0, 1.0, 1.0])
        scene = scene_from_arrays(jax_arrays(attach_bvh(b.build())), "cpu")
    elif case == "triangle_filter":
        kw.update(ftype=FILTER_TRIANGLE, fradius=1.0)
    else:
        cfg = {"direct_mode": PathConfig(max_depth=2, mode="direct"),
               "whitted_mode": PathConfig(max_depth=2, mode="whitted"),
               "nee_off": PathConfig(max_depth=2, nee=False,
                                     emit_all_bounces=True)}[case]
    img = render(scene, cam, 4, 4, 1, cfg, **kw)
    assert img.shape == (4, 4, 3) and bool(torch.isfinite(img).all())

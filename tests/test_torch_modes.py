"""Port parity: the integrator's modes (direct, whitted, BSDF sampling only).

``tests/test_furnace.py``'s analytic gates of the three modes run on the
port (direct lighting and Whitted give 1 + rho = 1.5 in the furnace, BSDF
sampling with emission at every bounce 1 / (1 - rho) = 2). Fixed waves of
the direct and whitted modes run in both packages on a scene with every
light type but the sphere's (the mis_box with a second mesh light, a
point, a distant and an infinite light), with the same seeds: equal ray
counts and radiance within the stated tolerance (NEE off and the CLI's
``bsdf`` integrator are in tests/test_torch_modes_nee.py: each JAX wave
compiles for ~10-30 s on the CPU). JAX's regeneration wave compiles
slowly on the CPU, so the port's regeneration with refills is held to
the sum of two JAX fixed waves (samples 0 and 1) that share one compile.
A regeneration wave that refills no lane is the fixed wave, bitwise, in
every mode.

Observed on the CPU when this file was written: the waves' radiance
equal within rtol 2e-5 and the ray counts equal; the furnace gates as in
the JAX package.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fountain_tpu_torch.integrator.path import PathConfig
from tests.test_torch_lights import _all_lights_scene

RES = 8
SPP = 4
N = RES * RES * SPP
SEED = 5
# inside the box, looking up at the downward-facing mesh light
EYE, TARGET = [278.0, 60.0, 278.0], [175.0, 300.0, 490.0]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scenes():
    return _all_lights_scene()


def _furnace(device="cpu"):
    from fountain_tpu_torch.core import transform as tf
    from fountain_tpu_torch.scene.build import SceneBuilder
    from fountain_tpu_torch.scene.camera import make_perspective_camera
    b = SceneBuilder()
    mat = b.add_matte(kd=[0.5] * 3, sigma=0.0)
    sph = b.add_sphere(radius=100.0, mat_id=mat, reverse_orientation=True)
    b.add_area_light_sphere(sph, [1.0] * 3)
    cam = make_perspective_camera(
        tf.look_at([0.0, -2.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 1.0]),
        (16, 16), fov_deg=60.0)
    return b.build(device=device), cam


def _render16(cfg, spp):
    from fountain_tpu_torch.integrator.render import render
    scene, cam = _furnace()
    return render(scene, cam, 16, 16, spp, cfg).numpy()


def test_furnace_direct_mode():
    cfg = PathConfig(max_depth=5, rr_threshold=0.0, nee=True, mode="direct")
    np.testing.assert_allclose(_render16(cfg, 64), 1.5, atol=0.01)


def test_furnace_whitted_mode():
    cfg = PathConfig(max_depth=5, rr_threshold=0.0, mode="whitted")
    np.testing.assert_allclose(_render16(cfg, 64), 1.5, atol=0.01)


def test_furnace_bsdf_sampling_only():
    cfg = PathConfig(max_depth=20, rr_threshold=0.0, nee=False,
                     emit_all_bounces=True)
    np.testing.assert_allclose(_render16(cfg, 32), 2.0, atol=0.01)


def test_furnace_deterministic():
    cfg = PathConfig(max_depth=5, rr_threshold=0.0, nee=True,
                     mode="direct")
    np.testing.assert_array_equal(_render16(cfg, 4), _render16(cfg, 4))


_JAX_RUNS = {}
_JAX_WAVES = {}


def _jax_wave(js, mode, nee, emit_all, regen, sample=0):
    """JAX's wave of ``N`` lanes whose first sample is ``sample``; the
    jitted function takes ``sample`` as an argument, so the waves of one
    (scene, mode) share one compile, and each wave runs once (~4 s on one
    core)."""
    key = (id(js), mode, nee, emit_all, regen)
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = _jax_run(js, mode, nee, emit_all, regen)
    if key + (sample,) not in _JAX_WAVES:
        out = _JAX_RUNS[key](jnp.int32(sample))
        if regen:
            wave = (np.stack([np.asarray(c) for c in out.accum], -1),
                    np.asarray(out.n_done), int(out.n_rays))
        else:
            r, n_rays = out
            wave = (np.stack([np.asarray(c) for c in r], -1), None,
                    int(n_rays))
        _JAX_WAVES[key + (sample,)] = wave
    return _JAX_WAVES[key + (sample,)]


def _jax_run(js, mode, nee, emit_all, regen):
    from fountain_tpu.core import rng as jrng
    from fountain_tpu.core import transform as jtf
    from fountain_tpu.integrator.path import DIM_CAMERA
    from fountain_tpu.integrator.path import PathConfig as JConfig
    from fountain_tpu.integrator.path import trace_paths as jtrace
    from fountain_tpu.scene.camera import generate_rays as jgen
    from fountain_tpu.scene.camera import make_perspective_camera as jmk
    cam = jmk(jtf.look_at(EYE, TARGET, [0.0, 0.0, 1.0]), (RES, RES),
              fov_deg=70.0)
    cfg = JConfig(max_depth=4, rr_threshold=1.0, nee=nee,
                  emit_all_bounces=emit_all, mode=mode)

    def ray_fn(lane_ids, sample_ids):
        px = (lane_ids % RES).astype(jnp.float32)
        py = ((lane_ids // RES) % RES).astype(jnp.float32)
        u = jrng.uniform4(lane_ids, sample_ids, DIM_CAMERA, SEED)
        r = jgen(cam, px + u[0], py + u[1], u[2], u[3])
        return r.o, r.d, jnp.zeros_like(px)

    @jax.jit
    def run(first):
        lane = jnp.arange(N, dtype=jnp.int32)
        sample = jnp.full((N,), first, jnp.int32)
        o, d, _ = ray_fn(lane, sample)
        return jtrace(js, o, d, lane, sample, cfg, seed=SEED,
                      count_rays=True, regen_fn=ray_fn if regen else None,
                      n_iters=8 if regen else None)
    return run


def _port_wave(ts, mode, nee, emit_all, regen, detach_sampling=True,
               n_iters=8):
    from fountain_tpu_torch.core import transform as tf
    from fountain_tpu_torch.core import rng
    from fountain_tpu_torch.integrator.path import DIM_CAMERA, trace_paths
    from fountain_tpu_torch.scene.camera import (generate_rays,
                                                 make_perspective_camera)
    cam = make_perspective_camera(
        tf.look_at(EYE, TARGET, [0.0, 0.0, 1.0]), (RES, RES), fov_deg=70.0)
    cfg = PathConfig(max_depth=4, rr_threshold=1.0, nee=nee,
                     emit_all_bounces=emit_all, mode=mode)

    def ray_fn(lane_ids, sample_ids):
        px = (lane_ids % RES).to(torch.float32)
        py = (torch.div(lane_ids, RES, rounding_mode="floor") % RES).to(
            torch.float32)
        u = rng.uniform4(lane_ids, sample_ids, DIM_CAMERA, SEED)
        r = generate_rays(cam, px + u[0], py + u[1], u[2], u[3])
        return r.o, r.d, torch.zeros_like(px)

    lane = torch.arange(N, dtype=torch.int32)
    sample = torch.zeros(N, dtype=torch.int32)
    o, d, _ = ray_fn(lane, sample)
    out = trace_paths(ts, o, d, lane, sample, cfg, seed=SEED,
                      count_rays=True, regen_fn=ray_fn if regen else None,
                      n_iters=n_iters if regen else None,
                      detach_sampling=detach_sampling)
    if regen:
        return (torch.stack(list(out.accum), -1).detach().numpy(),
                out.n_done.numpy(), int(out.n_rays))
    r, n_rays = out
    return torch.stack(list(r), -1).detach().numpy(), None, int(n_rays)


def check_wave(scenes, mode, nee, emit_all, regen):
    """8x8 pixels, 4 samples each, depth 4, RR, seed 5, lanes on every
    light type: ray counts equal, radiance within rtol 1e-4 (atol 1e-6)
    on >= 99% of lanes and the mean within rel 1e-4; under regeneration
    the completed-sample counts equal on >= 99% of lanes."""
    js, ts = scenes
    ja, jn, jr = _jax_wave(js, mode, nee, emit_all, regen)
    pa, pn, pr = _port_wave(ts, mode, nee, emit_all, regen)
    assert np.isfinite(pa).all() and pa.max() > 0.0
    assert pr == jr, (pr, jr)
    same = np.ones(len(pa), bool) if jn is None else jn == pn
    assert same.mean() >= 0.99
    close = np.isclose(pa, ja, rtol=1e-4, atol=1e-6).all(-1) & same
    assert close.mean() >= 0.99, close.mean()
    assert abs(pa.mean() - ja.mean()) <= 1e-4 * abs(ja.mean())


@pytest.mark.parametrize("mode", ["direct", "whitted"])
def test_wave_matches_jax(scenes, mode):
    """The fixed wave (``check_wave``); tests/test_torch_modes_nee.py
    holds NEE off."""
    check_wave(scenes, mode, True, False, False)


def test_ray_counts_per_mode(scenes):
    """count_rays: one closest-hit ray per live lane per bounce, plus one
    shadow ray per NEE lane (path), two (direct: and the BSDF ray), one
    per light (whitted: the scene has 5 lights), none without NEE. On the
    same paths' first bounce (the camera rays all hit the box), so the
    modes' counts order as their NEE rays."""
    _, ts = scenes
    counts = {m: _port_wave(ts, m, True, False, False)[2]
              for m in ("path", "direct", "whitted")}
    nee_off = _port_wave(ts, "path", False, True, False)[2]
    assert ts.lights.count == 5
    # direct and whitted stop at the first diffuse vertex: N camera rays
    # plus NEE rays of the N first-bounce lanes (every wall is diffuse)
    assert counts["direct"] == N + 2 * N
    assert counts["whitted"] == N + 5 * N
    assert counts["path"] > N + N and nee_off > N


@pytest.mark.parametrize("mode", ["path", "direct", "whitted"])
def test_regen_without_refill_is_the_fixed_wave(scenes, mode):
    """A regeneration wave of max_depth + 1 iterations refills no lane,
    so each lane completes exactly its first path: the fixed wave's
    radiance and rays, bitwise."""
    fixed, _, rays = _port_wave(scenes[1], mode, True, False, False)
    regen, n_done, rays_r = _port_wave(scenes[1], mode, True, False, True,
                                       n_iters=5)
    np.testing.assert_array_equal(n_done, 1)
    np.testing.assert_array_equal(regen, fixed)
    assert rays_r == rays


@pytest.mark.parametrize("mode", ["direct", "whitted"])
def test_regen_with_refill_matches_jax(scenes, mode):
    """Regeneration that refills every lane, held against JAX's fixed
    waves: on this all-diffuse box a direct or whitted path ends at its
    first vertex, so a wave of max_depth + 2 iterations refills each lane
    once (after iteration 0) and completes its samples 0 and 1. Its
    accumulated radiance is the sum of JAX's fixed waves at samples 0 and
    1, within check_wave's tolerances; its rays are theirs together."""
    js, ts = scenes
    j0, _, r0 = _jax_wave(js, mode, True, False, False, sample=0)
    j1, _, r1 = _jax_wave(js, mode, True, False, False, sample=1)
    pa, n_done, pr = _port_wave(ts, mode, True, False, True, n_iters=6)
    np.testing.assert_array_equal(n_done, 2)
    assert pr == r0 + r1, (pr, r0, r1)
    ja = j0 + j1
    assert np.isfinite(pa).all() and pa.max() > 0.0
    close = np.isclose(pa, ja, rtol=1e-4, atol=1e-6).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(pa.mean() - ja.mean()) <= 1e-4 * abs(ja.mean())


def test_attached_estimator_same_forward(scenes):
    """The attached estimator changes gradients only: the forward wave of
    each mode is bitwise that of the detached one."""
    _, ts = scenes
    for mode in ("direct", "whitted"):
        a = _port_wave(ts, mode, True, False, False, detach_sampling=False)
        b = _port_wave(ts, mode, True, False, False)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[2] == b[2]

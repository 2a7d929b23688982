"""The regeneration wave's iteration as segments between its triangle
queries (``integrator.regen_graph``), on the CPU: the plumbing that the
card's CUDA graphs run through (static buffers, the queries answered
between segments, the outputs cloned out, the seeds read from device
scalars), with plain calls where the card replays graphs. The capture
itself is in tests/test_torch_graph_gpu.py.

Each wave here is the same call twice: once as it runs without autograd
(through the segments), once under autograd with a texture value that
requires grad (the plain loop). The two must agree bit for bit.
"""
import dataclasses
import gc

import pytest
import torch

from fountain_tpu_torch import bench
from fountain_tpu_torch.core import rng
from fountain_tpu_torch.geometry import intersect
from fountain_tpu_torch.integrator import path, regen_graph
from fountain_tpu_torch.integrator.path import PathConfig
from fountain_tpu_torch.integrator.render import render_regen

RES = 8
ITERS = 7          # depth 3: 3 iterations of refills, 4 draining
NO_WAVES = {"wave_captures": 0, "wave_replays": 0, "eager_waves": 0}

# scene, mode, triangle queries an iteration
CASES = {
    "config3_path": ("rounded_cube_env", "path", 2),
    "mis_box_path": ("mis_box", "path", 2),
    "mis_box_direct": ("mis_box", "direct", 3),
    "mis_box_whitted": ("mis_box", "whitted", 2),
    "spheres_only": ("metal_textured_ggx", "path", 0),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(name):
    return bench.CONFIGS[name][0]("cpu", RES)


def _with_grad_leaf(scene):
    """The scene with a copy of its texture values that requires grad."""
    tex = scene.textures
    return dataclasses.replace(scene, textures=dataclasses.replace(
        tex, value=tex.value.detach().clone().requires_grad_(True)))


def _wave(scene, cam, cfg, seed, sample0=0, grad=False):
    """(r, g, b sums, completed samples, rays) of one wave; under autograd
    with a texture leaf (the plain loop) with ``grad``."""
    if grad:
        with torch.enable_grad():
            film, n = render_regen(_with_grad_leaf(scene), cam, RES, RES,
                                   ITERS, cfg, seed=seed, sample0=sample0,
                                   count_rays=True)
    else:
        with torch.no_grad():
            film, n = render_regen(scene, cam, RES, RES, ITERS, cfg,
                                   seed=seed, sample0=sample0,
                                   count_rays=True)
    return [t.detach() for t in (film.r_sum, film.g_sum, film.b_sum,
                                 film.weight_sum, n)]


def _held():
    """The CPU's held regeneration recording."""
    return regen_graph._HELD[(torch.device("cpu"), "segments")][1]


def _assert_equal(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("case", list(CASES))
def test_segments_equal_the_plain_loop(case):
    """Every mode, and a scene without triangles (one segment, no query):
    the segmented wave is the plain loop's, bitwise, with the number of
    queries the mode makes recorded."""
    name, mode, n_queries = CASES[case]
    scene, cam = _scene(name)
    cfg = PathConfig(max_depth=3, mode=mode)
    path.reset_graph_counts()
    seg = _wave(scene, cam, cfg, seed=2_000_000_011)
    assert path.graph_counts() == {"captures": 1, "replays": ITERS - 1,
                                   "eager_iterations": 0,
                                   **NO_WAVES}
    assert len(_held().outs) == n_queries
    plain = _wave(scene, cam, cfg, seed=2_000_000_011, grad=True)
    assert path.graph_counts()["eager_iterations"] == ITERS
    _assert_equal(seg, plain)
    assert seg[3].sum() > 0


def test_outputs_are_the_callers_own():
    """The returned sums and counts are clones: no storage shared with the
    static buffers, and unchanged by the next wave."""
    scene, cam = _scene("rounded_cube_env")
    cfg = PathConfig(max_depth=3)
    first = _wave(scene, cam, cfg, seed=7)
    kept = [t.clone() for t in first]
    held = {t.untyped_storage().data_ptr()
            for t in _held().state.values()}
    assert not held & {t.untyped_storage().data_ptr() for t in first}
    second = _wave(scene, cam, cfg, seed=8, sample0=3)
    _assert_equal(first, kept)
    assert not torch.equal(first[0], second[0])


def test_queries_see_the_real_rays(monkeypatch):
    """A wrapper of ``intersect.intersect_faces`` put on the module sees
    each query of the segmented wave, with the plain loop's rays."""
    scene, cam = _scene("rounded_cube_env")
    cfg = PathConfig(max_depth=3)
    _wave(scene, cam, cfg, seed=1)           # records the key
    original = intersect.intersect_faces
    seen = []

    def wrapped(scene, o, d, t_max, any_hit=False):
        seen.append((any_hit, torch.stack([*o, *d, t_max]).clone()))
        return original(scene, o, d, t_max, any_hit=any_hit)
    monkeypatch.setattr(intersect, "intersect_faces", wrapped)
    path.reset_graph_counts()
    _wave(scene, cam, cfg, seed=5)
    assert path.graph_counts()["replays"] == ITERS
    segmented, seen[:] = list(seen), []
    _wave(scene, cam, cfg, seed=5, grad=True)
    assert [k for k, _ in segmented] == [False, True] * ITERS
    assert [k for k, _ in seen] == [k for k, _ in segmented]
    for (_, a), (_, b) in zip(segmented, seen):
        assert torch.equal(a, b)


def test_seed_is_read_from_the_device_scalar():
    """Two waves with other seeds and first samples through one recording:
    each is its own plain loop's wave, so the seeds come from the device
    scalars and not from the first wave. A seed in a device scalar hashes
    as the Python int does."""
    scene, cam = _scene("mis_box")
    cfg = PathConfig(max_depth=3)
    path.reset_graph_counts()
    waves = [_wave(scene, cam, cfg, seed=s, sample0=s0)
             for s, s0 in ((3, 0), (2 ** 31 + 5, 4))]
    assert path.graph_counts() == {"captures": 1, "replays": 2 * ITERS - 1,
                                   "eager_iterations": 0,
                                   **NO_WAVES}
    for w, (s, s0) in zip(waves, ((3, 0), (2 ** 31 + 5, 4))):
        _assert_equal(w, _wave(scene, cam, cfg, seed=s, sample0=s0,
                               grad=True))
    assert not torch.equal(waves[0][0], waves[1][0])
    lane = torch.arange(-50, 50, dtype=torch.int32) * 40_000_001
    dim = lane % 9
    for seed in (0, 2 ** 31 + 5, -3):
        _assert_equal(rng.uniform4(lane, 7, dim, seed),
                      rng.uniform4(lane, 7, dim, torch.tensor(seed)))


def test_a_new_key_replaces_the_held_one():
    """A device holds one regeneration key: another number of iterations
    records anew and drops the first; the first records anew when it
    comes back; the recording goes with its scene."""
    scene, cam = _scene("rounded_cube_env")
    cfg = PathConfig(max_depth=3)
    path.reset_graph_counts()
    _wave(scene, cam, cfg, seed=1)
    first = _held()
    with torch.no_grad():
        render_regen(scene, cam, RES, RES, ITERS + 1, cfg, seed=1)
    assert _held() is not first
    _wave(scene, cam, cfg, seed=1)
    assert path.graph_counts()["captures"] == 3
    del scene, first
    gc.collect()
    assert (torch.device("cpu"), "segments") not in regen_graph._HELD


def test_fresh_camera_that_requires_grad_records_anew():
    """A wave without autograd whose camera holds a tensor that requires
    grad: a fresh camera of the same shapes is another key (its tensors
    are read at their addresses), so it records anew and its wave is its
    own plain loop's, not the first camera's."""
    from fountain_tpu_torch.core import transform as tf
    scene, cam = _scene("rounded_cube_env")
    cfg = PathConfig(max_depth=3)

    def leaf_camera(to_world):
        return dataclasses.replace(cam, camera_to_world=tf.Transform(
            *(t.detach().clone().requires_grad_(True)
              for t in (to_world.m, to_world.m_inv))))
    cams = [leaf_camera(cam.camera_to_world),
            leaf_camera(tf.translate([0.05, -0.03, 0.0])
                        @ cam.camera_to_world)]
    path.reset_graph_counts()
    waves = [_wave(scene, c, cfg, seed=9) for c in cams]
    assert path.graph_counts()["captures"] == 2
    for w, c in zip(waves, cams):
        _assert_equal(w, _wave(scene, c, cfg, seed=9, grad=True))
    assert not torch.equal(waves[0][0], waves[1][0])


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("route", ["sweeps", "walk"])
def test_empty_results_are_the_hit_records_format(monkeypatch, route,
                                                  any_hit):
    """``intersect.empty_results`` has the dtypes, shapes and device of
    what ``intersect_faces`` returns on a mesh, through the sweeps and
    through the walk (``MAX_DENSE_FACES`` forced to 0): the recordings'
    static results, made with no query of their own."""
    from fountain_tpu_torch.geometry import tensor_tri
    if route == "walk":
        monkeypatch.setattr(tensor_tri, "MAX_DENSE_FACES", 0)
    scene, cam = _scene("rounded_cube_env")
    assert (scene.triangles.count > tensor_tri.MAX_DENSE_FACES) \
        == (route == "walk")
    lane = torch.arange(37, dtype=torch.int32)
    o, d, _ = bench.make_ray_fn(cam, RES, 1)(lane, torch.zeros_like(lane))
    t_max = torch.where(lane % 5 == 0, -1.0, float("inf"))
    got = intersect.intersect_faces(scene, o, d, t_max, any_hit=any_hit)
    assert got[2].any()
    assert [(r.dtype, r.shape, r.device) for r in got] == [
        (r.dtype, r.shape, r.device)
        for r in intersect.empty_results(37, o.x.device)]

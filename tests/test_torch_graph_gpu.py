"""The regeneration wave, and the differentiable fixed wave, as CUDA
graphs between their triangle queries, on a card (marker ``gpu``; skips
without one). This file imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_graph_gpu.py -q

The graphed regeneration wave (no autograd) is held bit for bit to the
same call under autograd (a texture value that requires grad: the plain
loop, op by op); the graphed fixed wave under autograd to the plain loop
put in its place.
"""
import dataclasses

import pytest
import torch

from fountain_tpu_torch import bench
from fountain_tpu_torch.geometry import intersect
from fountain_tpu_torch.integrator import path, regen_graph
from fountain_tpu_torch.integrator.path import PathConfig
from fountain_tpu_torch.integrator.render import render_regen

NO_WAVES = {"wave_captures": 0, "wave_replays": 0, "eager_waves": 0}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _with_grad_leaf(scene):
    tex = scene.textures
    return dataclasses.replace(scene, textures=dataclasses.replace(
        tex, value=tex.value.detach().clone().requires_grad_(True)))


def _wave(scene, cam, res, iters, cfg, seed, sample0=0, spp_total=16,
          grad=False):
    """(r, g, b sums, completed samples, rays) of one wave; the plain loop
    under autograd with ``grad``."""
    with torch.enable_grad() if grad else torch.no_grad():
        film, n = render_regen(_with_grad_leaf(scene) if grad else scene,
                               cam, res, res, iters, cfg, seed=seed,
                               sample0=sample0, spp_total=spp_total,
                               count_rays=True)
    return [t.detach() for t in (film.r_sum, film.g_sum, film.b_sum,
                                 film.weight_sum, n)]


def _assert_equal(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _config3(res):
    return bench.build_scene(res, "cuda")


# scene, film, iterations, config, spp_total
CASES = {
    "config3_64": (lambda: _config3(64), 64, 24, PathConfig(max_depth=5),
                   16),
    "flagship_32": (lambda: bench.build_flagship("cuda", film_res=32), 32,
                    25, PathConfig(max_depth=8), 64),
    "mis_box_direct": (lambda: bench.build_mis_box("cuda", 32), 32, 10,
                       PathConfig(max_depth=4, mode="direct"), 16),
    "mis_box_whitted": (lambda: bench.build_mis_box("cuda", 32), 32, 10,
                        PathConfig(max_depth=4, mode="whitted"), 16),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_graphed_wave_equals_the_eager_wave(case):
    _card()
    make, res, iters, cfg, spp = CASES[case]
    scene, cam = make()
    path.reset_graph_counts()
    graphed = _wave(scene, cam, res, iters, cfg, 2_000_000_011,
                    spp_total=spp)
    assert path.graph_counts() == {"captures": 1, "replays": iters - 1,
                                   "eager_iterations": 0,
                                   **NO_WAVES}
    again = _wave(scene, cam, res, iters, cfg, 2_000_000_011,
                  spp_total=spp)
    eager = _wave(scene, cam, res, iters, cfg, 2_000_000_011,
                  spp_total=spp, grad=True)
    assert path.graph_counts()["eager_iterations"] == iters
    _assert_equal(graphed, eager)
    _assert_equal(again, eager)
    assert graphed[3].sum() > 0


@pytest.mark.gpu
def test_second_wave_replays_and_keeps_the_first():
    """Two waves with other seeds and first samples: one capture, every
    iteration of the second a replay, each wave its eager wave, and the
    first wave's outputs unchanged by the second."""
    _card()
    scene, cam = _config3(64)
    cfg = PathConfig(max_depth=5)
    path.reset_graph_counts()
    first = _wave(scene, cam, 64, 24, cfg, 11)
    kept = [t.clone() for t in first]
    assert path.graph_counts() == {"captures": 1, "replays": 23,
                                   "eager_iterations": 0,
                                   **NO_WAVES}
    second = _wave(scene, cam, 64, 24, cfg, 2 ** 31 + 7, sample0=5)
    assert path.graph_counts() == {"captures": 1, "replays": 47,
                                   "eager_iterations": 0,
                                   **NO_WAVES}
    _assert_equal(first, kept)
    _assert_equal(first, _wave(scene, cam, 64, 24, cfg, 11, grad=True))
    _assert_equal(second, _wave(scene, cam, 64, 24, cfg, 2 ** 31 + 7,
                                sample0=5, grad=True))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["regen_replay", "regen_first",
                                  "wave_first"])
def test_patched_query_sees_every_query_and_its_rays(monkeypatch, case):
    """A wrapper put on ``intersect.intersect_faces`` sees exactly the
    plain loop's queries, 24 closest and 24 any-hit in a 24-iteration
    config-3 wave (6 and 6 in a fixed wave), and the rays of launches 0
    and 8 (0 and 3) of each kind equal the plain loop's: in a replayed
    regeneration wave, and in the first wave of a new key of either kind,
    whose recording makes no query of its own."""
    _card()
    scene, cam = _config3(64)
    cfg = PathConfig(max_depth=5)
    if case == "regen_replay":
        _wave(scene, cam, 64, 24, cfg, 3)         # the key's capture
    original = intersect.intersect_faces
    its = (0, 3) if case == "wave_first" else (0, 8)
    seen = {}

    def wrapped(scene, o, d, t_max, any_hit=False):
        calls = seen.setdefault(any_hit, [])
        calls.append(torch.stack([*o, *d, t_max]).clone()
                     if len(calls) in its else None)
        return original(scene, o, d, t_max, any_hit=any_hit)
    monkeypatch.setattr(intersect, "intersect_faces", wrapped)
    path.reset_graph_counts()
    if case == "wave_first":
        _flagship_step(scene, cam, [5])
        assert _wave_counts() == (1, 0, 0)
        graphed, seen = seen, {}
        monkeypatch.setattr(path, "_graphed_wave", _plain_wave)
        _flagship_step(scene, cam, [5])
        n = cfg.max_depth + 1
    else:
        _wave(scene, cam, 64, 24, cfg, 5)
        first = case == "regen_first"
        assert (path.graph_counts()["captures"],
                path.graph_counts()["replays"]) == (first, 24 - first)
        graphed, seen = seen, {}
        _wave(scene, cam, 64, 24, cfg, 5, grad=True)
        n = 24
    for kind in (False, True):
        assert len(graphed[kind]) == len(seen[kind]) == n
        for k in its:
            assert torch.equal(graphed[kind][k], seen[kind][k])


# The differentiable fixed wave (``regen_graph.differentiable``): a
# recording call, then replays of its forward and backward graphs. Its
# reference is the plain loop under autograd; the loss must be the plain
# loop's to the bit, and each gradient within GRAD_RTOL in relative L2
# (the texel ``index_add_``'s float atomics sum in another order).

GRAD_RTOL = 1e-5
FLAGSHIP_RES = 64
# CUDA runtime calls that put work on the device
LAUNCH_CALLS = frozenset((
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
    "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpy", "cudaMemcpyAsync",
    "cudaMemset", "cudaMemsetAsync", "cuMemcpyAsync", "cuMemsetD8Async",
    "cuMemsetD32Async"))


def _plain_wave(scene, o, d, lane, sample, spread, cfg, seed, count_rays,
                detach_sampling):
    """The plain loop in place of ``path._graphed_wave``."""
    detach = path._detach if detach_sampling else path._attached
    return intersect.answer_queries(scene, path._fixed_wave(
        scene, path._first_lanes(o, d, lane, sample, spread), cfg, seed,
        count_rays, detach))


def _flagship_loss(scene, cam, seeds, detach=True):
    """(loss, texture value leaf, texel leaf): fresh leaf copies of both
    tables in a fresh scene, and the summed loss (r.x + r.y + r.z).sum()
    / 3 of a fixed wave at each seed, before its backward."""
    tv = scene.textures.value.detach().clone().requires_grad_(True)
    tx = scene.env_images.texels.detach().clone().requires_grad_(True)
    sc = bench.with_params(scene, tv, tx)
    loss = 0.0
    for s in seeds:
        r = bench.wave(sc, cam, FLAGSHIP_RES, s, regen=False,
                       detach_sampling=detach)
        loss = loss + (r.x + r.y + r.z).sum() / 3.0
    return loss, tv, tx


def _flagship_step(scene, cam, seeds, detach=True):
    loss, tv, tx = _flagship_loss(scene, cam, seeds, detach)
    loss.backward()
    return loss.detach(), tv.grad, tx.grad


def _backward_calls(loss) -> int:
    """Host calls that put work on the device during ``loss.backward()``,
    from the profiler's trace."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loss.backward()
        torch.cuda.synchronize()
    return sum(e.name() in LAUNCH_CALLS
               for e in prof.profiler.kineto_results.events())


def _wave_counts():
    c = path.graph_counts()
    return c["wave_captures"], c["wave_replays"], c["eager_waves"]


def _assert_step_close(got, want):
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert torch.isfinite(g).all()
        rel = float((g.double() - w.double()).norm()
                    / w.double().norm().clamp_min(1e-300))
        assert rel <= GRAD_RTOL, rel


@pytest.mark.gpu
@pytest.mark.parametrize("detach", [True, False],
                         ids=["detached", "attached"])
def test_graphed_step_equals_the_plain_step(monkeypatch, detach):
    """The flagship's step through the graphed fixed wave: one capture,
    every later step a replay, each step's loss the plain loop's to the
    bit and its gradients within GRAD_RTOL, and the backward under 50
    host calls."""
    _card()
    scene, cam = bench.build_flagship("cuda", film_res=FLAGSHIP_RES)
    seeds = (2_000_000_011, 5, 2 ** 31 + 7) if detach else (3, 2 ** 31 + 9)
    path.reset_graph_counts()
    got = [_flagship_step(scene, cam, [s], detach) for s in seeds]
    assert _wave_counts() == (1, len(seeds) - 1, 0)
    loss, _, _ = _flagship_loss(scene, cam, [17], detach)
    calls = _backward_calls(loss)
    assert _wave_counts() == (1, len(seeds), 0)
    assert calls < 50, calls
    monkeypatch.setattr(path, "_graphed_wave", _plain_wave)
    for g, s in zip(got, seeds):
        _assert_step_close(g, _flagship_step(scene, cam, [s], detach))
    assert _wave_counts() == (1, len(seeds), 0)


@pytest.mark.gpu
def test_waves_before_one_backward():
    """Several graphed waves summed into one loss before its backward
    (a render of several samples): each backward whose wave a later one
    replaced replays its own forward again first, and the gradient is the
    plain loop's within GRAD_RTOL. The first time, the backward graph
    is captured in the last wave's backward."""
    _card()
    scene, cam = bench.build_flagship("cuda", film_res=FLAGSHIP_RES)
    path.reset_graph_counts()
    seeds = (21, 22, 23)
    first = _flagship_step(scene, cam, seeds[:2])    # records; re-runs 1
    again = _flagship_step(scene, cam, seeds)        # replays; re-runs 2
    assert _wave_counts() == (1, 1 + 1 + 3 + 2, 0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(path, "_graphed_wave", _plain_wave)
        _assert_step_close(first, _flagship_step(scene, cam, seeds[:2]))
        _assert_step_close(again, _flagship_step(scene, cam, seeds))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["wave", "segments"])
def test_first_recording_makes_its_own_constants(monkeypatch, kind):
    """A key recorded before any wave has run op by op (as the first
    wave of a fresh process is): the capture makes the integrator's
    cached constants itself, and the flagship's step, or its regeneration
    wave, is the plain loop's."""
    from fountain_tpu_torch.core import vecmath
    _card()
    monkeypatch.setattr(vecmath, "_CONSTS", {})
    torch.cuda.synchronize()
    regen_graph._HELD.clear()
    scene, cam = bench.build_flagship("cuda", film_res=FLAGSHIP_RES)
    path.reset_graph_counts()
    if kind == "segments":
        cfg = PathConfig(max_depth=8)
        got = _wave(scene, cam, FLAGSHIP_RES, 25, cfg, 31, spp_total=64)
        assert path.graph_counts() == {"captures": 1, "replays": 24,
                                       "eager_iterations": 0, **NO_WAVES}
        _assert_equal(got, _wave(scene, cam, FLAGSHIP_RES, 25, cfg, 31,
                                 spp_total=64, grad=True))
        return
    got = _flagship_step(scene, cam, [31])
    assert _wave_counts() == (1, 0, 0)
    monkeypatch.setattr(path, "_graphed_wave", _plain_wave)
    _assert_step_close(got, _flagship_step(scene, cam, [31]))

@pytest.mark.gpu
def test_held_wave_and_its_pool_go_with_the_scene():
    """The graphed wave's key is dropped when its scene goes, and the
    device memory of its graphs' pool is given back with it."""
    import gc
    _card()
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    scene, cam = bench.build_flagship("cuda", film_res=FLAGSHIP_RES)
    _flagship_step(scene, cam, [4])
    assert (torch.device("cuda", 0), "wave") in regen_graph._HELD
    held = torch.cuda.memory_reserved()
    del scene, cam
    gc.collect()
    assert (torch.device("cuda", 0), "wave") not in regen_graph._HELD
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved() - before < (held - before) / 4

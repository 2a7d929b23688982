"""The regeneration wave as CUDA graphs between its triangle queries, on
a card (marker ``gpu``; skips without one). This file imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_graph_gpu.py -q

The graphed wave (no autograd) is held bit for bit to the same call under
autograd (a texture value that requires grad: the plain loop, op by op).
"""
import dataclasses

import pytest
import torch

from fountain_tpu_torch import bench
from fountain_tpu_torch.geometry import intersect
from fountain_tpu_torch.integrator import path
from fountain_tpu_torch.integrator.path import PathConfig
from fountain_tpu_torch.integrator.render import render_regen


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
                                   "eager_iterations": 1}
    again = _wave(scene, cam, res, iters, cfg, 2_000_000_011,
                  spp_total=spp)
    eager = _wave(scene, cam, res, iters, cfg, 2_000_000_011,
                  spp_total=spp, grad=True)
    assert path.graph_counts()["eager_iterations"] == 1 + iters
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
                                   "eager_iterations": 1}
    second = _wave(scene, cam, 64, 24, cfg, 2 ** 31 + 7, sample0=5)
    assert path.graph_counts() == {"captures": 1, "replays": 47,
                                   "eager_iterations": 1}
    _assert_equal(first, kept)
    _assert_equal(first, _wave(scene, cam, 64, 24, cfg, 11, grad=True))
    _assert_equal(second, _wave(scene, cam, 64, 24, cfg, 2 ** 31 + 7,
                                sample0=5, grad=True))


@pytest.mark.gpu
def test_patched_query_sees_every_query_and_its_rays(monkeypatch):
    """A wrapper put on ``intersect.intersect_faces`` sees 24 closest and
    24 any-hit queries in a 24-iteration config-3 wave, and the rays of
    launches 0 and 8 of each kind equal the eager wave's."""
    _card()
    scene, cam = _config3(64)
    cfg = PathConfig(max_depth=5)
    _wave(scene, cam, 64, 24, cfg, 3)             # the key's capture
    original = intersect.intersect_faces
    seen = {}

    def wrapped(scene, o, d, t_max, any_hit=False):
        calls = seen.setdefault(any_hit, [])
        calls.append(torch.stack([*o, *d, t_max]).clone()
                     if len(calls) in (0, 8) else None)
        return original(scene, o, d, t_max, any_hit=any_hit)
    monkeypatch.setattr(intersect, "intersect_faces", wrapped)
    path.reset_graph_counts()
    _wave(scene, cam, 64, 24, cfg, 5)
    assert path.graph_counts()["replays"] == 24
    graphed, seen = seen, {}
    _wave(scene, cam, 64, 24, cfg, 5, grad=True)
    for kind in (False, True):
        assert len(graphed[kind]) == len(seen[kind]) == 24
        for k in (0, 8):
            assert torch.equal(graphed[kind][k], seen[kind][k])

"""The differentiable fixed wave as one autograd function
(``regen_graph.differentiable``), on the CPU: the plumbing that the
card's CUDA graphs run through (the scene's tables that require grad and
the wave's first lanes as the function's inputs, the key that survives
fresh leaves and a fresh scene, the outputs cloned out, the backward
through ``torch.autograd.grad``), with plain calls where the card
replays graphs. The capture itself is in tests/test_torch_graph_gpu.py.

Each step here is made as the benchmark's ``step`` traffic makes it: leaf
copies of the texture values and the atlas texels, a scene from
``dataclasses.replace``, one fixed wave, the loss (r.x + r.y + r.z).sum()
/ 3 and its backward. The reference is the same step through the plain
loop under autograd; the two must agree bit for bit.
"""
import gc
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from fountain_tpu_torch import bench
from fountain_tpu_torch.geometry.intersect import answer_queries
from fountain_tpu_torch.integrator import path, regen_graph
from fountain_tpu_torch.integrator.path import PathConfig, trace_paths

RES = 16
CFG = PathConfig(max_depth=5, rr_threshold=1.0, nee=True)
SCENES = {
    "config3": lambda: bench.build_scene(RES, "cpu"),
    "flagship": lambda: bench.build_flagship("cpu", film_res=RES),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scenes():
    return {k: make() for k, make in SCENES.items()}


def _plain(scene, o, d, lane, sample, spread, cfg, seed, count_rays,
           detach_sampling):
    """The plain loop in place of ``path._graphed_wave``."""
    detach = path._detach if detach_sampling else path._attached
    return answer_queries(scene, path._fixed_wave(
        scene, path._first_lanes(o, d, lane, sample, spread), cfg, seed,
        count_rays, detach))


def _step(scene, cam, seed, detach=True, value=None):
    """[loss, r.x, r.y, r.z, n_rays, d/d texture values, d/d texels] of
    one step with fresh leaves (``value``: other texture values)."""
    value = scene.textures.value if value is None else value
    tv = value.detach().clone().requires_grad_(True)
    tx = scene.env_images.texels.detach().clone().requires_grad_(True)
    sc = bench.with_params(scene, tv, tx)
    lane = torch.arange(RES * RES, dtype=torch.int32)
    sample = torch.zeros(RES * RES, dtype=torch.int32)
    o, d, _ = bench.make_ray_fn(cam, RES, seed)(lane, sample)
    r, n_rays = trace_paths(sc, o, d, lane, sample, CFG, seed=seed,
                            detach_sampling=detach, count_rays=True)
    loss = (r.x + r.y + r.z).sum() / 3.0
    loss.backward()
    return [loss.detach(), r.x.detach(), r.y.detach(), r.z.detach(), n_rays,
            tv.grad, tx.grad]


def _assert_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("detach", [True, False],
                         ids=["detached", "attached"])
@pytest.mark.parametrize("name", list(SCENES))
def test_function_equals_the_plain_loop(scenes, monkeypatch, name, detach):
    """Loss, radiance, rays and both tables' gradients of the wave run as
    one autograd function are the plain loop's, bit for bit, in both
    estimators; the first call of the key records."""
    scene, cam = scenes[name]
    regen_graph._HELD.clear()
    path.reset_graph_counts()
    got = _step(scene, cam, 2_000_000_011, detach)
    counts = path.graph_counts()
    assert (counts["wave_captures"], counts["wave_replays"],
            counts["eager_waves"]) == (1, 0, 0)
    monkeypatch.setattr(path, "_graphed_wave", _plain)
    want = _step(scene, cam, 2_000_000_011, detach)
    _assert_equal(got, want)
    assert want[4] > RES * RES
    assert all(g.abs().sum() > 0 for g in want[5:])


def test_fresh_leaves_and_scene_replay(scenes, monkeypatch):
    """Two steps made as the benchmark's ``step`` traffic makes them
    (fresh leaf copies, a fresh scene each): one recording, then a
    replay, never a second recording; each step the plain loop's."""
    scene, cam = scenes["flagship"]
    regen_graph._HELD.clear()
    path.reset_graph_counts()
    got = [_step(scene, cam, s) for s in (7, 2 ** 31 + 5)]
    counts = path.graph_counts()
    assert (counts["wave_captures"], counts["wave_replays"],
            counts["eager_waves"]) == (1, 1, 0)
    monkeypatch.setattr(path, "_graphed_wave", _plain)
    for g, s in zip(got, (7, 2 ** 31 + 5)):
        _assert_equal(g, _step(scene, cam, s))
    assert not torch.equal(got[0][0], got[1][0])


def test_other_table_shapes_record_anew(scenes, monkeypatch):
    """A texture value table of another shape is another key: it records
    anew, and its step is still the plain loop's."""
    scene, cam = scenes["config3"]
    regen_graph._HELD.clear()
    path.reset_graph_counts()
    _step(scene, cam, 3)
    value = scene.textures.value
    longer = torch.cat([value, value[:1]])       # one row no texture reads
    got = _step(scene, cam, 3, value=longer)
    assert path.graph_counts()["wave_captures"] == 2
    assert got[5].shape == longer.shape
    monkeypatch.setattr(path, "_graphed_wave", _plain)
    _assert_equal(got, _step(scene, cam, 3, value=longer))


def test_waves_without_autograd_stay_plain(scenes):
    """A fixed wave under no_grad, or with nothing requiring grad, is the
    plain loop: counted as an op-by-op wave, no key recorded."""
    scene, cam = scenes["config3"]
    path.reset_graph_counts()
    with torch.no_grad():
        bench.wave(bench.with_params(
            scene, scene.textures.value.clone().requires_grad_(True),
            scene.env_images.texels), cam, RES, 1, regen=False)
    bench.wave(scene, cam, RES, 1, regen=False)
    counts = path.graph_counts()
    assert (counts["wave_captures"], counts["wave_replays"],
            counts["eager_waves"]) == (0, 0, 2)


def test_outputs_are_the_callers_own(scenes):
    """The returned radiance and rays are clones: a later step leaves them
    as they were."""
    scene, cam = scenes["config3"]
    first = _step(scene, cam, 11)
    kept = [t.clone() for t in first]
    _step(scene, cam, 12)
    _assert_equal(first, kept)


WAVE = (torch.device("cpu"), "wave")


def test_held_wave_goes_with_its_scene():
    """The device's held wave goes when a tensor of its scene whose
    address the key reads goes: nothing of the scene is kept past its
    use."""
    scene, cam = bench.build_scene(RES, "cpu")
    regen_graph._HELD.clear()
    _step(scene, cam, 5)
    assert WAVE in regen_graph._HELD
    del scene, cam
    gc.collect()
    assert WAVE not in regen_graph._HELD


def test_each_kind_keeps_its_own_recording(scenes):
    """A regeneration render and a differentiable wave on one device
    hold a recording each: alternating them records each once, and both
    stay held."""
    scene, cam = scenes["config3"]
    regen_graph._HELD.clear()
    path.reset_graph_counts()
    for seed in (1, 2):
        with torch.no_grad():
            bench.wave(scene, cam, RES, seed, n_iters=7)
        _step(scene, cam, seed)
    assert path.graph_counts() == {
        "captures": 1, "replays": 13, "eager_iterations": 0,
        "wave_captures": 1, "wave_replays": 1, "eager_waves": 0}
    assert set(regen_graph._HELD) == {WAVE, (torch.device("cpu"),
                                             "segments")}


def test_backward_imports_no_symbolic_shapes():
    """A step's backward through the function, in a fresh interpreter,
    imports no ``torch.fx`` symbolic shapes: a backward given gradient
    tensors imports them on its first call, seconds of a card's set-up."""
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from fountain_tpu_torch import bench\n"
        "from fountain_tpu_torch.integrator.path import PathConfig, "
        "trace_paths\n"
        "scene, cam = bench.build_scene(8, 'cpu')\n"
        "tv = scene.textures.value.detach().clone().requires_grad_(True)\n"
        "sc = bench.with_params(scene, tv, scene.env_images.texels)\n"
        "lane = torch.arange(64, dtype=torch.int32)\n"
        "sample = torch.zeros(64, dtype=torch.int32)\n"
        "o, d, _ = bench.make_ray_fn(cam, 8, 1)(lane, sample)\n"
        "r = trace_paths(sc, o, d, lane, sample, PathConfig(max_depth=2))\n"
        "(r.x + r.y + r.z).sum().backward()\n"
        "assert tv.grad.abs().sum() > 0\n"
        "print('torch.fx.experimental.symbolic_shapes' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.stdout.strip() == "False"

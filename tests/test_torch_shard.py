"""The port's sharded render (``fountain_tpu_torch/parallel/shard.py``).

In one process, the shards' partial films (``render_shard``) sum to the
image of ``render`` and of the JAX package's ``render_sharded`` on its 8
virtual CPU devices: the counterparts of tests/test_shard.py. Then two
gloo processes on the CPU (the counterpart of tests/test_multiproc.py):
the render CLI's ``--cpu --devices 2`` against its one-process image,
and the sharded gradient, summed over the ranks with ``all_reduce_grads``,
against the one-process gradient. Each rendezvous is a ``file://`` store
in a temporary directory under the test's ``tmp_path``.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from fountain_tpu.core import transform as jtf
from fountain_tpu.integrator.path import PathConfig as JCfg
from fountain_tpu.parallel.shard import render_sharded as jrender_sharded
from fountain_tpu.scene.build import SceneBuilder as JBuilder
from fountain_tpu.scene.camera import make_perspective_camera as jcamera
from fountain_tpu_torch.core import transform as tf
from fountain_tpu_torch.integrator.path import PathConfig
from fountain_tpu_torch.integrator.render import render
from fountain_tpu_torch.parallel import shard
from fountain_tpu_torch.scene.build import SceneBuilder
from fountain_tpu_torch.scene.camera import make_perspective_camera
from fountain_tpu_torch.scene.film import FILTER_BOX, Film, finalize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FURNACE = os.path.join(REPO, "testscenes", "furnace_empty.pbrt")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _furnace(builder, camera, look_at, res, **build):
    """tests/test_shard.py's scene, from either package's builder."""
    b = builder()
    mat = b.add_matte(kd=[0.5] * 3)
    sph = b.add_sphere(radius=100.0, mat_id=mat, reverse_orientation=True)
    b.add_area_light_sphere(sph, [1.0] * 3)
    cam = camera(look_at([0.0, -2.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 1.0]),
                 (res, res), fov_deg=60.0)
    return b.build(**build), cam


def _port_furnace(res):
    return _furnace(SceneBuilder, make_perspective_camera, tf.look_at, res,
                    device="cpu")


def _sum_of_shards(scene, cam, xres, yres, spp, cfg, n, ftype=FILTER_BOX,
                   fradius=0.5, seed=0):
    """The image of ``n`` shards rendered one after another here, their
    partial films summed (what ``render_sharded`` does over n ranks)."""
    films = [shard.render_shard(scene, cam, xres, yres, spp, cfg, ftype,
                                fradius, seed, r, n) for r in range(n)]
    return finalize(Film(*(sum(getattr(f, k) for f in films) for k in
                           ("r_sum", "g_sum", "b_sum", "weight_sum"))))


CFG8 = PathConfig(max_depth=5, rr_threshold=0.0, nee=True)


@pytest.fixture(scope="module")
def eight_shards():
    scene, cam = _port_furnace(16)
    return _sum_of_shards(scene, cam, 16, 16, 8, CFG8, 8).numpy()


def test_sharded_matches_single_device(eight_shards):
    """8 shards summed equal ``render`` (rtol 5e-7, tests/test_shard.py's
    gate; the lanes' radiance is the same bits, the box filter gives each
    pixel to one shard)."""
    scene, cam = _port_furnace(16)
    ref = render(scene, cam, 16, 16, 8, CFG8).numpy()
    np.testing.assert_allclose(eight_shards, ref, rtol=5e-7, atol=1e-7)


def test_eight_shards_match_jax_render_sharded(eight_shards):
    """The port's 8 shards against the JAX package's ``render_sharded`` on
    its 8 virtual devices (rtol 1e-6, as tests/test_torch_render.py)."""
    assert len(jax.devices()) >= 8
    jscene, jcam = _furnace(JBuilder, jcamera, jtf.look_at, 16)
    jimg = np.asarray(jrender_sharded(
        jscene, jcam, 16, 16, 8, JCfg(max_depth=5, rr_threshold=0.0,
                                      nee=True), n_devices=8))
    np.testing.assert_allclose(eight_shards, jimg, rtol=1e-6, atol=1e-6)


def test_device_count_invariance():
    """2 shards against 4 (rtol 5e-7)."""
    scene, cam = _port_furnace(16)
    cfg = PathConfig(max_depth=3, rr_threshold=0.0, nee=True)
    np.testing.assert_allclose(
        _sum_of_shards(scene, cam, 16, 16, 4, cfg, 2).numpy(),
        _sum_of_shards(scene, cam, 16, 16, 4, cfg, 4).numpy(),
        rtol=5e-7, atol=1e-7)


def test_sharded_non_divisible_resolution():
    """10 x 10 = 100 lanes over 8 shards of 13 (the last one 9 lanes):
    against ``render`` (rtol 5e-7); no lane beyond the image is traced."""
    assert [shard.shard_lanes(100, r, 8) for r in (0, 6, 7)] == [
        (0, 13), (78, 13), (91, 9)]
    assert shard.shard_lanes(10, 7, 8) == (10, 0)
    scene, cam = _port_furnace(10)
    cfg = PathConfig(max_depth=2, rr_threshold=0.0, nee=True)
    np.testing.assert_allclose(
        _sum_of_shards(scene, cam, 10, 10, 4, cfg, 8).numpy(),
        render(scene, cam, 10, 10, 4, cfg).numpy(), rtol=5e-7, atol=1e-7)


def test_wide_filter_logo_cube():
    """logo_cube at 32 x 32 with the Gaussian filter of radius 2 over 3
    ragged shards (each a partial wave: the scatter splat) against
    ``render``'s aligned splat (rtol 1e-5: float addition order)."""
    from fountain_tpu_torch import bench
    from fountain_tpu_torch.scene.film import FILTER_GAUSSIAN
    scene, cam = bench.build_flagship("cpu", film_res=32)
    cfg = PathConfig(max_depth=3, rr_threshold=1.0, nee=True)
    kw = dict(ftype=FILTER_GAUSSIAN, fradius=2.0, seed=1)
    np.testing.assert_allclose(
        _sum_of_shards(scene, cam, 32, 32, 1, cfg, 3, **kw).numpy(),
        render(scene, cam, 32, 32, 1, cfg, **kw).numpy(), rtol=1e-5,
        atol=1e-6)


def test_one_process_needs_no_group(monkeypatch):
    """Without a process group the world is this process: init_distributed
    initialises nothing, the barrier is trivial, ``render_sharded`` is
    ``render`` (bitwise) and refuses n_devices > 1; ``render_devices``
    and ``--devices 2`` raise without two cards."""
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert shard.init_distributed() == 0
    assert not torch.distributed.is_initialized()
    scene, cam = _port_furnace(8)
    cfg = PathConfig(max_depth=2, rr_threshold=0.0, nee=True)
    torch.testing.assert_close(shard.render_sharded(scene, cam, 8, 8, 2, cfg),
                               render(scene, cam, 8, 8, 2, cfg), rtol=0,
                               atol=0)
    with pytest.raises(ValueError, match="process group has 1 ranks"):
        shard.render_sharded(scene, cam, 8, 8, 2, cfg, n_devices=2)
    from fountain_tpu_torch.cli.render import main
    for avail, count in ((False, 0), (True, 1)):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: avail)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
        with pytest.raises(RuntimeError, match="2 CUDA devices asked for"):
            shard.render_devices(2)
        with pytest.raises(RuntimeError, match="2 CUDA devices asked for"):
            main([FURNACE, "--devices", "2"])


def _env(tmp_path):
    """A child's environment: one torch thread, temporary files (the
    rendezvous store) under ``tmp_path``."""
    return dict(os.environ, OMP_NUM_THREADS="1", TMPDIR=str(tmp_path),
                PYTHONPATH=REPO)


def test_cli_two_gloo_processes_match_one(tmp_path):
    """``--cpu --devices 2`` (two gloo ranks) writes the image of
    ``--cpu`` (rtol 1e-6, tests/test_multiproc.py's gate); only rank 0
    prints."""
    from fountain_tpu_torch.cli.render import main
    from fountain_tpu_torch.io.exr import read_exr
    args = [FURNACE, "--cpu", "--samples", "4", "--max-depth", "3", "-o"]
    proc = subprocess.run(
        [sys.executable, "-m", "fountain_tpu_torch.cli.render", *args,
         str(tmp_path / "f2.exr"), "--devices", "2"], cwd=REPO,
        env=_env(tmp_path), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stderr.count("Completed rendering") == 1
    assert main(args + [str(tmp_path / "f1.exr")]) == 0
    img2, img1 = (read_exr(str(tmp_path / f)) for f in ("f2.exr", "f1.exr"))
    assert img2.shape == (16, 16, 3)
    np.testing.assert_allclose(img2, img1, rtol=1e-6, atol=1e-6)


def test_two_gloo_processes_gradient(tmp_path):
    """The furnace's image and the gradient of its mean with respect to
    ``textures.value`` over two gloo ranks equal one process's (rtol 1e-6
    and 1e-5) on both ranks; a backward that all-reduced the upstream
    gradient would double the gradient."""
    from tests.test_torch_gpu import (furnace_image_and_grad,
                                      run_furnace_ranks)
    ranks = run_furnace_ranks(["cpu", "cpu"], 12, 2, tmp_path)
    img, grad = furnace_image_and_grad("cpu", 12, 2, sharded=False)
    assert float(grad.abs().sum()) > 0
    for got in ranks:
        torch.testing.assert_close(got["img"], img, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(got["grad"], grad, rtol=1e-5, atol=1e-7)


def test_failed_rank_fails_the_run(tmp_path):
    """A rank that raises ends the run with a non-zero exit, whatever the
    other rank does."""
    proc = subprocess.run(
        [sys.executable, "-m", "fountain_tpu_torch.cli.render",
         str(tmp_path / "missing.pbrt"), "--cpu", "--devices", "2"],
        cwd=REPO, env=_env(tmp_path), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert "missing.pbrt" in proc.stderr

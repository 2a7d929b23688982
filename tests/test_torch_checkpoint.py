"""Checkpoint / resume in the port (``fountain_tpu_torch/io/checkpoint.py``)
against the JAX package's ``fountain_tpu/io/checkpoint.py``: the
counterparts of tests/test_checkpoint.py, and checkpoints that cross
between the two packages in both directions (one file format).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fountain_tpu.core import transform as jtf
from fountain_tpu.integrator.path import PathConfig as JCfg
from fountain_tpu.integrator.render import render_samples as jrender_samples
from fountain_tpu.io.checkpoint import load_checkpoint as jload
from fountain_tpu.io.checkpoint import save_checkpoint as jsave
from fountain_tpu.scene.build import SceneBuilder as JBuilder
from fountain_tpu.scene.camera import make_perspective_camera as jcamera
from fountain_tpu.scene.film import make_film as jmake_film
from fountain_tpu_torch.core import transform as tf
from fountain_tpu_torch.integrator.path import PathConfig
from fountain_tpu_torch.integrator.render import render_samples
from fountain_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from fountain_tpu_torch.scene.build import SceneBuilder
from fountain_tpu_torch.scene.camera import make_perspective_camera
from fountain_tpu_torch.scene.film import finalize, make_film

RES, SPP, SEED = 12, 8, 3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _furnace(builder, camera, look_at, **build):
    """tests/test_checkpoint.py's scene, from either package's builder."""
    b = builder()
    mat = b.add_matte(kd=[0.5] * 3)
    sph = b.add_sphere(radius=100.0, mat_id=mat, reverse_orientation=True)
    b.add_area_light_sphere(sph, [1.0] * 3)
    cam = camera(look_at([0.0, -2.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 1.0]),
                 (RES, RES), fov_deg=60.0)
    return b.build(**build), cam


def _port():
    return _furnace(SceneBuilder, make_perspective_camera, tf.look_at,
                    device="cpu")


CFG = PathConfig(max_depth=4, rr_threshold=0.0, nee=True)


def _planes(film):
    return [np.asarray(p) for p in (film.r_sum, film.g_sum, film.b_sum,
                                    film.weight_sum)]


def _port_samples(scene, cam, s0, s1, film=None):
    film = make_film(RES, RES, "cpu") if film is None else film
    return render_samples(scene, cam, RES, RES, s0, s1, SPP, film, CFG,
                          seed=SEED)


def test_resume_bitwise_equal(tmp_path):
    """[0, 4), save, load, [4, 8) equals [0, 8) bit for bit; the
    parameters come back equal (a tensor, and a nested structure)."""
    scene, cam = _port()
    full = _port_samples(scene, cam, 0, SPP)
    path = str(tmp_path / "ckpt.npz")
    params = {"kd": scene.textures.value, "pair": [scene.textures.value,
                                                   torch.arange(3)]}
    save_checkpoint(path, _port_samples(scene, cam, 0, 4), next_sample=4,
                    spp_total=SPP, seed=SEED, params=params)
    film, next_s, spp_tot, seed, back = load_checkpoint(
        path, params_like=params, device="cpu")
    assert (next_s, spp_tot, seed) == (4, SPP, SEED)
    torch.testing.assert_close(back["kd"], scene.textures.value, rtol=0,
                               atol=0)
    torch.testing.assert_close(back["pair"][1], torch.arange(3), rtol=0,
                               atol=0)
    resumed = render_samples(scene, cam, RES, RES, next_s, spp_tot, spp_tot,
                             film, CFG, seed=seed)
    for a, b in zip(_planes(full), _planes(resumed)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(finalize(full).numpy(),
                                  finalize(resumed).numpy())


def test_checkpoint_rejects_garbage(tmp_path):
    """A file without the magic tag, and a leaf count that differs from
    ``params_like``, raise."""
    p = str(tmp_path / "bad.npz")
    np.savez(p, meta=np.frombuffer(b'{"magic": "nope"}', dtype=np.uint8),
             r_sum=np.zeros((2, 2)), g_sum=np.zeros((2, 2)),
             b_sum=np.zeros((2, 2)), weight_sum=np.zeros((2, 2)))
    with pytest.raises(ValueError, match="not a fountain-tpu checkpoint"):
        load_checkpoint(p, device="cpu")
    good = str(tmp_path / "good.npz")
    save_checkpoint(good, make_film(2, 2, "cpu"), 1, 2,
                    params=[torch.zeros(2), torch.ones(3)])
    with pytest.raises(ValueError, match="2 param leaves"):
        load_checkpoint(good, params_like=[torch.zeros(2)], device="cpu")


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """JAX renders [0, 4) and saves; the port loads and renders [4, 8):
    the film equals the port's uninterrupted one to rtol 1e-6 (the two
    packages' first halves differ in float rounding only)."""
    jscene, jcam = _furnace(JBuilder, jcamera, jtf.look_at)
    jcfg = JCfg(max_depth=4, rr_threshold=0.0, nee=True)
    jfilm = jrender_samples(jscene, jcam, RES, RES, 0, 4, SPP,
                            jmake_film(RES, RES), jcfg, seed=SEED)
    path = str(tmp_path / "jax.npz")
    jsave(path, jfilm, next_sample=4, spp_total=SPP, seed=SEED,
          params=jscene.textures.value)
    scene, cam = _port()
    film, next_s, spp_tot, seed, kd = load_checkpoint(
        path, params_like=scene.textures.value, device="cpu")
    np.testing.assert_array_equal(kd.numpy(),
                                  np.asarray(jscene.textures.value))
    resumed = render_samples(scene, cam, RES, RES, next_s, spp_tot, spp_tot,
                             film, CFG, seed=seed)
    for a, b in zip(_planes(_port_samples(scene, cam, 0, SPP)),
                    _planes(resumed)):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)


def test_port_checkpoint_loads_in_jax(tmp_path):
    """JAX's ``load_checkpoint`` reads the port's file: the film, the
    counters and the parameter structure (a dict of a list)."""
    scene, cam = _port()
    film = _port_samples(scene, cam, 0, 2)
    params = {"b": [torch.ones(2), torch.arange(4.0)], "a": torch.zeros(3)}
    path = str(tmp_path / "port.npz")
    save_checkpoint(path, film, next_sample=2, spp_total=SPP, seed=SEED,
                    params=params)
    like = {"b": [jnp.zeros(2), jnp.zeros(4)], "a": jnp.zeros(3)}
    jfilm, next_s, spp_tot, seed, jparams = jload(path, params_like=like)
    assert (next_s, spp_tot, seed) == (2, SPP, SEED)
    for a, b in zip(_planes(film), jfilm):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(jparams["b"][1], np.arange(4.0))
    np.testing.assert_array_equal(jparams["a"], np.zeros(3))

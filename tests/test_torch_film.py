"""Port parity: the film's filters, the scatter splat and partial waves.

``tests/test_film.py``'s four cases run on the port (the lane-aligned
splat equals the scatter splat for the box, triangle and Gaussian
filters; the box's weights sum to the sample count; a constant signal
reconstructs the constant; NaN samples are dropped). The filter weights,
the scatter splat ``add_samples`` (each tap an ``index_add``) and the
splat of a partial wave (``lane_offset``, as a sharded render splats its
lanes) are held to the JAX package's on the same random samples (rtol
1e-5, atol 1e-6: f32 sums of up to 25 taps a pixel, in orders that may
differ), and a 4x4 render with each filter to the JAX package's render.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fountain_tpu.core.vecmath import V3 as JV3
from fountain_tpu.scene import film as jf
from fountain_tpu_torch.core.vecmath import V3
from fountain_tpu_torch.scene import film as tf_
from fountain_tpu_torch.scene.film import (FILTER_BOX, FILTER_GAUSSIAN,
                                           FILTER_TRIANGLE)

TOL = dict(rtol=1e-5, atol=1e-6)
FILTERS = [(FILTER_BOX, 0.5), (FILTER_TRIANGLE, 1.0), (FILTER_TRIANGLE, 2.0),
           (FILTER_GAUSSIAN, 1.5)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tv3(a):
    a = torch.as_tensor(np.ascontiguousarray(a))
    return V3(a[..., 0], a[..., 1], a[..., 2])


def _jv3(a):
    a = jnp.asarray(a)
    return JV3(a[..., 0], a[..., 1], a[..., 2])


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _rand_wave(w, h, seed):
    r = np.random.default_rng(seed)
    frac = r.random((w * h, 2), np.float32)
    radiance = r.random((w * h, 3), np.float32)
    lane = np.arange(w * h)
    p_film = np.stack([lane % w + frac[:, 0], lane // w + frac[:, 1]],
                      axis=-1).astype(np.float32)
    return frac, p_film, radiance


def _rgb(film):
    return torch.stack([film.r_sum, film.g_sum, film.b_sum], -1).numpy()


def _same_film(jfilm, tfilm, **tol):
    for f in ("r_sum", "g_sum", "b_sum", "weight_sum"):
        np.testing.assert_allclose(getattr(tfilm, f).numpy(),
                                   np.asarray(getattr(jfilm, f)),
                                   **(tol or TOL))


@pytest.mark.parametrize("ftype,radius", FILTERS)
def test_aligned_matches_scatter(ftype, radius):
    w, h = 7, 5
    frac, p_film, radiance = _rand_wave(w, h, 42)
    f_scatter = tf_.add_samples(tf_.make_film(w, h, "cpu"),
                                _t(p_film[:, 0]), _t(p_film[:, 1]),
                                _tv3(radiance), ftype=ftype, radius=radius)
    f_aligned = tf_.add_samples_aligned(
        tf_.make_film(w, h, "cpu"), _t(frac[:, 0]), _t(frac[:, 1]),
        _tv3(radiance), ftype=ftype, radius=radius)
    np.testing.assert_allclose(_rgb(f_aligned), _rgb(f_scatter), **TOL)
    np.testing.assert_allclose(f_aligned.weight_sum.numpy(),
                               f_scatter.weight_sum.numpy(), **TOL)


def test_box_filter_partition_of_unity():
    w, h = 8, 8
    frac, _, radiance = _rand_wave(w, h, 7)
    film = tf_.add_samples_aligned(tf_.make_film(w, h, "cpu"),
                                   _t(frac[:, 0]), _t(frac[:, 1]),
                                   _tv3(radiance), ftype=FILTER_BOX,
                                   radius=0.5)
    assert np.isclose(float(film.weight_sum.sum()), w * h)


def test_constant_radiance_reconstructs_constant():
    w, h = 16, 16
    radiance = _tv3(np.full((w * h, 3), 0.75, np.float32))
    film = tf_.make_film(w, h, "cpu")
    for s in range(4):
        fr, _, _ = _rand_wave(w, h, 10 + s)
        film = tf_.add_samples_aligned(film, _t(fr[:, 0]), _t(fr[:, 1]),
                                       radiance, ftype=FILTER_GAUSSIAN,
                                       radius=1.5)
    img = tf_.finalize(film).numpy()
    np.testing.assert_allclose(img[2:-2, 2:-2], 0.75, atol=1e-4)


def test_nan_samples_are_dropped():
    w, h = 4, 4
    frac, _, radiance = _rand_wave(w, h, 1)
    radiance = radiance.copy()
    radiance[5] = np.nan
    film = tf_.add_samples_aligned(tf_.make_film(w, h, "cpu"),
                                   _t(frac[:, 0]), _t(frac[:, 1]),
                                   _tv3(radiance), ftype=FILTER_BOX)
    assert np.isfinite(_rgb(film)).all()
    assert float(film.weight_sum.reshape(-1)[5]) == 0.0


@pytest.mark.parametrize("ftype,radius", FILTERS)
def test_filter_weight_matches_jax(ftype, radius):
    r = np.random.default_rng(ftype * 10 + int(radius * 2))
    dx, dy = r.uniform(-2.5, 2.5, (2, 4096)).astype(np.float32)
    np.testing.assert_allclose(
        tf_.filter_weight(ftype, radius, _t(dx), _t(dy)).numpy(),
        np.asarray(jf.filter_weight(ftype, radius, jnp.asarray(dx),
                                    jnp.asarray(dy))), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("ftype,radius", FILTERS)
def test_scatter_splat_matches_jax(ftype, radius):
    """Samples anywhere on (and off) a 9x6 film, several per pixel, with
    non-finite ones among them."""
    w, h, n = 9, 6, 500
    r = np.random.default_rng(11)
    px = r.uniform(-1.0, w + 1.0, n).astype(np.float32)
    py = r.uniform(-1.0, h + 1.0, n).astype(np.float32)
    rad = r.random((n, 3), np.float32)
    rad[::37, 1] = np.inf
    jfilm = jf.add_samples(jf.make_film(w, h), jnp.asarray(px),
                           jnp.asarray(py), _jv3(rad), ftype=ftype,
                           radius=radius)
    tfilm = tf_.add_samples(tf_.make_film(w, h, "cpu"), _t(px), _t(py),
                            _tv3(rad), ftype=ftype, radius=radius)
    _same_film(jfilm, tfilm)


@pytest.mark.parametrize("ftype,radius", FILTERS)
def test_partial_wave_matches_jax(ftype, radius):
    """Two partial waves (lanes [0, 23) and [23, 40) of an 8x5 film, as
    two shards splat them) sum to the full wave's film, and each equals
    the JAX package's splat of the same lanes."""
    w, h = 8, 5
    frac, _, radiance = _rand_wave(w, h, 9)
    full = tf_.add_samples_aligned(tf_.make_film(w, h, "cpu"),
                                   _t(frac[:, 0]), _t(frac[:, 1]),
                                   _tv3(radiance), ftype=ftype,
                                   radius=radius)
    tfilm, jfilm = tf_.make_film(w, h, "cpu"), jf.make_film(w, h)
    for lo, hi in ((0, 23), (23, 40)):
        tfilm = tf_.add_samples_aligned(
            tfilm, _t(frac[lo:hi, 0]), _t(frac[lo:hi, 1]),
            _tv3(radiance[lo:hi]), ftype=ftype, radius=radius,
            lane_offset=lo)
        jfilm = jf.add_samples_aligned(
            jfilm, jnp.asarray(frac[lo:hi, 0]), jnp.asarray(frac[lo:hi, 1]),
            _jv3(radiance[lo:hi]), ftype=ftype, radius=radius,
            lane_offset=lo)
        _same_film(jfilm, tfilm)
    for f in ("r_sum", "g_sum", "b_sum", "weight_sum"):
        np.testing.assert_allclose(getattr(tfilm, f).numpy(),
                                   getattr(full, f).numpy(), **TOL)


@pytest.mark.parametrize("ftype,radius", FILTERS[2:])
def test_render_with_filter_matches_jax(ftype, radius):
    """render() of the furnace at 4x4, 2 spp with each wide filter: the
    port's image equals the JAX package's (rtol 1e-5)."""
    from fountain_tpu.core import transform as jtf
    from fountain_tpu.integrator.path import PathConfig as JConfig
    from fountain_tpu.integrator.render import render as jrender
    from fountain_tpu.scene.camera import make_perspective_camera as jmk
    from fountain_tpu_torch.core import transform as ttf
    from fountain_tpu_torch.integrator.path import PathConfig
    from fountain_tpu_torch.integrator.render import render
    from fountain_tpu_torch.scene.camera import make_perspective_camera
    from tests.test_furnace import build_furnace_scene
    from tests.test_torch_modes import _furnace
    look = ([0.0, -2.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 1.0])
    j = np.asarray(jrender(build_furnace_scene(),
                           jmk(jtf.look_at(*look), (4, 4), fov_deg=60.0),
                           4, 4, 2, JConfig(max_depth=3), ftype=ftype,
                           fradius=radius))
    scene, _ = _furnace()
    t = render(scene, make_perspective_camera(ttf.look_at(*look), (4, 4),
                                              fov_deg=60.0),
               4, 4, 2, PathConfig(max_depth=3), ftype=ftype,
               fradius=radius).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)

"""The slice's entry point, integrator/render.render_regen, on config 3.

The wave under it is held against JAX in test_torch_path.py (compiling
the JAX render_regen itself takes over a minute on the CPU). Here: the
port's own SceneBuilder scene renders exactly like the bridged JAX tables,
the film and its finalize match the JAX film's, the wave is deterministic,
and the ray count is within its bounds.
"""
import jax.numpy as jnp
import numpy as np
import torch

from fountain_tpu.scene.film import Film as JFilm
from fountain_tpu.scene.film import finalize as jfinalize
from fountain_tpu_torch.integrator.path import PathConfig
from fountain_tpu_torch.integrator.render import render_regen
from fountain_tpu_torch.scene.film import finalize
from tests.test_torch_scene import RES, bridged_config3, port_config3

CFG = PathConfig(max_depth=5, rr_threshold=1.0, nee=True)


def test_port_build_renders_like_the_bridge():
    """Identical tables give the identical film (tolerance 1e-6)."""
    scene, cam = port_config3()
    a = render_regen(scene, cam, RES, RES, 8, CFG, seed=2)
    b = render_regen(bridged_config3(), cam, RES, RES, 8, CFG, seed=2)
    for x, y in zip((a.r_sum, a.g_sum, a.b_sum, a.weight_sum),
                    (b.r_sum, b.g_sum, b.b_sum, b.weight_sum)):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6)


def test_render_regen_film_counts_and_determinism():
    scene, cam = port_config3()
    film, n_rays = render_regen(scene, cam, RES, RES, 12, CFG, seed=1,
                                count_rays=True)
    again = render_regen(scene, cam, RES, RES, 12, CFG, seed=1)
    torch.testing.assert_close(film.r_sum, again.r_sum, rtol=0, atol=0)
    w = film.weight_sum.numpy()
    assert w.min() >= 1
    # one closest-hit ray per live lane per iteration, one shadow ray per
    # NEE lane: between one camera ray per lane and 2 rays per lane-iter
    assert RES * RES <= int(n_rays) <= 2 * RES * RES * 12
    img = finalize(film).numpy()
    assert np.isfinite(img).all() and img.mean() > 0.0
    jimg = jfinalize(JFilm(*(jnp.asarray(p.numpy()) for p in (
        film.r_sum, film.g_sum, film.b_sum, film.weight_sum))))
    np.testing.assert_allclose(img, np.asarray(jimg), rtol=1e-6, atol=0)

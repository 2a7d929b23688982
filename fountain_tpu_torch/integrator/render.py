"""Render driver: camera -> wavefront trace -> film (PyTorch).

Counterpart of ``fountain_tpu/integrator/render.py``: ``render_wave``
traces one sample per pixel (the fixed wave, or a slice of its lanes),
``render_samples``
accumulates a range of samples into a film (a Python loop over samples),
``render`` is the whole image, and ``render_regen`` is one
path-regeneration wave. Every random number depends only on (pixel lane,
sample index), so the image is independent of batching, and rendering
samples [0, 4) then [4, 8) equals [0, 8) in one call. Each of them takes
``detach_sampling``: the detached (default) or attached gradient
estimator of ``trace_paths``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch

from fountain_tpu_torch.core import rng
from fountain_tpu_torch.core.vecmath import length
from fountain_tpu_torch.integrator.path import (DIM_CAMERA, PathConfig,
                                                trace_paths)
from fountain_tpu_torch.scene.camera import PerspectiveCamera, generate_rays
from fountain_tpu_torch.scene.film import (FILTER_BOX, Film,
                                           add_samples_aligned, finalize,
                                           make_film)
from fountain_tpu_torch.scene.types import Scene


def render_wave(scene: Scene, camera: PerspectiveCamera, xres: int,
                yres: int, sample_idx: int, cfg: PathConfig, seed=0,
                lane_offset: int = 0, n_lanes: Optional[int] = None,
                detach_sampling: bool = True, diff_scale: float = 1.0):
    """Trace one sample-per-pixel wave; returns (frac_x, frac_y, L): the
    in-pixel jitter [N] in [0, 1)^2 and the radiance V3 of [N].

    Lanes cover pixels [lane_offset, lane_offset + n_lanes) in row-major
    order (all pixels by default): the slicing hook of the sharded
    render. The random numbers key off the global lane, so a slice's
    radiance equals the same lanes of the whole wave. ``diff_scale``
    scales the texture-filter ray-cone spread."""
    n_lanes = xres * yres if n_lanes is None else n_lanes
    lane = lane_offset + torch.arange(n_lanes, dtype=torch.int32,
                                      device=scene.device)
    px = (lane % xres).to(torch.float32)
    py = torch.div(lane, xres, rounding_mode="floor").to(torch.float32)
    u = rng.uniform4(lane, sample_idx, DIM_CAMERA, seed)
    rays = generate_rays(camera, px + u[0], py + u[1], u[2], u[3])
    spread = torch.maximum(length(rays.rx_d - rays.d),
                           length(rays.ry_d - rays.d)) * diff_scale
    sample = torch.full((n_lanes,), sample_idx, dtype=torch.int32,
                        device=scene.device)
    radiance = trace_paths(scene, rays.o, rays.d, lane, sample, cfg,
                           seed=seed, detach_sampling=detach_sampling,
                           cone_spread=spread)
    return u[0], u[1], radiance


def render_samples(scene: Scene, camera: PerspectiveCamera, xres: int,
                   yres: int, s_begin: int, s_end: int, spp_total: int,
                   film: Film, cfg: PathConfig = PathConfig(),
                   ftype: int = FILTER_BOX, fradius: float = 0.5, seed=0,
                   detach_sampling: bool = True) -> Film:
    """Accumulate samples [s_begin, s_end) into ``film`` and return it.
    ``spp_total`` only scales the ray-cone spread and must be held fixed
    across a resumed run."""
    for s in range(s_begin, s_end):
        fx, fy, radiance = render_wave(
            scene, camera, xres, yres, s, cfg, seed=seed,
            detach_sampling=detach_sampling,
            diff_scale=1.0 / max(spp_total, 1) ** 0.5)
        film = add_samples_aligned(film, fx, fy, radiance, ftype=ftype,
                                   radius=fradius)
    return film


def render(scene: Scene, camera: PerspectiveCamera, xres: int, yres: int,
           spp: int, cfg: PathConfig = PathConfig(),
           ftype: int = FILTER_BOX, fradius: float = 0.5, seed=0,
           detach_sampling: bool = True) -> torch.Tensor:
    """The image [yres, xres, 3] with ``spp`` samples per pixel, on the
    scene's device."""
    film = render_samples(scene, camera, xres, yres, 0, spp, spp,
                          make_film(xres, yres, scene.device), cfg, ftype,
                          fradius, seed, detach_sampling=detach_sampling)
    return finalize(film)


@dataclass(frozen=True, eq=False)
class RayFn:
    """``ray_fn(lane, sample) -> (o, d, spread)``: jittered camera rays for
    pixel lanes (row-major) and their ray-cone spread, scaled by
    1 / sqrt(``spp_total``) (zero without ``spp_total``). ``seed`` is an
    int or an integer device scalar; ``with_seed`` gives the same rays
    under another, which lets a CUDA graph of the regeneration wave read
    it from device memory (``path.trace_paths``)."""
    camera: PerspectiveCamera
    xres: int
    seed: object
    spp_total: Optional[int] = 16

    def with_seed(self, seed) -> "RayFn":
        return replace(self, seed=seed)

    def __call__(self, lane_ids, sample_ids):
        px = (lane_ids % self.xres).to(torch.float32)
        py = torch.div(lane_ids, self.xres, rounding_mode="floor").to(
            torch.float32)
        u = rng.uniform4(lane_ids, sample_ids, DIM_CAMERA, self.seed)
        rays = generate_rays(self.camera, px + u[0], py + u[1], u[2], u[3])
        if self.spp_total is None:
            return rays.o, rays.d, torch.zeros_like(px)
        sx = length(rays.rx_d - rays.d)
        sy = length(rays.ry_d - rays.d)
        spread = torch.maximum(sx, sy) / max(self.spp_total, 1) ** 0.5
        return rays.o, rays.d, spread


def make_ray_fn(camera: PerspectiveCamera, xres: int, seed,
                spp_total: int = 16) -> RayFn:
    """``ray_fn(lane, sample) -> (o, d, spread)``: jittered camera rays for
    pixel lanes (row-major) and their ray-cone spread."""
    return RayFn(camera, xres, seed, spp_total)


def render_regen(scene: Scene, camera: PerspectiveCamera, xres: int,
                 yres: int, n_iters: int, cfg: PathConfig = PathConfig(),
                 seed=0, sample0=0, spp_total: int = 16,
                 count_rays: bool = False, detach_sampling: bool = True):
    """Render one path-regeneration wave into a film (box filter: each
    completed sample counts 1.0 in its own pixel, so weight_sum is the
    per-pixel sample count). Runs on the scene's device. With
    ``count_rays`` returns (film, n_rays)."""
    dev = scene.device
    total = xres * yres
    lane = torch.arange(total, dtype=torch.int32, device=dev)
    ray_fn = make_ray_fn(camera, xres, seed, spp_total)
    sample = torch.full((total,), sample0, dtype=torch.int32, device=dev)
    # Known divergence from fountain, kept from the JAX package: the
    # wave's first rays are traced without their ray-cone spread (only
    # regenerated rays carry it), so first-sample texture lookups use the
    # finest mip level.
    o, d, _ = ray_fn(lane, sample)
    out = trace_paths(scene, o, d, lane, sample, cfg, seed=seed,
                      detach_sampling=detach_sampling,
                      count_rays=count_rays, regen_fn=ray_fn,
                      n_iters=n_iters)
    film = Film(r_sum=out.accum.x.reshape(yres, xres),
                g_sum=out.accum.y.reshape(yres, xres),
                b_sum=out.accum.z.reshape(yres, xres),
                weight_sum=out.n_done.to(torch.float32).reshape(yres, xres))
    return (film, out.n_rays) if count_rays else film

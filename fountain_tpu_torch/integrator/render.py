"""Render entry point: one path-regeneration wave into a film (PyTorch).

Counterpart of ``render_regen`` in ``fountain_tpu/integrator/render.py``.
Every random number depends only on (pixel lane, sample index), so the
image is independent of batching.
"""
from __future__ import annotations

import torch

from fountain_tpu_torch.core import rng
from fountain_tpu_torch.core.vecmath import length
from fountain_tpu_torch.integrator.path import (DIM_CAMERA, PathConfig,
                                                trace_paths)
from fountain_tpu_torch.scene.camera import PerspectiveCamera, generate_rays
from fountain_tpu_torch.scene.film import Film
from fountain_tpu_torch.scene.types import Scene


def make_ray_fn(camera: PerspectiveCamera, xres: int, seed,
                spp_total: int = 16):
    """``ray_fn(lane, sample) -> (o, d, spread)``: jittered camera rays for
    pixel lanes (row-major) and their ray-cone spread."""
    def ray_fn(lane_ids, sample_ids):
        px = (lane_ids % xres).to(torch.float32)
        py = torch.div(lane_ids, xres, rounding_mode="floor").to(
            torch.float32)
        u = rng.uniform4(lane_ids, sample_ids, DIM_CAMERA, seed)
        rays = generate_rays(camera, px + u[0], py + u[1], u[2], u[3])
        sx = length(rays.rx_d - rays.d)
        sy = length(rays.ry_d - rays.d)
        spread = torch.maximum(sx, sy) / max(spp_total, 1) ** 0.5
        return rays.o, rays.d, spread
    return ray_fn


def render_regen(scene: Scene, camera: PerspectiveCamera, xres: int,
                 yres: int, n_iters: int, cfg: PathConfig = PathConfig(),
                 seed=0, sample0=0, spp_total: int = 16,
                 count_rays: bool = False):
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
                      count_rays=count_rays, regen_fn=ray_fn,
                      n_iters=n_iters)
    film = Film(r_sum=out.accum.x.reshape(yres, xres),
                g_sum=out.accum.y.reshape(yres, xres),
                b_sum=out.accum.z.reshape(yres, xres),
                weight_sum=out.n_done.to(torch.float32).reshape(yres, xres))
    return (film, out.n_rays) if count_rays else film

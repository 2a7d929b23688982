# Frozen copy of fountain_tpu_torch/scene/camera.py (commit 6354002): the benchmark's plain reference; edit never.
"""Perspective camera and batched ray generation (PyTorch).

Counterpart of ``make_perspective_camera`` and ``generate_rays`` in
``fountain_tpu/scene/camera.py``: the raster -> screen -> camera transform
chain, the thin lens (depth of field) and one-pixel ray differentials.
The camera's matrices live on the host; rays live on the device of the
raster coordinates.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from refpt.core import transform as tf
from refpt.core.sampling import concentric_sample_disk
from refpt.core.vecmath import V3, normalize


@dataclass
class Rays:
    o: V3
    d: V3
    t_max: torch.Tensor
    rx_o: Optional[V3] = None
    rx_d: Optional[V3] = None
    ry_o: Optional[V3] = None
    ry_d: Optional[V3] = None


@dataclass
class PerspectiveCamera:
    camera_to_world: tf.Transform
    raster_to_camera: tf.Transform
    dx_camera: torch.Tensor   # [3] camera-space shift for +1 raster x
    dy_camera: torch.Tensor   # [3]
    lens_radius: float = 0.0  # 0: pinhole
    focal_dist: float = 1e6


def default_screen_window(xres: int, yres: int) -> Tuple[float, ...]:
    """PBRT aspect-correct screen window (x_min, x_max, y_min, y_max)."""
    aspect = xres / yres
    if aspect > 1.0:
        return (-aspect, aspect, -1.0, 1.0)
    return (-1.0, 1.0, -1.0 / aspect, 1.0 / aspect)


def make_perspective_camera(camera_to_world: tf.Transform,
                            resolution: Tuple[int, int], fov_deg: float,
                            lens_radius: float = 0.0,
                            focal_dist: float = 1e6) -> PerspectiveCamera:
    """Build the transform chain. Raster y points down; screen y up."""
    xres, yres = resolution
    x0, x1, y0, y1 = default_screen_window(xres, yres)
    persp = tf.perspective(fov_deg, 1.0e-2, 1000.0)
    screen_to_raster = (
        tf.scale(float(xres), float(yres), 1.0)
        @ tf.scale(1.0 / (x1 - x0), 1.0 / (y0 - y1), 1.0)
        @ tf.translate([-x0, -y1, 0.0]))
    raster_to_camera = persp.inverse @ screen_to_raster.inverse
    pt = lambda x, y: tf.transform_point(                     # noqa: E731
        raster_to_camera, torch.tensor([x, y, 0.0]))
    origin = pt(0.0, 0.0)
    return PerspectiveCamera(
        camera_to_world=camera_to_world, raster_to_camera=raster_to_camera,
        dx_camera=pt(1.0, 0.0) - origin, dy_camera=pt(0.0, 1.0) - origin,
        lens_radius=float(lens_radius), focal_dist=float(focal_dist))


def generate_rays(cam: PerspectiveCamera, px, py, lens_u, lens_v) -> Rays:
    """World-space rays with differentials for raster points (px, py) [N].
    ``lens_u/lens_v`` [N] are U[0,1) lens samples, used when the lens
    radius is > 0: the ray starts at a concentric-disk point of the lens
    and passes through the plane of focus; the differentials share its
    origin."""
    zero = torch.zeros_like(px)
    p_cam = tf.transform_point_v3(cam.raster_to_camera, V3(px, py, zero))
    d = normalize(p_cam)
    o = V3(zero, zero, zero)
    dxc = V3(*cam.dx_camera.tolist())
    dyc = V3(*cam.dy_camera.tolist())
    dx = normalize(p_cam + dxc)
    dy = normalize(p_cam + dyc)
    if cam.lens_radius > 0.0:
        lx, ly = concentric_sample_disk(lens_u, lens_v)
        p_lens = V3(cam.lens_radius * lx, cam.lens_radius * ly,
                    torch.zeros_like(lx))
        focus = lambda w: normalize(                          # noqa: E731
            w * (cam.focal_dist / w.z) - p_lens)
        o, d, dx, dy = p_lens, focus(d), focus(dx), focus(dy)
    o_w = tf.transform_point_v3(cam.camera_to_world, o)
    d_w = tf.transform_vector_v3(cam.camera_to_world, d)
    return Rays(o=o_w, d=d_w, t_max=torch.full_like(px, float("inf")),
                rx_o=o_w, rx_d=tf.transform_vector_v3(cam.camera_to_world, dx),
                ry_o=o_w, ry_d=tf.transform_vector_v3(cam.camera_to_world, dy))

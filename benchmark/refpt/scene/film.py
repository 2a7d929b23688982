# Frozen copy of fountain_tpu_torch/scene/film.py (commit 6354002): the benchmark's plain reference; edit never.
"""Film: channel-planar sample sums plus a weight plane (PyTorch).

Counterpart of ``fountain_tpu/scene/film.py``: the ``Film`` container,
``make_film``, the box, triangle and Gaussian reconstruction filters, the
scatter splat ``add_samples`` (samples at any raster position, each
filter tap an ``index_add_``), the lane-aligned splat
``add_samples_aligned`` (lane i is the sample of pixel lane_offset + i,
jittered within it, so every tap lands at a fixed pixel offset: a dense
shifted add instead of a scatter; a partial wave with a wide filter takes
the scatter splat) and ``finalize``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from refpt.core.vecmath import V3, where3
from refpt.device import resolve_device

FILTER_BOX = 0
FILTER_TRIANGLE = 1
FILTER_GAUSSIAN = 2


@dataclass
class Film:
    r_sum: torch.Tensor       # [H, W]
    g_sum: torch.Tensor       # [H, W]
    b_sum: torch.Tensor       # [H, W]
    weight_sum: torch.Tensor  # [H, W]


def make_film(xres: int, yres: int, device=None) -> Film:
    z = torch.zeros((yres, xres), dtype=torch.float32,
                    device=resolve_device(device))
    return Film(r_sum=z, g_sum=z, b_sum=z, weight_sum=z)


def filter_weight(ftype: int, radius: float, dx, dy):
    """Filter kernel value at offset (dx, dy) from the sample: the box is 1
    inside its support, the triangle a tent, the Gaussian pbrt's alpha = 2
    with its value at the radius subtracted."""
    ax, ay = dx.abs(), dy.abs()
    inside = (ax <= radius) & (ay <= radius)
    if ftype == FILTER_BOX:
        return torch.where(inside, 1.0, 0.0)
    if ftype == FILTER_TRIANGLE:
        w = (radius - ax).clamp_min(0.0) * (radius - ay).clamp_min(0.0)
    else:
        alpha = 2.0
        edge = math.exp(-alpha * radius * radius)
        gx = (torch.exp(-alpha * dx * dx) - edge).clamp_min(0.0)
        gy = (torch.exp(-alpha * dy * dy) - edge).clamp_min(0.0)
        w = gx * gy
    return torch.where(inside, w, 0.0)


def _support_taps(radius: float) -> int:
    """Half-width in pixels of the filter support around the sample's
    pixel: a pixel center at offset o is within ``radius`` of a sample in
    the base pixel iff |o| - 0.5 < radius."""
    return max(int(math.ceil(radius - 0.5 - 1e-6)), 0)


def _finite(radiance: V3):
    finite = torch.isfinite(radiance.x) & torch.isfinite(radiance.y) \
        & torch.isfinite(radiance.z)
    return finite, where3(finite, radiance, 0.0)


def _planes(film: Film):
    return [film.r_sum.reshape(-1), film.g_sum.reshape(-1),
            film.b_sum.reshape(-1), film.weight_sum.reshape(-1)]


def _film(planes, h: int, w: int) -> Film:
    r, g, b, ws = (p.reshape(h, w) for p in planes)
    return Film(r_sum=r, g_sum=g, b_sum=b, weight_sum=ws)


def add_samples(film: Film, px_f, py_f, radiance: V3,
                ftype: int = FILTER_BOX, radius: float = 0.5) -> Film:
    """Splat samples at continuous raster positions (px_f, py_f) [N]
    (pixel (x, y) covers [x, x + 1) x [y, y + 1)). Each tap of the filter
    window around the sample's pixel is one ``index_add_`` per plane; taps
    off the film and samples with a non-finite component add 0."""
    h, w = film.weight_sum.shape
    taps = _support_taps(radius)
    finite, radiance = _finite(radiance)
    planes = _planes(film)
    px0, py0 = torch.floor(px_f), torch.floor(py_f)
    for oy in range(-taps, taps + 1):
        for ox in range(-taps, taps + 1):
            px, py = px0 + ox, py0 + oy
            fw = filter_weight(ftype, radius, (px + 0.5) - px_f,
                               (py + 0.5) - py_f)
            inb = (px >= 0) & (px < w) & (py >= 0) & (py < h) & finite
            fw = torch.where(inb, fw, 0.0)
            idx = (py.clamp(0, h - 1) * w + px.clamp(0, w - 1)).long()
            planes = [p.index_add(0, idx, c) for p, c in zip(
                planes, (fw * radiance.x, fw * radiance.y, fw * radiance.z,
                         fw))]
    return _film(planes, h, w)


def add_samples_aligned(film: Film, frac_x, frac_y, radiance: V3,
                        ftype: int = FILTER_BOX, radius: float = 0.5,
                        lane_offset: int = 0) -> Film:
    """Splat one sample per pixel: lane i is the sample of pixel
    lane_offset + i in row-major order, jittered by (frac_x, frac_y) in
    [0, 1)^2. Samples with a non-finite component are dropped. A partial
    wave (fewer lanes than pixels, or an offset) with a filter wider than
    its pixel takes the scatter splat."""
    h, w = film.weight_sum.shape
    taps = _support_taps(radius)
    n = frac_x.shape[0]
    dev = frac_x.device
    if taps > 0 and (lane_offset != 0 or n != h * w):
        lane = lane_offset + torch.arange(n, device=dev)
        return add_samples(film, (lane % w).to(torch.float32) + frac_x,
                           torch.div(lane, w, rounding_mode="floor").to(
                               torch.float32) + frac_y,
                           radiance, ftype=ftype, radius=radius)
    finite, radiance = _finite(radiance)
    planes = _planes(film)
    lane = lane_offset + torch.arange(n, device=dev)
    px, py = lane % w, torch.div(lane, w, rounding_mode="floor")
    for oy in range(-taps, taps + 1):
        for ox in range(-taps, taps + 1):
            # offset of the tap pixel's center from the sample
            fw = filter_weight(ftype, radius, (ox + 0.5) - frac_x,
                               (oy + 0.5) - frac_y)
            inb = ((px + ox >= 0) & (px + ox < w) & (py + oy >= 0)
                   & (py + oy < h) & finite)
            fw = torch.where(inb, fw, 0.0)
            contrib = (fw * radiance.x, fw * radiance.y, fw * radiance.z,
                       fw)
            shift = oy * w + ox
            if n != h * w:
                # a partial wave (one tap): a dense add over its lanes'
                # own pixels
                planes = [torch.cat([p[:lane_offset],
                                     p[lane_offset:lane_offset + n] + c,
                                     p[lane_offset + n:]])
                          for p, c in zip(planes, contrib)]
            else:
                # full frame: target[j] = contrib[j - shift]; wrapped
                # lanes already have fw = 0 through the bounds mask
                planes = [p + (torch.roll(c, shift) if shift else c)
                          for p, c in zip(planes, contrib)]
    return _film(planes, h, w)


def finalize(film: Film) -> torch.Tensor:
    """Weight-normalized image [H, W, 3]."""
    inv = torch.where(film.weight_sum > 0.0,
                      1.0 / film.weight_sum.clamp_min(1e-12), 0.0)
    return torch.stack([film.r_sum * inv, film.g_sum * inv,
                        film.b_sum * inv], dim=-1)

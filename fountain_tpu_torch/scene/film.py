"""Film: channel-planar sample sums plus a weight plane (PyTorch).

Counterpart of ``fountain_tpu/scene/film.py``: the ``Film`` container,
``make_film``, the box reconstruction filter, the lane-aligned splat
``add_samples_aligned`` (lane i is the sample of pixel i, jittered within
it, so every filter tap lands at a fixed pixel offset: a dense shifted add
instead of a scatter) and ``finalize``. The triangle and Gaussian filters
and the splat of partial waves (the multi-device path) are not ported yet
and raise.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from fountain_tpu_torch.core.vecmath import V3, where3
from fountain_tpu_torch.device import resolve_device

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
    inside its support."""
    if ftype != FILTER_BOX:
        raise NotImplementedError(
            "only the box filter is ported to fountain_tpu_torch yet")
    inside = (dx.abs() <= radius) & (dy.abs() <= radius)
    return torch.where(inside, 1.0, 0.0)


def _support_taps(radius: float) -> int:
    """Half-width in pixels of the filter support around the sample's
    pixel: a pixel center at offset o is within ``radius`` of a sample in
    the base pixel iff |o| - 0.5 < radius."""
    return max(int(math.ceil(radius - 0.5 - 1e-6)), 0)


def add_samples_aligned(film: Film, frac_x, frac_y, radiance: V3,
                        ftype: int = FILTER_BOX, radius: float = 0.5) -> Film:
    """Splat one sample per pixel: lane i is the sample of pixel i in
    row-major order, jittered by (frac_x, frac_y) in [0, 1)^2. Samples
    with a non-finite component are dropped."""
    h, w = film.weight_sum.shape
    taps = _support_taps(radius)
    if frac_x.shape[0] != h * w:
        raise NotImplementedError(
            "the splat of a partial wave is not ported yet")
    finite = torch.isfinite(radiance.x) & torch.isfinite(radiance.y) \
        & torch.isfinite(radiance.z)
    radiance = where3(finite, radiance, 0.0)
    planes = [film.r_sum.reshape(-1), film.g_sum.reshape(-1),
              film.b_sum.reshape(-1), film.weight_sum.reshape(-1)]
    lane = torch.arange(h * w, device=frac_x.device)
    px, py = lane % w, torch.div(lane, w, rounding_mode="floor")
    for oy in range(-taps, taps + 1):
        for ox in range(-taps, taps + 1):
            # offset of the tap pixel's center from the sample
            fw = filter_weight(ftype, radius, (ox + 0.5) - frac_x,
                               (oy + 0.5) - frac_y)
            inb = ((px + ox >= 0) & (px + ox < w) & (py + oy >= 0)
                   & (py + oy < h) & finite)
            fw = torch.where(inb, fw, 0.0)
            # target[j] = contrib[j - shift]; wrapped lanes already have
            # fw = 0 through the bounds mask
            shift = oy * w + ox
            planes = [p + torch.roll(c, shift) for p, c in zip(
                planes, (fw * radiance.x, fw * radiance.y, fw * radiance.z,
                         fw))]
    r, g, b, ws = (p.reshape(h, w) for p in planes)
    return Film(r_sum=r, g_sum=g, b_sum=b, weight_sum=ws)


def finalize(film: Film) -> torch.Tensor:
    """Weight-normalized image [H, W, 3]."""
    inv = torch.where(film.weight_sum > 0.0,
                      1.0 / film.weight_sum.clamp_min(1e-12), 0.0)
    return torch.stack([film.r_sum * inv, film.g_sum * inv,
                        film.b_sum * inv], dim=-1)

"""Film container: channel-planar sums plus a weight plane (PyTorch).

Counterpart of the ``Film`` container and ``finalize`` of
``fountain_tpu/scene/film.py``. The reconstruction filters and splats are
not ported yet: the regeneration render fills the planes directly.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class Film:
    r_sum: torch.Tensor       # [H, W]
    g_sum: torch.Tensor       # [H, W]
    b_sum: torch.Tensor       # [H, W]
    weight_sum: torch.Tensor  # [H, W]


def finalize(film: Film) -> torch.Tensor:
    """Weight-normalized image [H, W, 3]."""
    inv = torch.where(film.weight_sum > 0.0,
                      1.0 / film.weight_sum.clamp_min(1e-12), 0.0)
    return torch.stack([film.r_sum * inv, film.g_sum * inv,
                        film.b_sum * inv], dim=-1)

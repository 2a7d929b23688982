# Frozen copy of fountain_tpu_torch/core/spectrum.py (commit 6354002): the benchmark's plain reference; edit never.
"""RGB spectrum helpers (PyTorch).

Counterpart of ``fountain_tpu/core/spectrum.py``: a spectrum is a
``[..., 3]`` tensor of linear RGB, so only the colour-science helpers live
here: XYZ <-> RGB (standard CIE sRGB primaries), luminance, the black and
max-component tests, and the sRGB transfer curve and its inverse.
"""
from __future__ import annotations

import numpy as np
import torch

# Row-vector matrices of the CIE sRGB primaries (as in the JAX package)
_XYZ_TO_RGB = np.array([
    [3.240479, -1.537150, -0.498535],
    [-0.969256, 1.875991, 0.041556],
    [0.055648, -0.204043, 1.057311],
], dtype=np.float32)

_RGB_TO_XYZ = np.array([
    [0.412453, 0.357580, 0.180423],
    [0.212671, 0.715160, 0.072169],
    [0.019334, 0.119193, 0.950227],
], dtype=np.float32)


def _apply(m: np.ndarray, v: torch.Tensor) -> torch.Tensor:
    return torch.einsum("ij,...j->...i",
                        torch.as_tensor(m, dtype=v.dtype, device=v.device), v)


def xyz_to_rgb(xyz: torch.Tensor) -> torch.Tensor:
    return _apply(_XYZ_TO_RGB, xyz)


def rgb_to_xyz(rgb: torch.Tensor) -> torch.Tensor:
    return _apply(_RGB_TO_XYZ, rgb)


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """The y component of XYZ."""
    return rgb_to_xyz(rgb)[..., 1]


def is_black(rgb: torch.Tensor) -> torch.Tensor:
    return (rgb == 0.0).all(dim=-1)


def max_component(rgb: torch.Tensor) -> torch.Tensor:
    return rgb.amax(dim=-1)


def gamma_correct(v: torch.Tensor) -> torch.Tensor:
    """sRGB encode."""
    return torch.where(v <= 0.0031308, 12.92 * v,
                       1.055 * v.clamp_min(1e-8).pow(1.0 / 2.4) - 0.055)


def inverse_gamma_correct(v: torch.Tensor) -> torch.Tensor:
    """sRGB decode."""
    return torch.where(v <= 0.04045, v / 12.92,
                       ((v + 0.055) / 1.055).pow(2.4))

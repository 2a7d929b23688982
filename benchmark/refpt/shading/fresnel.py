# Frozen copy of fountain_tpu_torch/shading/fresnel.py (commit 6354002): the benchmark's plain reference; edit never.
"""Fresnel reflectance: exact dielectric and per-channel conductor (PyTorch).

Counterpart of ``fountain_tpu/shading/fresnel.py``. Batched and
branch-free; ``cos_theta_i`` may be any sign (negative = exiting).
"""
from __future__ import annotations

import torch

from refpt.core.vecmath import V3


def fresnel_dielectric(cos_theta_i, eta_i, eta_t):
    """Unpolarized Fresnel reflectance at a dielectric boundary; the
    indices swap when ``cos_theta_i < 0`` (ray exiting). ``eta_i`` and
    ``eta_t`` are tensors or Python floats. Returns [N] in [0, 1]."""
    cos_i = cos_theta_i.clamp(-1.0, 1.0)
    entering = cos_i > 0.0
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    cos_i = cos_i.abs()

    # sqrt floors are 1e-36 (not 0): sqrt'(0) = inf leaks NaN gradients
    sin_i = torch.sqrt((1.0 - cos_i * cos_i).clamp_min(1e-36))
    sin_t = ei / et * sin_i
    tir = sin_t >= 1.0
    cos_t = torch.sqrt((1.0 - sin_t * sin_t).clamp_min(1e-36))

    r_parl = ((et * cos_i) - (ei * cos_t)) / \
        ((et * cos_i) + (ei * cos_t)).clamp_min(1e-20)
    r_perp = ((ei * cos_i) - (et * cos_t)) / \
        ((ei * cos_i) + (et * cos_t)).clamp_min(1e-20)
    fr = 0.5 * (r_parl * r_parl + r_perp * r_perp)
    return torch.where(tir, 1.0, fr)


def fresnel_conductor(cos_theta_i, eta_i: V3, eta_t: V3, k: V3) -> V3:
    """Conductor Fresnel with complex IOR ``eta_t + i k``, per RGB
    channel (pbrt's FrConductor). Returns a V3."""
    cos_i = cos_theta_i.abs().clamp(0.0, 1.0)
    cos2 = cos_i * cos_i
    sin2 = 1.0 - cos2

    def chan(ei, et, kk):
        eta = et / ei
        eta_k = kk / ei
        eta2 = eta * eta
        eta_k2 = eta_k * eta_k
        t0 = eta2 - eta_k2 - sin2
        a2_plus_b2 = torch.sqrt(
            (t0 * t0 + 4.0 * eta2 * eta_k2).clamp_min(1e-36))
        t1 = a2_plus_b2 + cos2
        a = torch.sqrt((0.5 * (a2_plus_b2 + t0)).clamp_min(1e-36))
        t2 = 2.0 * a * cos_i
        rs = (t1 - t2) / (t1 + t2).clamp_min(1e-20)
        t3 = cos2 * a2_plus_b2 + sin2 * sin2
        t4 = t2 * sin2
        rp = rs * (t3 - t4) / (t3 + t4).clamp_min(1e-20)
        return 0.5 * (rp + rs)

    return V3(chan(eta_i.x, eta_t.x, k.x), chan(eta_i.y, eta_t.y, k.y),
              chan(eta_i.z, eta_t.z, k.z))

# Frozen copy of fountain_tpu_torch/shading/microfacet.py (commit 6354002): the benchmark's plain reference; edit never.
"""Microfacet distributions: Trowbridge-Reitz (GGX) and Beckmann (PyTorch).

Counterpart of ``fountain_tpu/shading/microfacet.py``: D, Smith lambda
and G, and full-distribution half-vector sampling for both models, plus
the ``roughness_to_alpha`` remap. Everything is in the local shading
frame (z = shading normal); pdf = D(wh) |cos theta_h|. Every intermediate
is kept finite so that the backward pass stays NaN-free on lanes that a
``where`` masks out.
"""
from __future__ import annotations

import torch

from refpt.core.vecmath import PI, V3, clip, maximum, sqrt0

# --- local-frame trig helpers ----------------------------------------------


def cos_theta(w: V3):
    return w.z


def cos2_theta(w: V3):
    return w.z * w.z


def abs_cos_theta(w: V3):
    return w.z.abs()


def sin2_theta(w: V3):
    return maximum(1.0 - cos2_theta(w), 0.0)


def tan2_theta(w: V3):
    return sin2_theta(w) / cos2_theta(w).clamp_min(1e-20)


def cos_phi(w: V3):
    s2 = sin2_theta(w)
    s = torch.sqrt(s2.clamp_min(1e-36))
    return torch.where(s2 == 0.0, 1.0, clip(w.x / s, -1.0, 1.0))


def sin_phi(w: V3):
    s2 = sin2_theta(w)
    s = torch.sqrt(s2.clamp_min(1e-36))
    return torch.where(s2 == 0.0, 0.0, clip(w.y / s, -1.0, 1.0))


def same_hemisphere(a: V3, b: V3):
    return a.z * b.z > 0.0


def roughness_to_alpha(roughness):
    """pbrt's heuristic roughness -> alpha remap."""
    r = roughness.clamp_min(1e-3)
    x = torch.log(r)
    return (1.62142 + 0.819955 * x + 0.1734 * x * x
            + 0.0171201 * x ** 3 + 0.000640711 * x ** 4)


# --- Trowbridge-Reitz (GGX) -------------------------------------------------


def tr_d(wh: V3, ax, ay):
    """GGX normal distribution D(wh)."""
    c2 = cos2_theta(wh)
    ok = c2 > 1e-10
    c2s = torch.where(ok, c2, 1.0)
    t2 = sin2_theta(wh) / c2s
    e = ((cos_phi(wh) ** 2 / (ax * ax).clamp_min(1e-20)
          + sin_phi(wh) ** 2 / (ay * ay).clamp_min(1e-20)) * t2
         ).clamp_max(1e16)
    d = 1.0 / (PI * (ax * ay).clamp_min(1e-20) * c2s * c2s
               * (1.0 + e) ** 2).clamp_min(1e-30)
    return torch.where(ok, d, 0.0)


def tr_lambda(w: V3, ax, ay):
    c2 = cos2_theta(w)
    ok = c2 > 1e-10
    t2 = sin2_theta(w) / torch.where(ok, c2, 1.0)
    alpha2 = cos_phi(w) ** 2 * ax * ax + sin_phi(w) ** 2 * ay * ay
    a2t2 = (alpha2 * t2).clamp_max(1e30)
    lam = (-1.0 + torch.sqrt(1.0 + a2t2)) / 2.0
    return torch.where(ok, lam, 0.0)


def tr_sample_wh(u1, u2, ax, ay) -> V3:
    """Full-NDF GGX half-vector sampling; the anisotropic branch uses the
    pole-free ellipse parameterization phi = atan2(ay sin t, ax cos t),
    t = 2 pi u2, as the JAX package does."""
    iso = ax == ay
    phi_i = (2.0 * PI) * u2
    t = 2.0 * PI * u2
    cx = ax.clamp_min(1e-20) * torch.cos(t)
    sy = ay.clamp_min(1e-20) * torch.sin(t)
    inv_n = 1.0 / torch.sqrt((cx * cx + sy * sy).clamp_min(1e-40))
    cp = cx * inv_n
    sp = sy * inv_n
    alpha2 = 1.0 / (cp * cp / (ax * ax).clamp_min(1e-20)
                    + sp * sp / (ay * ay).clamp_min(1e-20)).clamp_min(1e-20)
    tan2_i = ax * ax * u1 / (1.0 - u1).clamp_min(1e-9)
    tan2_a = alpha2 * u1 / (1.0 - u1).clamp_min(1e-9)

    cos_phi_v = torch.where(iso, torch.cos(phi_i), cp)
    sin_phi_v = torch.where(iso, torch.sin(phi_i), sp)
    tan2 = torch.where(iso, tan2_i, tan2_a)
    cos_t = 1.0 / torch.sqrt(1.0 + tan2)
    sin_t = sqrt0(1.0 - cos_t * cos_t)
    return V3(sin_t * cos_phi_v, sin_t * sin_phi_v, cos_t)


# --- Beckmann ---------------------------------------------------------------


def beckmann_d(wh: V3, ax, ay):
    c2 = cos2_theta(wh)
    ok = c2 > 1e-10
    c2s = torch.where(ok, c2, 1.0)
    t2 = sin2_theta(wh) / c2s
    expo = (t2 * (cos_phi(wh) ** 2 / (ax * ax).clamp_min(1e-20)
                  + sin_phi(wh) ** 2 / (ay * ay).clamp_min(1e-20))
            ).clamp_max(88.0)
    d = torch.exp(-expo) / (PI * (ax * ay).clamp_min(1e-20) * c2s * c2s
                            ).clamp_min(1e-30)
    return torch.where(ok, d, 0.0)


def beckmann_lambda(w: V3, ax, ay):
    c2 = cos2_theta(w)
    ok = c2 > 1e-10
    t2 = sin2_theta(w) / torch.where(ok, c2, 1.0)
    abs_tan = torch.sqrt(t2.clamp_min(1e-36))
    alpha = torch.sqrt((cos_phi(w) ** 2 * ax * ax
                        + sin_phi(w) ** 2 * ay * ay).clamp_min(1e-36))
    a = 1.0 / (alpha * abs_tan).clamp_min(1e-20)
    lam = torch.where(
        a >= 1.6, 0.0,
        (1.0 - 1.259 * a + 0.396 * a * a)
        / (3.535 * a + 2.181 * a * a).clamp_min(1e-20))
    return torch.where(ok, lam, 0.0)


def beckmann_sample_wh(u1, u2, ax, ay) -> V3:
    """Full-NDF Beckmann sampling (isotropic, and pbrt's anisotropic
    log-space form)."""
    iso = ax == ay
    log_u = torch.log((1.0 - u1).clamp_min(1e-9))
    tan2_i = -ax * ax * log_u
    phi_i = u2 * 2.0 * PI

    phi_a = torch.arctan(ay / ax.clamp_min(1e-20)
                         * torch.tan(2.0 * PI * u2 + 0.5 * PI))
    phi_a = torch.where(u2 > 0.5, phi_a + PI, phi_a)
    sp, cp = torch.sin(phi_a), torch.cos(phi_a)
    tan2_a = -log_u / (cp * cp / (ax * ax).clamp_min(1e-20)
                       + sp * sp / (ay * ay).clamp_min(1e-20)
                       ).clamp_min(1e-20)

    phi = torch.where(iso, phi_i, phi_a)
    tan2 = torch.where(iso, tan2_i, tan2_a)
    cos_t = 1.0 / torch.sqrt(1.0 + tan2)
    sin_t = sqrt0(1.0 - cos_t * cos_t)
    return V3(sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t)


# --- shared G / pdf ---------------------------------------------------------


def smith_g1(lam):
    return 1.0 / (1.0 + lam)


def smith_g(lam_wo, lam_wi):
    return 1.0 / (1.0 + lam_wo + lam_wi)


def mf_pdf(d_wh, wh: V3):
    """Full-NDF sampling pdf D(wh) |cos theta_h|."""
    return d_wh * abs_cos_theta(wh)

"""Matte BSDF evaluation and sampling over the wavefront (PyTorch).

Counterpart of the matte parts of ``fountain_tpu/shading/bsdf.py``: the
packed shading table and ``gather_shading``, the local frame, Lambert and
Oren–Nayar reflection, and the matte ``bsdf_f_pdf`` / ``bsdf_sample`` /
``has_non_specular``. The other four material models are not ported yet;
scenes that use them are refused at setup (``scene.build``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from fountain_tpu_torch.core.sampling import cosine_sample_hemisphere
from fountain_tpu_torch.core.vecmath import INV_PI, V3, dot, where3
from fountain_tpu_torch.geometry.intersect import Hit
from fountain_tpu_torch.scene.types import MAT_MATTE, TEX_IMAGE, TEX_UV, Scene


@dataclass
class ShadeParams:
    """Per-lane shading parameters after texture evaluation (matte)."""
    mtype: torch.Tensor  # [N] int32 (-1 = null bsdf)
    kd: V3
    sigma: torch.Tensor  # [N] Oren-Nayar sigma (degrees)


_SLOT0 = 12        # first texture-slot column
_SLOT_W = 12       # columns per texture slot
_N_SLOTS = 7       # kd ks kr kt sigma rough_u rough_v
_SLOT_KD = 0
_SLOT_SIGMA = 4


def _shading_table(scene: Scene) -> torch.Tensor:
    """[M, 96] packed per-material row: material constants plus the
    descriptor of each of its 7 texture slots.

    Layout: 0 mtype | 1 eta | 2:5 eta3 | 5:8 k3 | 8 remap | 9:12 pad, then
    per slot s at 12+12s: 0 ttype | 1:4 value | 4:6 uv_scale |
    6:8 uv_offset | 8 image_id | 9 tid | 10:12 pad. Int fields are stored
    as float values; only ``textures.value`` (and the material scalars)
    stay attached, so gradients reach the texture table through it.
    """
    m, tex = scene.materials, scene.textures
    f32 = torch.float32
    zeros = torch.zeros((m.count, 1), dtype=f32, device=tex.value.device)
    head = torch.cat([m.mtype.to(f32)[:, None], m.eta[:, None], m.eta3,
                      m.k3, m.remap_roughness.to(f32)[:, None],
                      zeros, zeros, zeros], dim=1)
    tids = torch.stack([m.kd_tex, m.ks_tex, m.kr_tex, m.kt_tex, m.sigma_tex,
                        m.rough_u_tex, m.rough_v_tex], dim=1)  # [M, 7]
    t = tids.clamp(0, max(tex.count - 1, 0)).long()
    z = zeros[:, None, :].expand(-1, _N_SLOTS, 1)
    slots = torch.cat([
        tex.ttype[t].to(f32)[..., None], tex.value[t],
        tex.uv_scale[t].detach(), tex.uv_offset[t].detach(),
        tex.image_id[t].to(f32)[..., None], t.to(f32)[..., None], z, z],
        dim=2)                                                 # [M, 7, 12]
    return torch.cat([head, slots.reshape(m.count, _N_SLOTS * _SLOT_W)],
                     dim=1)


def gather_shading(scene: Scene, hit: Hit, tex_width=None) -> ShadeParams:
    """Evaluate the material table + textures at the hit points.
    ``tex_width`` [N] is the uv-space ray-cone footprint for mipmapping."""
    mid = hit.mat_id.clamp(0, max(scene.materials.count - 1, 0))
    rows = _shading_table(scene)[mid]
    col = lambda k: rows[:, k]                                # noqa: E731
    ib = lambda k: rows[:, k].detach().to(torch.int32)        # noqa: E731
    tex_lookup = None
    if scene.env_images is not None:
        from fountain_tpu_torch.shading.mipmap import lookup_trilinear
        atlas = scene.env_images
        tex_lookup = lambda iid, u, v, w=None: lookup_trilinear(  # noqa
            atlas, iid, u, v, w)

    def eval_slot(s):
        off = _SLOT0 + _SLOT_W * s
        ttype = ib(off + 0)
        su, sv = col(off + 4), col(off + 5)
        du, dv = col(off + 6), col(off + 7)
        u = hit.u * su + du
        v = hit.v * sv + dv
        out = V3(col(off + 1), col(off + 2), col(off + 3))   # constant
        uv_rgb = V3(u - torch.floor(u), v - torch.floor(v),
                    torch.zeros_like(u))
        out = where3(ttype == TEX_UV, uv_rgb, out)
        if tex_lookup is not None:
            w = None if tex_width is None \
                else tex_width * torch.maximum(su, sv)
            img = tex_lookup(ib(off + 8), u, v, w)
            out = where3(ttype == TEX_IMAGE, img, out)
        return out

    return ShadeParams(
        mtype=torch.where(hit.mat_id >= 0, ib(0), -1).to(torch.int32),
        kd=eval_slot(_SLOT_KD), sigma=eval_slot(_SLOT_SIGMA).x)


# --- frame conversion ------------------------------------------------------


def world_to_local(hit: Hit, v: V3) -> V3:
    return V3(dot(v, hit.ss), dot(v, hit.ts), dot(v, hit.ns))


def local_to_world(hit: Hit, v: V3) -> V3:
    return hit.ss * v.x + hit.ts * v.y + hit.ns * v.z


# --- local-frame trig helpers (fountain_tpu/shading/microfacet.py) ---------


def _sin2_theta(w: V3):
    return (1.0 - w.z * w.z).clamp_min(0.0)


def _cos_phi(w: V3):
    s = torch.sqrt(_sin2_theta(w).clamp_min(1e-36))
    return torch.where(_sin2_theta(w) == 0.0, 1.0,
                       (w.x / s).clamp(-1.0, 1.0))


def _sin_phi(w: V3):
    s = torch.sqrt(_sin2_theta(w).clamp_min(1e-36))
    return torch.where(_sin2_theta(w) == 0.0, 0.0,
                       (w.y / s).clamp(-1.0, 1.0))


# --- matte lobes -----------------------------------------------------------


def _oren_nayar_f(kd: V3, sigma_deg, wo: V3, wi: V3) -> V3:
    """Oren-Nayar qualitative model."""
    sigma = torch.deg2rad(sigma_deg)
    s2 = sigma * sigma
    a = 1.0 - s2 / (2.0 * (s2 + 0.33))
    b = 0.45 * s2 / (s2 + 0.09)
    sin_ti = torch.sqrt(_sin2_theta(wi).clamp_min(1e-36))
    sin_to = torch.sqrt(_sin2_theta(wo).clamp_min(1e-36))
    cos_d_phi = _cos_phi(wi) * _cos_phi(wo) + _sin_phi(wi) * _sin_phi(wo)
    max_cos = torch.where((sin_ti > 1e-4) & (sin_to > 1e-4),
                          cos_d_phi.clamp_min(0.0), 0.0)
    abs_ci = wi.z.abs()
    abs_co = wo.z.abs()
    sin_alpha = torch.where(abs_ci > abs_co, sin_to, sin_ti)
    tan_beta = torch.where(abs_ci > abs_co,
                           sin_ti / abs_ci.clamp_min(1e-6),
                           sin_to / abs_co.clamp_min(1e-6))
    return kd * (INV_PI * (a + b * max_cos * sin_alpha * tan_beta))


def bsdf_f_pdf(sp: ShadeParams, wo: V3, wi: V3):
    """Non-specular f and pdf (local frame): matte Lambert/Oren-Nayar;
    zero for lanes without a matte material."""
    same = wo.z * wi.z > 0.0
    f_lam = sp.kd * INV_PI
    f_on = _oren_nayar_f(sp.kd, sp.sigma, wo, wi)
    f = where3(sp.sigma == 0.0, f_lam, f_on)
    pdf = wi.z.abs() * INV_PI
    matte = sp.mtype == MAT_MATTE
    return (where3(matte, where3(same, f, 0.0), 0.0),
            torch.where(matte, torch.where(same, pdf, 0.0), 0.0))


def has_non_specular(sp: ShadeParams):
    """NEE gate: the lane's material has a non-specular lobe."""
    return sp.mtype == MAT_MATTE


@dataclass
class BsdfSample:
    wi: V3                     # local frame
    f: V3
    pdf: torch.Tensor
    is_specular: torch.Tensor  # [N] bool
    valid: torch.Tensor        # [N] bool


def bsdf_sample(sp: ShadeParams, wo: V3, u_lobe, u1, u2) -> BsdfSample:
    """Sample a continuation direction (matte: cosine hemisphere on wo's
    side). The sampled direction is detached (detached-sampling
    estimator); f and pdf at it stay attached to the parameters."""
    wi = cosine_sample_hemisphere(u1, u2)
    wi = where3(wo.z < 0.0, V3(wi.x, wi.y, -wi.z), wi)
    wi = V3(wi.x.detach(), wi.y.detach(), wi.z.detach())
    f, pdf = bsdf_f_pdf(sp, wo, wi)
    return BsdfSample(wi=wi, f=f, pdf=pdf,
                      is_specular=torch.zeros_like(pdf, dtype=torch.bool),
                      valid=(sp.mtype >= 0) & (pdf > 0.0))

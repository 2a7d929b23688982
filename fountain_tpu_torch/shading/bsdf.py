"""BSDF evaluation and sampling over the wavefront: all five materials.

Counterpart of ``fountain_tpu/shading/bsdf.py``: the packed shading
table and ``gather_shading`` (textures evaluated at the hit, with the
checker/scale walk for nested slots), the local frame, and the matte,
mirror, glass (smooth and rough), metal and plastic models.
``bsdf_f_pdf`` sums the non-specular lobes; ``bsdf_sample`` builds every
candidate direction and selects one per lane by material type and a
uniform lobe pick, so a lane draws the same random numbers as in the JAX
package. The sampled direction is detached under the detached-sampling
estimator and attached otherwise; f and pdf at it stay attached to the
material and texture tables. Gathers of those tables are
``gather.gather_rows`` (``index_select``; on a card under autograd its
backward is the ``scatter_rows`` kernel).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from fountain_tpu_torch.core.gather import gather_rows
from fountain_tpu_torch.core.sampling import cosine_sample_hemisphere
from fountain_tpu_torch.core.vecmath import (INV_PI, V3, dot, normalize,
                                             refract, where3)
from fountain_tpu_torch.geometry.intersect import Hit
from fountain_tpu_torch.scene.types import (ALL_MATERIALS, MAT_GLASS,
                                            MAT_MATTE, MAT_METAL, MAT_MIRROR,
                                            MAT_PLASTIC, TEX_CHECKER,
                                            TEX_IMAGE, TEX_SCALE, TEX_UV,
                                            Scene)
from fountain_tpu_torch.shading import microfacet as mf
from fountain_tpu_torch.shading.fresnel import (fresnel_conductor,
                                                fresnel_dielectric)
from fountain_tpu_torch.shading.textures import eval_texture


@dataclass
class ShadeParams:
    """Per-lane shading parameters after texture evaluation."""
    mtype: torch.Tensor    # [N] int32 (-1 = null bsdf)
    kd: V3
    ks: V3
    kr: V3
    kt: V3
    sigma: torch.Tensor    # [N] Oren-Nayar sigma (degrees)
    eta: torch.Tensor      # [N] dielectric ior
    eta3: V3               # conductor ior
    k3: V3                 # conductor absorption
    alpha_u: torch.Tensor  # [N] microfacet alpha (after the remap)
    alpha_v: torch.Tensor
    rough_raw: torch.Tensor  # [N] roughness before the remap (0: smooth)
    # material types that lanes may have (host-side): the lobes and
    # sampling candidates of other types are not built
    present: frozenset = ALL_MATERIALS

    def has(self, *types) -> bool:
        return not self.present.isdisjoint(types)


_SLOT0 = 12        # first texture-slot column
_SLOT_W = 12       # columns per texture slot
_N_SLOTS = 7       # kd ks kr kt sigma rough_u rough_v


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
    t = tids.clamp(0, max(tex.count - 1, 0)).reshape(-1)
    rows = lambda a: gather_rows(a, t).reshape(  # noqa: E731
        m.count, _N_SLOTS, -1)
    z = zeros[:, None, :].expand(-1, _N_SLOTS, 1)
    slots = torch.cat([
        rows(tex.ttype[:, None]).to(f32), rows(tex.value),
        rows(tex.uv_scale).detach(), rows(tex.uv_offset).detach(),
        rows(tex.image_id[:, None]).to(f32),
        t.reshape(m.count, _N_SLOTS, 1).to(f32), z, z], dim=2)  # [M, 7, 12]
    return torch.cat([head, slots.reshape(m.count, _N_SLOTS * _SLOT_W)],
                     dim=1)


def shading_rows(scene: Scene, mat_id) -> torch.Tensor:
    """[N, 96] shading-table rows of per-lane material ids, by
    ``gather_rows``."""
    mid = mat_id.clamp(0, max(scene.materials.count - 1, 0))
    return gather_rows(_shading_table(scene), mid)


def gather_shading(scene: Scene, hit: Hit, tex_width=None) -> ShadeParams:
    """Evaluate the material table + textures at the hit points.

    One [N, 96] ``gather_rows`` of the packed shading table resolves the
    material constants and every constant/uv/image slot; slots whose
    texture is a checker or scale graph take the ``eval_texture`` walk
    (only in scenes that have one). A slot that no material type of the
    scene reads is not evaluated (zeros). ``tex_width`` [N] is the
    uv-space ray-cone footprint for mipmapping."""
    rows = shading_rows(scene, hit.mat_id)
    col = lambda k: rows[:, k]                                # noqa: E731
    ib = lambda k: rows[:, k].detach().to(torch.int32)        # noqa: E731
    tex = scene.textures
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
        if tex.has_nested:
            nested = (ttype == TEX_CHECKER) | (ttype == TEX_SCALE)
            full = eval_texture(tex, ib(off + 9), hit.u, hit.v,
                                tex_lookup=tex_lookup, width=tex_width)
            out = where3(nested, full, out)
        return out

    present = scene.materials.present
    zero = torch.zeros_like(hit.u)
    slot = lambda s, *types: eval_slot(s) if not present.isdisjoint(  # noqa
        types) else V3(zero, zero, zero)
    rough_u = slot(5, MAT_GLASS, MAT_METAL, MAT_PLASTIC).x
    rough_v = slot(6, MAT_GLASS, MAT_METAL, MAT_PLASTIC).x
    remap = col(8) > 0.5
    return ShadeParams(
        mtype=torch.where(hit.mat_id >= 0, ib(0), -1).to(torch.int32),
        kd=slot(0, MAT_MATTE, MAT_PLASTIC), ks=slot(1, MAT_PLASTIC),
        kr=slot(2, MAT_MIRROR, MAT_GLASS), kt=slot(3, MAT_GLASS),
        sigma=slot(4, MAT_MATTE).x, eta=col(1),
        eta3=V3(col(2), col(3), col(4)), k3=V3(col(5), col(6), col(7)),
        alpha_u=torch.where(remap, mf.roughness_to_alpha(rough_u), rough_u),
        alpha_v=torch.where(remap, mf.roughness_to_alpha(rough_v), rough_v),
        rough_raw=torch.maximum(rough_u, rough_v), present=present)


# --- frame conversion ------------------------------------------------------


def world_to_local(hit: Hit, v: V3) -> V3:
    return V3(dot(v, hit.ss), dot(v, hit.ts), dot(v, hit.ns))


def local_to_world(hit: Hit, v: V3) -> V3:
    return hit.ss * v.x + hit.ts * v.y + hit.ns * v.z


# --- lobe models (local frame) ---------------------------------------------


def _oren_nayar_f(kd: V3, sigma_deg, wo: V3, wi: V3) -> V3:
    """Oren-Nayar qualitative model."""
    sigma = torch.deg2rad(sigma_deg)
    s2 = sigma * sigma
    a = 1.0 - s2 / (2.0 * (s2 + 0.33))
    b = 0.45 * s2 / (s2 + 0.09)
    sin_ti = torch.sqrt(mf.sin2_theta(wi).clamp_min(1e-36))
    sin_to = torch.sqrt(mf.sin2_theta(wo).clamp_min(1e-36))
    cos_d_phi = (mf.cos_phi(wi) * mf.cos_phi(wo)
                 + mf.sin_phi(wi) * mf.sin_phi(wo))
    max_cos = torch.where((sin_ti > 1e-4) & (sin_to > 1e-4),
                          cos_d_phi.clamp_min(0.0), 0.0)
    abs_ci = mf.abs_cos_theta(wi)
    abs_co = mf.abs_cos_theta(wo)
    sin_alpha = torch.where(abs_ci > abs_co, sin_to, sin_ti)
    tan_beta = torch.where(abs_ci > abs_co,
                           sin_ti / abs_ci.clamp_min(1e-6),
                           sin_to / abs_co.clamp_min(1e-6))
    return kd * (INV_PI * (a + b * max_cos * sin_alpha * tan_beta))


def _microfacet_reflection_f(ks: V3, fresnel_fn, wo: V3, wi: V3, ax,
                             ay) -> V3:
    """Torrance-Sparrow reflection; ``fresnel_fn(cos_i) -> V3``."""
    cos_o = mf.abs_cos_theta(wo)
    cos_i = mf.abs_cos_theta(wi)
    wh = wi + wo
    degen = (cos_i == 0.0) | (cos_o == 0.0) | (dot(wh, wh) == 0.0)
    wh = normalize(wh)
    f_term = fresnel_fn(dot(wi, where3(wh.z < 0, -wh, wh)))
    d = mf.tr_d(wh, ax, ay)
    g = mf.smith_g(mf.tr_lambda(wo, ax, ay), mf.tr_lambda(wi, ax, ay))
    val = ks * f_term * (d * g / (4.0 * cos_i * cos_o).clamp_min(1e-8))
    return where3(degen, 0.0, val)


def _microfacet_reflection_pdf(wo: V3, wi: V3, ax, ay):
    wh = normalize(wi + wo)
    same = mf.same_hemisphere(wo, wi)
    pdf_wh = mf.mf_pdf(mf.tr_d(wh, ax, ay), wh)
    pdf = pdf_wh / (4.0 * dot(wo, wh)).clamp_min(1e-8)
    return torch.where(same & (dot(wo, wh) > 0), pdf, 0.0)


def _microfacet_transmission_f(kt: V3, eta_a, eta_b, wo: V3, wi: V3,
                               ax, ay) -> V3:
    """pbrt's rough transmission (radiance transport: no eta^2 factor)."""
    same = mf.same_hemisphere(wo, wi)
    cos_o = mf.cos_theta(wo)
    cos_i = mf.cos_theta(wi)
    eta = torch.where(cos_o > 0.0, eta_b / eta_a, eta_a / eta_b)
    wh = normalize(wo + wi * eta)
    wh = where3(wh.z < 0.0, -wh, wh)
    f_term = fresnel_dielectric(dot(wo, wh), eta_a, eta_b)
    sqrt_denom = dot(wo, wh) + eta * dot(wi, wh)
    d = mf.tr_d(wh, ax, ay)
    g = mf.smith_g(mf.tr_lambda(wo, ax, ay), mf.tr_lambda(wi, ax, ay))
    val = (d * g * dot(wi, wh).abs() * dot(wo, wh).abs()
           / ((cos_i * cos_o).abs() * sqrt_denom ** 2).clamp_min(1e-8))
    ok = (~same) & (cos_i != 0.0) & (cos_o != 0.0)
    return where3(ok, kt * ((1.0 - f_term) * val), 0.0)


def _microfacet_transmission_pdf(eta_a, eta_b, wo: V3, wi: V3, ax, ay):
    same = mf.same_hemisphere(wo, wi)
    cos_o = mf.cos_theta(wo)
    eta = torch.where(cos_o > 0.0, eta_b / eta_a, eta_a / eta_b)
    wh = normalize(wo + wi * eta)
    sqrt_denom = dot(wo, wh) + eta * dot(wi, wh)
    dwh_dwi = ((eta * eta * dot(wi, wh))
               / (sqrt_denom * sqrt_denom).clamp_min(1e-12)).abs()
    pdf_wh = mf.mf_pdf(mf.tr_d(where3(wh.z < 0, -wh, wh), ax, ay), wh)
    return torch.where(same, 0.0, pdf_wh * dwh_dwi)


# --- per-material f / pdf --------------------------------------------------


def _matte_f_pdf(sp: ShadeParams, wo, wi):
    same = mf.same_hemisphere(wo, wi)
    f_lam = sp.kd * INV_PI
    f_on = _oren_nayar_f(sp.kd, sp.sigma, wo, wi)
    f = where3(sp.sigma == 0.0, f_lam, f_on)
    pdf = mf.abs_cos_theta(wi) * INV_PI
    return where3(same, f, 0.0), torch.where(same, pdf, 0.0)


def _metal_f_pdf(sp: ShadeParams, wo, wi):
    one = torch.ones_like(sp.eta)
    one3 = V3(one, one, one)
    same = mf.same_hemisphere(wo, wi)
    f = _microfacet_reflection_f(
        one3, lambda ci: fresnel_conductor(ci, one3, sp.eta3, sp.k3),
        wo, wi, sp.alpha_u, sp.alpha_v)
    pdf = _microfacet_reflection_pdf(wo, wi, sp.alpha_u, sp.alpha_v)
    return where3(same, f, 0.0), pdf


def _plastic_f_pdf(sp: ShadeParams, wo, wi):
    same = mf.same_hemisphere(wo, wi)

    def fr_d(ci):
        v = fresnel_dielectric(ci, 1.5, 1.0)
        return V3(v, v, v)
    f_spec = _microfacet_reflection_f(sp.ks, fr_d, wo, wi,
                                      sp.alpha_u, sp.alpha_u)
    f = sp.kd * INV_PI + f_spec
    pdf_l = mf.abs_cos_theta(wi) * INV_PI
    pdf_m = _microfacet_reflection_pdf(wo, wi, sp.alpha_u, sp.alpha_u)
    pdf = 0.5 * (pdf_l + pdf_m)
    return where3(same, f, 0.0), torch.where(same, pdf, 0.0)


def _glass_rough_f_pdf(sp: ShadeParams, wo, wi):
    def fr(ci):
        v = fresnel_dielectric(ci, 1.0, sp.eta)
        return V3(v, v, v)
    one = torch.ones_like(sp.eta)
    f_r = _microfacet_reflection_f(sp.kr, fr, wo, wi, sp.alpha_u,
                                   sp.alpha_v)
    f_t = _microfacet_transmission_f(sp.kt, one, sp.eta, wo, wi,
                                     sp.alpha_u, sp.alpha_v)
    f = where3(mf.same_hemisphere(wo, wi), f_r, f_t)
    pdf_r = _microfacet_reflection_pdf(wo, wi, sp.alpha_u, sp.alpha_v)
    pdf_t = _microfacet_transmission_pdf(one, sp.eta, wo, wi, sp.alpha_u,
                                         sp.alpha_v)
    return f, 0.5 * (pdf_r + pdf_t)


def bsdf_f_pdf(sp: ShadeParams, wo: V3, wi: V3):
    """Non-specular f and pdf for NEE/MIS (local frame); specular lobes
    (mirror, smooth glass) contribute nothing. Returns (f V3, pdf [N])."""
    zero = torch.zeros_like(sp.eta)
    f, pdf = V3(zero, zero, zero), zero
    for mtype, fn in ((MAT_MATTE, _matte_f_pdf),
                      (MAT_METAL, _metal_f_pdf),
                      (MAT_PLASTIC, _plastic_f_pdf),
                      (MAT_GLASS, _glass_rough_f_pdf)):
        if not sp.has(mtype):
            continue
        fi, pi = fn(sp, wo, wi)
        sel = sp.mtype == mtype
        if mtype == MAT_GLASS:           # smooth glass is specular only
            sel = sel & (sp.rough_raw > 0.0)
        f = where3(sel, fi, f)
        pdf = torch.where(sel, pi, pdf)
    return f, pdf


def has_non_specular(sp: ShadeParams):
    """NEE gate: the lane's material has a non-specular lobe."""
    return ((sp.mtype == MAT_MATTE) | (sp.mtype == MAT_METAL)
            | (sp.mtype == MAT_PLASTIC)
            | ((sp.mtype == MAT_GLASS) & (sp.rough_raw > 0.0)))


@dataclass
class BsdfSample:
    wi: V3                     # local frame
    f: V3
    pdf: torch.Tensor
    is_specular: torch.Tensor  # [N] bool
    valid: torch.Tensor        # [N] bool


def bsdf_sample(sp: ShadeParams, wo: V3, u_lobe, u1, u2,
                detach_wi: bool = True) -> BsdfSample:
    """Sample a continuation direction (local frame).

    Candidates: the cosine hemisphere on wo's side, the GGX half-vector
    reflection, the mirror direction, specular refraction and GGX
    refraction; the material type and the lobe pick ``u_lobe < 0.5``
    (two-lobe materials) select one. ``detach_wi`` (the detached
    estimator) severs the sampled direction; without it the chain
    u -> wh(alpha) -> wi stays attached, so gradients of the lobe's shape
    (roughness) flow through the direction too."""
    mtype = sp.mtype
    pick_first = u_lobe < 0.5
    c = cosine_sample_hemisphere(u1, u2)
    wi_cos = where3(wo.z < 0.0, V3(c.x, c.y, -c.z), c)   # on wo's side
    wi = wi_cos                                          # matte
    wi_mirror = V3(-wo.x, -wo.y, wo.z)
    is_mirror = mtype == MAT_MIRROR
    if sp.has(MAT_MIRROR):
        wi = where3(is_mirror, wi_mirror, wi)
    if sp.has(MAT_METAL, MAT_PLASTIC, MAT_GLASS):        # GGX reflection
        wh = mf.tr_sample_wh(u1, u2, sp.alpha_u, sp.alpha_v)
        wh_f = where3(wo.z < 0.0, -wh, wh)               # wo's side
        wi_mf = normalize(wh_f * (2.0 * dot(wo, wh_f)) - wo)
        wi = where3(mtype == MAT_METAL, wi_mf, wi)
        wi = where3(mtype == MAT_PLASTIC, where3(pick_first, wi_cos, wi_mf),
                    wi)
    is_glass = mtype == MAT_GLASS
    glass_rough = is_glass & (sp.rough_raw > 0.0)
    glass_smooth = is_glass & (sp.rough_raw == 0.0)
    if sp.has(MAT_GLASS):
        entering = wo.z > 0.0
        zer = torch.zeros_like(wo.z)
        nloc = V3(zer, zer, torch.where(entering, 1.0, -1.0))
        wi_refr, refr_ok = refract(
            wo, nloc, torch.where(entering, 1.0 / sp.eta, sp.eta))
        wi_refr = normalize(wi_refr)
        eta_t = torch.where(mf.cos_theta(wo) > 0.0, 1.0 / sp.eta, sp.eta)
        wi_mft, mft_ok = refract(
            wo, where3(dot(wo, wh_f) < 0, -wh_f, wh_f), eta_t)
        wi_mft = normalize(wi_mft)
        wi = where3(glass_smooth, where3(pick_first, wi_mirror, wi_refr), wi)
        wi = where3(glass_rough, where3(pick_first, wi_mf, wi_mft), wi)
    if detach_wi:
        wi = V3(wi.x.detach(), wi.y.detach(), wi.z.detach())

    safe_ci = mf.abs_cos_theta(wi).clamp_min(1e-8)
    f, pdf = bsdf_f_pdf(sp, wo, wi)
    if sp.has(MAT_MIRROR):
        f = where3(is_mirror, sp.kr * (1.0 / safe_ci), f)
        pdf = torch.where(is_mirror, 1.0, pdf)
    valid = sp.mtype >= 0
    if sp.has(MAT_GLASS):
        fr_d = fresnel_dielectric(mf.cos_theta(wo), 1.0, sp.eta)
        f = where3(glass_smooth, where3(
            pick_first, sp.kr * (fr_d / safe_ci),
            sp.kt * ((1.0 - fr_d) / safe_ci)), f)
        pdf = torch.where(glass_smooth, 0.5, pdf)
        valid = valid & torch.where(glass_smooth & ~pick_first, refr_ok,
                                    True)
        valid = valid & torch.where(glass_rough & ~pick_first, mft_ok, True)
    return BsdfSample(wi=wi, f=f, pdf=pdf,
                      is_specular=is_mirror | glass_smooth,
                      valid=valid & (pdf > 0.0))

"""Light emission, sampling and pdf queries (PyTorch).

Counterpart of ``fountain_tpu/lights/lights.py``: area emission at hits
(spheres and mesh faces, through ``hit.light_id``), the environment
radiance of escaped rays, and every light type's branch of
``sample_light`` and ``light_pdf``: point (1 / r^2 falloff), distant
(endpoint past the scene bounds), infinite (uniform sphere, or the
per-light env-map alias table), sphere area lights (uniform point on the
sphere, pdf at the first hit along wi) and mesh area lights (a face drawn
by the light's alias rows of ``Scene.light_tri``, in SceneBuilder's
original face order, then a uniform point on it; the pdf of a direction
comes from the traced hit along it). Every lane carries its own light
index, and each type's result is selected per lane; a branch is built
only when the scene holds that type (``Lights.present``), which gives
the same values on every lane, with fewer launches. The emission table
``lights.emit`` stays differentiable.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from fountain_tpu_torch.core import transform as tf
from fountain_tpu_torch.core.gather import gather_rows
from fountain_tpu_torch.core.sampling import (pdf_env_alias,
                                              sample_env_alias,
                                              uniform_sample_sphere,
                                              uniform_sample_triangle)
from fountain_tpu_torch.core.vecmath import (PI, V3, cross, dot, gamma,
                                             gather3, length, normalize,
                                             sqrt0, where3, zeros3)
from fountain_tpu_torch.geometry.intersect import (Hit, _sphere_candidates,
                                                   _v3)
from fountain_tpu_torch.scene.types import (LIGHT_AREA_SPHERE,
                                            LIGHT_AREA_TRI, LIGHT_DISTANT,
                                            LIGHT_INFINITE, LIGHT_POINT,
                                            Scene, Spheres)

INV_2PI = 1.0 / (2.0 * PI)
INV_PI = 1.0 / PI


def dir_to_env_uv(d: V3):
    """Equirect uv of a unit direction (theta from +z, phi from +x)."""
    theta = torch.arccos(d.z.clamp(-1.0, 1.0))
    phi = torch.atan2(d.y, d.x)
    phi = torch.where(phi < 0.0, phi + 2.0 * PI, phi)
    return phi * INV_2PI, 1.0 - theta * INV_PI


def env_uv_to_dir(u, v):
    theta = PI * (1.0 - v)
    phi = 2.0 * PI * u
    sin_t = torch.sin(theta)
    return V3(sin_t * torch.cos(phi), sin_t * torch.sin(phi),
              torch.cos(theta)), sin_t


def _eval_env_tex(scene: Scene, tex_id, u, v) -> V3:
    """Evaluate an env radiance texture id at env uv (batched)."""
    from fountain_tpu_torch.shading.textures import eval_texture
    lookup = None
    if scene.env_images is not None:
        from fountain_tpu_torch.shading.mipmap import lookup_trilinear
        lookup = lambda iid, uu, vv, w=None: lookup_trilinear(  # noqa
            scene.env_images, iid, uu, vv, w)
    return eval_texture(scene.textures, tex_id, u, v, tex_lookup=lookup)


@dataclass
class LightSample:
    radiance: V3
    wi: V3                    # towards the light
    pdf: torch.Tensor         # [N] solid-angle density
    p_light: V3               # visibility endpoint
    p_light_err: V3
    n_light: V3
    is_delta: torch.Tensor    # [N] bool
    is_infinite: torch.Tensor  # [N] bool


def emitted_radiance(scene: Scene, hit: Hit) -> V3:
    """One-sided area-light emission toward the viewer at surface hits."""
    lid = hit.light_id.clamp(0, max(scene.lights.count - 1, 0))
    emit = gather3(scene.lights.emit, lid)
    visible = dot(hit.n, hit.wo) > 0.0
    on = (hit.light_id >= 0) & hit.valid & visible
    return where3(on, emit, 0.0)


def environment_radiance(scene: Scene, d: V3) -> V3:
    """Total radiance from infinite lights for escaped rays (the other
    lights' terms are zero and are not built)."""
    total = zeros3(d.shape, d.x.device)
    for i in infinite_lights(scene):
        total = total + environment_light_radiance(scene, i, d)
    return total


def infinite_lights(scene: Scene):
    """Indices of the scene's infinite lights (host-side, from the table
    read at build)."""
    return [i for i, t in enumerate(scene.lights.types)
            if t == LIGHT_INFINITE]


def environment_light_radiance(scene: Scene, i: int, d: V3) -> V3:
    """Radiance of infinite light ``i`` alone for escaped rays in direction
    d (zero when light i is not infinite)."""
    lt = scene.lights
    u, v = dir_to_env_uv(normalize(d))
    ones = torch.ones_like(u)
    radiance = V3(lt.emit[i, 0] * ones, lt.emit[i, 1] * ones,
                  lt.emit[i, 2] * ones)
    if scene.env_images is not None:
        tex_rgb = _eval_env_tex(scene, lt.env_tex[i].expand(u.shape), u, v)
        radiance = where3(lt.env_tex[i] >= 0, radiance * tex_rgb, radiance)
    return where3(lt.ltype[i] == LIGHT_INFINITE, radiance, 0.0)


def _sphere_surface_at(scene: Scene, sphere_idx, p_obj_unit: V3):
    """World position, error and normal of a unit-sphere point scaled to
    the surface of sphere ``sphere_idx`` (per lane)."""
    sph = scene.spheres
    g = lambda a: a[sphere_idx.long()]                        # noqa: E731
    o2w = tf.Transform(g(sph.o2w), g(sph.w2o))
    p_unit = p_obj_unit.stack()
    p_obj = p_unit * g(sph.radius)[..., None]
    p_w, p_err = tf.transform_points_with_input_error(
        o2w, p_obj, gamma(5) * p_obj.abs())
    n_w = normalize(_v3(tf.transform_normals(o2w, p_unit)))
    n_w = where3(g(sph.flip_normal), -n_w, n_w)
    return _v3(p_w), _v3(p_err), n_w


def _pick(sel, a, b):
    """``a`` where ``sel``, else ``b`` (0 while no branch has set it)."""
    return torch.where(sel, a, 0.0 if b is None else b)


def _mesh_light_point(scene: Scene, li, u1, u2):
    """A point on mesh light ``li`` (per lane): its face drawn in
    proportion to area by the light's alias rows of ``light_tri``
    (original face order), then uniform on the face. Returns the point,
    its error bound and the face's (orientation-flipped) normal."""
    lt = scene.lights
    start = lt.tri_start[li]
    count = lt.tri_count[li].clamp_min(1)
    f0 = u1 * count.to(torch.float32)
    k = torch.minimum(f0.to(torch.int32).clamp_min(0), count - 1)
    frac = (f0 - k.to(torch.float32)).clamp(0.0, 1.0 - 1e-7)
    j0 = start + k
    prob = gather_rows(scene.light_tri[:, 0], j0.long())
    alias = gather_rows(scene.light_tri[:, 1], j0.long()).detach()
    take_alias = frac >= prob
    face = torch.where(take_alias, alias.to(torch.int32), j0)
    rc = gather_rows(scene.light_tri, face.long())
    # the residual of the alias cell, remapped to a fresh uniform
    resid = torch.where(take_alias,
                        (frac - prob) / (1.0 - prob).clamp_min(1e-12),
                        frac / prob.clamp_min(1e-12)).clamp(0.0, 1.0)
    p0, p1, p2 = (V3(rc[:, c], rc[:, c + 1], rc[:, c + 2])
                  for c in (2, 5, 8))
    b0, b1 = uniform_sample_triangle(resid, u2)
    b2 = 1.0 - b0 - b1
    p = p0 * b0 + p1 * b1 + p2 * b2
    p_err = ((p0 * b0).abs() + (p1 * b1).abs() + (p2 * b2).abs()) * gamma(6)
    n = normalize(cross(p1 - p0, p2 - p0))
    return p, p_err, where3(rc[:, 11] > 0.5, -n, n)


def sample_light(scene: Scene, light_idx, ref_p: V3, u1, u2) -> LightSample:
    """Sample incident illumination from per-lane light ``light_idx``.
    Point and distant lights are delta lights (pdf 1); env-mapped
    infinite lights importance-sample scene.env_dist, plain ones take
    uniform-sphere directions; area lights take a uniform point on their
    shape (a mesh light's face in proportion to its area), with the pdf
    converted to solid angle."""
    lt = scene.lights
    present = lt.present
    n, dev = ref_p.shape, ref_p.x.device
    li = light_idx.clamp(0, max(lt.count - 1, 0))
    ltype = lt.ltype[li]
    emit = gather3(lt.emit, li)
    is_delta = (ltype == LIGHT_POINT) | (ltype == LIGHT_DISTANT)
    is_infinite = (ltype == LIGHT_INFINITE) | (ltype == LIGHT_DISTANT)
    zero = zeros3(n, dev)
    radiance = wi = p_light = p_light_err = n_light = zero
    pdf = None

    if LIGHT_POINT in present:
        # I / r^2 toward the light's position
        sel = ltype == LIGHT_POINT
        pos = gather3(lt.pos, li)
        d_vec = pos - ref_p
        r2 = dot(d_vec, d_vec).clamp_min(1e-12)
        wi = where3(sel, normalize(d_vec), wi)
        radiance = where3(sel, emit * (1.0 / r2), radiance)
        pdf = _pick(sel, 1.0, pdf)
        p_light = where3(sel, pos, p_light)

    if LIGHT_DISTANT in present:
        # ``dir`` points from the light: wi = -dir, the endpoint outside
        # the scene's bounding sphere
        sel = ltype == LIGHT_DISTANT
        wi_d = normalize(-gather3(lt.dir, li))
        wi = where3(sel, wi_d, wi)
        radiance = where3(sel, emit, radiance)
        pdf = _pick(sel, 1.0, pdf)
        p_light = where3(sel, ref_p + wi_d * (2.0 * scene.world_radius),
                         p_light)

    if LIGHT_INFINITE in present:
        # endpoint at 2 * world radius
        sel = ltype == LIGHT_INFINITE
        env_tex, env_slot = lt.env_tex[li], lt.env_slot[li]
        wi_u = uniform_sample_sphere(u1, u2)
        pdf_u = torch.full(n, 1.0 / (4.0 * PI), dtype=torch.float32,
                           device=dev)
        rad_u = emit
        if scene.env_dist is not None:
            slot = env_slot.clamp_min(0)
            ue, ve, pdf_uv = sample_env_alias(scene.env_dist, slot, u1, u2)
            wi_e, sin_t = env_uv_to_dir(ue, ve)
            pdf_e = torch.where(
                sin_t > 0.0,
                pdf_uv / (2.0 * PI * PI * sin_t.clamp_min(1e-9)), 0.0)
            rad_e = emit * _eval_env_tex(scene, env_tex, ue, ve)
            has_env = (env_tex >= 0) & (env_slot >= 0)
            wi_u = where3(has_env, wi_e, wi_u)
            pdf_u = torch.where(has_env, pdf_e, pdf_u)
            rad_u = where3(has_env, rad_e, rad_u)
        elif scene.env_images is not None:
            u_env, v_env = dir_to_env_uv(wi_u)
            rad_e = emit * _eval_env_tex(scene, env_tex, u_env, v_env)
            rad_u = where3(env_tex >= 0, rad_e, rad_u)
        wi = where3(sel, wi_u, wi)
        radiance = where3(sel, rad_u, radiance)
        pdf = _pick(sel, pdf_u, pdf)
        p_light = where3(sel, ref_p + wi_u * (2.0 * scene.world_radius),
                         p_light)

    if LIGHT_AREA_SPHERE in present and scene.spheres.count > 0:
        sel = ltype == LIGHT_AREA_SPHERE
        sphere_idx = lt.shape_id[li].clamp(0, scene.spheres.count - 1)
        p_s, p_s_err, n_s = _sphere_surface_at(
            scene, sphere_idx, uniform_sample_sphere(u1, u2))
        wi_s = normalize(p_s - ref_p)
        pdf_s = light_pdf(scene, li, ref_p, wi_s)
        # one-sided emission towards the reference point
        rad_s = where3(dot(n_s, -wi_s) > 0.0, emit, 0.0)
        degenerate = length(p_s - ref_p) < 1e-8
        wi = where3(sel, wi_s, wi)
        radiance = where3(sel & ~degenerate, rad_s,
                          where3(sel, 0.0, radiance))
        pdf = _pick(sel, torch.where(degenerate, 0.0, pdf_s), pdf)
        p_light = where3(sel, p_s, p_light)
        p_light_err = where3(sel, p_s_err, p_light_err)
        n_light = where3(sel, n_s, n_light)

    if LIGHT_AREA_TRI in present and scene.light_tri is not None:
        # pdf = d^2 / (|cos| total area): uniform over the light's area
        sel = ltype == LIGHT_AREA_TRI
        p_t, p_t_err, n_t = _mesh_light_point(scene, li, u1, u2)
        d_t = p_t - ref_p
        d2 = dot(d_t, d_t).clamp_min(1e-20)
        wi_t = d_t * (1.0 / torch.sqrt(d2))
        cos_l = dot(n_t, -wi_t)
        area = lt.area[li].clamp_min(1e-20)
        pdf_t = torch.where(cos_l.abs() > 1e-8,
                            d2 / (cos_l.abs() * area), 0.0)
        rad_t = where3(cos_l > 0.0, emit, 0.0)
        degenerate = d2 < 1e-16
        wi = where3(sel, wi_t, wi)
        radiance = where3(sel & ~degenerate, rad_t,
                          where3(sel, 0.0, radiance))
        pdf = _pick(sel, torch.where(degenerate, 0.0, pdf_t), pdf)
        p_light = where3(sel, p_t, p_light)
        p_light_err = where3(sel, p_t_err, p_light_err)
        n_light = where3(sel, n_t, n_light)
    if pdf is None:
        pdf = torch.zeros(n, dtype=torch.float32, device=dev)
    return LightSample(
        radiance=radiance, wi=wi, pdf=pdf, p_light=p_light,
        p_light_err=p_light_err, n_light=n_light, is_delta=is_delta,
        is_infinite=is_infinite)


def light_pdf(scene: Scene, light_idx, ref_p: V3, wi: V3,
              hit: Hit = None) -> torch.Tensor:
    """Solid-angle pdf that ``sample_light`` would pick direction wi:
    0 for delta lights, 1/4pi for a uniform infinite light, the
    alias-table pdf with the sin(theta) Jacobian for an env-mapped one,
    distance^2 / (|cos| area) at the first hit along wi for a sphere area
    light, and for a mesh area light the same at ``hit``, the already
    traced hit along wi (0 without it, or where it is not on the light)."""
    lt = scene.lights
    present = lt.present
    n, dev = ref_p.shape, ref_p.x.device
    li = light_idx.clamp(0, max(lt.count - 1, 0))
    ltype = lt.ltype[li]
    pdf = None
    if LIGHT_INFINITE in present:
        pdf_inf = torch.full(n, 1.0 / (4.0 * PI), dtype=torch.float32,
                             device=dev)
        if scene.env_dist is not None:
            env_tex, env_slot = lt.env_tex[li], lt.env_slot[li]
            wn = normalize(wi)
            u_env, v_env = dir_to_env_uv(wn)
            sin_t = sqrt0(1.0 - wn.z ** 2)
            pdf_uv = pdf_env_alias(scene.env_dist, env_slot.clamp_min(0),
                                   u_env, v_env)
            pdf_env = torch.where(
                sin_t > 0.0,
                pdf_uv / (2.0 * PI * PI * sin_t.clamp_min(1e-9)), 0.0)
            has_env = (env_tex >= 0) & (env_slot >= 0)
            pdf_inf = torch.where(has_env, pdf_env, pdf_inf)
        pdf = _pick(ltype == LIGHT_INFINITE, pdf_inf, pdf)

    if hit is not None and LIGHT_AREA_TRI in present:
        dh = ref_p - hit.p
        same = hit.valid & (hit.light_id == li)
        cos_l = dot(hit.n, -normalize(wi)).abs()
        area = lt.area[li].clamp_min(1e-20)
        pdf_t = torch.where(same & (cos_l > 1e-8),
                            dot(dh, dh) / (cos_l * area), 0.0)
        pdf = _pick(ltype == LIGHT_AREA_TRI, pdf_t, pdf)

    if LIGHT_AREA_SPHERE in present and scene.spheres.count > 0:
        sel = ltype == LIGHT_AREA_SPHERE
        sphere_idx = lt.shape_id[li].clamp(
            0, scene.spheres.count - 1).long()
        # a single-sphere table per lane: that light's sphere only
        sph = scene.spheres
        one = Spheres(**{f: getattr(sph, f)[sphere_idx][:, None]
                         for f in Spheres.__dataclass_fields__})
        ref_a, wi_a = ref_p.stack(), wi.stack()
        # start just off the reference point along wi, so a reference
        # point on the light does not hit itself
        o = ref_a + wi_a * 1e-3
        t_hit, ok = _single_sphere_t(one, o, wi_a)
        # a miss lane's t is inf: its p_hit, d2 would be inf and the
        # masked quotient's backward inf * 0 (attached sampling
        # differentiates wi)
        t_hit = torch.where(ok, t_hit, 0.0)
        p_hit = o + t_hit[..., None] * wi_a
        o2w = tf.Transform(one.o2w[:, 0], one.w2o[:, 0])
        n_obj = tf.transform_points(o2w.inverse, p_hit)
        n_w = normalize(_v3(tf.transform_normals(
            o2w, normalize(_v3(n_obj)).stack())))
        n_w = where3(one.flip_normal[:, 0], -n_w, n_w)
        r = sph.radius[sphere_idx]
        dd = ref_a - p_hit
        d2 = (dd * dd).sum(-1)
        denom = dot(n_w, -_v3(wi_a)).abs() * (4.0 * PI * r * r)
        pdf_area = torch.where(ok & (denom > 0.0),
                               d2 / denom.clamp_min(1e-12), 0.0)
        pdf = _pick(sel, pdf_area, pdf)
    if pdf is None:
        pdf = torch.zeros(n, dtype=torch.float32, device=dev)
    return pdf


def _single_sphere_t(one: Spheres, o, d):
    """First positive t along [N, 3] rays against per-lane one-sphere
    tables ([N, 1] fields); returns (t, ok), each [N]."""
    t_max = torch.full(o.shape[:-1], float("inf"), device=o.device)
    t_all, ok = _sphere_candidates(one, o, d, t_max)
    return t_all[..., 0], ok[..., 0]

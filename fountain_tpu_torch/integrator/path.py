"""Wavefront unidirectional path integrator with NEE + MIS (PyTorch).

Counterpart of ``fountain_tpu/integrator/path.py``: the whole wavefront
of lanes advances together through a bounce loop with an ``active`` mask;
Russian roulette after 3 bounces; every random number is a counter hash
of (lane, sample, bounce, slot). Three modes, as in the JAX package:
- ``"path"`` with NEE: one light per bounce and one shadow ray (the
  light-sampling branch); its MIS partner is the next bounce's emission
  gather, weighted by the power heuristic against the continuation ray's
  BSDF pdf. With ``nee=False`` emission counts only on camera and
  specular bounces, or on every bounce with ``emit_all_bounces`` (BSDF
  sampling only);
- ``"direct"``: one light per bounce with both MIS branches (a shadow
  ray and a traced BSDF-sampled ray), continuing through specular lobes
  only;
- ``"whitted"``: every light, light sampling only, no MIS, continuing
  through specular lobes only.

Two waves, both Python loops: the fixed wave (``regen_fn=None``) traces
one path per lane through ``max_depth + 1`` bounces and returns its
radiance; path regeneration (``regen_fn`` + ``n_iters``) lets a lane
whose path ends during the first ``n_iters - (max_depth + 1)`` iterations
start its pixel's next sample, and the remaining iterations drain the
paths in flight, so every started path completes; per-lane ``depth`` is
the bounce index.

Gradients: two estimators, as in the JAX package. Detached sampling
(``detach_sampling=True``, the default): sampled directions, light
samples, pdfs and the geometric carry (origins, directions, cone width,
previous pdf, on entry to every iteration) are detached, so gradients
flow through f * L * cos / pdf into the material, texture and emitter
tables only. Attached sampling (``detach_sampling=False``): ``detach`` is
the identity, so the chain u -> wh(alpha) -> wi -> next ray -> next hit
(sphere intersection, the triangle's re-intersected barycentrics, light
sample and pdf, Russian roulette's rescale) is differentiated too, which
gives the gradient of sampled-lobe parameters such as roughness. In both,
discrete choices and the sweeps' (t, face) carry no gradient, and the
backward pass never launches a sweep.

Known deviation from fountain, kept from the JAX package: a lane hitting a
null-BSDF material passes through but consumes a bounce.
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Callable, Optional

import torch

from fountain_tpu_torch.core import rng
from fountain_tpu_torch.core.sampling import power_heuristic
from fountain_tpu_torch.core.vecmath import (SHADOW_EPSILON, V3, absdot, dot,
                                             normalize, offset_ray_origin,
                                             where3, zeros3)
from fountain_tpu_torch.geometry.intersect import (
    Hit, answer_queries, scene_intersect_any_steps, scene_intersect_steps,
    spawn_ray)
from fountain_tpu_torch.integrator import regen_graph
from fountain_tpu_torch.lights.lights import (emitted_radiance,
                                              environment_light_radiance,
                                              environment_radiance,
                                              infinite_lights, light_pdf,
                                              sample_light)
from fountain_tpu_torch.scene.types import LIGHT_INFINITE, Scene
from fountain_tpu_torch.shading.bsdf import (bsdf_f_pdf, bsdf_sample,
                                             gather_shading, has_non_specular,
                                             local_to_world, world_to_local)

# RNG slot layout within a bounce (dims are bounce*SLOTS + slot)
_SLOTS = 4
_SLOT_BSDF = 0      # u_lobe, u1, u2
_SLOT_LIGHT = 1     # light select, u_light x2
_SLOT_SCATTER = 2   # direct mode's BSDF branch; whitted's light samples
_SLOT_RR = 3
MODES = ("path", "direct", "whitted")
DIM_CAMERA = 1 << 20  # camera jitter/lens dims live far above bounce dims


@dataclass(frozen=True)
class PathConfig:
    """The JAX package's PathConfig: ``mode`` is one of ``MODES``;
    ``nee=False`` turns next-event estimation off in "path" and "direct"
    modes, and ``emit_all_bounces`` then counts emission at every bounce
    (BSDF sampling only)."""
    max_depth: int = 5
    rr_threshold: float = 1.0
    nee: bool = True
    emit_all_bounces: bool = False
    mode: str = "path"


@dataclass
class RegenResult:
    """Per-lane radiance summed over all completed samples, the number of
    completed samples, and (count_rays) the exact useful-ray count."""
    accum: V3
    n_done: torch.Tensor
    n_rays: Optional[torch.Tensor]


@dataclass
class _Lanes:
    """Per-lane state of the wavefront (all flat [N])."""
    o: V3
    d: V3
    beta: V3
    radiance: V3
    active: torch.Tensor
    specular: torch.Tensor
    cone_width: torch.Tensor
    prev_pdf: torch.Tensor
    lane: torch.Tensor
    sample: torch.Tensor
    spread: torch.Tensor
    n_rays: torch.Tensor


def _shadow_target(hit: Hit, ls, wi: V3):
    """Shadow-ray origin off the surface and its end at the light sample
    (off the light's surface for area lights)."""
    o_sh = offset_ray_origin(hit.p, hit.p_err, hit.n, wi)
    target = where3(ls.is_infinite | ls.is_delta, ls.p_light,
                    offset_ray_origin(ls.p_light, ls.p_light_err,
                                      ls.n_light, o_sh - ls.p_light))
    return o_sh, target


def _estimate_direct(scene: Scene, hit: Hit, sp, light_idx, u_light,
                     active, detach, u_scatter=None) -> V3:
    """One-light direct illumination. The light-sampling branch traces
    one shadow ray. Without ``u_scatter`` (path mode) its MIS partner is
    the continuation ray's emission gather in the bounce loop; with it
    (direct mode) the BSDF-sampling branch traces its own ray, before the
    light pdf, which mesh lights take from that ray's hit. Lanes outside
    ``active`` trace nothing (t_max < 0); the caller drops their light.
    A generator of its triangle queries (``intersect.answer_queries``)."""
    wo_l = world_to_local(hit, hit.wo)
    ls = sample_light(scene, light_idx, hit.p, u_light[0], u_light[1])
    wi = detach(ls.wi)
    f, scattering_pdf = bsdf_f_pdf(sp, wo_l, world_to_local(hit, wi))
    f_cos = f * absdot(wi, hit.ns)
    light_pdf_val = detach(ls.pdf)
    possible = (light_pdf_val > 0.0) & ls.radiance.any_positive() \
        & f_cos.any_positive()
    o_sh, target = _shadow_target(hit, ls, wi)
    t_max = torch.where(possible & active, 1.0 - SHADOW_EPSILON, -1.0)
    occluded = yield from scene_intersect_any_steps(scene, o_sh,
                                                    target - o_sh, t_max)
    unocc = possible & ~occluded
    weight_l = torch.where(ls.is_delta, 1.0,
                           power_heuristic(1, light_pdf_val, 1,
                                           detach(scattering_pdf)))
    ld = where3(unocc, f_cos * ls.radiance
                * (weight_l / light_pdf_val.clamp_min(1e-12)), 0.0)
    if u_scatter is None:
        return ld

    # BSDF-sampling branch (not for delta lights or specular samples)
    bs = bsdf_sample(sp, wo_l, *u_scatter, detach_wi=detach is _detach)
    wi_b = detach(local_to_world(hit, bs.wi))
    f_b = bs.f * absdot(wi_b, hit.ns)
    bsdf_ok = bs.valid & ~ls.is_delta & f_b.any_positive() \
        & ~bs.is_specular
    t_inf = torch.where(bsdf_ok & active, float("inf"), -1.0)
    hit_b = yield from scene_intersect_steps(scene, spawn_ray(hit, wi_b),
                                             wi_b, t_inf)
    lpdf_b = light_pdf(scene, light_idx, hit.p, wi_b, hit=hit_b)
    bsdf_ok = bsdf_ok & (lpdf_b > 0.0)
    weight_b = power_heuristic(1, detach(bs.pdf), 1, detach(lpdf_b))
    same_light = hit_b.valid & (hit_b.light_id == light_idx)
    li = where3(same_light, emitted_radiance(scene, hit_b), 0.0)
    lt = scene.lights
    if LIGHT_INFINITE in lt.present:
        is_inf = lt.ltype[light_idx.clamp(0, lt.count - 1)] \
            == LIGHT_INFINITE
        li = li + where3(~hit_b.valid & is_inf,
                         environment_radiance(scene, wi_b), 0.0)
    return ld + where3(bsdf_ok, f_b * li * (
        weight_b / detach(bs.pdf).clamp_min(1e-12)), 0.0)


def _whitted_direct(scene: Scene, hit: Hit, sp, st: _Lanes, bounce, seed,
                    active, detach) -> V3:
    """Direct light from every light, light sampling only (no MIS): one
    shadow ray per light; light ``i`` draws its sample with seed
    ``seed + i``. A generator of its triangle queries."""
    wo_l = world_to_local(hit, hit.wo)
    total = zeros3(hit.p.shape, hit.p.x.device)
    for i in range(scene.lights.count):
        ui = rng.uniform4(st.lane, st.sample,
                          bounce * _SLOTS + _SLOT_SCATTER, seed + i)
        ls = sample_light(scene, torch.full_like(st.lane, i), hit.p, ui[0],
                          ui[1])
        wi = detach(ls.wi)
        f, _ = bsdf_f_pdf(sp, wo_l, world_to_local(hit, wi))
        f_cos = f * absdot(wi, hit.ns)
        pdf = detach(ls.pdf)
        ok = (pdf > 0.0) & f_cos.any_positive() & ls.radiance.any_positive()
        o_sh, target = _shadow_target(hit, ls, wi)
        t_sh = torch.where(ok & active, 1.0 - SHADOW_EPSILON, -1.0)
        occ = yield from scene_intersect_any_steps(scene, o_sh,
                                                   target - o_sh, t_sh)
        total = total + where3(ok & ~occ, f_cos * ls.radiance
                               * (1.0 / pdf.clamp_min(1e-12)), 0.0)
    return total


def _bounce(scene: Scene, st: _Lanes, bounce, cfg: PathConfig, seed,
            count_rays: bool, detach) -> None:
    """Advance every lane by one bounce, in place on ``st``. ``bounce`` is
    the bounce index: an int for the fixed wave, a per-lane int tensor
    under regeneration. A generator of the bounce's triangle queries
    (``intersect.answer_queries``): the closest hit, then each shadow and
    BSDF ray of the mode."""
    n_lights = scene.lights.count
    ro, rd = st.o, st.d
    t_max = torch.where(st.active, float("inf"), -1.0)
    hit = yield from scene_intersect_steps(scene, ro, rd, t_max)
    if count_rays:
        st.n_rays = st.n_rays + st.active.sum()

    # emitted radiance: full weight on camera/specular bounces (every
    # bounce with emit_all_bounces); on path-mode NEE bounces the
    # continuation ray is the MIS BSDF branch of the previous vertex
    gate = (bounce == 0) | st.specular
    if cfg.emit_all_bounces:
        gate = torch.ones_like(st.specular)
    le_surf = emitted_radiance(scene, hit)
    if cfg.nee and n_lights > 0 and cfg.mode == "path":
        lpdf_surf = detach(light_pdf(scene, hit.light_id.clamp_min(0), ro,
                                     rd, hit=hit))
        w_surf = torch.where(gate, 1.0, power_heuristic(
            1, st.prev_pdf, 1, lpdf_surf))
        le_env = zeros3(ro.shape, ro.x.device)
        # the other lights' environment terms are zero
        for k in infinite_lights(scene):
            pdf_k = detach(light_pdf(scene, torch.full_like(st.lane, k), ro,
                                     rd))
            w_k = torch.where(gate, 1.0, power_heuristic(
                1, st.prev_pdf, 1, pdf_k))
            le_env = le_env + environment_light_radiance(scene, k, rd) * w_k
        le_env = where3(hit.valid, 0.0, le_env)
        st.radiance = st.radiance + where3(
            st.active, st.beta * (le_surf * w_surf + le_env), 0.0)
    elif n_lights > 0:
        le_env = where3(hit.valid, 0.0, environment_radiance(scene, rd))
        st.radiance = st.radiance + where3(st.active & gate,
                                           st.beta * (le_surf + le_env), 0.0)
    else:
        st.radiance = st.radiance + where3(st.active & gate,
                                           st.beta * le_surf, 0.0)

    # terminate: escaped or depth cap
    alive = st.active & hit.valid & (bounce < cfg.max_depth)

    # ray-cone footprint at the hit -> mip filter width in uv space
    t_hit = torch.where(hit.valid, hit.t, 0.0)
    width_at_hit = st.cone_width + t_hit * st.spread
    abs_cos = dot(hit.wo, hit.n).abs()
    tex_width = width_at_hit * hit.inv_uv_scale / abs_cos.clamp_min(0.05)
    st.cone_width = torch.where(alive, width_at_hit, st.cone_width)

    sp = gather_shading(scene, hit, tex_width=tex_width)
    null_bsdf = alive & (sp.mtype < 0)

    if n_lights > 0 and (cfg.nee or cfg.mode == "whitted"):
        nee_on = alive & has_non_specular(sp) & ~null_bsdf
    if n_lights > 0 and cfg.mode == "whitted":
        direct = yield from _whitted_direct(scene, hit, sp, st, bounce, seed,
                                            nee_on, detach)
        st.radiance = st.radiance + where3(nee_on, st.beta * direct, 0.0)
        if count_rays:  # one shadow ray per light and NEE lane
            st.n_rays = st.n_rays + n_lights * nee_on.sum()
    elif cfg.nee and n_lights > 0:
        u_sel = rng.uniform4(st.lane, st.sample,
                             bounce * _SLOTS + _SLOT_LIGHT, seed)
        light_idx = (u_sel[0] * n_lights).to(torch.int32).clamp_max(
            n_lights - 1)
        u_sc = None
        if cfg.mode == "direct":
            u_sc = rng.uniform4(st.lane, st.sample,
                                bounce * _SLOTS + _SLOT_SCATTER, seed)[:3]
        direct = yield from _estimate_direct(scene, hit, sp, light_idx,
                                             (u_sel[1], u_sel[2]), nee_on,
                                             detach, u_sc)
        st.radiance = st.radiance + where3(
            nee_on, st.beta * direct * float(n_lights), 0.0)
        if count_rays:  # a shadow ray per NEE lane, + the BSDF ray in direct
            per_lane = 1 if cfg.mode == "path" else 2
            st.n_rays = st.n_rays + per_lane * nee_on.sum()

    # BSDF sampling for the continuation ray
    ub = rng.uniform4(st.lane, st.sample, bounce * _SLOTS + _SLOT_BSDF, seed)
    bs = bsdf_sample(sp, world_to_local(hit, hit.wo), ub[0], ub[1], ub[2],
                     detach_wi=detach is _detach)
    wi_w = detach(normalize(local_to_world(hit, bs.wi)))
    f_ok = bs.valid & bs.f.any_nonzero()
    contrib = bs.f * (absdot(wi_w, hit.ns)
                      / detach(bs.pdf).clamp_min(1e-12))
    new_beta = st.beta * where3(f_ok, contrib, 1.0)
    new_o = spawn_ray(hit, wi_w)

    # null bsdf: pass through unchanged
    pass_o = offset_ray_origin(hit.p, hit.p_err, hit.n, rd)
    st.o = where3(null_bsdf, pass_o, where3(alive, new_o, ro))
    st.d = where3(null_bsdf, rd, where3(alive, wi_w, rd))
    st.beta = where3(alive & ~null_bsdf, new_beta, st.beta)
    st.specular = torch.where(null_bsdf, st.specular,
                              torch.where(alive, bs.is_specular, st.specular))
    st.prev_pdf = torch.where(null_bsdf, st.prev_pdf,
                              torch.where(alive, detach(bs.pdf),
                                          st.prev_pdf))
    alive = alive & (null_bsdf | f_ok)
    if cfg.mode != "path":
        # direct and whitted continue through specular lobes only
        alive = alive & (null_bsdf | bs.is_specular)

    # Russian roulette
    if cfg.rr_threshold > 0.0:
        u_rr = rng.uniform1(st.lane, st.sample, bounce * _SLOTS + _SLOT_RR,
                            seed)
        beta_max = detach(st.beta.max_component())
        do_rr = alive & (beta_max < cfg.rr_threshold) & (bounce > 3)
        q = (1.0 - beta_max).clamp_min(0.05)
        die = do_rr & (u_rr < q)
        st.beta = where3(do_rr & ~die,
                         st.beta * (1.0 / (1.0 - q).clamp_min(1e-6)),
                         st.beta)
        alive = alive & ~die
    st.active = alive


def _detach(x):
    """The detached estimator's cut: a tensor or V3 without its graph."""
    if isinstance(x, V3):
        return V3(x.x.detach(), x.y.detach(), x.z.detach())
    return x.detach()


def _attached(x):
    """The attached estimator's ``detach``: the identity."""
    return x


def _detach_geometry(st: _Lanes) -> None:
    """Detach the geometric carry on entry to an iteration, as the JAX
    package's loop bodies do under detached sampling (``_geo``: origins,
    directions, cone width, previous pdf)."""
    st.o, st.d = _detach(st.o), _detach(st.d)
    st.cone_width = st.cone_width.detach()
    st.prev_pdf = st.prev_pdf.detach()


_LANE_FIELDS = tuple(f.name for f in fields(_Lanes))


def _flat(parts: dict) -> dict:
    """Name -> tensor, each V3 as three entries ("o.x", "o.y", "o.z")."""
    out = {}
    for k, v in parts.items():
        if isinstance(v, V3):
            out.update({f"{k}.x": v.x, f"{k}.y": v.y, f"{k}.z": v.z})
        else:
            out[k] = v
    return out


def _unflat(state: dict):
    """(lanes, depth, accum, n_done) of a regeneration wave's flat state."""
    parts = {}
    for k, v in state.items():
        name, _, c = k.partition(".")
        if c:
            parts.setdefault(name, {})[c] = v
        else:
            parts[k] = v
    parts = {k: V3(**v) if isinstance(v, dict) else v
             for k, v in parts.items()}
    st = _Lanes(**{k: parts[k] for k in _LANE_FIELDS})
    return st, parts["depth"], parts["accum"], parts["n_done"]


def _iteration(scene: Scene, state: dict, cfg: PathConfig, seed,
               count_rays: bool, detach):
    """The bounce of one regeneration iteration from the flat state, as a
    generator of its triangle queries; returns what ``_end_iteration``
    takes."""
    st, depth, accum, n_done = _unflat(state)
    if detach is _detach:
        _detach_geometry(st)
    was = st.active
    yield from _bounce(scene, st, depth, cfg, seed, count_rays, detach)
    return st, was, depth, accum, n_done


def _end_iteration(middle, regen_fn: Optional[Callable]) -> dict:
    """The flat state after an iteration: the samples that finished in its
    bounce summed into ``accum`` and, with ``regen_fn`` (inside the refill
    window), their lanes started on their next samples."""
    st, was, depth, accum, n_done = middle
    st = replace(st)
    finished = was & ~st.active
    accum = accum + where3(finished, st.radiance, 0.0)
    n_done = n_done + finished.to(torch.int32)
    grown = torch.where(st.active, depth + 1, depth)
    if regen_fn is None:
        depth = grown
    else:
        refill = finished
        new_sample = st.sample + 1
        o2, d2, sp2 = regen_fn(st.lane, new_sample)
        st.o = where3(refill, o2, st.o)
        st.d = where3(refill, d2, st.d)
        st.radiance = where3(refill, 0.0, st.radiance)
        st.beta = where3(refill, 1.0, st.beta)
        st.specular = st.specular & ~refill
        st.cone_width = torch.where(refill, 0.0, st.cone_width)
        st.spread = torch.where(refill, sp2, st.spread)
        st.prev_pdf = torch.where(refill, 1.0, st.prev_pdf)
        st.sample = torch.where(refill, new_sample, st.sample)
        depth = torch.where(refill, 0, grown).to(torch.int32)
        st.active = st.active | refill
    return _flat({**{k: getattr(st, k) for k in _LANE_FIELDS},
                  "depth": depth, "accum": accum, "n_done": n_done})


def graph_counts() -> dict:
    """Regeneration iterations and fixed waves so far by how they ran:
    {"captures": ..., "replays": ..., "eager_iterations": ...,
    "wave_captures": ..., "wave_replays": ..., "eager_waves": ...}
    (``regen_graph.counts``)."""
    return regen_graph.counts()


def reset_graph_counts() -> None:
    """Every count of ``graph_counts`` to 0."""
    regen_graph.reset_counts()


def _regen_segmented(scene: Scene, state: dict, cfg: PathConfig, seed,
                     count_rays: bool, detach_sampling: bool, regen_fn,
                     k_iters: int, r_win: int) -> RegenResult:
    """The regeneration loop through ``regen_graph.segmented`` from the
    wave's first ``state``: the bounce's and the rays' seeds read from
    device scalars, the tail "refill" inside the refill window and
    "drain" after it."""
    detach = _detach if detach_sampling else _attached
    regen = regen_fn.with_seed(None)
    out = regen_graph.segmented(
        scene, state, (seed, regen_fn.seed),
        lambda sc, s, seeds: _iteration(sc, s, cfg, seeds[0], count_rays,
                                        detach),
        {"refill": lambda m, seeds: _end_iteration(
            m, regen.with_seed(seeds[1])),
         "drain": lambda m, seeds: _end_iteration(m, None)},
        ["refill" if it < r_win else "drain" for it in range(k_iters)],
        (regen, cfg, detach_sampling, count_rays))
    _, _, accum, n_done = _unflat(out)
    return RegenResult(V3(*(c.clone() for c in accum)), n_done.clone(),
                       out["n_rays"].clone() if count_rays else None)


def _first_lanes(o: V3, d: V3, lane, sample, spread) -> _Lanes:
    """The lanes on entry to a wave: camera rays ``o``, ``d`` and the
    lanes' ``lane``, ``sample`` and ray-cone ``spread`` [N]."""
    n, dev = o.shape, o.x.device
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    return _Lanes(
        o=o, d=d, beta=V3(ones, ones, ones), radiance=zeros3(n, dev),
        active=torch.ones(n, dtype=torch.bool, device=dev),
        specular=torch.zeros(n, dtype=torch.bool, device=dev),
        cone_width=torch.zeros(n, dtype=torch.float32, device=dev),
        prev_pdf=ones, lane=lane, sample=sample, spread=spread,
        n_rays=torch.zeros((), dtype=torch.int64, device=dev))


def _fixed_wave(scene: Scene, st: _Lanes, cfg: PathConfig, seed,
                count_rays: bool, detach):
    """The fixed wave's ``max_depth + 1`` bounces from ``st``, as a
    generator of their triangle queries; returns (radiance.x, .y, .z,
    n_rays)."""
    for b in range(cfg.max_depth + 1):
        if detach is _detach:
            _detach_geometry(st)
        yield from _bounce(scene, st, b, cfg, seed, count_rays, detach)
    return (*st.radiance, st.n_rays)


def _graphed_wave(scene: Scene, o: V3, d: V3, lane, sample, spread,
                  cfg: PathConfig, seed, count_rays: bool,
                  detach_sampling: bool) -> tuple:
    """The fixed wave under autograd, through
    ``regen_graph.differentiable``: its inputs are the scene's tables
    that require grad and the first lanes' rays, lanes, samples and
    spread; the seed is read from a device scalar."""
    detach = _detach if detach_sampling else _attached

    def body(sc, sd, ox, oy, oz, dx, dy, dz, lane, sample, spread):
        # a generator function: the first lanes are made inside the first
        # segment, so a replay makes them anew
        st = _first_lanes(V3(ox, oy, oz), V3(dx, dy, dz), lane, sample,
                          spread)
        return (yield from _fixed_wave(sc, st, cfg, sd, count_rays, detach))
    return regen_graph.differentiable(
        scene, seed, (*o, *d, lane, sample, spread), body,
        (cfg, detach_sampling, count_rays))


def trace_paths(scene: Scene, o: V3, d: V3, lane, sample, cfg: PathConfig,
                seed=0, detach_sampling: bool = True,
                count_rays: bool = False, cone_spread=None,
                regen_fn: Optional[Callable] = None,
                n_iters: Optional[int] = None):
    """Trace one camera path per lane.

    o, d: camera rays (V3 of flat [N]); lane/sample: int tensors [N]
    feeding the counter RNG; ``cone_spread`` [N] (optional): the rays'
    ray-cone spread. Without ``regen_fn`` this is the fixed wave: returns
    the radiance V3, or (radiance, n_rays) with count_rays=True. With
    ``regen_fn(lane, sample) -> (o, d, spread)`` (the rays of a lane's
    next sample) it is a regeneration wave of ``n_iters`` iterations and
    returns a RegenResult. n_rays counts one closest-hit ray per active
    lane per iteration plus the NEE rays: one shadow ray per NEE lane
    (path mode), two (direct mode: and the BSDF-sampled ray), one per
    light (whitted mode).
    ``detach_sampling`` picks the estimator (module docstring).

    Two waves run through ``regen_graph``'s recordings (its module
    docstring: on a card CUDA graphs between the triangle queries,
    captured in the first call of a key and replayed after; plain calls
    on the CPU): a regeneration wave that builds no autograd graph (grad
    mode off, or no tensor of the scene or the rays requiring grad) and
    whose ``regen_fn`` can take its seed from a device scalar
    (``with_seed``, as ``render.make_ray_fn``'s), through
    ``regen_graph.segmented``; and a fixed wave that builds one, as one
    autograd function (``regen_graph.differentiable``). Their results are
    the plain loop's and the caller's own tensors, and the gradients
    reach the caller's tensors as the plain loop's do.
    """
    if cfg.mode not in MODES:
        raise ValueError(f"unknown integrator mode {cfg.mode!r}")
    detach = _detach if detach_sampling else _attached
    n, dev = o.shape, o.x.device
    lane = torch.as_tensor(lane, dtype=torch.int32, device=dev).expand(n)
    sample = torch.as_tensor(sample, dtype=torch.int32, device=dev).expand(n)
    spread = torch.zeros(n, dtype=torch.float32, device=dev) \
        if cone_spread is None else cone_spread.expand(n)

    if regen_fn is None:
        if torch.is_grad_enabled() and regen_graph.requires_grad(
                scene, o, d, cone_spread):
            out = _graphed_wave(scene, o, d, lane, sample, spread, cfg, seed,
                                count_rays, detach_sampling)
        else:
            regen_graph.count("eager_waves")
            out = answer_queries(scene, _fixed_wave(
                scene, _first_lanes(o, d, lane, sample, spread), cfg, seed,
                count_rays, detach))
        radiance = V3(*out[:3])
        return (radiance, out[3]) if count_rays else radiance

    k_iters = n_iters if n_iters is not None else 2 * (cfg.max_depth + 1)
    # refill window: paths started before it have max_depth+1 iterations
    # left, so they complete inside the wave
    r_win = k_iters - (cfg.max_depth + 1)
    st = _first_lanes(o, d, lane, sample, spread)
    state = _flat({**{k: getattr(st, k) for k in _LANE_FIELDS},
                   "depth": torch.zeros(n, dtype=torch.int32, device=dev),
                   "accum": zeros3(n, dev),
                   "n_done": torch.zeros(n, dtype=torch.int32, device=dev)})
    if hasattr(regen_fn, "with_seed") and not (
            torch.is_grad_enabled()
            and regen_graph.requires_grad(scene, o, d, cone_spread)):
        return _regen_segmented(scene, state, cfg, seed, count_rays,
                                detach_sampling, regen_fn, k_iters, r_win)
    for it in range(k_iters):
        state = _end_iteration(
            answer_queries(scene, _iteration(scene, state, cfg, seed,
                                             count_rays, detach)),
            regen_fn if it < r_win else None)
    regen_graph.count("eager_iterations", k_iters)
    _, _, accum, n_done = _unflat(state)
    return RegenResult(accum, n_done,
                       state["n_rays"] if count_rays else None)

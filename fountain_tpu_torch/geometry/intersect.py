"""Batched ray-scene intersection: spheres here, triangles in the sweeps
or the BVH walk.

Counterpart of ``fountain_tpu/geometry/intersect.py``. Spheres are tested
all-pairs against every ray (plain PyTorch, as the JAX package's jnp
version): the cancellation-free quadratic, z/phi clipping, and hit records
with reprojected points and error bounds. Triangles follow the JAX
package's rule off the TPU (where its dense table stops at
``tensor_tri.MAX_DENSE_FACES`` faces): a mesh of at most that many faces
goes through the sweeps (``tri_sweep.mt_intersect_kernel``), a larger one
through the BVH walk (``bvh_walk.walk_intersect``); each takes its CUDA
kernels on a card and its plain version on the CPU. The triangle search
is capped at the sphere hit's t, so a triangle hit is always the closer
one.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from fountain_tpu_torch.core import transform as tf
from fountain_tpu_torch.core.vecmath import (PI, V3, coordinate_system,
                                             cross, gamma, length, normalize,
                                             offset_ray_origin, sqrt0, where3)
from fountain_tpu_torch.geometry import tensor_tri
from fountain_tpu_torch.scene.types import Scene, Spheres

# Primitive kind codes in Hit.prim_kind
PRIM_NONE = 0
PRIM_SPHERE = 1
PRIM_TRIANGLE = 2


@dataclass
class Hit:
    """SoA surface-interaction record over the wavefront (flat [N])."""
    valid: torch.Tensor       # [N] bool
    t: torch.Tensor           # [N]
    p: V3
    p_err: V3
    n: V3                     # geometric normal (orientation-flipped)
    ns: V3                    # shading normal
    ss: V3                    # shading tangent
    ts: V3                    # shading bitangent
    u: torch.Tensor
    v: torch.Tensor
    wo: V3
    prim_kind: torch.Tensor   # [N] int32
    prim_id: torch.Tensor     # [N] int32
    mat_id: torch.Tensor      # [N] int32 (-1 => null bsdf)
    light_id: torch.Tensor    # [N] int32 (-1 => not an emitter)
    inv_uv_scale: torch.Tensor  # [N] world-to-uv scale for ray cones


def spawn_ray(hit: Hit, d: V3) -> V3:
    """Robust secondary-ray origin."""
    return offset_ray_origin(hit.p, hit.p_err, hit.n, d)


def miss_hit(o: V3, d: V3) -> Hit:
    """All-invalid Hit wave."""
    z = torch.zeros_like(o.x)
    one = torch.ones_like(o.x)
    zi = torch.zeros(o.shape, dtype=torch.int32, device=o.x.device)
    return Hit(valid=torch.zeros_like(zi, dtype=torch.bool),
               t=torch.full_like(z, float("inf")),
               p=V3(z, z, z), p_err=V3(z, z, z),
               n=V3(z, z, one), ns=V3(z, z, one),
               ss=V3(one, z, z), ts=V3(z, one, z),
               u=z, v=z, wo=normalize(-d),
               prim_kind=zi, prim_id=zi, mat_id=zi - 1, light_id=zi - 1,
               inv_uv_scale=z)


def select_hit(mask: torch.Tensor, a: Hit, b: Hit) -> Hit:
    """Per-lane select between two Hit records (mask True -> a)."""
    out = {}
    for f in fields(Hit):
        fa, fb = getattr(a, f.name), getattr(b, f.name)
        out[f.name] = where3(mask, fa, fb) if isinstance(fa, V3) \
            else torch.where(mask, fa, fb)
    return Hit(**out)


def _v3(a: torch.Tensor) -> V3:
    return V3(a[..., 0], a[..., 1], a[..., 2])


def _length(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((a * a).sum(-1))


def _sphere_candidates(sph: Spheres, o_w: torch.Tensor, d_w: torch.Tensor,
                       t_max: torch.Tensor):
    """All-pairs ray x sphere candidate t [N, S] (inf where none) and its
    mask, clipping included. ``sph`` fields are [S] (or per lane [N, S])."""
    w2o = tf.Transform(sph.w2o, sph.o2w)
    o = tf.transform_points(w2o, o_w[..., None, :])     # [N, S, 3]
    d = tf.transform_vectors(w2o, d_w[..., None, :])
    r = sph.radius
    a = (d * d).sum(-1)
    b = 2.0 * (o * d).sum(-1)
    c = (o * o).sum(-1) - r * r
    # geometric discriminant: v = o - (b/2a) d; disc = 4a(r-|v|)(r+|v|)
    safe_a = torch.where(a == 0.0, 1.0, a)
    vlen = _length(o - (b / (2.0 * safe_a))[..., None] * d)
    disc = 4.0 * a * (r - vlen) * (r + vlen)
    has_root = (disc >= 0.0) & (a > 0.0)
    root = sqrt0(disc)
    q = torch.where(b < 0.0, -0.5 * (b - root), -0.5 * (b + root))
    t0 = q / safe_a
    t1 = c / torch.where(q == 0.0, 1.0, q)
    tlo = torch.minimum(t0, t1)
    thi = torch.maximum(t0, t1)

    def clip_ok(t):
        p = o + t[..., None] * d
        p = p * (r / _length(p).clamp_min(1e-20))[..., None]
        z_ok = (p[..., 2] >= sph.z_min) & (p[..., 2] <= sph.z_max)
        phi = torch.atan2(p[..., 1], p[..., 0])
        phi = torch.where(phi < 0.0, phi + 2.0 * PI, phi)
        return z_ok & (phi <= sph.phi_max + 1e-6)

    eps = 1e-3 * tlo.abs() + 1e-6  # conservative t > 0 guard
    cap = t_max[..., None]
    lo_ok = has_root & (tlo > eps) & (tlo < cap) & clip_ok(tlo)
    hi_ok = has_root & (thi > eps) & (thi < cap) & clip_ok(thi)
    ok = lo_ok | hi_ok
    return torch.where(ok, torch.where(lo_ok, tlo, thi), float("inf")), ok


def intersect_spheres(sph: Spheres, o_w, d_w, t_max):
    """Closest hit over the sphere table: (t, index, valid), each [N]."""
    if sph.count == 0:
        n, dev = o_w.shape[:-1], o_w.device
        return (torch.full(n, float("inf"), device=dev),
                torch.zeros(n, dtype=torch.int32, device=dev),
                torch.zeros(n, dtype=torch.bool, device=dev))
    t_all, ok = _sphere_candidates(sph, o_w, d_w, t_max)
    idx = torch.argmin(t_all, dim=-1)
    t = torch.take_along_dim(t_all, idx[..., None], dim=-1)[..., 0]
    valid = torch.take_along_dim(ok, idx[..., None], dim=-1)[..., 0]
    return t, idx.to(torch.int32), valid


def intersect_spheres_any(sph: Spheres, o_w, d_w, t_max) -> torch.Tensor:
    """Any-hit (shadow) test over the sphere table: [N] bool."""
    if sph.count == 0:
        return torch.zeros(o_w.shape[:-1], dtype=torch.bool,
                           device=o_w.device)
    return _sphere_candidates(sph, o_w, d_w, t_max)[1].any(-1)


def sphere_hit_info(sph: Spheres, idx, o_w, d_w, t, valid) -> Hit:
    """Surface interaction on each ray's sphere ``idx``: reprojected point,
    phi/theta uv, analytic dpdu/dpdv, error bounds, world-space frame."""
    g = lambda a: a[idx.long()]                                # noqa: E731
    o2w = tf.Transform(g(sph.o2w), g(sph.w2o))
    w2o = o2w.inverse
    r = g(sph.radius)
    # a miss lane's p = o + inf * d would be NaN
    t = torch.where(valid & torch.isfinite(t), t, 0.0)
    o = tf.transform_points(w2o, o_w)
    d = tf.transform_vectors(w2o, d_w)
    p = o + t[..., None] * d
    p = p * (r / _length(p).clamp_min(1e-20))[..., None]
    # avoid the phi singularity
    px = torch.where((p[..., 0] == 0.0) & (p[..., 1] == 0.0), 1e-5 * r,
                     p[..., 0])
    p = torch.stack([px, p[..., 1], p[..., 2]], dim=-1)
    phi = torch.atan2(p[..., 1], p[..., 0])
    phi = torch.where(phi < 0.0, phi + 2.0 * PI, phi)

    z_min, z_max, phi_max = g(sph.z_min), g(sph.z_max), g(sph.phi_max)
    theta_min = torch.arccos((z_min / r).clamp(-1.0, 1.0))
    theta_max = torch.arccos((z_max / r).clamp(-1.0, 1.0))
    theta = torch.arccos((p[..., 2] / r).clamp(-1.0, 1.0))
    u = phi / phi_max
    v = (theta - theta_min) / torch.where(theta_max == theta_min, 1.0,
                                          theta_max - theta_min)

    # analytic partials
    z_radius = torch.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2)
    inv_zr = 1.0 / z_radius.clamp_min(1e-20)
    cos_phi = p[..., 0] * inv_zr
    sin_phi = p[..., 1] * inv_zr
    dpdu = torch.stack([-phi_max * p[..., 1], phi_max * p[..., 0],
                        torch.zeros_like(phi)], dim=-1)
    dpdv = (theta_max - theta_min)[..., None] * torch.stack(
        [p[..., 2] * cos_phi, p[..., 2] * sin_phi, -r * torch.sin(theta)],
        dim=-1)

    p_w, p_err = tf.transform_points_with_input_error(
        o2w, p, gamma(5) * p.abs())
    n_w = normalize(_v3(tf.transform_normals(o2w, normalize(_v3(p)).stack())))
    n_w = where3(g(sph.flip_normal), -n_w, n_w)
    dpdu_w = _v3(tf.transform_vectors(o2w, dpdu))
    dpdv_w = _v3(tf.transform_vectors(o2w, dpdv))

    ss = normalize(dpdu_w)
    ns = n_w
    ts = cross(ns, ss)
    # re-orthogonalize (degenerate dpdu at the poles)
    bad = length(ts) < 1e-8
    _, alt_ss, alt_ts = coordinate_system(ns)
    ss = where3(bad, alt_ss, ss)
    ts = where3(bad, alt_ts, normalize(ts))

    i32 = torch.int32
    inv_uv = torch.maximum(1.0 / length(dpdu_w).clamp_min(1e-12),
                           1.0 / length(dpdv_w).clamp_min(1e-12))
    return Hit(
        valid=valid, t=t, p=_v3(p_w), p_err=_v3(p_err), n=n_w, ns=ns, ss=ss,
        ts=ts, u=u, v=v, wo=normalize(-_v3(d_w)),
        prim_kind=torch.where(valid, PRIM_SPHERE, PRIM_NONE).to(i32),
        prim_id=idx.to(i32),
        mat_id=torch.where(valid, g(sph.mat_id), -1).to(i32),
        light_id=torch.where(valid, g(sph.light_id), -1).to(i32),
        inv_uv_scale=inv_uv)


def kernel_launches() -> dict:
    """Launches of every triangle kernel so far, by name: the sweeps'
    (``tri_sweep.launch_counts``) and the walks'
    (``bvh_walk.launch_counts``)."""
    from fountain_tpu_torch.geometry import bvh_walk, tri_sweep
    return {**tri_sweep.launch_counts, **bvh_walk.launch_counts}


def reset_kernel_launches() -> None:
    """Every triangle kernel's launch count to 0."""
    from fountain_tpu_torch.geometry import bvh_walk, tri_sweep
    tri_sweep.reset_launch_counts()
    bvh_walk.reset_launch_counts()


def intersect_faces(scene: Scene, o: V3, d: V3, t_max,
                    any_hit: bool = False):
    """(t, face_idx, found) over the scene's faces: the BVH walk above
    ``tensor_tri.MAX_DENSE_FACES`` faces, the sweeps at or below it."""
    if scene.triangles.count > tensor_tri.MAX_DENSE_FACES:
        from fountain_tpu_torch.geometry.bvh_walk import walk_intersect
        return walk_intersect(scene.bvh_nodes8, scene.bvh_tri_verts, o, d,
                              t_max, any_hit=any_hit)
    from fountain_tpu_torch.geometry.tri_sweep import mt_intersect_kernel
    return mt_intersect_kernel(scene.tri_sweep, o, d, t_max,
                               any_hit=any_hit)


def empty_results(n: int, device) -> tuple:
    """Uninitialised (t, face_idx, found) for ``n`` lanes in the format
    that ``intersect_faces`` returns for either kind of query, through the
    sweeps and through the walk: t float32, face_idx int32, found bool,
    each [n]."""
    return (torch.empty(n, dtype=torch.float32, device=device),
            torch.empty(n, dtype=torch.int32, device=device),
            torch.empty(n, dtype=torch.bool, device=device))


def answer_queries(scene: Scene, steps):
    """Run ``steps``, a generator that yields triangle queries as (o, d,
    t_max, any_hit) and takes each one's (t, face_idx, found) back,
    answering every query with ``intersect_faces`` (looked up on this
    module at call time); returns the generator's value."""
    try:
        query = next(steps)
        while True:
            o, d, t_max, any_hit = query
            result = intersect_faces(scene, o, d, t_max, any_hit=any_hit)
            # the query's rays are the generator's to free
            query = o = d = t_max = None
            query = steps.send(result)
    except StopIteration as stop:
        return stop.value


def scene_intersect_steps(scene: Scene, o: V3, d: V3, t_max):
    """``scene_intersect`` as a generator of its triangle query (see
    ``answer_queries``); returns the Hit."""
    if scene.spheres.count == 0:
        hit, cap = miss_hit(o, d), t_max
    else:
        oa, da = o.stack(), d.stack()
        t_s, idx_s, ok_s = intersect_spheres(scene.spheres, oa, da, t_max)
        cap = torch.where(ok_s, t_s, t_max)
        hit = sphere_hit_info(scene.spheres, idx_s, oa, da, cap, ok_s)
    if scene.triangles.count == 0:
        return hit
    from fountain_tpu_torch.geometry.triangle import triangle_hit_info
    t_t, idx_t, ok_t = yield o, d, cap, False
    tri_hit = triangle_hit_info(scene.tri_attr, idx_t, o, d, t_t, ok_t)
    return select_hit(ok_t, tri_hit, hit)


def scene_intersect_any_steps(scene: Scene, o: V3, d: V3, t_max):
    """``scene_intersect_any`` as a generator of its triangle query;
    returns the [N] bool."""
    blocked = None if scene.spheres.count == 0 else intersect_spheres_any(
        scene.spheres, o.stack(), d.stack(), t_max)
    if scene.triangles.count:
        occ = (yield o, d, t_max, True)[2]
        blocked = occ if blocked is None else blocked | occ
    if blocked is None:
        return torch.zeros(o.shape, dtype=torch.bool, device=o.x.device)
    return blocked


def scene_intersect(scene: Scene, o: V3, d: V3, t_max) -> Hit:
    """Closest hit over the scene; ``t_max < 0`` marks a dead lane."""
    return answer_queries(scene, scene_intersect_steps(scene, o, d, t_max))


def scene_intersect_any(scene: Scene, o: V3, d: V3, t_max) -> torch.Tensor:
    """Occlusion query: [N] bool."""
    return answer_queries(scene,
                          scene_intersect_any_steps(scene, o, d, t_max))

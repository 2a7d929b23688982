"""Batched ray-scene intersection for triangle-only scenes (PyTorch).

Counterpart of ``fountain_tpu/geometry/intersect.py``. The sweep backend is
chosen by the rays' device (``tri_sweep.mt_intersect_kernel``): the CUDA
kernels on a card, the plain version on the CPU. Spheres are not ported
yet and raise.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from fountain_tpu_torch.core.vecmath import (V3, normalize,
                                             offset_ray_origin, where3)
from fountain_tpu_torch.scene.types import Scene

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


def _require_triangles_only(scene: Scene) -> None:
    if scene.spheres.count:
        raise NotImplementedError(
            "spheres are not ported to fountain_tpu_torch")


def scene_intersect(scene: Scene, o: V3, d: V3, t_max) -> Hit:
    """Closest hit over the scene; ``t_max < 0`` marks a dead lane."""
    _require_triangles_only(scene)
    hit = miss_hit(o, d)
    if scene.triangles.count == 0:
        return hit
    from fountain_tpu_torch.geometry.tri_sweep import mt_intersect_kernel
    from fountain_tpu_torch.geometry.triangle import triangle_hit_info
    t_t, idx_t, ok_t = mt_intersect_kernel(scene.tri_sweep, o, d, t_max)
    tri_hit = triangle_hit_info(scene.tri_attr, idx_t, o, d, t_t, ok_t)
    return select_hit(ok_t, tri_hit, hit)


def scene_intersect_any(scene: Scene, o: V3, d: V3, t_max) -> torch.Tensor:
    """Occlusion query: [N] bool."""
    _require_triangles_only(scene)
    if scene.triangles.count == 0:
        return torch.zeros(o.shape, dtype=torch.bool, device=o.x.device)
    from fountain_tpu_torch.geometry.tri_sweep import mt_intersect_kernel
    return mt_intersect_kernel(scene.tri_sweep, o, d, t_max,
                               any_hit=True)[2]

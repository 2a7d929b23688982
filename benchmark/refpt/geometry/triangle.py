# Frozen copy of fountain_tpu_torch/geometry/triangle.py (commit 6354002): the benchmark's plain reference; edit never.
"""Triangle hit records: packed per-face attributes and hit refinement.

Counterpart of ``build_tri_attr``, ``woop_intersect_v3``,
``intersect_triangles(_any)`` and ``triangle_hit_info`` in
``fountain_tpu/geometry/triangle.py``: a sweep or the BVH walk returns
(t, face index); the hit record (barycentric point with error bounds, uv,
shading frame) comes from one watertight Woop test of that face, with
edge functions as compensated differences of products. The brute-force
``intersect_triangles`` is the walk's oracle in the tests.
"""
from __future__ import annotations

import numpy as np
import torch

from refpt.core.vecmath import (V3, coordinate_system, cross,
                                             dot, gamma, length, normalize,
                                             where3)
from refpt.geometry.intersect import (PRIM_NONE, PRIM_TRIANGLE,
                                                   Hit, _v3)

_SPLIT = 4097.0  # 2^12 + 1 Veltkamp split constant for f32


def _two_prod(a, b):
    """Error-free product: a*b = p + e exactly (Dekker/Veltkamp in f32)."""
    p = a * b
    a_hi = (a * _SPLIT) - ((a * _SPLIT) - a)
    a_lo = a - a_hi
    b_hi = (b * _SPLIT) - ((b * _SPLIT) - b)
    b_lo = b - b_hi
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def _diff_of_products(a, b, c, d):
    """Compensated a*b - c*d."""
    p1, e1 = _two_prod(a, b)
    p2, e2 = _two_prod(c, d)
    return (p1 - p2) + (e1 - e2)


def woop_intersect_v3(p0: V3, p1: V3, p2: V3, o: V3, d: V3, t_max):
    """Watertight ray-triangle test, one face per lane (all flat [N]).
    Returns (t, b0, b1, b2, valid)."""
    p0t, p1t, p2t = p0 - o, p1 - o, p2 - o
    ax, ay, az = d.x.abs(), d.y.abs(), d.z.abs()
    kz0 = (ax >= ay) & (ax >= az)   # dominant axis x -> kz = 0
    kz1 = ~kz0 & (ay >= az)         # dominant axis y -> kz = 1

    def permute(v: V3) -> V3:
        # kz=0: (y,z,x); kz=1: (z,x,y); kz=2: (x,y,z)
        x = torch.where(kz0, v.y, torch.where(kz1, v.z, v.x))
        y = torch.where(kz0, v.z, torch.where(kz1, v.x, v.y))
        z = torch.where(kz0, v.x, torch.where(kz1, v.y, v.z))
        return V3(x, y, z)

    dt = permute(d)
    p0t, p1t, p2t = permute(p0t), permute(p1t), permute(p2t)
    inv_dz = 1.0 / dt.z
    sx = -dt.x * inv_dz
    sy = -dt.y * inv_dz
    sz = inv_dz
    x0 = p0t.x + sx * p0t.z
    y0 = p0t.y + sy * p0t.z
    x1 = p1t.x + sx * p1t.z
    y1 = p1t.y + sy * p1t.z
    x2 = p2t.x + sx * p2t.z
    y2 = p2t.y + sy * p2t.z

    e0 = _diff_of_products(x1, y2, y1, x2)
    e1 = _diff_of_products(x2, y0, y2, x0)
    e2 = _diff_of_products(x0, y1, y0, x1)
    same_sign = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0)) | \
                ((e0 <= 0) & (e1 <= 0) & (e2 <= 0))
    det = e0 + e1 + e2
    nondegen = det != 0.0

    z0 = sz * p0t.z
    z1 = sz * p1t.z
    z2 = sz * p2t.z
    t_scaled = e0 * z0 + e1 * z1 + e2 * z2
    neg = det < 0.0
    in_range = torch.where(
        neg,
        (t_scaled <= 0.0) & (t_scaled > det * t_max),
        (t_scaled >= 0.0) & (t_scaled < det * t_max))

    inv_det = 1.0 / torch.where(det == 0.0, 1.0, det)
    t = t_scaled * inv_det
    b0 = e0 * inv_det
    b1 = e1 * inv_det
    b2 = e2 * inv_det

    def m3(a, b, c):
        return torch.maximum(torch.maximum(a.abs(), b.abs()), c.abs())
    max_zt = m3(z0, z1, z2)
    max_xt = m3(x0, x1, x2)
    max_yt = m3(y0, y1, y2)
    delta_z = gamma(3) * max_zt
    delta_x = gamma(5) * (max_xt + max_zt)
    delta_y = gamma(5) * (max_yt + max_zt)
    delta_e = 2.0 * (gamma(2) * max_xt * max_yt + delta_y * max_xt
                     + delta_x * max_yt)
    max_e = m3(e0, e1, e2)
    delta_t = 3.0 * (gamma(3) * max_e * max_zt + delta_e * max_zt
                     + delta_z * max_e) * inv_det.abs()
    valid = same_sign & nondegen & in_range & (t > delta_t)
    return t, b0, b1, b2, valid


def _chunk_tests(tris, o, d, t_lim, base: int, chunk: int):
    """Woop tests of rays [N] against faces [base, base + chunk): (t,
    valid), each [N, C], every face tested against its ray's t_lim."""
    fidx = tris.indices[base:base + chunk].long()
    pv = tris.positions[fidx]                       # [C, 3, 3]
    o3, d3 = _v3(o[:, None, :]), _v3(d[:, None, :])
    t, _, _, _, valid = woop_intersect_v3(
        *(_v3(pv[None, :, k, :]) for k in range(3)), o3, d3,
        t_lim[:, None])
    return t, valid


def intersect_triangles(tris, o, d, t_max, chunk: int = 1024):
    """Closest hit over the whole face table by brute force (the oracle
    of the BVH walk): (t, face_idx, valid), each [N]; o, d [N, 3].

    Chunked running minimum of the Woop test, each chunk against the best
    t of the chunks before it; within a chunk the lowest t wins, the
    lowest face index among equal t.
    """
    n, dev = o.shape[0], o.device
    t_best = torch.where(torch.isfinite(t_max), t_max,
                         torch.full_like(t_max, float("inf")))
    i_best = torch.zeros(n, dtype=torch.int32, device=dev)
    ok_best = torch.zeros(n, dtype=torch.bool, device=dev)
    for base in range(0, tris.count, chunk):
        t, valid = _chunk_tests(tris, o, d, t_best, base, chunk)
        t = torch.where(valid, t, float("inf"))
        j = torch.argmin(t, dim=-1)
        t_c = torch.gather(t, 1, j[:, None])[:, 0]
        ok_c = torch.gather(valid, 1, j[:, None])[:, 0]
        better = ok_c & (t_c < t_best)
        t_best = torch.where(better, t_c, t_best)
        i_best = torch.where(better, (base + j).to(torch.int32), i_best)
        ok_best = ok_best | better
    return torch.where(ok_best, t_best, float("inf")), i_best, ok_best


def intersect_triangles_any(tris, o, d, t_max, chunk: int = 1024
                            ) -> torch.Tensor:
    """Occlusion by brute force: [N] bool, some face hit inside t_max."""
    blocked = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    for base in range(0, tris.count, chunk):
        blocked = blocked | _chunk_tests(tris, o, d, t_max, base,
                                         chunk)[1].any(-1)
    return blocked


def build_tri_attr(indices: np.ndarray, positions: np.ndarray,
                   normals: np.ndarray, uv: np.ndarray, mat_id: np.ndarray,
                   light_id: np.ndarray, has_normals: np.ndarray,
                   flip_normal: np.ndarray, device) -> torch.Tensor:
    """[F, 32] f32 per-face row: 0:9 p0p1p2 | 9:18 n0n1n2 | 18:24 uv0uv1uv2
    | 24 mat_id | 25 light_id | 26 flags (has_normals | flip << 1). Ids and
    flags are stored as float values (exact below 2^24)."""
    f = len(indices)
    out = np.zeros((f, 32), np.float32)
    out[:, 0:9] = np.asarray(positions, np.float32)[indices].reshape(f, 9)
    out[:, 9:18] = np.asarray(normals, np.float32)[indices].reshape(f, 9) \
        if np.asarray(normals).size else 0.0
    uv_all = np.asarray(uv, np.float32)[indices].reshape(f, 6)
    # default barycentric uvs where a face has none
    uv_all[np.all(uv_all == 0.0, axis=-1)] = np.asarray(
        [0, 0, 1, 0, 1, 1], np.float32)
    out[:, 18:24] = uv_all
    out[:, 24] = np.asarray(mat_id, np.float32)
    out[:, 25] = np.asarray(light_id, np.float32)
    out[:, 26] = (np.asarray(has_normals).astype(np.int32)
                  | (np.asarray(flip_normal).astype(np.int32) << 1))
    return torch.as_tensor(out, device=device)


def triangle_hit_info(attr: torch.Tensor, face_idx, o: V3, d: V3, t,
                      valid) -> Hit:
    """Full surface interaction for per-ray face ``face_idx`` from the
    packed attribute table (one row gather per lane)."""
    rows = attr[face_idx]
    g = lambda k: rows[:, k]                      # noqa: E731
    p0 = V3(g(0), g(1), g(2))
    p1 = V3(g(3), g(4), g(5))
    p2 = V3(g(6), g(7), g(8))
    n0 = V3(g(9), g(10), g(11))
    n1 = V3(g(12), g(13), g(14))
    n2 = V3(g(15), g(16), g(17))
    uv0, uv1, uv2 = (g(18), g(19)), (g(20), g(21)), (g(22), g(23))
    mat_id = g(24).to(torch.int32)
    light_id = g(25).to(torch.int32)
    flags = g(26).to(torch.int32)
    has_n = (flags & 1) != 0
    flip = (flags & 2) != 0

    _, b0, b1, b2, _ = woop_intersect_v3(
        p0, p1, p2, o, d,
        torch.where(valid, t * 1.0001 + 1e-5, float("inf")))
    p = p0 * b0 + p1 * b1 + p2 * b2
    x_abs = (p0 * b0).abs() + (p1 * b1).abs() + (p2 * b2).abs()
    p_err = x_abs * gamma(7)
    u_hit = b0 * uv0[0] + b1 * uv1[0] + b2 * uv2[0]
    v_hit = b0 * uv0[1] + b1 * uv1[1] + b2 * uv2[1]

    # partial derivatives from the uv parameterization
    du02 = uv0[0] - uv2[0]
    dv02 = uv0[1] - uv2[1]
    du12 = uv1[0] - uv2[0]
    dv12 = uv1[1] - uv2[1]
    dp02 = p0 - p2
    dp12 = p1 - p2
    det_uv = du02 * dv12 - dv02 * du12
    degen_uv = det_uv.abs() < 1e-12
    inv_det = 1.0 / torch.where(degen_uv, 1.0, det_uv)
    dpdu = (dp02 * dv12 - dp12 * dv02) * inv_det
    dpdv = (dp12 * du02 - dp02 * du12) * inv_det

    ng = normalize(cross(dp02, dp12))
    _, fb_ss, _ = coordinate_system(ng)
    dpdu = where3(degen_uv, fb_ss, dpdu)
    ng = where3(flip, -ng, ng)

    # interpolated shading normal
    ns_interp = normalize(n0 * b0 + n1 * b1 + n2 * b2)
    ns_interp = where3(flip, -ns_interp, ns_interp)
    degenerate_ns = length(ns_interp) < 0.5
    ns = where3(has_n & ~degenerate_ns, ns_interp, ng)
    # orient the geometric normal to the shading-normal side
    ng = where3(dot(ng, ns) < 0.0, -ng, ng)

    # shading tangent from dpdu, re-orthogonalized against ns
    ss = normalize(dpdu - ns * dot(dpdu, ns))
    bad = length(ss) < 1e-6
    _, alt_ss, _ = coordinate_system(ns)
    ss = where3(bad, alt_ss, ss)
    ts = cross(ns, ss)

    wo = normalize(-d)
    inv_uv = torch.maximum(1.0 / length(dpdu).clamp_min(1e-12),
                           1.0 / length(dpdv).clamp_min(1e-12))
    inv_uv = torch.where(degen_uv, 0.0, inv_uv)
    i32 = torch.int32
    return Hit(
        valid=valid, t=torch.where(valid, t, float("inf")), p=p, p_err=p_err,
        n=ng, ns=ns, ss=ss, ts=ts, u=u_hit, v=v_hit, wo=wo,
        prim_kind=torch.where(valid, PRIM_TRIANGLE, PRIM_NONE).to(i32),
        prim_id=face_idx.to(i32),
        mat_id=torch.where(valid, mat_id, -1).to(i32),
        light_id=torch.where(valid, light_id, -1).to(i32),
        inv_uv_scale=inv_uv)

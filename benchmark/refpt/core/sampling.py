# Frozen copy of fountain_tpu_torch/core/sampling.py (commit 6354002): the benchmark's plain reference; edit never.
"""Sampling warps and the env-map alias tables (PyTorch).

Counterpart of the parts of ``fountain_tpu/core/sampling.py`` that the
renders reach: the warps (disk, hemisphere, sphere, triangle), the power
heuristic, and the O(1) Vose alias tables (env-map texels, and the faces
of mesh area lights).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from refpt.core.vecmath import PI, PI_OVER_2, PI_OVER_4, V3


def concentric_sample_disk(u1, u2):
    """Map U[0,1)^2 to the unit disk, concentric mapping. Returns (x, y)."""
    ox = 2.0 * u1 - 1.0
    oy = 2.0 * u2 - 1.0
    at_origin = (ox == 0.0) & (oy == 0.0)
    use_x = ox.abs() > oy.abs()
    r = torch.where(use_x, ox, oy)
    safe_div = torch.where(use_x,
                           oy / torch.where(ox == 0.0, 1.0, ox),
                           ox / torch.where(oy == 0.0, 1.0, oy))
    theta = torch.where(use_x, PI_OVER_4 * safe_div,
                        PI_OVER_2 - PI_OVER_4 * safe_div)
    x = torch.where(at_origin, 0.0, r * torch.cos(theta))
    y = torch.where(at_origin, 0.0, r * torch.sin(theta))
    return x, y


def cosine_sample_hemisphere(u1, u2) -> V3:
    """Cosine-weighted hemisphere about +z."""
    x, y = concentric_sample_disk(u1, u2)
    z = torch.sqrt((1.0 - x * x - y * y).clamp_min(0.0))
    return V3(x, y, z)


def uniform_sample_sphere(u1, u2) -> V3:
    z = 1.0 - 2.0 * u1
    r = torch.sqrt((1.0 - z * z).clamp_min(0.0))
    phi = 2.0 * PI * u2
    return V3(r * torch.cos(phi), r * torch.sin(phi), z)


def uniform_sample_triangle(u1, u2):
    """Barycentrics (b0, b1) uniform over a triangle."""
    su0 = torch.sqrt(u1)
    return 1.0 - su0, u2 * su0


def power_heuristic(nf, f_pdf, ng, g_pdf):
    """Power heuristic (beta=2) MIS weight, guarded against 0/0."""
    f = nf * f_pdf
    g = ng * g_pdf
    denom = f * f + g * g
    return torch.where(denom > 0.0,
                       f * f / torch.where(denom == 0.0, 1.0, denom), 0.0)


def vose_alias(pmf):
    """Host-side Vose alias table: (prob [n] f32, alias [n] i32) such that
    drawing j = floor(u*n) and taking j if frac(u*n) < prob[j] else
    alias[j] samples index i with probability pmf[i]."""
    pmf = np.asarray(pmf, np.float64)
    n = len(pmf)
    prob = pmf * n
    alias = np.arange(n, dtype=np.int64)
    small = [i for i in range(n) if prob[i] < 1.0]
    large = [i for i in range(n) if prob[i] >= 1.0]
    while small and large:
        s = small.pop()
        lg = large.pop()
        alias[s] = lg
        prob[lg] = (prob[lg] + prob[s]) - 1.0
        (small if prob[lg] < 1.0 else large).append(lg)
    for i in large + small:
        prob[i] = 1.0
    return prob.astype(np.float32), alias.astype(np.int32)


@dataclass
class EnvAlias:
    """Per-light stacked texel alias tables: prob/alias [S, nv*nu];
    func [S, nv, nu] (the luminance*sin(theta) density); func_mean [S]."""
    prob: torch.Tensor
    alias: torch.Tensor
    func: torch.Tensor
    func_mean: torch.Tensor


def make_env_alias_stack(funcs, device) -> EnvAlias:
    """Stack per-light [nv, nu] density funcs (same shape) into an
    EnvAlias. Host-side; zero-total funcs fall back to uniform."""
    probs, aliases, fs, means = [], [], [], []
    for f in funcs:
        f = np.asarray(f, np.float64)
        if f.sum() <= 0.0:
            f = np.ones_like(f)
        p, a = vose_alias((f / f.sum()).reshape(-1))
        probs.append(p)
        aliases.append(a)
        fs.append(f.astype(np.float32))
        means.append(np.float32(f.mean()))
    return EnvAlias(*(torch.as_tensor(np.stack(x), device=device)
                      for x in (probs, aliases, fs, means)))


# In-cell offsets are capped just below 1 so (i + offset)/n can never round
# into the next cell.
_CELL_EPS = 1.0 - 2.0 ** -10


def sample_env_alias(ea: EnvAlias, slot, u1, u2):
    """Per-lane O(1) sample of a stacked EnvAlias: returns (u, v, pdf_uv),
    the pdf taken w.r.t. the unit square. u1 picks the texel through the
    alias table (its in-cell residual becomes the in-texel u offset); u2
    is the in-texel v offset."""
    s, nv, nu = ea.func.shape
    nm = nv * nu
    f0 = u1 * nm
    j0 = f0.to(torch.int32).clamp(0, nm - 1)
    frac = (f0 - j0.to(torch.float32)).clamp(0.0, _CELL_EPS)
    base = slot * nm
    p = ea.prob.reshape(-1)[base + j0]
    take = frac >= p
    k = torch.where(take, ea.alias.reshape(-1)[base + j0], j0)
    resid = torch.where(take,
                        (frac - p) / (1.0 - p).clamp_min(1e-12),
                        frac / p.clamp_min(1e-12))
    resid = resid.clamp(0.0, _CELL_EPS)
    iv = torch.div(k, nu, rounding_mode="floor")
    iu = k - iv * nu
    u = (iu.to(torch.float32) + resid) / nu
    v = (iv.to(torch.float32) + u2.clamp_max(_CELL_EPS)) / nv
    pdf = ea.func.reshape(-1)[base + k] / ea.func_mean[slot].clamp_min(1e-30)
    return u, v, pdf


def pdf_env_alias(ea: EnvAlias, slot, u, v):
    """Pdf of sample_env_alias at continuous (u, v): one flat gather."""
    s, nv, nu = ea.func.shape
    iu = (u * nu).to(torch.int32).clamp(0, nu - 1)
    iv = (v * nv).to(torch.int32).clamp(0, nv - 1)
    k = slot * (nv * nu) + iv * nu + iu
    return ea.func.reshape(-1)[k] / ea.func_mean[slot].clamp_min(1e-30)

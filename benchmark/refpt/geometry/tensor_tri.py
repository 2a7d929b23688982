# Frozen copy of fountain_tpu_torch/geometry/tensor_tri.py (commit 6354002): the benchmark's plain reference; edit never.
"""Dense ray-triangle intersection: Möller–Trumbore as one matmul (PyTorch).

Counterpart of ``fountain_tpu/geometry/tensor_tri.py`` and the plain
version of both triangle sweeps: every Möller–Trumbore quantity is
bilinear in the ray features R = [d, o×d, o, 1] and per-face features, so
N rays against a chunk of C faces is one [N, 10] @ [10, 4C] matmul plus an
elementwise acceptance epilogue. Per face (n = e1×e2, w1 = v0×e1,
w2 = v0×e2, k = v0·n):

  det = −d·n,  u·det = (o×d)·e2 + d·w2,  v·det = −(o×d)·e1 − d·w1,
  t·det = o·n − k.

Acceptance multiplies through by sign(det) and widens the barycentric
tests by REL_EPS·|det| so shared edges never leak (a graze counts on both
faces; the nearer t wins).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# relative slack on the barycentric edge tests (units of |det|)
REL_EPS = 1e-4
# the dense budget: above this face count a scene goes through the BVH
# walk instead of the sweeps (geometry.intersect.intersect_faces)
MAX_DENSE_FACES = 65536
# pair-block budget: chunk C chosen so N * C * 4 stays under this many floats
PAIR_BUDGET = 1 << 27


@dataclass
class TriFeatures:
    packed: torch.Tensor  # [10, F, 4] f32 (det, u_num, v_num, t_num) columns

    @property
    def count(self) -> int:
        return self.packed.shape[1]


def build_tri_features(tri_verts: np.ndarray, device) -> TriFeatures:
    """tri_verts: [F, 3, 3] world vertices (leaf order); coefficients are
    computed in float64 on the host, then rounded to f32."""
    tv = np.asarray(tri_verts, np.float64)
    v0 = tv[:, 0]
    e1 = tv[:, 1] - v0
    e2 = tv[:, 2] - v0
    n = np.cross(e1, e2)
    w1 = np.cross(v0, e1)
    w2 = np.cross(v0, e2)
    k = (v0 * n).sum(-1)
    packed = np.zeros((10, len(tv), 4), np.float32)
    packed[0:3, :, 0] = -n.T            # det   = -d.n
    packed[0:3, :, 1] = w2.T            # u_num =  d.w2 + (oxd).e2
    packed[3:6, :, 1] = e2.T
    packed[0:3, :, 2] = -w1.T           # v_num = -d.w1 - (oxd).e1
    packed[3:6, :, 2] = -e1.T
    packed[6:9, :, 3] = n.T             # t_num =  o.n - k
    packed[9, :, 3] = -k
    return TriFeatures(packed=torch.as_tensor(packed, device=device))


def ray_features(o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """[N, 10] = [d, o×d, o, 1] for o, d [N, 3]."""
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    oxd = torch.stack([oy * dz - oz * dy, oz * dx - ox * dz,
                       ox * dy - oy * dx], dim=-1)
    return torch.cat([d, oxd, o, torch.ones_like(ox)[:, None]], dim=-1)


def mt_intersect(feat: TriFeatures, o, d, t_max, chunk: int = 0,
                 t_eps: float = 1e-4, any_hit: bool = False):
    """Closest hit (or any hit) over the dense face table.

    o, d: [N, 3]; t_max: [N] (< 0 marks a dead lane). Returns
    (t, face_idx, found); a miss is (inf, 0, False). In any-hit mode only
    ``found`` is meaningful. Face chunks are streamed with a running
    per-ray min so the pair matrix never exceeds PAIR_BUDGET floats; ties
    go to the lowest face index.
    """
    f = feat.count
    n = o.shape[0]
    if chunk <= 0:
        chunk = int(max(256, min(8192, PAIR_BUDGET // max(n * 4, 1))))
    rf = ray_features(o, d)
    t_best = torch.where(torch.isfinite(t_max), t_max,
                         torch.full_like(t_max, 3e38))
    i_best = torch.zeros(n, dtype=torch.int32, device=o.device)
    found = torch.zeros(n, dtype=torch.bool, device=o.device)
    for base in range(0, f, chunk):
        blk = feat.packed[:, base:base + chunk]
        c = blk.shape[1]
        out = (rf @ blk.reshape(10, c * 4)).reshape(n, c, 4)
        det, u_num, v_num, t_num = out.unbind(-1)
        s = torch.sign(det)
        adet = det.abs()
        U = u_num * s
        V = v_num * s
        T = t_num * s
        eps = REL_EPS * adet
        valid = (adet > 1e-20) & (U >= -eps) & (V >= -eps) \
            & (U + V <= adet + eps) & (T > t_eps * adet) \
            & (T < t_best[:, None] * adet)
        t = torch.where(valid, T / torch.where(adet == 0.0, 1.0, adet),
                        float("inf"))
        t_c, j = torch.min(t, dim=-1)
        ok_c = torch.gather(valid, 1, j[:, None])[:, 0]
        better = ok_c & (t_c < t_best)
        t_best = torch.where(better, t_c, t_best)
        i_best = torch.where(better, (base + j).to(torch.int32), i_best)
        found = found | better
    if any_hit:
        return t_best, i_best, found
    return torch.where(found, t_best, float("inf")), i_best, found

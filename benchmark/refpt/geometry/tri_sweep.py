# Frozen copy of fountain_tpu_torch/geometry/tri_sweep.py (commit 6354002), CUDA branches taken out: the benchmark's plain reference; edit never.
"""The sweeps' face tables and the plain Möller–Trumbore sweeps.

The port's module of the same name, with its CUDA library, kernels and
launch counts taken out: every call takes the plain PyTorch version
(``tensor_tri.mt_intersect``), on the CPU and on a card alike.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from refpt.core.vecmath import V3
from refpt.geometry.tensor_tri import (TriFeatures,
                                                    build_tri_features,
                                                    mt_intersect)

BLOCK_FACES = 128      # faces per leaf block (one shared-memory stage)
COEF_PER_FACE = 16     # the non-zero ones of a face's 10 x 4 coefficients

# Where each of a face's 16 kernel coefficients sits in the plain
# version's [10, F, 4] table (ray feature k, quantity): rows of 4, in the
# order the kernel's FMA chains read them. Quantity 0 is det (-n against
# d), 1 is u (w2, e2), 2 is v (-w1, -e1), 3 is t (n against o, then -k);
# t's n is -det's, so the kernel reads it from row 0.
_COMPACT = ((0, 0), (1, 0), (2, 0), (9, 3),
            (0, 1), (1, 1), (2, 1), (3, 1),
            (4, 1), (5, 1), (0, 2), (1, 2),
            (2, 2), (3, 2), (4, 2), (5, 2))



@dataclass
class SweepTable:
    """Face tables of both sweeps, faces in LBVH leaf order.

    feat:   [10, F, 4] f32 coefficients (the plain version's table);
    coef:   [Fpad / 128, 4, 128, 4] f32, each face's 16 non-zero
            coefficients (see ``_COMPACT``) as 4 rows of 4, row-major within
            each 128-face block ([block][row][face][4]; one block is one
            contiguous 8 KB stage), padded with zero faces (det = 0, never
            accepted) to a multiple of 128;
    bounds: [Fpad / 128, 8] f32 block AABBs (min xyz, max xyz, 0, 0),
            widened so the kernels' block cull stays conservative.
    """
    feat: TriFeatures
    coef: torch.Tensor
    bounds: torch.Tensor

    @property
    def count(self) -> int:
        return self.feat.count

    @property
    def n_blocks(self) -> int:
        return self.bounds.shape[0]


def pack_sweep_table(tri_verts: np.ndarray, device,
                     feat: TriFeatures | None = None) -> SweepTable:
    """Build both sweeps' tables from [F, 3, 3] leaf-ordered vertices.

    ``feat`` (optional) supplies the [10, F, 4] coefficients instead of
    computing them, so a scene carried over from another build traces the
    identical table.
    """
    tv = np.asarray(tri_verts, np.float32)
    f = len(tv)
    if feat is None:
        feat = build_tri_features(tv, device)
    n_blk = max(-(-f // BLOCK_FACES), 1)
    coef = torch.zeros((n_blk * BLOCK_FACES, COEF_PER_FACE),
                       dtype=torch.float32, device=device)
    coef[:f] = compact_coefficients(feat.packed)
    coef = coef.reshape(n_blk, BLOCK_FACES, 4, 4).permute(0, 2, 1, 3) \
        .contiguous()
    bounds = np.zeros((n_blk, 8), np.float32)
    for b in range(n_blk):
        blk = tv[b * BLOCK_FACES:(b + 1) * BLOCK_FACES].reshape(-1, 3)
        if not len(blk):
            # all-padding block: an empty (inverted) box no ray enters
            bounds[b, 0:3], bounds[b, 3:6] = 1.0, -1.0
            continue
        lo, hi = blk.min(0), blk.max(0)
        # The watertight slack accepts hits up to ~REL_EPS (1e-4) outside a
        # face in barycentric units; widen by 1e-3 of the block extent plus
        # a few ulps of the coordinates so the cull never drops such a hit.
        pad = 1e-3 * float((hi - lo).max()) \
            + 1e-6 * float(np.abs(blk).max()) + 1e-30
        bounds[b, 0:3] = lo - pad
        bounds[b, 3:6] = hi + pad
    return SweepTable(feat=feat, coef=coef,
                      bounds=torch.as_tensor(bounds, device=device))


def compact_coefficients(packed: torch.Tensor) -> torch.Tensor:
    """[F, 16]: the non-zero coefficients of a [10, F, 4] table, in the
    kernel's order. Raises unless the other 24 are zero and t's normal is
    det's negated, as ``build_tri_features`` makes them."""
    dense = torch.zeros_like(packed)
    k, qty = zip(*_COMPACT)
    dense[list(k), :, list(qty)] = packed[list(k), :, list(qty)]
    dense[6:9, :, 3] = -packed[0:3, :, 0]
    if not torch.equal(dense, packed):
        raise ValueError("face table is not the Möller–Trumbore table of "
                         "build_tri_features")
    return packed[list(k), :, list(qty)].T.contiguous()


def dense_coefficients(compact: torch.Tensor) -> torch.Tensor:
    """The [10, F, 4] table that [F, 16] compact coefficients stand for."""
    dense = compact.new_zeros((10, compact.shape[0], 4))
    k, qty = zip(*_COMPACT)
    dense[list(k), :, list(qty)] = compact.T
    dense[6:9, :, 3] = -compact[:, 0:3].T
    return dense



def closest_hit_plain(table: SweepTable, o: V3, d: V3, t_cap,
                      t_eps: float = 1e-4):
    """Plain PyTorch closest-hit sweep: (t, idx), t = t_cap and idx = -1
    on a miss."""
    t, idx, found = mt_intersect(table.feat, o.stack(), d.stack(), t_cap,
                                 t_eps=t_eps)
    return torch.where(found, t, t_cap), torch.where(found, idx, -1)


def any_hit_plain(table: SweepTable, o: V3, d: V3, t_cap,
                  t_eps: float = 1e-4):
    """Plain PyTorch any-hit sweep: occluded [N] bool."""
    return mt_intersect(table.feat, o.stack(), d.stack(), t_cap,
                        t_eps=t_eps, any_hit=True)[2]


def mt_intersect_kernel(table: SweepTable, o: V3, d: V3, t_max,
                        t_eps: float = 1e-4, any_hit: bool = False):
    """Closest-hit (or any-hit) sweep over the scene's faces, always the
    plain version, on any device: ``t_max = inf`` becomes the cap 3e38,
    ``t_max < 0`` marks a dead lane, a miss is (t=inf, idx=0,
    found=False), and in any-hit mode only the boolean is meaningful. The
    rays are detached: a sweep carries no gradient."""
    o = V3(o.x.detach(), o.y.detach(), o.z.detach())
    d = V3(d.x.detach(), d.y.detach(), d.z.detach())
    t_max = t_max.detach()
    t_cap = torch.where(torch.isfinite(t_max), t_max,
                        torch.full_like(t_max, 3e38))
    if any_hit:
        occ = any_hit_plain(table, o, d, t_cap, t_eps)
        return torch.zeros_like(t_cap), torch.zeros_like(
            occ, dtype=torch.int32), occ
    t, idx = closest_hit_plain(table, o, d, t_cap, t_eps)
    found = idx >= 0
    return torch.where(found, t, float("inf")), idx.clamp_min(0), found

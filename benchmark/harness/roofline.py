"""The kernels' yardstick: peaks of the card, the work an LBVH walk needs
on a query's rays, and the bound that work sets.

Frozen from ``chip_smoke.py`` (commit 6354002): ``walk_work``,
``walk_bound`` and their constants, ``events_ms``. The work is counted
by the benchmark's own frozen walk (``refpt.geometry.bvh.bvh_intersect``
over the nodes of ``refpt``'s numpy LBVH build of the faces it reads
from the scene files), so the bound depends only on the rays and the
faces, never on which implementation answered the query.
"""
from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM published peak, at 700 W
FP32_FLOPS = 67e12          # H100 SXM FP32 (non-tensor) published peak
# FP32 operations of the walk (no FMAs; abs and negation, bit operations,
# not counted). A node visit, the slab test: 6 subtractions and 6
# multiplications for the six slab distances, 3 min and 3 max of their
# pairs, 2 max for t_near, 2 min for t_far, 1 multiplication by
# 1 + 2 gamma(3), 3 comparisons: 26.
SLAB_OPS = 26
# A leaf slot, the Woop test: 9 subtractions (translate), 12 (shear), 111
# (three compensated differences of products: two Veltkamp products of 17
# and 3 subtractions or additions each), 6 comparisons (same sign), 2
# (det), 3 (z), 5 (t_scaled), 4 (in range), 2 (det = 0 and 1 / det), 1
# (t), 6 (three maxima of three), 12 (delta_z, delta_x, delta_y,
# delta_e), 2 (max_e), 8 (delta_t), 2 (det != 0, t > delta_t): 185.
WOOP_OPS = 185
# A live ray's setup: 3 tests d = 0 and 3 reciprocals, 3 comparisons for
# the dominant axis, the t_max tests (2), 1 / d_z and the shear's 2
# multiplications: 14.
RAY_OPS = 14


def walk_work(ref_scene, o, d, t_max, any_hit: bool) -> dict:
    """The work these rays need in an LBVH walk over ``ref_scene``'s faces,
    counted by the frozen plain walk: node visits, leaf slots tested,
    distinct node and vertex rows read, and the live rays (t_max > 0
    after a non-finite limit becomes 3e38). o, d: [N, 3]."""
    from refpt.geometry.bvh import bvh_intersect
    stats = {}
    with torch.no_grad():
        bvh_intersect(ref_scene.bvh_nodes8, ref_scene.bvh_tri_verts, o, d,
                      t_max, any_hit=any_hit, stats=stats)
    t = torch.where(torch.isfinite(t_max), t_max,
                    torch.full_like(t_max, 3e38))
    stats["live"] = int((t > 0).sum())
    return stats


def walk_bound(any_hit: bool, n: int, work: dict):
    """(bound ms, "bytes" or "operations", bytes, operations) of a query of
    ``n`` rays: rays in (7 floats) and results out (t and index, or one
    flag), the distinct node rows (32 B) and vertex rows (36 B) read, over
    the HBM rate; the operations the work needs over the FP32 rate."""
    bytes_ = n * 28 + n * (1 if any_hit else 8) \
        + work["nodes_touched"] * 32 + work["faces_touched"] * 36
    ops = work["node_visits"] * SLAB_OPS + work["woop_tests"] * WOOP_OPS \
        + work["live"] * RAY_OPS
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes
                                 else "bytes"), bytes_, ops


def events_ms(call, reps: int) -> float:
    """CUDA events around ``reps`` back-to-back calls, after one warm
    call: ms each."""
    call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps

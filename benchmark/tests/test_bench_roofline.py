"""The kernels' roofline: the walk-work count on a tiny mesh equals a hand
count, and a wave's bound is the same whichever implementation answers
the query (the sweeps, or the BVH walk as the port takes it above
``MAX_DENSE_FACES``)."""
import numpy as np
import pytest
import torch

from bench_tiny import TINY
from harness import cells, impl as impls, roofline, tracing


def _quad_scene():
    from refpt.geometry.bvh import attach_bvh
    from refpt.scene.build import SceneBuilder
    b = SceneBuilder()
    mat = b.add_matte(kd=[0.5, 0.5, 0.5])
    b.add_triangle_mesh(
        np.asarray([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                   np.float32),
        np.asarray([[0, 1, 2], [0, 2, 3]], np.int32), mat_id=mat)
    return attach_bvh(b.build(device="cpu"))


def test_walk_work_equals_a_hand_count():
    scene = _quad_scene()
    assert scene.bvh_nodes8.shape[0] == 1        # one leaf of both faces
    o = torch.tensor([[0.2, 0.3, 1.0], [0.2, 0.3, 1.0], [0.0, 0.0, 1.0]])
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, 1.0], [0.0, 0.0, -1.0]])
    t_max = torch.tensor([float("inf"), float("inf"), -1.0])
    # ray 0 enters the leaf and tests both faces; ray 1 points away and
    # fails the slab test; ray 2 is dead (t_max < 0) and never starts
    work = roofline.walk_work(scene, o, d, t_max, any_hit=False)
    assert (work["node_visits"], work["woop_tests"], work["live"],
            work["nodes_touched"], work["faces_touched"]) == (2, 2, 2, 1, 2)
    ms, by, bytes_, ops = roofline.walk_bound(False, 3, work)
    assert ops == 2 * 26 + 2 * 185 + 2 * 14
    assert bytes_ == 3 * 28 + 3 * 8 + 1 * 32 + 2 * 36
    assert by == "bytes"
    assert ms == pytest.approx(bytes_ / 3.35e12 * 1e3)


def _wave_rows(monkeypatch, force_walk):
    from fountain_tpu_torch.geometry import bvh_walk, tensor_tri
    from harness import runner
    walks = []
    if force_walk:
        monkeypatch.setattr(tensor_tri, "MAX_DENSE_FACES", 0)
        original = bvh_walk.walk_intersect

        def counted(*a, **k):
            walks.append(1)
            return original(*a, **k)
        monkeypatch.setattr(bvh_walk, "walk_intersect", counted)
    cell = cells.find_cell("rounded_cube_env.render_regen")
    traffic = {**cell.traffic, **TINY["render_regen"]}
    port = impls.port()
    drv, scene, _ = runner.build(port, cell, traffic, torch.device("cpu"))
    captured = tracing.capture_queries(drv, port, 11)
    ref_scene = impls.reference().load_pbrt(str(cell.scene_path()),
                                            device="cpu")[0]
    rows = tracing.time_queries(captured, port, scene, ref_scene,
                                torch.device("cpu"))
    monkeypatch.undo()
    return rows, len(walks)


def test_bound_is_the_same_through_the_sweeps_and_the_walk(monkeypatch):
    swept, n_sweep_walks = _wave_rows(monkeypatch, False)
    walked, n_walks = _wave_rows(monkeypatch, True)
    assert n_sweep_walks == 0 and n_walks > 0
    keys = ("kind", "launch", "rays", "bound_ms", "bound_by", "bytes",
            "operations", "node_visits", "woop_tests")
    assert [(r["kind"], r["launch"]) for r in swept] == [
        ("any", 0), ("any", 8), ("closest", 0), ("closest", 8)]
    assert [{k: r[k] for k in keys} for r in swept] == \
        [{k: r[k] for k in keys} for r in walked]
    assert all(r["ms"] is None for r in swept)   # no device time on the CPU

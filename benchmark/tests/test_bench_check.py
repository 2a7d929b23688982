"""What decides ``correct``: a sound run passes its cell's limits; the
timed path broken underneath (a step that returns its state unchanged,
half the batch left out, an answer altered where it is produced) fails
them, and so does the bfloat16 control in the program's place. Tiny
sizes on the CPU; the readings the limits come from are in PERF.md."""
import dataclasses

import pytest
import torch

from bench_tiny import CELLS, TINY, tiny_run
from harness import cells, control, runner


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    res = tiny_run(name)
    assert res["correct"] is True
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    limits = cells.find_cell(name).limits
    assert set(res["checks"]) == set(limits)
    for k, c in res["checks"].items():
        assert c == {"value": 0.0, "limit": limits[k]}


def _unchanged(trace_paths):
    """The wave returns its lanes' state as it entered: no radiance, no
    completed sample, no ray."""
    def broken(scene, o, d, lane, sample, cfg, **kw):
        out = trace_paths(scene, o, d, lane, sample, cfg, **kw)
        if kw.get("regen_fn") is None:
            r, n = out
            return r * 0.0, n * 0
        return dataclasses.replace(out, accum=out.accum * 0.0,
                                   n_done=out.n_done * 0,
                                   n_rays=out.n_rays * 0)
    return broken


def _half(trace_paths):
    """Half of the lanes left out: the wave traces the first half and the
    rest read as nothing."""
    def broken(scene, o, d, lane, sample, cfg, **kw):
        n = o.x.shape[0] // 2
        cut = lambda v: type(v)(*(c[:n] for c in v))   # noqa: E731
        lane_t = torch.as_tensor(lane).expand(o.x.shape[0])[:n]
        sample_t = torch.as_tensor(sample).expand(o.x.shape[0])[:n]
        out = trace_paths(scene, cut(o), cut(d), lane_t, sample_t, cfg,
                          **kw)
        pad = lambda t: torch.cat([t, torch.zeros_like(t)])  # noqa: E731
        if kw.get("regen_fn") is None:
            r, n_rays = out
            return type(r)(*(pad(c) for c in r)), n_rays
        return dataclasses.replace(
            out, accum=type(out.accum)(*(pad(c) for c in out.accum)),
            n_done=pad(out.n_done))
    return broken


def _altered(trace_paths):
    """Every lane's radiance 1% off where the wave produces it."""
    def broken(scene, o, d, lane, sample, cfg, **kw):
        out = trace_paths(scene, o, d, lane, sample, cfg, **kw)
        if kw.get("regen_fn") is None:
            r, n = out
            return r * 1.01, n
        return dataclasses.replace(out, accum=out.accum * 1.01)
    return broken


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    from fountain_tpu_torch.integrator import path, render
    broken = fault(path.trace_paths)
    monkeypatch.setattr(path, "trace_paths", broken)
    monkeypatch.setattr(render, "trace_paths", broken)
    res = tiny_run(name)
    assert res["correct"] is False
    limits = cells.find_cell(name).limits
    assert any(c["value"] > limits[k] for k, c in res["checks"].items())


@pytest.mark.parametrize("name", CELLS)
def test_the_bfloat16_control_fails_the_limits(name):
    cell = cells.find_cell(name)
    traffic = {**cell.traffic, **TINY[cell.kind]}
    seeds = [runner.unit_seed(s, 0) for s in (41, 42, 43)]
    dev = torch.device("cpu")
    refs = runner.reference_outputs(cell, traffic, dev, seeds)
    ctrl = control.control_outputs(cell, traffic, dev, seeds)
    compare = cells.driver(cell.kind).compare
    for c, r in zip(ctrl, refs):
        nums = compare(c, r)
        assert any(v > cell.limits[k] for k, v in nums.items()), nums

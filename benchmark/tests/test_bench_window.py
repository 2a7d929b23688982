"""The timed window runs whole units, each with its own seed, and a rate
is all their rays over the first unit's start to the last one's end."""
import time

import pytest
import torch

from harness import cells, runner


class _Units:
    """A driver whose units take ``dt`` seconds and trace ``rays`` rays."""
    iterations = 1

    def __init__(self, dt, rays):
        self.dt, self.rays, self.seeds = dt, rays, []

    def unit(self, seed, spans=None):
        self.seeds.append(seed)
        time.sleep(self.dt)
        return {"x": torch.ones(2)}, torch.tensor(self.rays)


def test_window_runs_whole_units():
    drv = _Units(0.05, 1000)
    win = runner.timed_window(drv, 7, 0.12, torch.device("cpu"))
    n = len(win["rays"])
    assert n == 3                     # the unit that crosses 0.12 s ends it
    assert win["rays"] == [1000] * n
    assert win["window_s"] >= sum(win["unit_s"]) >= 0.15
    assert drv.seeds == [runner.unit_seed(7, i) for i in range(n)]
    assert win["failed"] == 0
    record = dict(kind="render_regen", rays=sum(win["rays"]),
                  window_s=win["window_s"])
    rate = cells.reader("fwd_rays_per_s").read(record)
    assert rate == 3000 / win["window_s"]
    assert cells.reader("fwdbwd_rays_per_s").read(record) is None


def test_unit_seeds_fit_31_bits_and_repeat():
    big = 2 ** 31 + 12345
    seeds = [runner.unit_seed(big, i) for i in range(50)]
    assert all(0 <= s < 2 ** 31 for s in seeds)
    assert len(set(seeds)) == 50
    assert seeds == [runner.unit_seed(big, i) for i in range(50)]


def test_kept_units_cover_the_check():
    for seed in range(40):
        drv = _Units(0.0, 1)
        win = runner.timed_window(drv, seed, 0.0, torch.device("cpu"))
        assert len(win["rays"]) == 1
        assert runner.check_units(seed, 1) == [0]
        assert set(runner.check_units(seed, 3)) <= set(range(3))


def test_non_finite_output_counts_as_failed():
    class Bad(_Units):
        def unit(self, seed, spans=None):
            return {"x": torch.tensor([float("nan")])}, torch.tensor(1)
    win = runner.timed_window(Bad(0.0, 1), 1, 0.0, torch.device("cpu"))
    assert win["failed"] == 1


def test_profile_summary_of_a_unit():
    from harness.tracing import summarize
    events = [
        ("bench.unit", False, 0.0, 100.0),
        ("bench.forward", False, 0.0, 60.0),
        ("bench.query", False, 10.0, 20.0),
        ("bench.query", False, 30.0, 40.0),
        ("bench.backward", False, 60.0, 100.0),
        ("bench.forward", True, 0.0, 60.0),    # a span on the device track
        ("cudaLaunchKernel", False, 5.0, 6.0),
        ("cudaLaunchKernel", False, 12.0, 13.0),
        ("cudaMemcpyAsync", False, 35.0, 36.0),
        ("cudaLaunchKernel", False, 70.0, 71.0),
        ("aten::add", False, 5.0, 6.0),
        ("k1", True, 6.0, 9.0),
        ("k2", True, 13.0, 18.0),
        ("k1", True, 36.0, 40.0),
        ("k3", True, 71.0, 72.0),
    ]
    out = summarize(events)
    assert out["window_s"] == 100e-6
    assert out["busy_s"] == (3 + 5 + 4 + 1) * 1e-6
    assert out["launch_calls"] == {"unit": 4, "forward": 3, "query": 2,
                                   "backward": 1}
    assert out["device_ops"][0] == ["k1", 7e-6]
    gaps = dict((round(s * 1e6), n) for n, s in out["idle_gaps"])
    # each gap named by the innermost span at its middle: 72..100 (86)
    # backward, 40..71 (55.5) forward, 18..36 (27) forward, 9..13 (11)
    # query, 0..6 (3) forward
    assert gaps == {28: "backward", 31: "forward", 18: "forward",
                    4: "query", 6: "forward"}
    assert out["idle_by_span"]["forward"] == pytest.approx(55e-6)
    assert out["idle_by_span"]["query"] == pytest.approx(4e-6)

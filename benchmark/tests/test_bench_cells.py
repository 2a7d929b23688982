"""BENCHMARK.json and the files it names: every cell finds its
configuration, traffic, driver, readers and limits by name, and the
entries keep to the benchmark's contract."""
import json
import re

import pytest

from bench_tiny import CELLS
from harness import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.fixture(scope="module")
def bench():
    return cells.load_benchmark()


def test_cells_in_order_of_proof(bench):
    assert tuple(w["name"] for w in bench["workloads"]) == CELLS
    assert all(w["chips"] == 1 for w in bench["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_finds_its_files(name):
    cell = cells.find_cell(name)
    assert cell.scene_path().exists()
    drv = cells.driver(cell.kind)
    assert hasattr(drv, "Driver") and hasattr(drv, "compare")
    assert cell.limits, "every cell has limits for its check"
    for m in cell.end_to_end + cell.per_layer:
        assert hasattr(cells.reader(m["name"]), "read")
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e, m["name"]


def test_every_metric_has_a_reader_and_a_name(bench):
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n)
        assert (cells.BENCH_DIR / "metrics" / f"{n}.py").exists()
    assert {m["name"] for m in bench["end_to_end"]} == {
        "fwdbwd_rays_per_s", "fwd_rays_per_s", "peak_mem_gib", "setup_s"}
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25


def test_configs_and_paths(bench):
    assert bench["paths"] == ["benchmark"]
    assert bench["command"] == ["python3", "benchmark/run.py"]
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/configs/")
        cfg = json.loads((cells.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert (cells.BENCH_DIR / cfg["scene"]).exists()
        for a in cfg["assets"]:
            assert (cells.BENCH_DIR / a).exists()


def test_bench_file_is_small(bench):
    assert len((cells.ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", ["logo_cube_flagship.step",
                                  "rounded_cube_env.step_regen"])
def test_a_step_cell_reports_its_own_rate(name, trace):
    """The flagship step holds its rate end to end; config 3's step, whose
    host-clock rate spreads past any bound, reports it per layer only."""
    from bench_tiny import tiny_run
    cell = cells.find_cell(name)
    declared = {m["name"] for m in (cell.per_layer if trace
                                    else cell.end_to_end)}
    got = set(tiny_run(name, trace=trace)["metrics"])
    assert got <= declared
    rate = {("logo_cube_flagship.step", False): "fwdbwd_rays_per_s",
            ("rounded_cube_env.step_regen", True):
                "fwdbwd_rays_per_s.step_regen"}.get((name, trace))
    rates = {n for n in got if n.startswith("fwdbwd_rays_per_s")}
    assert rates == ({rate} if rate else set())

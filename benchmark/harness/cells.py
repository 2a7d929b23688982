"""Finding a cell's configuration, traffic, driver, readers and limits by
name, from ``BENCHMARK.json`` at the root of the checkout."""
from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    limits: dict | None = None

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    def scene_path(self) -> Path:
        return BENCH_DIR / self.config["scene"]


def read_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_benchmark(root: Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name``: its configuration file, its traffic file
    (``traffic/<traffic>.json``), the metrics that apply to it and its
    limits (``limits/<cell>.json``; None where there is none)."""
    bench = load_benchmark() if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(ROOT / configs[w["config"]]["file"])
    traffic = read_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    limits_path = BENCH_DIR / "limits" / f"{name}.json"
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        limits=read_json(limits_path) if limits_path.exists() else None)


def load_file_module(path: Path, name: str):
    """Import the Python file ``path`` as module ``name``."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str):
    """The driver module of a traffic kind: ``drivers/<kind>.py``."""
    return load_file_module(BENCH_DIR / "drivers" / f"{kind}.py",
                            f"bench_driver_{kind}")


def reader(metric: str):
    """The reader module of a metric: ``metrics/<metric>.py``."""
    return load_file_module(BENCH_DIR / "metrics" / f"{metric}.py",
                            "bench_metric_" + metric.replace(".", "__"))

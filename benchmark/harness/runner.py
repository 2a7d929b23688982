"""One run of one cell: set-up, a warm unit, the timed window, the traced
measurements (``--trace 1``), the check against the plain reference, and
the result line.

The window runs whole units (steps or waves), each with its own seed
from ``--seed`` and its index, until ``--seconds`` have passed; a rate is
all the units' rays over the time from the first unit's start to the
last unit's synchronized end. Once the window has closed and the peak
memory has been read, the program's state is freed and the reference
(``refpt``, in ``impl.reference``) runs the units drawn for the check
from the seed; each number compared is the worst over them.
"""
from __future__ import annotations

import gc
import hashlib
import subprocess
import sys
import time

import torch

from harness import cells, impl as impls, tracing

FORBIDDEN = ("jax", "jaxlib", "flax", "fountain_tpu")
CHECK_POOL = 5      # the drawn unit is one of units 1..CHECK_POOL


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole (``fountain_tpu_torch`` is not ``fountain_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def unit_seed(seed: int, index) -> int:
    """The RNG seed of unit ``index`` ("warm" for the warm-up) of a run:
    31 bits of a hash, so any ``--seed`` gives the same work for the same
    seed and unit."""
    h = hashlib.sha256(f"{seed}/{index}".encode()).digest()
    return int.from_bytes(h[:4], "little") & 0x7FFFFFFF


def check_units(seed: int, n_units: int) -> list:
    """The units whose outputs the reference checks: the first, and one
    drawn from the seed among the next ``CHECK_POOL`` (the last unit where
    the window ran fewer)."""
    drawn = 1 + unit_seed(seed, "check") % CHECK_POOL
    return sorted({0, min(drawn, n_units - 1)})


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _to_cpu(outs: dict, n_rays) -> dict:
    out = {k: v.detach().cpu() for k, v in outs.items()}
    out["rays"] = int(n_rays)
    return out


def _finite(outs: dict) -> torch.Tensor:
    return torch.stack([torch.isfinite(v).all() for v in outs.values()]
                       ).all()


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def say(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def build(impl, cell, traffic, device):
    """(driver, scene, host seconds of the scene load) of one
    implementation on ``device``."""
    t0 = time.perf_counter()
    scene, cam, st = impl.load_pbrt(str(cell.scene_path()), device=device)
    build_s = time.perf_counter() - t0
    drv = cells.driver(traffic["kind"]).Driver(impl, scene, cam, st,
                                               traffic)
    return drv, scene, build_s


def reference_outputs(cell, traffic, device, seeds, impl=None) -> list:
    """The reference's outputs (on the CPU) of the units of ``seeds``."""
    impl = impls.reference() if impl is None else impl
    drv, _, _ = build(impl, cell, traffic, device)
    outs = []
    for s in seeds:
        o, n = drv.unit(s)
        outs.append(_to_cpu(o, n))
    return outs


def timed_window(drv, seed: int, seconds: float, device) -> dict:
    """Whole units, unit ``i`` with ``unit_seed(seed, i)``, until
    ``seconds`` have passed since the first one started; each ends in a
    synchronize. Returns the rays of each unit, each unit's seconds, the
    window's seconds (first start to last synchronized end), the units
    whose outputs were not all finite, and the outputs of the units the
    check may draw and of the last unit, by index."""
    kept, finite, rays, unit_s = {}, [], [], []
    drawn = check_units(seed, CHECK_POOL + 1)
    t0 = time.perf_counter()
    while True:
        i = len(rays)
        t_unit = time.perf_counter()
        outs, n_rays = drv.unit(unit_seed(seed, i))
        rays.append(n_rays)
        finite.append(_finite(outs))
        _sync(device)
        now = time.perf_counter()
        unit_s.append(now - t_unit)
        kept = {k: v for k, v in kept.items() if k in drawn}
        kept[i] = (outs, n_rays)
        if now - t0 >= seconds:
            break
    return dict(rays=[int(r) for r in rays], unit_s=unit_s,
                window_s=now - t0, kept=kept,
                failed=sum(not bool(f) for f in finite))


def run(name: str, seed: int, seconds: float, trace: bool, device,
        t_start: float, traffic_override: dict | None = None) -> dict:
    """One run of cell ``name`` on ``device``; returns the result line's
    object. Lines for the record go to standard error."""
    cell = cells.find_cell(name)
    traffic = {**cell.traffic, **(traffic_override or {})}
    limits = cell.limits
    cuda = device.type == "cuda"
    port = impls.port()
    drv, scene, scene_build_s = build(port, cell, traffic, device)
    drv.unit(unit_seed(seed, "warm"))                      # warm-up
    _sync(device)
    setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    win = timed_window(drv, seed, seconds, device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    kept, rays, win_s = win["kept"], win["rays"], win["window_s"]
    n_units, n_failed = len(rays), win["failed"]
    for i, (r, s) in enumerate(zip(rays, win["unit_s"])):
        print(f"# unit {i}: {s:.6f} s, {r} rays", flush=True)
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"loaded after the window: {bad}")

    record = dict(
        cell=cell.name, kind=traffic["kind"], traffic=traffic,
        iterations=drv.iterations, setup_s=setup_s,
        scene_build_s=scene_build_s, units=n_units, rays=sum(rays),
        window_s=win["window_s"], peak_bytes=peak)
    device_info = {
        "platform": "gpu" if cuda else device.type,
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": 1, "memory_peak_bytes": max(peak, setup_peak)}
    breakdown = None
    ref_impl = None
    t_trace = time.perf_counter()
    if trace:
        ref_impl = impls.reference()
        ts = unit_seed(seed, "trace")
        record["spans"] = tracing.timed_spans(drv, ts, device)
        record["profile"] = tracing.profile_unit(drv, ts, device)
        captured = tracing.capture_queries(drv, port, ts)
        ref_scene = ref_impl.load_pbrt(str(cell.scene_path()),
                                       device=device)[0]
        record["queries"] = tracing.time_queries(captured, port, scene,
                                                 ref_scene, device)
        del ref_scene, captured
        prof = record["profile"]
        if prof["busy_s"]:
            device_info.update(busy_s=prof["busy_s"],
                               window_s=prof["window_s"])
        breakdown = {"device_ops": prof["device_ops"],
                     "idle_gaps": prof["idle_gaps"]}
        say(f"# card: {power_limit() if cuda else 'cpu'}")
        say(f"# spans (s): {record['spans']}")
        say(f"# profile: busy_s={prof['busy_s']} window_s="
            f"{prof['window_s']} launch_calls={prof['launch_calls']} "
            f"runtime={prof['runtime_names']} "
            f"idle_by_span={prof.get('idle_by_span')}")
        for q in record["queries"]:
            say(f"# query {q}")

    t_check = time.perf_counter()
    # the check: the program's state freed, then the reference
    checked = [i for i in check_units(seed, n_units) if i in kept]
    prog = {i: _to_cpu(*kept[i]) for i in checked}
    del kept, win, drv, scene
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    refs = reference_outputs(cell, traffic, device,
                             [unit_seed(seed, i) for i in checked],
                             ref_impl)
    compare = cells.driver(traffic["kind"]).compare
    numbers = {}
    for i, ref in zip(checked, refs):
        for k, v in compare(prog[i], ref).items():
            numbers[k] = max(numbers.get(k, 0.0), v)
    correct = bool(limits) and n_failed == 0 and all(
        k in limits and v <= limits[k] for k, v in numbers.items())

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = cells.reader(m["name"]).read(record)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"loaded by the run: {bad}")
    checks = {k: {"value": v, "limit": (limits or {}).get(k)}
              for k, v in numbers.items()}
    say(f"# seconds: set-up {setup_s:.3f}, window {win_s:.3f}, traced "
        f"measurements {t_check - t_trace:.3f}, check "
        f"{time.perf_counter() - t_check:.3f}")
    say(f"# checked units {checked} (unit seeds "
        f"{[unit_seed(seed, i) for i in checked]}), failed units "
        f"{n_failed} of {n_units}")
    for k, c in checks.items():
        say(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    result = {"correct": correct, "attempted": n_units, "failed": n_failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result

"""The traced run's measurements, all outside the timed window: one unit
under ``torch.profiler`` (device-busy time, host launch calls by span,
top device ops, idle gaps labelled by the span that was open), one unit
with synchronized spans on the host clock, and the intersection queries
captured at given launches, timed with CUDA events and set against the
walk-work bound (``roofline``)."""
from __future__ import annotations

import bisect
from collections import defaultdict

import torch

from harness import roofline
from harness.spans import Spans

# CUDA runtime and driver calls that put work on the device: kernel
# launches, copies, fills and graph launches
LAUNCH_CALLS = frozenset((
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
    "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
    "cudaMemcpy", "cudaMemcpyAsync", "cudaMemcpy2DAsync",
    "cudaMemcpyPeerAsync", "cudaMemset", "cudaMemsetAsync",
    "cudaMemset2DAsync", "cuMemcpyAsync", "cuMemsetD8Async",
    "cuMemsetD32Async"))
QUERY_LAUNCHES = (0, 8)   # launches of each query kind that are captured
QUERY_REPS = 20


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile_unit(drv, seed: int, device) -> dict:
    """One unit under the profiler, each triangle query (the program's
    ``intersect_faces``) a ``bench.query`` range. Returns busy_s (the
    union of device activity), window_s (the unit's span), launch calls
    in the unit and in each ``bench.*`` span, the top device ops and the
    longest idle gaps, each gap named by the innermost span open at its
    middle."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    spans = Spans(device)
    mod = drv.impl.intersect
    original = mod.intersect_faces

    def query(*args, **kwargs):
        with torch.profiler.record_function("bench.query"):
            return original(*args, **kwargs)
    _sync(device)
    mod.intersect_faces = query
    try:
        with profile(activities=acts) as prof:
            with spans.phase("unit"):
                drv.unit(seed, spans=spans)
    finally:
        mod.intersect_faces = original
    # the raw events: building the profiler's event tree takes minutes
    # for a wave of 300,000 launches
    events = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        events.append((e.name(), str(e.device_type()).endswith("CUDA"),
                       start, start + e.duration_ns() / 1e3))
    return summarize(events)


def summarize(events) -> dict:
    """The profile of one unit from its events, each (name, on the
    device, start us, end us): device ops, CUDA runtime calls and the
    ``bench.*`` spans (a ``bench.unit`` span among them)."""
    dev_iv, by_op, calls, named = [], defaultdict(float), [], []
    runtime_names = defaultdict(int)
    for name, on_device, s, t in events:
        if on_device:
            if name.startswith("bench."):
                continue        # the spans' own ranges on the device track
            dev_iv.append((s, t))
            by_op[name[:160]] += (t - s) / 1e6
        elif name in LAUNCH_CALLS:
            calls.append(s)
            runtime_names[name] += 1
        elif name.startswith("bench."):
            named.append((name[len("bench."):], s, t))
    unit = next(((s, t) for n, s, t in named if n == "unit"), None)
    out = dict(busy_s=None, window_s=None, launch_calls={},
               runtime_names=dict(runtime_names), device_ops=[],
               idle_gaps=[])
    if unit is None:
        return out
    out["window_s"] = (unit[1] - unit[0]) / 1e6
    calls.sort()
    by_name = defaultdict(list)       # the ranges of one span never overlap
    for n, s, t in named:
        by_name[n].append((s, t))
    for n, ivs in by_name.items():
        ivs.sort()
        out["launch_calls"][n] = sum(
            bisect.bisect_right(calls, t) - bisect.bisect_left(calls, s)
            for s, t in ivs) if calls else None
    merged = _union([(max(s, unit[0]), min(t, unit[1])) for s, t in dev_iv
                     if t > unit[0] and s < unit[1]])
    if not merged:
        return out
    out["busy_s"] = sum(t - s for s, t in merged) / 1e6
    out["device_ops"] = [[n, v] for n, v in sorted(
        by_op.items(), key=lambda kv: -kv[1])[:10]]
    edges = [unit[0]] + [x for iv in merged for x in iv] + [unit[1]]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    # innermost first: spans by their mean length
    order = sorted(by_name, key=lambda n: sum(t - s for s, t in by_name[n])
                   / len(by_name[n]))
    starts = {n: [s for s, _ in by_name[n]] for n in order}

    def label(mid):
        for n in order:
            i = bisect.bisect_right(starts[n], mid) - 1
            if i >= 0 and by_name[n][i][1] >= mid:
                return n
        return "unit"
    out["idle_gaps"] = [[label((s + t) / 2), (t - s) / 1e6] for s, t in
                        sorted(gaps, key=lambda g: g[0] - g[1])[:10]]
    idle_by = defaultdict(float)
    for s, t in gaps:
        idle_by[label((s + t) / 2)] += (t - s) / 1e6
    out["idle_by_span"] = dict(idle_by)
    return out


def timed_spans(drv, seed: int, device) -> dict:
    """One unit with each phase synchronized and timed on the host clock:
    seconds by span name ("unit", "forward", "backward")."""
    spans = Spans(device)
    with spans.phase("unit"):
        drv.unit(seed, spans=spans)
    return dict(spans.seconds)


def capture_queries(drv, impl, seed: int) -> dict:
    """Run one unit with the program's one entry for a triangle query
    (``geometry.intersect.intersect_faces``) wrapped: clones of its inputs
    at the ``QUERY_LAUNCHES`` of each kind. Returns them by (kind,
    launch)."""
    mod = impl.intersect
    original = mod.intersect_faces
    counts = {"closest": 0, "any": 0}
    captured = {}

    def wrapped(scene, o, d, t_max, any_hit=False):
        kind = "any" if any_hit else "closest"
        if counts[kind] in QUERY_LAUNCHES:
            captured[(kind, counts[kind])] = (
                tuple(c.detach().clone() for c in o),
                tuple(c.detach().clone() for c in d),
                t_max.detach().clone())
        counts[kind] += 1
        return original(scene, o, d, t_max, any_hit=any_hit)

    mod.intersect_faces = wrapped
    try:
        drv.unit(seed)
    finally:
        mod.intersect_faces = original
    return captured


def time_queries(captured: dict, impl, scene, ref_scene, device) -> list:
    """Each captured query timed through the program's entry (CUDA events
    around warm calls, wrapper included; no time on the CPU) and set
    against the bound of the walk work its rays need."""
    from fountain_tpu_torch.core.vecmath import V3
    rows = []
    for (kind, launch), (o, d, t_max) in sorted(captured.items()):
        any_hit = kind == "any"
        ov, dv = V3(*o), V3(*d)

        def call():
            impl.intersect.intersect_faces(scene, ov, dv, t_max,
                                           any_hit=any_hit)
        ms = roofline.events_ms(call, QUERY_REPS) \
            if device.type == "cuda" else None
        work = roofline.walk_work(ref_scene, torch.stack(o, 1),
                                  torch.stack(d, 1), t_max, any_hit)
        bound, by, bytes_, ops = roofline.walk_bound(any_hit,
                                                     t_max.shape[0], work)
        rows.append(dict(kind=kind, launch=launch, rays=t_max.shape[0],
                         ms=ms, bound_ms=bound, bound_by=by, bytes=bytes_,
                         operations=ops, **work))
    return rows

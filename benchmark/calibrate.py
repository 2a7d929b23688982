"""Readings that the limits of a cell's check are set from: the program
against the reference on a dozen or more seeds (the lower readings), and
the bfloat16 control against the reference on three or more (the upper
readings), all in one process at the cell's own size.

    python3 benchmark/calibrate.py --workload <name> --first-seed <n> \
        [--seeds 12] [--control 3]

on a card (``--cpu`` with ``--lanes`` / ``--film`` / ``--iterations``
shrinks a cell for a rehearsal on the CPU). Seed ``s`` is checked as the
first unit of a run with ``--seed s``. Prints one JSON line a seed and
side, then the largest program reading and the smallest control reading
of each number, and the program's rays at RNG seed 0.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--lanes", type=int)
    ap.add_argument("--film", type=int)
    ap.add_argument("--iterations", type=int)
    args = ap.parse_args(argv)
    import torch
    from harness import cells, control, impl as impls, runner
    device = torch.device("cpu" if args.cpu else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    cell = cells.find_cell(args.workload)
    traffic = dict(cell.traffic)
    film = None if args.film is None else [args.film, args.film]
    for key, v in (("lanes", args.lanes), ("iterations", args.iterations),
                   ("film", film)):
        if v is not None:
            traffic[key] = v
    seeds = [args.first_seed + k for k in range(args.seeds)]
    unit_seeds = [runner.unit_seed(s, 0) for s in seeds]
    compare = cells.driver(traffic["kind"]).compare

    t0 = time.perf_counter()
    drv, scene, _ = runner.build(impls.port(), cell, traffic, device)
    prog = []
    for s in [0] + unit_seeds:
        o, n = drv.unit(s)
        prog.append(runner._to_cpu(o, n))
    rays_seed0 = prog.pop(0)["rays"]
    del drv, scene, o
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    refs = runner.reference_outputs(cell, traffic, device, unit_seeds)
    t2 = time.perf_counter()
    ctrl = control.control_outputs(cell, traffic, device,
                                   unit_seeds[:args.control])
    t3 = time.perf_counter()
    lower, upper = {}, {}
    for side, outs, agg in (("program", prog, lower),
                            ("control", ctrl, upper)):
        for s, u, out, ref in zip(seeds, unit_seeds, outs, refs):
            nums = compare(out, ref)
            print(json.dumps(dict(side=side, seed=s, unit_seed=u,
                                  rays=out["rays"], ref_rays=ref["rays"],
                                  **nums)), flush=True)
            for k, v in nums.items():
                agg[k] = max(agg.get(k, v), v) if side == "program" \
                    else min(agg.get(k, v), v)
    print(json.dumps(dict(
        workload=args.workload, device=torch.cuda.get_device_name(device)
        if device.type == "cuda" else "cpu", lower=lower, upper=upper,
        rays_at_rng_seed_0=rays_seed0, program_s=t1 - t0,
        reference_s_per_unit=(t2 - t1) / len(seeds),
        control_s_per_unit=(t3 - t2) / max(len(ctrl), 1))), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(1, str(BENCH_DIR.parent))
    sys.exit(main())

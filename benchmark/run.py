"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Measures ``fountain_tpu_torch`` on one CUDA
card: set-up (process start to the window), a window of whole units,
then (``--trace 1``) the per-layer measurements, then the check of the
window's outputs against the benchmark's plain reference. The last line
of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, ``breakdown`` when traced, and
``checks``: each number compared with its limit); the numbers compared
are also the last lines of standard error. Exits with 1, and prints no
result, without a card or with fewer cards than the cell asks for, and
when a module of JAX or of the JAX package is loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every kernel cache stays at a fixed path inside the checkout: the
    # program builds its nvcc and g++ libraries under build/ itself, and
    # a Triton or extension kernel a later change adds caches here
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    import torch
    from harness import cells, runner
    cell = cells.find_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    torch.cuda.set_device(0)
    result = runner.run(args.workload, args.seed, args.seconds,
                        bool(args.trace), torch.device("cuda", 0), T_START)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(1, str(ROOT))
    sys.exit(main())

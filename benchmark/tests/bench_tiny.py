"""Tiny versions of the cells for CPU runs of the harness."""
import time

import torch

# each traffic kind at a size the CPU runs in about a second a unit: a film
# of 8 x 8 through the file's camera, a few iterations
TINY = {"step": {"lanes": 8, "film": [8, 8], "iterations": 10},
        "render_regen": {"film": [8, 8], "iterations": 10}}
CELLS = ("logo_cube_flagship.step", "rounded_cube_env.render_regen",
         "rounded_cube_env.step_regen", "logo_cube_flagship.render_regen")
SEED = 2 ** 31 + 977     # past 32 signed bits, as the driver's seeds are


def tiny_run(name: str, trace: bool = False, seed: int = SEED) -> dict:
    """One CPU run of cell ``name`` cut to ``TINY``, held to the cell's own
    limits."""
    from harness import cells, runner
    kind = cells.find_cell(name).kind
    return runner.run(name, seed, 0.0, trace, torch.device("cpu"),
                      time.perf_counter(), traffic_override=TINY[kind])

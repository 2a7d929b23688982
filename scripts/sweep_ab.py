#!/usr/bin/env python3
"""Time the triangle-sweep kernels of an earlier source against the current
ones, in turns, on the config-3 wave's own inputs.

Run from the repository root on a machine with an NVIDIA card:

    git show COMMIT:fountain_tpu_torch/csrc/tri_sweep.cu > build/old.cu
    python3 scripts/sweep_ab.py build/old.cu

The earlier source has the one-thread-per-ray C interface: a face-major
table ([Fpad, 40] f32) and no chunk counter, i.e. ``tri_sweep_closest(ox,
oy, oz, dx, dy, dz, t_cap, n, coef, bounds, n_blocks, t_eps, t_out,
idx_out, stream)`` and ``tri_sweep_any(..., t_eps, occ_out, stream)``. It
is built with the package's nvcc flags into build/ab/.

The script captures the kernel inputs of iterations 0 and 8 of one
512x512 config-3 wave (as chip_smoke.py phase 3 does), fails unless the
earlier build gives the current build's results there (idx equal, t
within rtol 3e-5, any-hit flags equal), and times the library calls alone
(outputs preallocated) with CUDA events over 30 launches per reading, in
the order current, old, old, current, three times. Prints one JSON line
per kernel and iteration, then the card's name and power limit.
"""
import argparse
import ctypes
import functools
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from fountain_tpu_torch.core.vecmath import V3  # noqa: E402
from fountain_tpu_torch.geometry import tri_sweep as ts  # noqa: E402

REPS = 30


def build_old(src):
    out = os.path.join(ROOT, "build", "ab", "libtri_sweep_old.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    proc = subprocess.run([ts._nvcc(), *ts.NVCC_FLAGS, "-o", out, src],
                          capture_output=True, text=True)
    if proc.returncode:
        cs.fail(f"nvcc failed on {src}:\n{proc.stderr}")
    lib = ctypes.CDLL(out)
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    common = [p, p, p, p, p, p, p, i, p, p, i, fl]
    lib.tri_sweep_closest.argtypes = common + [p, p, p]
    lib.tri_sweep_any.argtypes = common + [p, p]
    return lib


def old_call(lib, name, table, cols, coef):
    """A zero-argument call of the earlier build's library function, its
    outputs allocated up front."""
    n = cols[0].shape[0]
    outs = ((torch.empty(n, dtype=torch.bool, device="cuda"),)
            if name == "tri_sweep_any" else
            (torch.empty(n, device="cuda"),
             torch.empty(n, dtype=torch.int32, device="cuda")))
    call = functools.partial(
        getattr(lib, name), *(c.data_ptr() for c in cols), n,
        coef.data_ptr(), table.bounds.data_ptr(), table.n_blocks, 1e-4,
        *(x.data_ptr() for x in outs), torch.cuda.current_stream().cuda_stream)
    call.buffers = (cols, outs)
    return call


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old", help="earlier tri_sweep.cu (one thread a ray)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_ab: needs an NVIDIA card")
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    old = build_old(args.old)
    scene, cam = cs.build_scene(cs.RES, "cuda")
    _, captured = cs.phase_wave(scene, cam)
    table = scene.tri_sweep
    packed = torch.zeros((10, table.n_blocks * ts.BLOCK_FACES, 4),
                         device="cuda")
    packed[:, :table.count] = table.feat.packed
    old_coef = packed.permute(1, 0, 2).reshape(-1, 40).contiguous()
    for kind, name in (("closest", "tri_sweep_closest"),
                       ("any", "tri_sweep_any")):
        for it in (0, 8):
            ox, oy, oz, dx, dy, dz, cap = captured[(kind, it)]
            o, d = V3(ox, oy, oz), V3(dx, dy, dz)
            calls = {"current": cs.kernel_call(name, table, o, d, cap),
                     "old": old_call(old, name, table,
                                     ts._ray_args(table, o, d, cap),
                                     old_coef)}
            readings = {k: [] for k in calls}
            for _ in range(3):
                for label in ("current", "old", "old", "current"):
                    cs.events_ms(calls[label], 1)
                    readings[label].append(cs.events_ms(calls[label], REPS))
            ref, got = (calls[k].buffers[1] for k in ("current", "old"))
            if kind == "any":
                ok = torch.equal(got[0], ref[0])
            else:
                hit = ref[1] >= 0
                rel = ((got[0] - ref[0]).abs()
                       / ref[0].abs().clamp_min(1e-9))[hit]
                ok = torch.equal(got[1], ref[1]) and (
                    not bool(hit.any()) or float(rel.max()) <= cs.T_RTOL)
            if not ok:
                cs.fail(f"{name} iteration {it}: the builds disagree")
            print(json.dumps(dict(
                kernel=name, iteration=it, rays=cap.shape[0],
                live=int((cap > 1e-4).sum()), ms=readings,
                median={k: float(np.median(v))
                        for k, v in readings.items()})), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())

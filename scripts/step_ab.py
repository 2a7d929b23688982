#!/usr/bin/env python3
"""Time the differentiable step of two trees of the port in turns.

    python3 scripts/step_ab.py OTHER_ROOT [--pairs N] [--res R]
                               [--flagship] [--forward]

OTHER_ROOT is a directory that holds another tree's ``fountain_tpu_torch/``
(for example a ``git archive`` of the parent commit unpacked under
``build/``). Both trees load in this one process: each keeps its own
modules, swapped into ``sys.modules`` while it runs, so the lazy imports
inside its functions resolve to its own code. After one warm-up step each,
the steps run in turns other, this, this, other (``--pairs`` times, seed
i for the i-th step of a tree), each timed on the host clock up to a
``torch.cuda.synchronize()``. Prints every step time, the medians, the
losses, and one JSON line with the card's name and power limit. Needs a
CUDA card; imports nothing of JAX.

The step is ``bench.step``: config 3's regeneration wave, or with
``--flagship`` one fixed wave through testscenes/logo_cube.pbrt's camera
(``load_pbrt``; res x res lanes, depth 5, NEE, RR; the gradient of the
mean radiance with respect to the texture values). ``--forward`` times
the step's forward wave alone under ``torch.no_grad()``, as a
forward-only render runs it.
"""
import argparse
import importlib
import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "fountain_tpu_torch"
FLAGSHIP = os.path.join(ROOT, "testscenes", "logo_cube.pbrt")


def _ours():
    return {k: m for k, m in sys.modules.items()
            if k == PKG or k.startswith(PKG + ".")}


def load_tree(root):
    """Import ``root``'s package (its bench module and what that imports)
    as a set of modules of its own, leaving sys.modules as it was."""
    saved = _ours()
    for k in saved:
        del sys.modules[k]
    sys.path.insert(0, root)
    try:
        importlib.import_module(PKG + ".bench")
        importlib.import_module(PKG + ".io.pbrt")
        mods = _ours()
    finally:
        sys.path.remove(root)
        for k in _ours():
            del sys.modules[k]
        sys.modules.update(saved)
    return mods


class Tree:
    def __init__(self, name, root, res, flagship=False, forward=False):
        self.name, self.mods = name, load_tree(root)
        with self:
            if flagship:
                self.scene, self.cam, _ = self.mods[
                    PKG + ".io.pbrt"].load_pbrt(FLAGSHIP, device="cuda")
            else:
                self.scene, self.cam = self.mods[PKG + ".bench"].build_scene(
                    res, "cuda")
        self.res, self.times, self.losses = res, [], []
        self.regen, self.forward = not flagship, forward

    def __enter__(self):
        self._saved = _ours()
        for k in self._saved:
            del sys.modules[k]
        sys.modules.update(self.mods)
        return self

    def __exit__(self, *exc):
        for k in list(self.mods):
            sys.modules.pop(k, None)
        sys.modules.update(self._saved)

    def step(self, seed, record=True):
        with self:
            bench = self.mods[PKG + ".bench"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if self.forward:
                with torch.no_grad():
                    loss = bench.loss_of(bench.wave(
                        self.scene, self.cam, self.res, seed,
                        regen=self.regen), self.regen)
            else:
                loss, _ = bench.step(self.scene, self.cam, self.res,
                                     self.scene.textures.value, seed,
                                     regen=self.regen)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        if record:
            self.times.append(dt)
            self.losses.append(float(loss))
        return dt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("other", help="root of the other tree")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--flagship", action="store_true",
                    help="logo_cube.pbrt's fixed wave, not config 3's")
    ap.add_argument("--forward", action="store_true",
                    help="time the forward wave alone, without gradients")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("step_ab: needs a CUDA card", file=sys.stderr)
        return 1
    other = Tree("other", os.path.abspath(args.other), args.res,
                 args.flagship, args.forward)
    this = Tree("this", ROOT, args.res, args.flagship, args.forward)
    for t in (other, this):
        t.step(0, record=False)                        # warm-up
    seed = {id(other): 0, id(this): 0}
    for _ in range(args.pairs):
        for t in (other, this, this, other):
            seed[id(t)] += 1
            dt = t.step(seed[id(t)])
            print(f"{t.name} step (seed {seed[id(t)]}): {dt:.4f} s",
                  flush=True)
    out = {t.name: dict(step_s=t.times, median_s=statistics.median(t.times),
                        losses=t.losses) for t in (other, this)}
    out.update(res=args.res, flagship=args.flagship, forward=args.forward,
               device=subprocess.run(
                   ["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], capture_output=True,
                   text=True).stdout.strip())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

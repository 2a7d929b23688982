"""`render` CLI: parse a .pbrt scene, render it, write EXR/PNG (PyTorch).

Counterpart of ``fountain_tpu/cli/render.py``, with the same flags and
stderr lines:

    python -m fountain_tpu_torch.cli.render scene.pbrt [-o out.exr]
        [--samples N] [--max-depth D] [--seed S] [--cpu] [--devices N]
        [--regen] [--progress] [--profile DIR]

It runs on the CUDA card, and raises without one, unless ``--cpu`` asks
for the plain path on the CPU. Every integrator (path, directlighting,
whitted, bsdf) and pixel filter (box, triangle, gaussian) of the JAX CLI
is taken. As there, ``Integrator "bsdf"`` maps to ``nee=False`` with
``emit_all_bounces`` left off, so emission counts only on camera and
specular bounces.

``--devices N > 1`` shards the pixels over N processes
(``parallel.shard.render_sharded``): one card a rank (``cuda:r``, NCCL),
or with ``--cpu`` N gloo processes on the CPU. It raises before anything
starts when fewer than N cards exist. Rank 0 prints the stderr lines and
writes the image; a rank that fails makes the command fail. As in the JAX
CLI, ``--regen`` ignores ``--devices`` (one device), and ``--progress``
with ``--devices > 1`` renders sharded without progress.
"""
from __future__ import annotations

import argparse
import os
import sys
import time


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fountain-tpu-torch render")
    ap.add_argument("scene", help="PBRT scene file")
    ap.add_argument("-o", "--output", default=None,
                    help="output image (.exr/.png); default from Film stmt")
    ap.add_argument("--samples", type=int, default=None,
                    help="override samples per pixel")
    ap.add_argument("--max-depth", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the CPU")
    ap.add_argument("--devices", type=int, default=1,
                    help="shard the render across N devices (processes: "
                         "one card each, or N CPU processes with --cpu)")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="write a torch.profiler Chrome trace of the "
                         "render to DIR/trace.json")
    ap.add_argument("--progress", action="store_true",
                    help="render in sample chunks and print live paths/s")
    ap.add_argument("--regen", action="store_true",
                    help="path-regeneration waves (box filter): dead lanes "
                         "start their pixel's next sample; spp becomes a "
                         "per-pixel average")
    args = ap.parse_args(argv)

    if args.regen:
        if args.devices > 1 or args.progress:
            print("warning: --regen ignores --devices/--progress",
                  file=sys.stderr)
    elif args.devices > 1:
        if args.progress:
            print("warning: --progress is not supported with --devices > 1; "
                  "rendering sharded without progress", file=sys.stderr)
        from fountain_tpu_torch.parallel.shard import (render_devices,
                                                       run_ranks)
        devices = (["cpu"] * args.devices if args.cpu
                   else render_devices(args.devices))
        run_ranks(_render, devices, args=(args,))
        return 0

    from fountain_tpu_torch.device import resolve_device
    return _render(0, resolve_device("cpu" if args.cpu else None), args)


def _render(rank: int, device, args) -> int:
    """Load, render and (rank 0) write the image on ``device``; the
    sharded render when ``args.devices > 1`` and not ``--regen`` (then
    one rank of ``parallel.shard.run_ranks``)."""
    import numpy as np

    from fountain_tpu_torch.integrator.path import PathConfig
    from fountain_tpu_torch.io.image import save_image
    from fountain_tpu_torch.io.pbrt import load_pbrt
    from fountain_tpu_torch.scene.film import (FILTER_BOX, FILTER_GAUSSIAN,
                                               FILTER_TRIANGLE, finalize)

    def say(*a, **k):
        if rank == 0:
            print(*a, file=sys.stderr, **k)

    t0 = time.time()
    scene, camera, st = load_pbrt(args.scene, device=device)
    say(f"scene loaded in {time.time() - t0:.2f}s: "
        f"{scene.spheres.count} spheres, {scene.triangles.count} tris, "
        f"{scene.lights.count} lights")

    spp = args.samples or st.spp
    max_depth = args.max_depth or st.max_depth
    mode = {"directlighting": "direct", "whitted": "whitted"}.get(
        st.integrator, "path")
    cfg = PathConfig(max_depth=max_depth, rr_threshold=1.0,
                     nee=st.integrator != "bsdf", mode=mode)
    ftype = {"box": FILTER_BOX, "triangle": FILTER_TRIANGLE,
             "gaussian": FILTER_GAUSSIAN}.get(st.filter_name, FILTER_BOX)

    if args.regen:
        if ftype != FILTER_BOX:
            say("warning: --regen uses the box filter")
        from fountain_tpu_torch.integrator.render import render_regen

        def img_fn():
            # a wave's refill window completes >= 1 sample a pixel per
            # iteration; waves of at most 16 samples (independent seeds)
            # keep each wave's loop bounded whatever spp is
            drain = cfg.max_depth + 1
            film, done_spp, wave = None, 0, 0
            while done_spp < spp:
                todo = min(spp - done_spp, 16)
                f = render_regen(scene, camera, st.xres, st.yres,
                                 todo + drain, cfg,
                                 seed=args.seed + 7919 * wave,
                                 spp_total=spp)
                film = f if film is None else type(f)(
                    *(a + b for a, b in zip(
                        (film.r_sum, film.g_sum, film.b_sum,
                         film.weight_sum),
                        (f.r_sum, f.g_sum, f.b_sum, f.weight_sum))))
                done_spp += todo
                wave += 1
            return finalize(film)
    elif args.devices > 1:
        from fountain_tpu_torch.parallel.shard import render_sharded
        img_fn = lambda: render_sharded(  # noqa: E731
            scene, camera, st.xres, st.yres, spp, cfg,
            n_devices=args.devices, ftype=ftype, fradius=st.filter_radius,
            seed=args.seed)
    elif args.progress:
        from fountain_tpu_torch.integrator.render import render_samples
        from fountain_tpu_torch.scene.film import make_film

        def img_fn():
            film = make_film(st.xres, st.yres, device)
            chunk = max(1, spp // 16)
            t1 = None   # the rate timer starts after the first chunk,
            s_rate = 0  # which pays the kernel build
            for s0 in range(0, spp, chunk):
                s1 = min(s0 + chunk, spp)
                film = render_samples(scene, camera, st.xres, st.yres,
                                      s0, s1, spp, film, cfg, ftype,
                                      st.filter_radius, seed=args.seed)
                _sync(device)
                if t1 is None:
                    t1, s_rate = time.time(), s1
                    rate = ""
                else:
                    done = (s1 - s_rate) * st.xres * st.yres
                    rate = f"{done / (time.time() - t1):.3g} paths/s   "
                print(f"\r  {s1}/{spp} spp  {rate}",
                      end="", file=sys.stderr, flush=True)
            print(file=sys.stderr)
            return finalize(film)
    else:
        from fountain_tpu_torch.integrator.render import render
        img_fn = lambda: render(scene, camera, st.xres, st.yres,  # noqa
                                spp, cfg, ftype=ftype,
                                fradius=st.filter_radius, seed=args.seed)

    t0 = time.time()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        img_fn()            # the kernel build stays outside the trace
        _sync(device)
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        t0 = time.time()
        with profile(activities=acts) as prof:
            img = img_fn()
            _sync(device)
        if rank == 0:   # every rank renders under the profiler alike
            os.makedirs(args.profile, exist_ok=True)
            trace = os.path.join(args.profile, "trace.json")
            prof.export_chrome_trace(trace)
            say(f"profile trace written to {trace}")
    else:
        img = img_fn()
        _sync(device)
    img = img.detach().cpu().numpy().astype(np.float32)
    dt = time.time() - t0
    n_paths = st.xres * st.yres * spp
    say(f"Completed rendering in {dt:.2f} s "
        f"({n_paths / dt:.3g} paths/s incl. compile)")

    if rank == 0:
        out = args.output or st.output
        save_image(out, img)
        say(f"wrote {out}")
    return 0

if __name__ == "__main__":
    sys.exit(main())

"""`render` CLI: parse a .pbrt scene, render it, write EXR/PNG (PyTorch).

Counterpart of ``fountain_tpu/cli/render.py``, with the same flags and
stderr lines:

    python -m fountain_tpu_torch.cli.render scene.pbrt [-o out.exr]
        [--samples N] [--max-depth D] [--seed S] [--cpu] [--regen]
        [--progress] [--profile DIR]

It runs on the CUDA card, and raises without one, unless ``--cpu`` asks
for the plain path on the CPU. Every integrator (path, directlighting,
whitted, bsdf) and pixel filter (box, triangle, gaussian) of the JAX CLI
is taken. As there, ``Integrator "bsdf"`` maps to ``nee=False`` with
``emit_all_bounces`` left off, so emission counts only on camera and
specular bounces. ``--devices N > 1`` waits for the ``torch.distributed``
port and raises.
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
                    help="shard the render across N devices (not ported)")
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
    if args.devices > 1:
        raise NotImplementedError(
            "--devices > 1 needs the torch.distributed port, which is not "
            "done yet")

    import numpy as np

    from fountain_tpu_torch.device import resolve_device
    from fountain_tpu_torch.integrator.path import PathConfig
    from fountain_tpu_torch.io.image import save_image
    from fountain_tpu_torch.io.pbrt import load_pbrt
    from fountain_tpu_torch.scene.film import (FILTER_BOX, FILTER_GAUSSIAN,
                                               FILTER_TRIANGLE, finalize)

    device = resolve_device("cpu" if args.cpu else None)
    t0 = time.time()
    scene, camera, st = load_pbrt(args.scene, device=device)
    print(f"scene loaded in {time.time() - t0:.2f}s: "
          f"{scene.spheres.count} spheres, {scene.triangles.count} tris, "
          f"{scene.lights.count} lights", file=sys.stderr)

    spp = args.samples or st.spp
    max_depth = args.max_depth or st.max_depth
    mode = {"directlighting": "direct", "whitted": "whitted"}.get(
        st.integrator, "path")
    cfg = PathConfig(max_depth=max_depth, rr_threshold=1.0,
                     nee=st.integrator != "bsdf", mode=mode)
    ftype = {"box": FILTER_BOX, "triangle": FILTER_TRIANGLE,
             "gaussian": FILTER_GAUSSIAN}.get(st.filter_name, FILTER_BOX)

    if args.regen:
        if args.progress:
            print("warning: --regen ignores --devices/--progress",
                  file=sys.stderr)
        if ftype != FILTER_BOX:
            print("warning: --regen uses the box filter", file=sys.stderr)
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
        os.makedirs(args.profile, exist_ok=True)
        trace = os.path.join(args.profile, "trace.json")
        prof.export_chrome_trace(trace)
        print(f"profile trace written to {trace}", file=sys.stderr)
    else:
        img = img_fn()
        _sync(device)
    img = img.cpu().numpy().astype(np.float32)
    dt = time.time() - t0
    n_paths = st.xres * st.yres * spp
    print(f"Completed rendering in {dt:.2f} s "
          f"({n_paths / dt:.3g} paths/s incl. compile)", file=sys.stderr)

    out = args.output or st.output
    save_image(out, img)
    print(f"wrote {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

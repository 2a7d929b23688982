#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero; no phase is skipped):
  1. setup: card name and power limit, builds of csrc/tri_sweep.cu,
     csrc/bvh_walk.cu and csrc/scatter_rows.cu (nvcc, sm_90a, all started
     together), their compile logs, and each kernel's build facts
     (registers, shared memory, spills, thread blocks per SM); a spill
     fails the run;
  2. kernel parity: each sweep kernel against its plain PyTorch version on
     four random meshes, on 4,096 random rays against the leaf-ordered
     rounded cube, and 100,000 rays from the cube's interior (0 leaks);
  3. the main path at full width: one config-3 ``render_regen`` wave
     (rounded_cube.ply, matte, sky.exr env light; 512x512 lanes, depth 5,
     24 regeneration iterations, NEE, seed 0), with each kernel's launch
     count read from a run that starts with every count at 0;
  4. the same scene at 32x32 and 12 iterations on the card and on the CPU
     (the plain versions): mean radiance and per-lane sample counts agree;
  5. kernel times at the wave's shapes (its iterations 0 and 8): each
     kernel held to its plain version there (same gates as phase 2), CUDA
     events over 20 launches of its wrapper (``ms``) and over 30 launches
     of the library call alone with outputs preallocated (``kernel_ms``),
     the plain version's time (its one call in the check), the bound,
     the pairs the cull lets through (``pairs``) and the lane-pairs a
     one-thread-per-ray kernel in lane order spends on them
     (``warp_pairs``: 32 x 128 x the blocks any lane of a warp needs);
  6. ray order: waves in turns with the rays in lane order (as shipped),
     in Morton order with dead lanes last, and with dead lanes last only
     (each sweep call sorts, gathers, sweeps and scatters back);
  7. torch.profiler over one more wave: device-busy time, the ops that
     take it, and each sweep kernel's device time over its 24 launches and
     at its launches of iterations 0 and 8 (to set beside phase 5);
  8. the differentiable step (``fountain_tpu_torch.bench.step``: the
     wave, then autograd of the mean completed radiance with respect to
     the texture value table) at full width: one warm-up and 4 timed
     steps (loss, kd gradient, fwd+bwd rays/s, step times, peak memory,
     each sweep's launches in a step, split into the forward and backward
     passes: 24 and 0); central differences of the kd row at full width;
     card against CPU at 32x32, 12 iterations; the furnace's gradients at
     64x64 against their analytic values; torch.profiler over one step,
     with the forward's and the backward's device-busy time and the
     backward's top device ops; the backward of a gather whose lanes all
     read one row, as PyTorch runs it and as ``index_add_``;
  9. the flagship, testscenes/logo_cube.pbrt (BASELINE config 5: metal
     cube, roughness-mapped metal sphere, glass sphere, checkerboard
     ground, sky.exr, thin-lens camera), loaded on the card: its content;
     both kernels held to their plain versions and timed at the inputs of
     their launches 0 and 6 of the CLI's first --regen wave (pairs,
     kernel-only time, bound); ``cli.render.main`` at the file's settings
     (256x256, 64 spp, depth 8) with --regen, and the fixed wave at 16 spp,
     each with its wall time, paths/s, rays/s, sweep launches (counts set
     to 0 just before), per-channel mean, and the written EXR read back
     equal; the card against the CPU at 32x32, 4 spp (fixed wave and
     regeneration); the furnace scene through the CLI: every pixel
     2 +- 0.1 at 256 spp of the fixed wave (tests/test_furnace.py's
     count for the epsilon with Russian roulette) and
     tests/test_regen.py's gates with --regen at the file's 128 spp;
 10. the flagship's differentiable step (``bench.flagship_step``, the JAX
     package's tools/bench_all.py config 5: a fixed wave of 512x512 lanes
     through logo_cube.pbrt's camera, depth 5, NEE, the gradient of the
     summed radiance / 3 with respect to the texture values and the atlas
     texels), once in each estimator: a warm-up and 3 timed steps
     (fwd+bwd rays/s, step times, peak memory, each sweep's launches in
     the forward and the backward pass: 6 and 0; the graphed wave
     recorded once, in the warm-up, and replayed 3 times), every gradient
     entry finite; both kernels held to their plain versions and timed at
     the step's rays of bounces 0 and 3; torch.profiler over one step;
     attached only, central differences of the metal sphere's roughness
     image at full width (loose gate: same sign, ratio in (0.5, 2)); and
     the card against the CPU at 16x16 lanes, depth 3;
 11. all five BASELINE configs forward as tools/bench_all.py measures
     them (``bench.measure_all``: a fixed wave of 512x512 lanes, depth 5,
     NEE, RR; 8 timed waves after a warm-up): rays a wave, each held to
     within 0.5% of the TPU's tools/bench_all_out.json (the difference
     printed), fwd ms, rays/s and sweep launches a wave (configs 1 and 4
     hold spheres only: 0); the fwd+bwd numbers of configs 3 and 5 are
     phases 8 and 10's; the TPU's table is printed beside the port's, not
     compared; the mis_box (config 2) on the card against the CPU at
     16x16, 4 spp;
 12. the 277,248-face gate of tools/large_scene.py: rounded_cube.ply
     welded and Loop-subdivided 3 levels (host time of the subdivision,
     of the table build and of its native node build; the node build
     again, native and numpy, byte-equal; the node count), both sweep
     kernels and both walk kernels (csrc/bvh_walk.cu) against their plain
     versions on 4,096 random rays, the closest hit of the sweep and of
     the walk against a numpy float64 brute force on 512 rays from
     outside (0 hit mismatches, t relerr <= 1e-6), 0 leaks in 100,000
     interior rays through each, a config-3 regeneration wave on the mesh
     (above 65,536 faces the port, as the JAX package off the TPU, takes
     the BVH walk: 24 launches of each walk kernel, none of the sweeps)
     with the walks and the sweeps held to their plain versions and timed
     at the same rays, its iterations 0 and 8 (kernel-only ms, the bound
     from the work the plain walk counts on those rays), and the fixed
     wave's fwd+bwd step through the walk (rays, rays/s, peak memory,
     MAX_DEPTH + 1 launches of each walk kernel; the TPU traced 398,828
     rays);
 13. integrator modes and filters: the furnace through the CLI with the
     directlighting and whitted integrators (every pixel 1.5 +- 0.01 at
     64 spp) and BSDF sampling only through the API (2 +- 0.01 at depth
     20, 32 spp); the mis_box's fixed wave at 512x512 in each mode with
     its sweep launches a bounce (path 1 + 1, direct 2 + 1, whitted 1 +
     1 light, BSDF only 1 + 0), and each kernel held to its plain version
     and timed at that wave's inputs of bounces 0 and 3 (in direct mode
     both closest-hit launches of each, the second one the BSDF-sampled
     ray; the path mode's wave is phase 11's config 2); logo_cube with
     the Gaussian and triangle filters (radius 2) on the card against the
     CPU at 32x32, 4 spp;
 14. the sharded render, checkpoints and image codecs: config 3's
     fixed wave (512x512 lanes, depth 5, NEE, box filter, 4 spp, seed 0)
     through ``render_sharded`` over two gloo ranks on one card, started
     with ``parallel.shard.run_ranks`` (torch.multiprocessing): each
     rank's image equal to the one-process ``render`` (rtol 1e-6, atol
     1e-6) and the gradient of its mean with respect to the texture
     values, summed with ``all_reduce_grads``, equal to the one-process
     gradient (rtol GRAD_RTOL: float32 sums in another order; one
     process's second step against its first printed beside it), each
     rank's sweep launches and wall times beside one process's; NCCL at world size 1 (``init_distributed``,
     ``barrier_sync``, a render bit-equal to ``render``); both kernels
     held to their plain versions and timed at rank 1's bounce-0 inputs;
     the CLI's ``--devices 2`` raising on a one-card machine and
     ``--devices 1`` rendering logo_cube; samples [0, 2) + a checkpoint
     + [2, 4) bit-equal to [0, 4) on the card; ``mipmap_debug`` on
     data/logo.png and a JPEG written and read back by the port's codecs
     (no Pillow needed);
 15. the gathers' backward kernel (csrc/scatter_rows.cu, built in phase
     1 with the others): the flagship step at full width launching it
     once a differentiable gather in its recording step (624 into the
     texel atlas, global atomics; 204 into the texture value and shading
     tables, shared memory) and not from the host in a replayed step;
     then, at the inputs of the gathers of bounces 0 and 3 (recorded from
     a step through the plain loop), each call held to float64
     index_add_ (relative L2 1e-5), and per call: the wrapper (zero fill
     + kernel), the library call alone and zeros + index_add_
     (``library_ms``) each timed as one CUDA graph of the bounce's calls,
     the plain version eager, the bytes bound (lanes x (4 C + index
     bytes) + rows x C x 4 at 3.35 TB/s), the share of lanes with a
     non-zero row and the atomic adds a call; index_add_'s own relative
     L2 against float64 beside the kernel's.

Prints the kernels' JSON line, the card line, and last
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
RES = 512
DEVICE = "cuda"
MAX_DEPTH = 5
REGEN_ITERS = 24
T_RTOL = 3e-5          # kernel vs plain t on hits (f32 sum order differs)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM published peak
FP32_FLOPS = 67e12          # H100 SXM FP32 (non-tensor) published peak
# FP32 operations a (ray, face) pair needs, an FMA counted as 2 (the rate
# FP32_FLOPS counts it so). The four Moller-Trumbore quantities over the
# face's 16 non-zero coefficients: det 1 multiply + 2 FMAs (5), u and v
# 1 multiply + 5 FMAs each (11 + 11), t 1 multiply + 2 FMAs + 1 add (6):
# 33. The acceptance rule: eps = 1e-4 * |det| (1), U + V and |det| + eps
# (2), the t window's two products (2), 6 compares (6): 11. Not counted:
# |det| and the sign flips by det's sign (bit operations), the division
# for t (accepted pairs only) and the 10 x 4 table's 21 zero
# coefficients (no work).
OPS_PER_PAIR = 33 + 11
ROW_KEYS = ("ms", "kernel_ms", "plain_ms", "bound_ms", "pairs",
            "warp_pairs", "live")


def log(*a):
    print(*a, flush=True)


T0 = time.perf_counter()


def stamp(result):
    """Log the seconds since the script started (after a phase)."""
    log(f"  [{time.perf_counter() - T0:.1f} s since start]")
    return result


def fail(msg):
    log(f"FAILED: {msg}")
    sys.exit(1)


SWEEPS = ("tri_sweep_closest", "tri_sweep_any")
WALKS = ("bvh_walk_closest", "bvh_walk_any")


def reset_counts():
    """Every kernel's launch count to 0: the sweeps' and the walks'."""
    from fountain_tpu_torch.geometry.intersect import reset_kernel_launches
    reset_kernel_launches()


def read_counts():
    """Every kernel's launch count, by name."""
    from fountain_tpu_torch.geometry.intersect import kernel_launches
    return kernel_launches()


def only(launches, names, label):
    """The counts of the kernels ``names``; fails if any other kernel
    launched (a mesh of at most 65,536 faces goes through the sweeps, a
    larger one through the walks)."""
    stray = {k: v for k, v in launches.items() if k not in names and v}
    if stray:
        fail(f"{label}: launched {stray}, expected only {names}")
    return {k: launches[k] for k in names}


def build_scene(res, device):
    """BASELINE config 3 and the bench.py camera
    (``fountain_tpu_torch.bench.build_scene``)."""
    from fountain_tpu_torch.bench import build_scene as build
    return build(res, device)


def v3(a):
    from fountain_tpu_torch.core.vecmath import V3
    return V3(a[:, 0].contiguous(), a[:, 1].contiguous(),
              a[:, 2].contiguous())


def random_mesh(n_tris, seed, spread=10.0):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-spread, spread, (n_tris, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    return np.stack([v0, v1, v2], axis=1)


def random_rays(n, seed, spread=12.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def timed_call(fn):
    """(fn(), its ms between CUDA events), one cold call."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def check(any_hit, table, o, d, cap, label):
    """One kernel against its plain version on the same rays; fails on any
    difference past the gates. Returns the max |kernel - plain| over the
    hits' t (closest hit) or the occlusion flags (any hit), and the plain
    call's ms."""
    from fountain_tpu_torch.geometry import tri_sweep as ts
    if any_hit:
        occ_k = ts.any_hit_kernel(table, o, d, cap)
        occ_p, plain_ms = timed_call(
            lambda: ts.any_hit_plain(table, o, d, cap))
        n_mis = int((occ_k != occ_p).sum())
        log(f"  {label}, any hit: rays={o.shape[0]} "
            f"occluded={int(occ_p.sum())} mismatch={n_mis}")
        if n_mis:
            fail(f"any-hit parity: {label}")
        return 0.0, plain_ms
    t_k, i_k = ts.closest_hit_kernel(table, o, d, cap)
    (t_p, i_p), plain_ms = timed_call(
        lambda: ts.closest_hit_plain(table, o, d, cap))
    hit_k, hit_p = i_k >= 0, i_p >= 0
    n_hit_mis = int((hit_k != hit_p).sum())
    m = hit_k & hit_p
    n_idx_mis = int((i_k[m] != i_p[m]).sum())
    rel = ((t_k[m] - t_p[m]).abs() / t_p[m].abs().clamp_min(1e-9))
    rel_max = float(rel.max()) if bool(m.any()) else 0.0
    abs_max = float((t_k[m] - t_p[m]).abs().max()) if bool(m.any()) else 0.0
    log(f"  {label}, closest hit: rays={o.shape[0]} hits={int(hit_p.sum())} "
        f"hit_mismatch={n_hit_mis} idx_mismatch={n_idx_mis} "
        f"t_rel_max={rel_max:.3e}")
    if n_hit_mis or n_idx_mis or rel_max > T_RTOL:
        fail(f"closest-hit parity: {label}")
    return abs_max, plain_ms


def compare(table, o, d, cap, label):
    """Both kernels against their plain versions on the same rays.
    Returns the max |t| error on hits."""
    check(True, table, o, d, cap, label)
    return check(False, table, o, d, cap, label)[0]


def phase_parity(cube):
    from fountain_tpu_torch.geometry.tri_sweep import (closest_hit_kernel,
                                                       pack_sweep_table)
    log("phase 2: kernel parity (gates: hit masks equal, idx equal on "
        f"hits, t rtol {T_RTOL}, any-hit equal)")
    dev = DEVICE
    err_t = 0.0
    cases = [  # (faces, mesh seed, spread, rays, ray seed, ray spread, cap)
        ("multi-block + ray padding", 128 + 37, 3, 10.0, 1024 + 61, 4, 12.0,
         float("inf")),
        ("t_cap any-hit", 200, 5, 10.0, 1024, 6, 12.0, 8.0),
        ("multi-superblock", 1024 + 3 * 128 + 17, 7, 10.0, 1024, 8, 12.0,
         float("inf")),
        ("multi-chunk 8192+261", 8192 + 2 * 128 + 5, 9, 14.0, 1024, 10, 16.0,
         float("inf")),
    ]
    for label, nf, ms, msp, nr, rs, rsp, cap in cases:
        table = pack_sweep_table(random_mesh(nf, ms, msp), dev)
        o, d = random_rays(nr, rs, rsp)
        capt = torch.full((nr,), cap, device=dev).clamp_max(3e38)
        err_t = max(err_t, compare(table, v3(torch.as_tensor(o, device=dev)),
                                   v3(torch.as_tensor(d, device=dev)), capt,
                                   label))
    rng = np.random.default_rng(7)
    o = rng.uniform(-25, 25, (4096, 3)).astype(np.float32)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    err_t = max(err_t, compare(cube.tri_sweep,
                               v3(torch.as_tensor(o, device=dev)),
                               v3(torch.as_tensor(d, device=dev)),
                               torch.full((4096,), 3e38, device=dev),
                               "rounded cube, 4096 random rays"))
    nw = 100_000
    dirs = rng.normal(size=(nw, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    zero = torch.zeros(nw, device=dev)
    from fountain_tpu_torch.core.vecmath import V3
    _, idx = closest_hit_kernel(cube.tri_sweep, V3(zero, zero, zero),
                                v3(torch.as_tensor(dirs, device=dev)),
                                torch.full((nw,), 3e38, device=dev))
    leaks = int((idx < 0).sum())
    log(f"  watertight: {leaks} leaks / {nw} interior rays")
    if leaks:
        fail("interior rays leaked")
    return err_t


def phase_wave(scene, cam):
    """One full-width wave; returns its numbers and the kernel inputs of
    iterations 0 and 8 (captured during the warm-up wave)."""
    from fountain_tpu_torch.integrator.path import PathConfig
    from fountain_tpu_torch.integrator.render import render_regen
    from fountain_tpu_torch.scene.film import finalize
    cfg = PathConfig(max_depth=MAX_DEPTH, rr_threshold=1.0, nee=True)
    log(f"phase 3: render_regen {RES}x{RES}, depth {MAX_DEPTH}, "
        f"{REGEN_ITERS} iterations, NEE, seed 0")
    # warm-up wave (also records the iteration-0/8 kernel inputs)
    captured = capture_sweep_inputs(
        lambda: render_regen(scene, cam, RES, RES, REGEN_ITERS, cfg,
                             seed=0), (0, 8))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    film, n_rays = render_regen(scene, cam, RES, RES, REGEN_ITERS, cfg,
                                seed=0, count_rays=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts()
    img = finalize(film)
    rays = int(n_rays)
    out = dict(rays_per_wave=rays, wave_s=dt, rays_per_s=rays / dt,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               mean_radiance=float(img.mean()),
               n_done_min=int(film.weight_sum.min()), launches=launches)
    log("  " + json.dumps(out))
    if not bool(torch.isfinite(img).all()):
        fail("wave image is not finite")
    if out["n_done_min"] < 1:
        fail("a lane completed no sample")
    for name, count in only(launches, SWEEPS, "config-3 wave").items():
        if count != REGEN_ITERS:
            fail(f"{name} launched {count} times in the wave, expected "
                 f"{REGEN_ITERS}")
    return out, captured


def capture_sweep_inputs(run, its, walk=False):
    """Run ``run()`` with each sweep wrapper (each walk wrapper where
    ``walk``) recording clones of its inputs (o, d, t_cap) at its launches
    number ``its`` (or ``its[kind]`` where ``its`` is a dict by kind,
    "closest" and "any"); returns them by (kind, launch)."""
    from fountain_tpu_torch.geometry import bvh_walk as bw
    from fountain_tpu_torch.geometry import tri_sweep as ts
    mod, n_tables = (bw, 2) if walk else (ts, 1)
    captured = {}
    originals = {"closest": mod.closest_hit_kernel,
                 "any": mod.any_hit_kernel}

    def recorder(kind):
        calls = [0]
        wanted = its[kind] if isinstance(its, dict) else its

        def wrapped(*a, **k):
            o, d, t_cap = a[n_tables:n_tables + 3]
            if calls[0] in wanted:
                captured[(kind, calls[0])] = tuple(
                    x.clone() for x in (*o, *d, t_cap))
            calls[0] += 1
            return originals[kind](*a, **k)
        return wrapped

    mod.closest_hit_kernel = recorder("closest")
    mod.any_hit_kernel = recorder("any")
    try:
        run()
        torch.cuda.synchronize()
    finally:
        mod.closest_hit_kernel = originals["closest"]
        mod.any_hit_kernel = originals["any"]
    return captured


def phase_gpu_vs_cpu():
    from fountain_tpu_torch.integrator.path import PathConfig
    from fountain_tpu_torch.integrator.render import render_regen
    res, iters = 32, 12
    cfg = PathConfig(max_depth=MAX_DEPTH, rr_threshold=1.0, nee=True)
    log(f"phase 4: GPU vs CPU at {res}x{res}, {iters} iterations "
        "(gates: mean radiance rel 1e-3, >= 99% lanes equal n_done)")
    films = {}
    for dev in (DEVICE, "cpu"):
        scene, cam = build_scene(res, dev)
        films[dev] = render_regen(scene, cam, res, res, iters, cfg, seed=0)
    g, c = films[DEVICE], films["cpu"]
    mean = lambda f: float((f.r_sum.sum() + f.g_sum.sum() + f.b_sum.sum())
                           / (3.0 * f.weight_sum.sum()))
    mg, mc = mean(g), mean(c)
    eq = float((g.weight_sum.cpu() == c.weight_sum).float().mean())
    rel = abs(mg - mc) / max(abs(mc), 1e-12)
    log(f"  mean radiance gpu={mg:.7f} cpu={mc:.7f} rel={rel:.3e} "
        f"n_done_equal={eq:.5f}")
    if rel > 1e-3 or eq < 0.99:
        fail("GPU and CPU renders disagree")


def needed_pairs(table, o, d, t_cap, any_hit, t_eps=1e-4):
    """(ray, face) pairs the kernel's cull lets through on these rays,
    per ray: blocks in order, slab test with the same widened boxes and
    margins, the running best t (closest hit) or the first occluding
    block (any hit) ending the walk, 128 pairs per tested block. Also
    returns the lane-pairs of one thread per ray in lane order, where a
    32-lane warp runs every block that any of its lanes needs."""
    from fountain_tpu_torch.geometry.tensor_tri import (REL_EPS,
                                                        ray_features)
    from fountain_tpu_torch.geometry.tri_sweep import BLOCK_FACES
    oa, da = o.stack(), d.stack()
    rf = ray_features(oa, da)
    inv = 1.0 / torch.where(da == 0.0, 1e-20, da)
    live = t_cap > t_eps
    t_run = t_cap.clone()
    done = torch.zeros_like(live)
    count = torch.zeros_like(t_cap, dtype=torch.int64)
    warp_blocks = 0
    pad = -t_cap.shape[0] % 32
    for b in range(table.n_blocks):
        bb = table.bounds[b]
        t0 = (bb[0:3] - oa) * inv
        t1 = (bb[3:6] - oa) * inv
        t_near = torch.minimum(t0, t1).amax(-1)
        t_far = torch.maximum(t0, t1).amin(-1)
        lim = t_cap if any_hit else t_run
        cand = live & ~done & (t_near <= t_far * 1.0001) & (t_far > 0.0) \
            & (t_near * 0.9999 < lim)
        count += cand
        warp_blocks += int(torch.cat([cand, cand.new_zeros(pad)]).view(
            -1, 32).any(1).sum())
        blk = table.feat.packed[:, b * BLOCK_FACES:(b + 1) * BLOCK_FACES]
        q = (rf @ blk.reshape(10, -1)).reshape(rf.shape[0], -1, 4)
        det, un, vn, tn = q.unbind(-1)
        s = torch.sign(det)
        adet = det.abs()
        U, V, T = un * s, vn * s, tn * s
        eps = REL_EPS * adet
        ok = (adet > 1e-20) & (U >= -eps) & (V >= -eps) \
            & (U + V <= adet + eps) & (T > t_eps * adet) \
            & (T < lim[:, None] * adet) & cand[:, None]
        if any_hit:
            done |= ok.any(-1)
        else:
            t = torch.where(ok, T / torch.where(adet == 0, 1.0, adet),
                            float("inf")).amin(-1)
            t_run = torch.minimum(t_run, t)
    return int(count.sum()) * BLOCK_FACES, warp_blocks * 32 * BLOCK_FACES


def time_cuda(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_call(name, table, o, d, cap):
    """A zero-argument call of the library function alone, with its
    outputs allocated up front; it returns the launch's error code."""
    from fountain_tpu_torch.geometry import tri_sweep as ts
    cols = ts._ray_args(table, o, d, cap)
    n = cap.shape[0]
    outs = ((torch.empty(n, dtype=torch.bool, device=DEVICE),)
            if name == "tri_sweep_any" else
            (torch.empty(n, device=DEVICE),
             torch.empty(n, dtype=torch.int32, device=DEVICE)))
    call = functools.partial(getattr(ts._library(), name),
                             *ts.launch_args(table, cols, 1e-4, outs))
    call.buffers = (cols, outs)  # alive as long as the call: it holds pointers
    return call


def events_ms(call, reps):
    """CUDA events around ``reps`` back-to-back launches: ms each."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    errs = [call() for _ in range(reps)]
    end.record()
    torch.cuda.synchronize()
    if any(errs):
        fail(f"launch failed: {errs}")
    return start.elapsed_time(end) / reps


def kernel_only_ms(name, table, o, d, cap, reps=30):
    """CUDA events around ``reps`` library calls alone, after a warm-up."""
    call = kernel_call(name, table, o, d, cap)
    events_ms(call, 1)
    return events_ms(call, reps)


def phase_kernel_times(scene, captured):
    """Each kernel at a wave's own inputs (``captured``, by kind and launch,
    from ``capture_sweep_inputs``): held to its plain version, timed, and
    set against its bound. The plain version's time is that of its one
    call in the parity check. Returns the rows by (kernel, launch)."""
    from fountain_tpu_torch.core.vecmath import V3
    from fountain_tpu_torch.geometry import tri_sweep as ts
    table = scene.tri_sweep
    table_bytes = table.coef.numel() * 4 + table.bounds.numel() * 4
    names = {"closest": "tri_sweep_closest", "any": "tri_sweep_any"}
    rows = {}
    # closest hit first, then by launch
    for kind, it in sorted(captured,
                           key=lambda k: (k[0] != "closest", k[1])):
        name = names[kind]
        any_hit = kind == "any"
        kern = ts.any_hit_kernel if any_hit else ts.closest_hit_kernel
        ox, oy, oz, dx, dy, dz, cap = captured[(kind, it)]
        o, d = V3(ox, oy, oz), V3(dx, dy, dz)
        n = cap.shape[0]
        err, plain_ms = check(any_hit, table, o, d, cap,
                              f"{name} launch {it}")
        ms = time_cuda(lambda: kern(table, o, d, cap), 20)
        k_ms = kernel_only_ms(name, table, o, d, cap)
        pairs, warp_pairs = needed_pairs(table, o, d, cap, any_hit)
        bytes_ = n * 28 + table_bytes + n * (1 if any_hit else 8)
        t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
        t_ops = pairs * OPS_PER_PAIR / FP32_FLOPS * 1e3
        row = dict(rays=n, live=int((cap > 1e-4).sum()), pairs=pairs,
                   warp_pairs=warp_pairs, ms=ms, kernel_ms=k_ms,
                   plain_ms=plain_ms,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="operations" if t_ops >= t_bytes
                   else "bytes", max_abs_err=err)
        log(f"  {name} launch {it}: " + json.dumps(row))
        rows[(name, it)] = row
    return rows


def _morton16(qx, qy, qz):
    """Interleave three 5-bit ints into a 15-bit Morton code."""
    def expand(v):
        v = (v | (v << 8)) & 0x100F
        v = (v | (v << 4)) & 0x10C3
        v = (v | (v << 2)) & 0x1249
        return v
    return (expand(qz) << 2) | (expand(qy) << 1) | expand(qx)


def sort_keys(o, d):
    """The JAX package's ray sort key (pallas_tri.sort_keys): Morton code
    of the origin's cell in the high bits, of the direction's cell low."""
    def qcell(c):
        lo, hi = c.min(), c.max()
        return ((c - lo) / (hi - lo).clamp_min(1e-12) * 31.0
                ).clamp(0.0, 31.0).to(torch.int32)
    qo = (qcell(o.x), qcell(o.y), qcell(o.z))
    qd = tuple(((c * 0.5 + 0.5) * 31.0).clamp(0.0, 31.0).to(torch.int32)
               for c in d)
    return (_morton16(*qo) << 15) | _morton16(*qd)


def phase_ray_order(scene, cam):
    """Waves in turns under three ray orders. The sorted variants wrap each
    sweep call: sort, gather the rays, sweep, scatter the results back.
    Fails if any order changes the image."""
    from fountain_tpu_torch.core.vecmath import V3
    from fountain_tpu_torch.geometry import tri_sweep as ts
    from fountain_tpu_torch.integrator.path import PathConfig
    from fountain_tpu_torch.integrator.render import render_regen
    cfg = PathConfig(max_depth=MAX_DEPTH, rr_threshold=1.0, nee=True)
    originals = {"closest": ts.closest_hit_kernel, "any": ts.any_hit_kernel}
    dead_key = torch.iinfo(torch.int32).max

    def sorted_call(kind, keyf):
        def call(table, o, d, t_cap, *a, **k):
            key = torch.where(t_cap > 0.0, keyf(o, d, t_cap), dead_key)
            perm = torch.argsort(key, stable=True)
            g = lambda v: V3(*(c[perm] for c in v))              # noqa
            out = originals[kind](table, g(o), g(d), t_cap[perm], *a, **k)
            outs = out if isinstance(out, tuple) else (out,)
            back = tuple(torch.empty_like(x).index_copy_(0, perm, x)
                         for x in outs)
            return back if isinstance(out, tuple) else back[0]
        return call

    variants = {
        "lane order": None,
        "Morton, dead last": lambda o, d, c: sort_keys(o, d),
        "dead last": lambda o, d, c: torch.zeros_like(c, dtype=torch.int32)}
    log("phase 6: ray order, waves in turns (host clock, "
        "torch.cuda.synchronize() at the end)")
    times = {k: [] for k in variants}
    means = {}
    turns = list(variants) + list(variants)[::-1]
    try:
        for name in turns * 2:
            keyf = variants[name]
            ts.closest_hit_kernel = originals["closest"] if keyf is None \
                else sorted_call("closest", keyf)
            ts.any_hit_kernel = originals["any"] if keyf is None \
                else sorted_call("any", keyf)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            film = render_regen(scene, cam, RES, RES, REGEN_ITERS, cfg,
                                seed=0)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
            means[name] = float(film.r_sum.sum() + film.g_sum.sum()
                                + film.b_sum.sum())
    finally:
        ts.closest_hit_kernel = originals["closest"]
        ts.any_hit_kernel = originals["any"]
    out = {}
    for name, v in times.items():
        out[name] = dict(median_s=float(np.median(v)), waves_s=v)
        log(f"  {name}: median {out[name]['median_s']:.4f} s over "
            f"{len(v)} waves {['%.4f' % x for x in v]}")
    if len(set(means.values())) != 1:
        fail(f"ray order changed the image: {means}")
    return out


def phase_profile(scene, cam):
    """Where the wave's time goes: torch.profiler over one more wave
    (launch counts of this wave are not read). Prints the device-busy
    share and the top device-time ops; device time that the profiler does
    not report is printed as not measured."""
    from torch.profiler import ProfilerActivity, profile
    from fountain_tpu_torch.integrator.path import PathConfig
    from fountain_tpu_torch.integrator.render import render_regen
    log("phase 7: torch.profiler over one wave")
    cfg = PathConfig(max_depth=MAX_DEPTH, rr_threshold=1.0, nee=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render_regen(scene, cam, RES, RES, REGEN_ITERS, cfg, seed=0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_us = lambda e: getattr(e, "self_device_time_total",         # noqa
                               getattr(e, "self_cuda_time_total", 0.0))
    events = [e for e in prof.key_averages() if dev_us(e) > 0]
    # device-side entries (kernels, memcpy/memset) vs the aten ops that
    # launched them: summing both would count the device time twice
    on_dev = [e for e in events if str(e.device_type).endswith("CUDA")]
    ops = [e for e in events if e not in on_dev]
    if not on_dev:
        log("  device time: not measured (the profiler reported none)")
        return {}
    busy_ms = sum(dev_us(e) for e in on_dev) / 1e3
    n_launch = sum(e.count for e in on_dev)
    log(f"  profiled wave: wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms (share {busy_ms / wall_ms:.3f}; the profiler "
        f"slows the host, so this share is a lower bound) in {n_launch} "
        f"device calls ({n_launch / REGEN_ITERS:.0f} per iteration)")
    for e in sorted(on_dev, key=dev_us, reverse=True)[:8]:
        log(f"  device {dev_us(e) / 1e3:8.2f} ms {e.count:6d}x "
            f"{e.key[:80]}")
    for e in sorted(ops, key=dev_us, reverse=True)[:12]:
        log(f"  op     {dev_us(e) / 1e3:8.2f} ms {e.count:6d}x {e.key[:80]}")
    sweeps = {}
    for name, tags in (("tri_sweep_closest", ("sweep_kernel<false>",
                                              "sweep_kernelILb0")),
                       ("tri_sweep_any", ("sweep_kernel<true>",
                                          "sweep_kernelILb1"))):
        hits = [e for e in on_dev if any(t in e.key for t in tags)]
        if not hits:
            log(f"  {name}: device time not measured (not in the trace)")
            continue
        total = sum(dev_us(e) for e in hits) / 1e3
        count = sum(e.count for e in hits)
        sweeps[name] = dict(device_ms=total, launches=count,
                            ms_per_launch=total / count)
        # the wave's launches in order, one device event each
        each = sorted((e.time_range.start, e.time_range.elapsed_us() / 1e3)
                      for e in prof.events()
                      if str(e.device_type).endswith("CUDA")
                      and any(t in e.name for t in tags))
        if len(each) == REGEN_ITERS:
            sweeps[name].update(it0_ms=each[0][1], it8_ms=each[8][1])
        log(f"  {name}: {total:.3f} ms device time in {count} launches "
            f"({total / count:.4f} ms each); iterations 0 and 8: "
            + (f"{each[0][1]:.4f} and {each[8][1]:.4f} ms"
               if len(each) == REGEN_ITERS else
               f"not measured ({len(each)} launch events in the trace)"))
    return sweeps


def _with_textures(scene, tv):
    import dataclasses
    return dataclasses.replace(scene, textures=dataclasses.replace(
        scene.textures, value=tv))


def split_step(scene, cam, res, seed, n_iters=REGEN_ITERS):
    """``bench.step`` in its two halves, with each kernel's launches in the
    forward and in the backward pass (counts set to 0 just before the
    forward). Returns (loss, grad, forward launches, backward launches)."""
    from fountain_tpu_torch import bench
    tv = scene.textures.value.detach().clone().requires_grad_(True)
    reset_counts()
    loss = bench.loss_of(bench.wave(_with_textures(scene, tv), cam, res,
                                    seed, n_iters))
    fwd = read_counts()
    loss.backward()
    torch.cuda.synchronize()
    bwd = {k: v - fwd[k] for k, v in read_counts().items()}
    return loss.detach(), tv.grad, fwd, bwd


def _furnace_grads(res, device, spp=4):
    """test_grad.py's analytic furnace gates on ``device``: d/d(albedo)
    of the mean image against the depth-12 truncated series, and
    d/d(emit) against 1 / (1 - rho) = 2."""
    import dataclasses
    from fountain_tpu_torch.core import transform as tf
    from fountain_tpu_torch.integrator.path import PathConfig
    from fountain_tpu_torch.integrator.render import render
    from fountain_tpu_torch.scene.build import SceneBuilder
    from fountain_tpu_torch.scene.camera import make_perspective_camera
    rho = 0.5
    b = SceneBuilder()
    mat = b.add_matte(kd=[rho] * 3)
    sph = b.add_sphere(radius=100.0, mat_id=mat, reverse_orientation=True)
    b.add_area_light_sphere(sph, [1.0] * 3)
    scene = b.build(device=device)
    cam = make_perspective_camera(
        tf.look_at([0.0, -2.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 1.0]),
        (res, res), fov_deg=60.0)
    tv = scene.textures.value.clone().requires_grad_(True)
    img = render(_with_textures(scene, tv), cam, res, res, spp,
                 PathConfig(max_depth=12, rr_threshold=0.0, nee=True))
    (g_alb,) = torch.autograd.grad(img.mean(), tv)
    emit = torch.tensor(1.0, device=device, requires_grad=True)
    s = dataclasses.replace(scene, lights=dataclasses.replace(
        scene.lights, emit=torch.ones_like(scene.lights.emit) * emit))
    img_e = render(s, cam, res, res, spp,
                   PathConfig(max_depth=16, rr_threshold=0.0, nee=True))
    (g_emit,) = torch.autograd.grad(img_e.mean(), emit)
    analytic = sum(k * rho ** (k - 1) for k in range(1, 14))
    return (float(img.detach().mean()), float(g_alb.sum()), analytic,
            float(img_e.detach().mean()), float(g_emit))


def _busy(events):
    """Summed duration (ms) of device events, and their count."""
    return sum(e.time_range.elapsed_us() for e in events) / 1e3, len(events)


def profile_step(forward):
    """torch.profiler over one step, ``forward()`` (the loss) then its
    backward pass, each in a profile of its own (each ends in a
    synchronize): their device-busy ms against their host-clock times,
    the forward's and the backward's top 8 device ops, and the device time
    of the gathers' backward kernels."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as p_fwd:
        t0 = time.perf_counter()
        loss = forward()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    with profile(activities=acts) as p_bwd:
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    out = {}
    dev = {}
    for half, prof, wall in (("fwd", p_fwd, t1 - t0), ("bwd", p_bwd,
                                                       t2 - t1)):
        dev[half] = [e for e in prof.events()
                     if str(e.device_type).endswith("CUDA")]
        busy = sum(e.time_range.elapsed_us() for e in dev[half]) / 1e3
        out.update({f"{half}_busy_ms": busy, f"{half}_wall_ms": wall * 1e3,
                    f"{half}_share": busy / (wall * 1e3),
                    f"{half}_device_calls": len(dev[half])})
    if not dev["fwd"] or not dev["bwd"]:
        log("  device time: not measured (the profiler reported none)")
        return {}
    log("  profiled step (the profiler slows the host, so the shares are "
        "lower bounds): " + json.dumps(out))
    for half, label in (("fwd", "forward"), ("bwd", "backward")):
        by_name = {}
        for e in dev[half]:
            t, c = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
        for name, (ms, count) in top:
            log(f"  {label} device {ms:8.2f} ms {count:6d}x {name[:80]}")
        out[f"{half}_top"] = [dict(name=n[:120], ms=ms, count=c)
                              for n, (ms, c) in top]
    # the backward of a gather whose lanes all read one row: the [N, 96]
    # shading rows (one a iteration; float rows of 96, vectorized by 4)
    # and the env texture's [N, 3] value rows (small stride)
    for tag in ("indexing_backward_kernel<float, 4>",
                "indexing_backward_kernel_small_stride"):
        hits = [(n, v) for n, v in by_name.items() if tag in n]
        ms, count = (sum(v[0] for _, v in hits), sum(v[1] for _, v in hits))
        out[tag] = dict(device_ms=ms, calls=count)
        log(f"  backward {tag}: {ms:.2f} ms device time in {count} calls")
    return out


def index_backward_ms(n, reps=5):
    """The backward of a gather whose n lanes all read one row of a small
    table, as the step's gathers do: what ``table[idx]``'s backward runs
    (an accumulating ``index_put_``) against ``index_add_`` (the backward
    of ``index_select``), CUDA events, ms a call, for the [1, 96] shading
    table and a [4, 3] texture value table; the two results must agree."""
    out = {}
    for rows, width in ((1, 96), (4, 3)):
        idx = torch.full((n,), rows - 1, dtype=torch.long, device=DEVICE)
        grad = torch.rand(n, width, device=DEVICE)
        put = torch.zeros(rows, width, device=DEVICE)
        add = torch.zeros(rows, width, device=DEVICE)
        put_ms = time_cuda(
            lambda: put.index_put_((idx,), grad, accumulate=True), reps)
        add_ms = time_cuda(lambda: add.index_add_(0, idx, grad), reps)
        if not torch.allclose(put, add, rtol=1e-4):
            fail("index_put_ and index_add_ sums differ")
        out[f"{rows}x{width}"] = dict(index_put_ms=put_ms,
                                      index_add_ms=add_ms)
    log(f"  gather backward over {n} lanes reading one row: "
        + json.dumps(out))
    return out


def phase_step(scene, cam, n_timed=4):
    """The differentiable step at full width; fails on any gate."""
    from fountain_tpu_torch import bench
    log(f"phase 8: the differentiable step, {RES}x{RES}, depth {MAX_DEPTH},"
        f" {REGEN_ITERS} iterations, NEE (fwd + autograd bwd w.r.t. the "
        "texture value table)")
    kd_row = int(scene.materials.kd_tex[0])
    tv = scene.textures.value
    rays = bench.count_rays(scene, cam, RES, 0)
    bench.step(scene, cam, RES, tv, 0)                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    times = []
    for i in range(n_timed):
        reset_counts()
        t0 = time.perf_counter()
        loss, grad = bench.step(scene, cam, RES, tv, i + 1)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        per_step = read_counts()
        if any(c != REGEN_ITERS
               for c in only(per_step, SWEEPS, "config-3 step").values()):
            fail(f"a step launched the sweeps {per_step} times, expected "
                 f"{REGEN_ITERS} each")
    peak = torch.cuda.max_memory_allocated()
    loss_s, grad_s, fwd, bwd = split_step(scene, cam, RES, n_timed)
    if any(c != REGEN_ITERS
           for c in only(fwd, SWEEPS, "config-3 step, forward").values()) \
            or any(bwd.values()):
        fail(f"sweep launches: forward {fwd}, backward {bwd}; expected "
             f"{REGEN_ITERS} and 0")
    g = grad[kd_row]
    out = dict(rays_per_wave=rays, step_s=times,
               median_step_s=float(np.median(times)),
               rays_per_s_fwd_bwd=n_timed * rays / sum(times),
               loss=float(loss), kd_grad=g.tolist(),
               max_memory_allocated=peak,
               memory_allocated_before=base_mem,
               launches_per_step=per_step, launches_fwd=fwd,
               launches_bwd=bwd)
    log("  " + json.dumps(out))
    if not (bool(torch.isfinite(grad).all()) and bool((g != 0).all())):
        fail("the kd gradient is not finite and non-zero")
    nz = grad != 0
    if not torch.equal(nz, grad_s != 0) or bool(
            (grad[nz] - grad_s[nz]).abs().gt(
                1e-3 * grad[nz].abs()).any()):
        fail("the split step's gradient differs from bench.step's")

    # central differences at full width, the last timed step's seed
    h = 1e-3
    seed = n_timed

    def loss_at(t):
        with torch.no_grad():
            return float(bench.loss_of(bench.wave(_with_textures(scene, t),
                                                  cam, RES, seed)))
    bump = torch.zeros_like(tv)
    bump[kd_row] = h
    fd = (loss_at(tv + bump) - loss_at(tv - bump)) / (2 * h)
    g_sum = float(g.sum())
    rel = abs(g_sum - fd) / abs(fd)
    log(f"  central difference (h = {h}) of the kd row, summed over "
        f"channels: fd={fd:.7f} grad={g_sum:.7f} rel={rel:.3e} "
        "(gate rtol 5e-3)")
    if rel > 5e-3:
        fail("the full-width gradient disagrees with central differences")
    out.update(fd=fd, fd_rel=rel)

    # card against CPU at 32x32, 12 iterations
    res, iters = 32, 12
    got = {}
    for dev in (DEVICE, "cpu"):
        sc, cm = build_scene(res, dev)
        got[dev] = bench.step(sc, cm, res, sc.textures.value, 0,
                              n_iters=iters)
    (lg, gg), (lc, gc) = got[DEVICE], got["cpu"]
    gg = gg.cpu()
    rel_loss = abs(float(lg) - float(lc)) / abs(float(lc))
    nzc = gc != 0
    rel_g = float(((gg - gc).abs()[nzc] / gc.abs()[nzc]).max())
    log(f"  card vs CPU at {res}x{res}, {iters} iterations: loss "
        f"{float(lg):.7f} / {float(lc):.7f} (rel {rel_loss:.3e}); largest "
        f"relative gradient difference {rel_g:.3e} over "
        f"{int(nzc.sum())} non-zero channels (gates rel 1e-3)")
    if rel_loss > 1e-3 or rel_g > 1e-3 or not torch.equal(gg != 0, nzc):
        fail("card and CPU steps disagree")
    out.update(card_vs_cpu_loss_rel=rel_loss, card_vs_cpu_grad_rel=rel_g)

    # the furnace's gradients on the card
    res = 64
    img_a, g_alb, analytic, img_e, g_emit = _furnace_grads(res, DEVICE)
    rel_a = abs(g_alb - analytic) / analytic
    rel_e = abs(g_emit - 2.0) / 2.0
    log(f"  furnace {res}x{res}, 4 spp: mean {img_a:.5f} (depth 12), "
        f"d/d(albedo) {g_alb:.5f} vs truncated series {analytic:.5f} (rel "
        f"{rel_a:.3e}, gate 0.05); mean {img_e:.5f} (depth 16), d/d(emit) "
        f"{g_emit:.5f} vs 2 (rel {rel_e:.3e}, gate 0.02)")
    if rel_a > 0.05 or rel_e > 0.02:
        fail("furnace gradients off their analytic values")
    out.update(furnace_albedo_grad=g_alb, furnace_emit_grad=g_emit)

    log("  torch.profiler over one step")
    tv_p = tv.detach().clone().requires_grad_(True)
    out["profile"] = profile_step(lambda: bench.loss_of(bench.wave(
        _with_textures(scene, tv_p), cam, RES, 7)))
    out["index_backward"] = index_backward_ms(RES * RES)
    return out


FLAGSHIP = "testscenes/logo_cube.pbrt"
FURNACE = "testscenes/furnace_empty.pbrt"
FLAG_ITS = (0, 6)      # sweep launches whose inputs phase 9 checks and times


def run_cli(args, label):
    """``cli.render.main(args)`` with its kernel launches (counts set to 0
    just before), its rays (each ``trace_paths`` call made to count them,
    as ``count_rays`` counts), its wall time and the image it saved.
    Fails unless the written EXR reads back equal to that image."""
    from fountain_tpu_torch.cli import render as cli
    from fountain_tpu_torch.integrator import render as rd
    from fountain_tpu_torch.io import image as io_image
    from fountain_tpu_torch.io.exr import read_exr
    saved, rays = {}, []
    orig_trace, orig_save = rd.trace_paths, io_image.save_image

    def counting_trace(*a, **k):
        out = orig_trace(*a, **dict(k, count_rays=True))
        if isinstance(out, tuple):          # fixed wave: (radiance, n)
            rays.append(out[1])
            return out[0]
        rays.append(out.n_rays)
        return out

    def keep(path, img):
        saved[path] = np.array(img)
        orig_save(path, img)
    rd.trace_paths, io_image.save_image = counting_trace, keep
    try:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        if cli.main(args) != 0:
            fail(f"{label}: the CLI returned non-zero")
        wall = time.perf_counter() - t0
        launches = read_counts()
    finally:
        rd.trace_paths, io_image.save_image = orig_trace, orig_save
    (path, img), = saved.items()
    back = read_exr(path)
    n_rays = int(sum(int(r) for r in rays))
    out = dict(wall_s=wall, rays=n_rays, rays_per_s=n_rays / wall,
               launches=launches,
               channel_mean=[float(c) for c in img.mean((0, 1))],
               finite=bool(np.isfinite(img).all()),
               exr_equal=bool(np.array_equal(back, img)))
    return out, img


def profile_wave(run, n_iters):
    """torch.profiler over ``run()`` (one wave of ``n_iters``
    iterations, ending in a synchronize): device-busy ms against the
    host-clock ms, device calls per iteration, the top 6 device kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
    if not dev:
        log("  device time: not measured (the profiler reported none)")
        return {}
    busy, calls = _busy(dev)
    by_name = {}
    for e in dev:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    out = dict(busy_ms=busy, wall_ms=wall, share=busy / wall,
               calls_per_iteration=calls / n_iters,
               top=[dict(name=n[:100], ms=ms, count=c)
                    for n, (ms, c) in top])
    log("  profiled wave (the profiler slows the host: the share is a "
        "lower bound): " + json.dumps(out))
    return out


def phase_flagship():
    """The flagship scene through the port's CLI on the card, its kernel
    inputs against the plain versions, the card against the CPU, and the
    furnace through the CLI. Fails on any gate."""
    from fountain_tpu_torch.core import transform as tf
    from fountain_tpu_torch.integrator.path import PathConfig
    from fountain_tpu_torch.integrator.render import render, render_regen
    from fountain_tpu_torch.io.pbrt import load_pbrt
    from fountain_tpu_torch.scene.camera import make_perspective_camera
    out = {}
    t0 = time.perf_counter()
    scene, cam, st = load_pbrt(os.path.join(ROOT, FLAGSHIP), device=DEVICE)
    content = dict(
        faces=scene.triangles.count, spheres=scene.spheres.count,
        lights=scene.lights.count, materials=scene.materials.count,
        material_types=scene.materials.mtype.tolist(),
        textures=scene.textures.count,
        nested_textures=scene.textures.has_nested,
        images=scene.env_images.count, load_s=time.perf_counter() - t0,
        res=st.xres, spp=st.spp, max_depth=st.max_depth,
        lens_radius=cam.lens_radius, focal_dist=cam.focal_dist)
    log(f"phase 9: {FLAGSHIP} on the card: " + json.dumps(content))
    out["scene"] = content
    cfg = PathConfig(max_depth=st.max_depth, rr_threshold=1.0, nee=True)
    n_iters = min(st.spp, 16) + st.max_depth + 1    # the CLI's first wave
    captured = capture_sweep_inputs(
        lambda: render_regen(scene, cam, st.xres, st.yres, n_iters, cfg,
                             seed=0, spp_total=st.spp), FLAG_ITS)
    log(f"  kernels at the first --regen wave's inputs (launches "
        f"{FLAG_ITS}; gates as in phase 2)")
    out["kernels"] = phase_kernel_times(scene, captured)
    out["profile"] = profile_wave(
        lambda: render_regen(scene, cam, st.xres, st.yres, n_iters, cfg,
                             seed=0, spp_total=st.spp), n_iters)

    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    exr = os.path.join(build, "logo_cube.exr")
    # the fixed wave at 16 spp (the file's 64 took ~120 s of the
    # script's time limit)
    for label, extra, spp in (("regen", ["--regen"], st.spp),
                              ("fixed", ["--samples", "16"], 16)):
        res, img = run_cli([os.path.join(ROOT, FLAGSHIP), "-o", exr]
                           + extra, f"logo_cube {label}")
        res["paths_per_s"] = st.xres * st.yres * spp / res["wall_s"]
        log(f"  CLI {label} ({st.xres}x{st.yres}, {spp} spp, depth "
            f"{st.max_depth}): " + json.dumps(res))
        if not (res["finite"] and res["exr_equal"]):
            fail(f"logo_cube {label}: image not finite or EXR differs")
        if min(only(res["launches"], SWEEPS, label).values()) < 1:
            fail(f"logo_cube {label}: a sweep kernel was not launched")
        if min(res["channel_mean"]) <= 0.0:
            fail(f"logo_cube {label}: black image")
        out[f"cli_{label}"] = res

    res_c, spp_c = 32, 4
    cam_c = make_perspective_camera(
        tf.from_matrix(st.camera_to_world), (res_c, res_c), st.fov,
        st.lens_radius, st.focal_dist)
    scene_cpu, _, _ = load_pbrt(os.path.join(ROOT, FLAGSHIP), device="cpu")
    imgs, films = {}, {}
    for dev, sc in ((DEVICE, scene), ("cpu", scene_cpu)):
        imgs[dev] = render(sc, cam_c, res_c, res_c, spp_c, cfg,
                           seed=0).cpu()
        films[dev] = render_regen(sc, cam_c, res_c, res_c,
                                  spp_c + st.max_depth + 1, cfg, seed=0,
                                  spp_total=spp_c)
    g, c = imgs[DEVICE], imgs["cpu"]
    rel_mean = abs(float(g.mean() - c.mean())) / abs(float(c.mean()))
    close = torch.isclose(g, c, rtol=1e-3, atol=1e-6).all(-1)
    fg, fc = films[DEVICE], films["cpu"]
    mean = lambda f: float((f.r_sum.sum() + f.g_sum.sum() + f.b_sum.sum())
                           / (3.0 * f.weight_sum.sum()))
    rel_regen = abs(mean(fg) - mean(fc)) / abs(mean(fc))
    n_eq = float((fg.weight_sum.cpu() == fc.weight_sum).float().mean())
    cmp = dict(fixed_mean_rel=rel_mean,
               fixed_pixels_close=float(close.float().mean()),
               regen_mean_rel=rel_regen, regen_n_done_equal=n_eq)
    log(f"  card vs CPU at {res_c}x{res_c}, {spp_c} spp, depth "
        f"{st.max_depth} (gates: means rel 1e-3, >= 99% of pixels rtol "
        "1e-3, >= 99% of lanes equal n_done): " + json.dumps(cmp))
    if rel_mean > 1e-3 or cmp["fixed_pixels_close"] < 0.99 \
            or rel_regen > 1e-3 or n_eq < 0.99:
        fail("card and CPU renders of the flagship disagree")
    out["card_vs_cpu"] = cmp

    # the furnace: 2 in every pixel; the reference's epsilon 0.1 with
    # Russian roulette at 256 spp of the fixed wave (tests/test_furnace.py),
    # and tests/test_regen.py's gates for the regeneration estimator
    fexr = os.path.join(build, "furnace.exr")
    for label, extra, pix, mean_gate in (
            ("fixed", ["--samples", "256"], 0.1, 0.01),
            ("regen", ["--regen"], 0.4, 0.05)):
        res, img = run_cli([os.path.join(ROOT, FURNACE), "-o", fexr]
                           + extra, f"furnace {label}")
        res.update(mean=float(img.mean()),
                   max_dev=float(np.abs(img - 2.0).max()))
        log(f"  furnace CLI {label} {' '.join(extra)} (gates: every pixel "
            f"2 +- {pix}, mean 2 +- {mean_gate}): " + json.dumps(res))
        if not (res["finite"] and res["exr_equal"]) \
                or res["max_dev"] > pix or abs(res["mean"] - 2.0) > mean_gate:
            fail(f"furnace {label}: off its analytic value")
        out[f"furnace_{label}"] = res
    return out


STEP_ITS = (0, 3)      # sweep launches (bounces) phase 10 checks and times
STEP_TIMED = 3


def logo_texel_range(scene):
    """(first, last + 1) atlas rows of the metal sphere's roughness image
    (every mip level): the image of the metal material whose rough_u slot
    is an image texture."""
    from fountain_tpu_torch.scene.types import MAT_METAL, TEX_IMAGE
    m, tex, atlas = scene.materials, scene.textures, scene.env_images
    for k in range(m.count):
        tid = int(m.rough_u_tex[k])
        if int(m.mtype[k]) == MAT_METAL and int(tex.ttype[tid]) == TEX_IMAGE:
            img = int(tex.image_id[tid])
            last = int(atlas.n_levels[img]) - 1
            end = int(atlas.level_offset[img, last]) + int(
                atlas.level_w[img, last]) * int(atlas.level_h[img, last])
            return int(atlas.level_offset[img, 0]), end
    fail("no metal material with an image roughness in the flagship")


def phase_flagship_step():
    """The flagship's differentiable step (``bench.flagship_step``:
    tools/bench_all.py's config 5) at full width in both estimators, with
    its gates. Fails on any."""
    import dataclasses
    from fountain_tpu_torch import bench
    from fountain_tpu_torch.integrator import path
    from fountain_tpu_torch.integrator.path import PathConfig
    scene, cam = bench.build_flagship(DEVICE)
    res_c, cfg_c = 16, PathConfig(max_depth=3, rr_threshold=1.0, nee=True)
    small = {dev: bench.build_flagship(dev, film_res=res_c)
             for dev in (DEVICE, "cpu")}
    out = {}
    for detach in (True, False):
        est = "detached" if detach else "attached"
        log(f"phase 10 ({est}): the flagship step, {RES}x{RES} lanes of a "
            f"fixed wave through {FLAGSHIP}'s 256x256 camera, depth "
            f"{MAX_DEPTH}, NEE, RR; d/d (texture values, atlas texels) of "
            "(r.x + r.y + r.z).sum() / 3")
        path.reset_graph_counts()
        rec = bench.measure_flagship(scene, cam, RES, STEP_TIMED, detach)
        rec["graph_counts"] = path.graph_counts()
        for run in ("fwd", "bwd"):   # every kernel's counts in one dict
            rec[f"launches_{run}"] |= rec.pop(f"walk_launches_{run}")
        for key, value in rec.items():
            log(f"  {key}: {json.dumps(value)}")
        want = MAX_DEPTH + 1
        if any(c != want for c in only(rec["launches_fwd"], SWEEPS,
                                       "flagship step").values()) \
                or any(rec["launches_bwd"].values()):
            fail(f"flagship step launches: forward {rec['launches_fwd']}, "
                 f"backward {rec['launches_bwd']}; expected {want} and 0")
        if not rec["grad_finite"]:
            fail(f"the {est} flagship gradient is not finite")
        counts = rec["graph_counts"]
        if (counts["wave_captures"], counts["wave_replays"]) \
                != (1, STEP_TIMED):
            fail(f"flagship step graph counts {counts}: expected one "
                 f"recording (the warm-up step) and {STEP_TIMED} replays")

        seed = STEP_TIMED + 1
        captured = capture_sweep_inputs(
            lambda: bench.flagship_forward(scene, cam, RES, seed, detach),
            STEP_ITS)
        log(f"  kernels at the step's rays (launches {STEP_ITS}: bounces 0 "
            "and 3; gates as in phase 2)")
        rec["kernels"] = phase_kernel_times(scene, captured)

        # the full-width key is replayed here; the small one, which
        # records anew, comes after
        log("  torch.profiler over one step")
        rec["profile"] = profile_step(lambda: bench.flagship_forward(
            scene, cam, RES, seed, detach)[0])

        if not detach:
            rec["roughness_fd"] = flagship_roughness_fd(scene, cam, seed)

        got = {dev: bench.flagship_step(sc, cm, res_c, 0, detach, cfg_c)
               for dev, (sc, cm) in small.items()}
        (lg, tg, xg), (lc, tc, xc) = got[DEVICE], got["cpu"]
        rel = lambda a, b: abs(float(a) - float(b)) / max(  # noqa: E731
            abs(float(b)), 1e-30)
        cmp = dict(loss=(float(lg), float(lc)), loss_rel=rel(lg, lc),
                   tex_value_sum=(float(tg.sum()), float(tc.sum())),
                   tex_value_rel=rel(tg.sum(), tc.sum()),
                   texels_sum=(float(xg.sum()), float(xc.sum())),
                   texels_rel=rel(xg.sum(), xc.sum()),
                   finite=bool(torch.isfinite(tg).all()
                               and torch.isfinite(xg).all()))
        log(f"  card vs CPU at {res_c}x{res_c} lanes, depth 3 (gates: loss "
            "rel 1e-4, summed texture-row and texel gradients rel 1e-3): "
            + json.dumps(cmp))
        if cmp["loss_rel"] > 1e-4 or cmp["tex_value_rel"] > 1e-3 \
                or cmp["texels_rel"] > 1e-3 or not cmp["finite"]:
            fail(f"the {est} flagship step differs between card and CPU")
        rec["card_vs_cpu"] = cmp
        out[est] = rec
    return out


def flagship_roughness_fd(scene, cam, seed, h=1e-4):
    """Attached estimator at full width: the metal sphere's roughness (its
    rough_u_tex = rough_v_tex is an image texture, so the parameter is the
    red channel of logo.png's texels, every mip level, bumped together)
    against central differences of the same loss (summed in float64).
    Loose gate: same sign, ratio in (0.5, 2): rays that the roughness
    turns across visibility edges add boundary terms to the difference
    that neither estimator carries."""
    from fountain_tpu_torch import bench
    lo, hi = logo_texel_range(scene)
    _, _, g_tx = bench.flagship_step(scene, cam, RES, seed, False)
    grad = float(g_tx[lo:hi, 0].double().sum())

    def loss_at(sign):
        tx = scene.env_images.texels.clone()
        tx[lo:hi, 0] += sign * h
        with torch.no_grad():
            r = bench.wave(bench.with_params(scene, scene.textures.value,
                                             tx), cam, RES, seed,
                           regen=False, detach_sampling=False)
            return float((r.x.double() + r.y.double() + r.z.double()).sum()
                         / 3.0)
    fd = (loss_at(1.0) - loss_at(-1.0)) / (2.0 * h)
    ratio = grad / fd if fd != 0.0 else float("inf")
    out = dict(texels=(lo, hi), h=h, grad=grad, fd=fd, ratio=ratio)
    log("  attached roughness at full width (logo.png's red texels, "
        "gate: same sign, 0.5 < ratio < 2): " + json.dumps(out))
    if not (np.sign(grad) == np.sign(fd) and 0.5 < ratio < 2.0):
        fail("the attached roughness gradient disagrees with central "
             "differences")
    return out


BENCH_ALL_OUT = "tools/bench_all_out.json"   # the TPU's table, for reading
RAYS_RTOL = 0.005      # rays_per_wave against the TPU's


def phase_all_configs(step, fstep):
    """All five BASELINE configs forward as tools/bench_all.py measures
    them (``bench.measure_all``), each ray count held to the TPU's, the
    fwd+bwd numbers of configs 3 and 5 from phases 8 and 10, and the
    mis_box's card against CPU. Fails on any gate."""
    from fountain_tpu_torch import bench
    from fountain_tpu_torch.integrator.path import PathConfig
    from fountain_tpu_torch.integrator.render import render
    with open(os.path.join(ROOT, BENCH_ALL_OUT)) as fh:
        tpu = {r["config"]: r for r in json.load(fh)["rows"]}
    log(f"phase 11: the five BASELINE configs forward ({RES}x{RES} lanes "
        f"of a fixed wave, depth {MAX_DEPTH}, NEE, RR; 8 timed waves after "
        f"a warm-up; gate: rays_per_wave within {RAYS_RTOL:.1%} of "
        f"{BENCH_ALL_OUT})")
    rows = {}
    for row in bench.measure_all(DEVICE, RES, reps=8, fwdbwd=False):
        row["launches"] |= row.pop("walk_launches")
        name = row["config"]
        ref = tpu[name]["rays_per_wave"]
        row.update(tpu_rays_per_wave=ref,
                   rays_diff=row["rays_per_wave"] - ref,
                   rays_rel=(row["rays_per_wave"] - ref) / ref)
        log("  " + json.dumps(row))
        if abs(row["rays_rel"]) > RAYS_RTOL:
            fail(f"{name}: {row['rays_per_wave']} rays a wave, the TPU's "
                 f"{ref}")
        scene_has_faces = name not in ("furnace_empty", "metal_textured_ggx")
        if scene_has_faces != (
                min(only(row["launches"], SWEEPS, name).values()) > 0):
            fail(f"{name}: sweep launches {row['launches']}")
        rows[name] = row
    rows["rounded_cube_env"].update(
        fwdbwd_from="phase 8 (the 24-iteration regeneration step)",
        fwdbwd_ms=step["median_step_s"] * 1e3,
        fwdbwd_rays_per_s=step["rays_per_s_fwd_bwd"])
    rows["logo_cube_flagship"].update(
        fwdbwd_from="phase 10 (detached)",
        fwdbwd_ms=fstep["detached"]["median_step_s"] * 1e3,
        fwdbwd_rays_per_s=fstep["detached"]["rays_per_s_fwd_bwd"])
    log("  config | port rays/wave | TPU rays/wave | port fwd ms | TPU fwd "
        "ms | port fwd rays/s | TPU fwd rays/s | port fwd+bwd rays/s | TPU "
        "fwd+bwd rays/s (the TPU's numbers are read from "
        f"{BENCH_ALL_OUT}, not compared)")
    for name, row in rows.items():
        t = tpu[name]
        log(f"  {name} | {row['rays_per_wave']} | {t['rays_per_wave']} | "
            f"{row['fwd_ms']:.1f} | {t['fwd_ms']} | "
            f"{row['fwd_rays_per_s']:.0f} | {t['fwd_rays_per_s']:.0f} | "
            f"{row.get('fwdbwd_rays_per_s', '-')} | "
            f"{t.get('fwdbwd_rays_per_s', '-')}")

    res_c, spp_c = 16, 4
    cfg = PathConfig(max_depth=MAX_DEPTH, rr_threshold=1.0, nee=True)
    imgs = {dev: render(*bench.build_mis_box(dev, res_c), res_c, res_c,
                        spp_c, cfg, seed=0).cpu() for dev in (DEVICE, "cpu")}
    g, c = imgs[DEVICE], imgs["cpu"]
    cmp = dict(mean_card=float(g.mean()), mean_cpu=float(c.mean()),
               mean_rel=abs(float(g.mean() - c.mean())) / abs(
                   float(c.mean())),
               pixels_close=float(torch.isclose(g, c, rtol=1e-3,
                                                atol=1e-8).all(-1).float()
                                  .mean()))
    log(f"  mis_box card vs CPU at {res_c}x{res_c}, {spp_c} spp (gates: "
        "mean rel 1e-3, >= 99% of pixels rtol 1e-3): " + json.dumps(cmp))
    if cmp["mean_rel"] > 1e-3 or cmp["pixels_close"] < 0.99:
        fail("card and CPU renders of the mis_box disagree")
    return dict(rows=rows, mis_box_card_vs_cpu=cmp)


LARGE_FACES = 277_248
N_ORACLE = 512


def brute_closest(tv, o, d):
    """Numpy float64 Moller-Trumbore closest hit over every face (as
    tools/large_scene.py's oracle): (t, face), inf / -1 on a miss."""
    v0 = tv[:, 0]
    e1, e2 = tv[:, 1] - v0, tv[:, 2] - v0
    best_t = np.full(len(o), np.inf)
    best_i = np.full(len(o), -1, np.int64)
    for s in range(0, len(tv), 8192):
        a0, ae1, ae2 = v0[s:s + 8192][None], e1[s:s + 8192][None], \
            e2[s:s + 8192][None]
        od, oo = d[:, None], o[:, None]
        pvec = np.cross(od, ae2)
        det = (pvec * ae1).sum(-1)
        inv = 1.0 / np.where(np.abs(det) < 1e-24, 1.0, det)
        tvec = oo - a0
        u = (tvec * pvec).sum(-1) * inv
        qvec = np.cross(tvec, ae1)
        v = (od * qvec).sum(-1) * inv
        t = (ae2 * qvec).sum(-1) * inv
        ok = (np.abs(det) > 1e-24) & (u >= -1e-7) & (v >= -1e-7) \
            & (u + v <= 1 + 1e-7) & (t > 1e-4)
        t = np.where(ok, t, np.inf)
        ci = t.argmin(1)
        ct = t[np.arange(len(o)), ci]
        better = ct < best_t
        best_t = np.where(better, ct, best_t)
        best_i = np.where(better, s + ci, best_i)
    return best_t, best_i


# The BVH walk (csrc/bvh_walk.cu). Kernel against plain walk: the same
# operations in the same order (the file is built with -fmad=false), so
# bit equality is expected; the gate on t is T_RTOL_WALK.
T_RTOL_WALK = 1e-6
# FP32 operations of the walk (no FMAs; abs and negation, bit operations,
# not counted). A node visit, the slab test: 6 subtractions and 6
# multiplications for the six slab distances, 3 min and 3 max of their
# pairs, 2 max for t_near, 2 min for t_far, 1 multiplication by
# 1 + 2 gamma(3), 3 comparisons: 26.
SLAB_OPS = 26
# A leaf slot, the Woop test: 9 subtractions (translate), 12 (shear), 111
# (three compensated differences of products: two Veltkamp products of 17
# and 3 subtractions or additions each), 6 comparisons (same sign), 2
# (det), 3 (z), 5 (t_scaled), 4 (in range), 2 (det = 0 and 1 / det), 1
# (t), 6 (three maxima of three), 12 (delta_z, delta_x, delta_y,
# delta_e), 2 (max_e), 8 (delta_t), 2 (det != 0, t > delta_t): 185.
WOOP_OPS = 185
# A live ray's setup: 3 tests d = 0 and 3 reciprocals, 3 comparisons for
# the dominant axis, the t_max tests (2), 1 / d_z and the shear's 2
# multiplications: 14.
RAY_OPS = 14
WALK_ITS = (0, 8)      # walk launches of the wave phase 12 checks and times


def check_walk(any_hit, scene, o, d, t_max, label):
    """One walk kernel against its plain version on the same rays; fails on
    any difference past the gates. Returns the max |kernel - plain| over
    the hits' t (closest hit; 0 for any hit) and the plain call's ms."""
    from fountain_tpu_torch.geometry import bvh_walk as bw
    args = (scene.bvh_nodes8, scene.bvh_tri_verts, o, d, t_max)
    if any_hit:
        occ_k = bw.any_hit_kernel(*args)
        occ_p, plain_ms = timed_call(lambda: bw.any_hit_plain(*args))
        n_mis = int((occ_k != occ_p).sum())
        log(f"  {label}, walk any hit: rays={o.shape[0]} "
            f"occluded={int(occ_p.sum())} mismatch={n_mis}")
        if n_mis:
            fail(f"walk any-hit parity: {label}")
        return 0.0, plain_ms
    t_k, i_k = bw.closest_hit_kernel(*args)
    (t_p, i_p), plain_ms = timed_call(lambda: bw.closest_hit_plain(*args))
    hit_k, hit_p = i_k >= 0, i_p >= 0
    n_hit_mis = int((hit_k != hit_p).sum())
    m = hit_k & hit_p
    n_idx_mis = int((i_k[m] != i_p[m]).sum())
    err = (t_k[m] - t_p[m]).abs()
    rel_max = float((err / t_p[m].abs().clamp_min(1e-9)).max()) \
        if bool(m.any()) else 0.0
    abs_max = float(err.max()) if bool(m.any()) else 0.0
    n_bits = int((t_k[m] != t_p[m]).sum())
    log(f"  {label}, walk closest hit: rays={o.shape[0]} "
        f"hits={int(hit_p.sum())} hit_mismatch={n_hit_mis} "
        f"idx_mismatch={n_idx_mis} t_rel_max={rel_max:.3e} "
        f"t_not_bit_equal={n_bits}")
    if n_hit_mis or n_idx_mis or rel_max > T_RTOL_WALK:
        fail(f"walk closest-hit parity: {label}")
    return abs_max, plain_ms


def walk_kernel_call(name, scene, o, d, t_max):
    """A zero-argument call of a walk's library function alone, with its
    outputs allocated up front; it returns the launch's error code."""
    from fountain_tpu_torch.geometry import bvh_walk as bw
    nodes, verts = scene.bvh_nodes8, scene.bvh_tri_verts
    cols = bw._ray_args(nodes, verts, o, d, t_max)
    n = t_max.shape[0]
    outs = ((torch.empty(n, dtype=torch.bool, device=DEVICE),)
            if name == "bvh_walk_any" else
            (torch.empty(n, device=DEVICE),
             torch.empty(n, dtype=torch.int32, device=DEVICE)))
    call = functools.partial(getattr(bw._library(), name),
                             *bw.launch_args(nodes, verts, cols, outs))
    call.buffers = (cols, outs)  # alive as long as the call: it holds pointers
    return call


def walk_work(any_hit, scene, o, d, t_max):
    """The work these rays need in the walk, counted by the plain walk:
    node visits, leaf slots tested, distinct node and vertex rows read,
    and the live rays (t_max > 0 after a non-finite limit becomes
    3e38)."""
    from fountain_tpu_torch.geometry import bvh_walk as bw
    stats = {}
    fn = bw.any_hit_plain if any_hit else bw.closest_hit_plain
    fn(scene.bvh_nodes8, scene.bvh_tri_verts, o, d, t_max, stats=stats)
    t = torch.where(torch.isfinite(t_max), t_max, 3e38)
    stats["live"] = int((t > 0).sum())
    return stats


def walk_bound(any_hit, n, work):
    """(bound ms, "bytes" or "operations") of a walk launch: rays in (7
    floats) and results out (t and idx, or one flag), the distinct node
    rows (32 B) and vertex rows (36 B) read, over the HBM rate; the
    operations the work needs over the FP32 rate."""
    bytes_ = n * 28 + n * (1 if any_hit else 8) \
        + work["nodes_touched"] * 32 + work["faces_touched"] * 36
    ops = work["node_visits"] * SLAB_OPS + work["woop_tests"] * WOOP_OPS \
        + work["live"] * RAY_OPS
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes
                                 else "bytes"), bytes_, ops


def phase_walk_times(scene, captured):
    """Each walk kernel at a wave's own inputs (``captured`` by kind and
    launch, from ``capture_sweep_inputs(..., walk=True)``): held to its
    plain version, timed (wrapper, and the library call alone), and set
    against its bound from the work the plain walk counts on the same
    rays. Returns the rows by (kernel, launch)."""
    from fountain_tpu_torch.core.vecmath import V3
    from fountain_tpu_torch.geometry import bvh_walk as bw
    names = {"closest": "bvh_walk_closest", "any": "bvh_walk_any"}
    rows = {}
    for kind, it in sorted(captured,
                           key=lambda k: (k[0] != "closest", k[1])):
        name = names[kind]
        any_hit = kind == "any"
        kern = bw.any_hit_kernel if any_hit else bw.closest_hit_kernel
        ox, oy, oz, dx, dy, dz, t_max = captured[(kind, it)]
        o, d = V3(ox, oy, oz), V3(dx, dy, dz)
        n = t_max.shape[0]
        err, plain_ms = check_walk(any_hit, scene, o, d, t_max,
                                   f"{name} launch {it}")
        ms = time_cuda(lambda: kern(scene.bvh_nodes8, scene.bvh_tri_verts,
                                    o, d, t_max), 20)
        call = walk_kernel_call(name, scene, o, d, t_max)
        events_ms(call, 1)
        k_ms = events_ms(call, 30)
        work = walk_work(any_hit, scene, o, d, t_max)
        bound, by, bytes_, ops = walk_bound(any_hit, n, work)
        row = dict(rays=n, ms=ms, kernel_ms=k_ms, plain_ms=plain_ms,
                   bound_ms=bound, bound_by=by, bytes=bytes_,
                   operations=ops, max_abs_err=err, **work)
        log(f"  {name} launch {it}: " + json.dumps(row))
        rows[(name, it)] = row
    return rows


def phase_large_scene():
    """The JAX package's 277,248-face gate (tools/large_scene.py) on the
    port: host build (the native node build, and the numpy one equal to
    it), both sweep kernels and both walk kernels against their plain
    versions, the closest hit of each against a float64 brute force,
    interior leaks through each, a config-3 wave on this mesh (through the
    walk, as the JAX package takes it off the TPU above 65,536 faces) with
    the walk and the sweeps timed at its iterations 0 and 8, and the fixed
    wave's fwd+bwd step through the walk. Fails on any gate."""
    from fountain_tpu_torch import bench
    from fountain_tpu_torch import native
    from fountain_tpu_torch.core.vecmath import V3
    from fountain_tpu_torch.geometry import bvh
    from fountain_tpu_torch.geometry import bvh_walk as bw
    from fountain_tpu_torch.geometry import tri_sweep as ts
    from fountain_tpu_torch.geometry.tensor_tri import MAX_DENSE_FACES
    from fountain_tpu_torch.integrator.path import PathConfig
    from fountain_tpu_torch.integrator.render import render_regen
    log("phase 12: the large-scene gate (rounded_cube.ply welded, Loop "
        "subdivision 3 levels)")
    scene, cam, host = bench.build_large_scene(DEVICE, RES)
    table = scene.tri_sweep
    out = dict(faces=scene.triangles.count, blocks=table.n_blocks,
               nodes=scene.bvh_nodes8.shape[0], **host)
    if out["faces"] != LARGE_FACES or out["faces"] <= MAX_DENSE_FACES:
        fail(f"the subdivided mesh has {out['faces']} faces")
    # the node build again from the leaf-ordered faces: native and numpy,
    # byte-equal, and (the order being already sorted) equal to the
    # scene's own node rows
    tv = scene.bvh_tri_verts.cpu().numpy()
    bmin, bmax = tv.min(1), tv.max(1)
    t0 = time.perf_counter()
    cc = native.lbvh_build(bmin, bmax, bvh.LEAF_SIZE)
    t1 = time.perf_counter()
    py = bvh.build_lbvh(bmin, bmax)
    t2 = time.perf_counter()
    out.update(nodes_native_s=t1 - t0, nodes_numpy_s=t2 - t1)
    log("  " + json.dumps(out))
    if not all(a.tobytes() == b.tobytes() for a, b in zip(cc, py)) \
            or not np.array_equal(py[3], np.arange(len(tv))) \
            or not np.array_equal(bvh.pack_nodes(*py[:3]),
                                  scene.bvh_nodes8.cpu().numpy()):
        fail("the native and numpy node builds differ at 277k faces")
    rng = np.random.default_rng(7)
    o = rng.uniform(-25, 25, (4096, 3)).astype(np.float32)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o4, d4 = (v3(torch.as_tensor(a, device=DEVICE)) for a in (o, d))
    cap4 = torch.full((4096,), 3e38, device=DEVICE)
    out["random_max_abs_err"] = compare(
        table, o4, d4, cap4, "277k faces, 4096 random rays")
    check_walk(True, scene, o4, d4, cap4, "277k faces, 4096 random rays")
    out["walk_random_max_abs_err"] = check_walk(
        False, scene, o4, d4, cap4, "277k faces, 4096 random rays")[0]

    # oracle rays from outside the mesh (as tools/large_scene.py)
    o = rng.uniform(-30, 30, (N_ORACLE, 3))
    o = np.where(np.abs(o) < 12, np.sign(o) * 12 + o, o)
    d = rng.uniform(-5, 5, (N_ORACLE, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tri = scene.triangles
    tv64 = tri.positions.cpu().double().numpy()[tri.indices.cpu().long()
                                                .numpy()]
    t0 = time.perf_counter()
    ref_t, _ = brute_closest(tv64, o, d)
    brute_s = time.perf_counter() - t0
    o_k, d_k = (v3(torch.as_tensor(a, dtype=torch.float32, device=DEVICE))
                for a in (o, d))
    cap_k = torch.full((N_ORACLE,), 3e38, device=DEVICE)
    hit_ref = np.isfinite(ref_t)
    for label, (t_k, i_k) in (
            ("sweep", ts.closest_hit_kernel(table, o_k, d_k, cap_k)),
            ("walk", bw.closest_hit_kernel(scene.bvh_nodes8,
                                           scene.bvh_tri_verts, o_k, d_k,
                                           cap_k))):
        t_k, hit_k = t_k.cpu().double().numpy(), (i_k >= 0).cpu().numpy()
        m = hit_ref & hit_k
        rel = np.abs(t_k[m] - ref_t[m]) / np.maximum(ref_t[m], 1e-9)
        oracle = dict(rays=N_ORACLE, hits=int(hit_ref.sum()),
                      hit_mismatches=int((hit_ref != hit_k).sum()),
                      t_relerr_max=float(rel.max()) if m.any() else 0.0,
                      brute_force_s=brute_s)
        log(f"  oracle, the {label}'s closest hit against numpy float64 "
            "(gates: 0 hit mismatches, t relerr <= 1e-6): "
            + json.dumps(oracle))
        if oracle["hit_mismatches"] or oracle["t_relerr_max"] > 1e-6:
            fail(f"the {label}'s closest hit disagrees with the brute force "
                 "at 277k faces")
        out[f"oracle_{label}"] = oracle

    nw = 100_000
    dirs = rng.normal(size=(nw, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    zero = torch.zeros(nw, device=DEVICE)
    o_in, d_in = V3(zero, zero, zero), v3(torch.as_tensor(dirs,
                                                          device=DEVICE))
    cap_in = torch.full((nw,), 3e38, device=DEVICE)
    _, idx = ts.closest_hit_kernel(table, o_in, d_in, cap_in)
    _, idx_w = bw.closest_hit_kernel(scene.bvh_nodes8, scene.bvh_tri_verts,
                                     o_in, d_in, cap_in)
    occ_w = bw.any_hit_kernel(scene.bvh_nodes8, scene.bvh_tri_verts, o_in,
                              d_in, cap_in)
    out.update(leaks=int((idx < 0).sum()), walk_leaks=int((idx_w < 0).sum()),
               walk_any_leaks=int((~occ_w).sum()))
    log(f"  watertight: {out['leaks']} leaks (sweep), {out['walk_leaks']} "
        f"(walk, closest hit), {out['walk_any_leaks']} (walk, any hit) / "
        f"{nw} interior rays")
    if out["leaks"] or out["walk_leaks"] or out["walk_any_leaks"]:
        fail("interior rays leaked at 277k faces")

    cfg = PathConfig(max_depth=MAX_DEPTH, rr_threshold=1.0, nee=True)
    captured = capture_sweep_inputs(
        lambda: render_regen(scene, cam, RES, RES, REGEN_ITERS, cfg,
                             seed=0), WALK_ITS, walk=True)
    reset_counts()
    t0 = time.perf_counter()
    film, n_rays = render_regen(scene, cam, RES, RES, REGEN_ITERS, cfg,
                                seed=0, count_rays=True)
    torch.cuda.synchronize()
    wave = dict(wave_s=time.perf_counter() - t0, rays=int(n_rays),
                launches=read_counts(),
                n_done_min=int(film.weight_sum.min()))
    wave["rays_per_s"] = wave["rays"] / wave["wave_s"]
    log(f"  config-3 regeneration wave on this mesh ({RES}x{RES}, "
        f"{REGEN_ITERS} iterations, uniform light; through the walk): "
        + json.dumps(wave))
    if any(c != REGEN_ITERS
           for c in only(wave["launches"], WALKS, "277k wave").values()) \
            or wave["n_done_min"] < 1:
        fail(f"277k wave launches {wave['launches']}")
    out["wave"] = wave
    log("  walk kernels at the wave's inputs (iterations 0 and 8; gates: "
        f"hit masks equal, idx equal on hits, t rtol {T_RTOL_WALK}, any-hit "
        "equal)")
    out["walks"] = phase_walk_times(scene, captured)
    log("  sweep kernels at the same inputs (t_max as the sweep takes it: "
        "non-finite -> 3e38; gates as in phase 2)")
    out["kernels"] = phase_kernel_times(scene, {
        key: (*cols[:6], torch.where(torch.isfinite(cols[6]), cols[6],
                                     3e38))
        for key, cols in captured.items()})

    # the fixed wave's fwd+bwd step, as tools/large_scene.py times it
    tv_ = scene.textures.value
    rays = bench.count_rays(scene, cam, RES, 0, regen=False)
    bench.step(scene, cam, RES, tv_, 0, regen=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(4):
        reset_counts()
        t0 = time.perf_counter()
        loss, grad = bench.step(scene, cam, RES, tv_, i + 1, regen=False)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step = dict(rays_per_wave=rays, tpu_rays_per_wave=398_828,
                step_s=times, median_step_s=float(np.median(times)),
                rays_per_s_fwd_bwd=4 * rays / sum(times),
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                launches_per_step=read_counts(),
                grad_finite=bool(torch.isfinite(grad).all()))
    log(f"  fixed-wave fwd+bwd step ({RES}x{RES}, depth {MAX_DEPTH}; 4 "
        "timed steps after a warm-up; through the walk): "
        + json.dumps(step))
    if not step["grad_finite"] or any(
            c != MAX_DEPTH + 1 for c in only(step["launches_per_step"], WALKS,
                                             "277k step").values()):
        fail("the 277k step's gradient or launches are off")
    if abs(rays - 398_828) > RAYS_RTOL * 398_828:
        fail(f"the 277k wave traces {rays} rays, the TPU's 398,828")
    out["step"] = step
    return out


FURNACE_MODES = (("directlighting", 1.5), ("whitted", 1.5))
MODE_BOUNCES = (0, 3)  # bounces whose sweep inputs phase 13 checks and times


def phase_modes():
    """The integrator modes and the film filters on the card: the furnace
    through the CLI with the directlighting and whitted integrators, BSDF
    sampling only through the API (tests/test_furnace.py's gates); the
    mis_box's fixed wave in each mode with its sweep launches a bounce;
    logo_cube with the Gaussian and triangle filters, card against CPU.
    Fails on any gate."""
    from fountain_tpu_torch import bench
    from fountain_tpu_torch.core import transform as tf
    from fountain_tpu_torch.integrator.path import PathConfig
    from fountain_tpu_torch.integrator.render import render
    from fountain_tpu_torch.io.pbrt import load_pbrt
    from fountain_tpu_torch.scene.camera import make_perspective_camera
    from fountain_tpu_torch.scene.film import (FILTER_GAUSSIAN,
                                               FILTER_TRIANGLE)
    log("phase 13: integrator modes and film filters")
    out = {}
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with open(os.path.join(ROOT, FURNACE)) as fh:
        text = fh.read()
    for integ, want in FURNACE_MODES:
        path = os.path.join(build, f"furnace_{integ}.pbrt")
        with open(path, "w") as fh:
            fh.write(text.replace('Integrator "path"',
                                  f'Integrator "{integ}"'))
        # depth 2: both modes stop at the first diffuse vertex, so the
        # file's depth 10 only adds empty bounces (launches)
        res, img = run_cli([path, "--samples", "64", "--max-depth", "2",
                            "-o", os.path.join(build, "furnace_mode.exr")],
                           f"furnace {integ}")
        res.update(mean=float(img.mean()),
                   max_dev=float(np.abs(img - want).max()))
        log(f"  furnace CLI, Integrator \"{integ}\", 64 spp, max depth 2 "
            f"(gate: every pixel {want} +- 0.01): " + json.dumps(res))
        if not res["finite"] or res["max_dev"] > 0.01:
            fail(f"furnace {integ}: off its analytic value")
        out[f"furnace_{integ}"] = res
    fscene, _ = bench.build_furnace(DEVICE, 16)
    fcam = make_perspective_camera(
        tf.look_at([0.0, -2.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 1.0]),
        (16, 16), fov_deg=60.0)
    img = render(fscene, fcam, 16, 16, 32,
                 PathConfig(max_depth=20, rr_threshold=0.0, nee=False,
                            emit_all_bounces=True)).cpu().numpy()
    bsdf = dict(mean=float(img.mean()), max_dev=float(np.abs(img - 2.0)
                                                      .max()))
    log("  furnace, BSDF sampling only (render API, nee=False, "
        "emit_all_bounces, depth 20, 32 spp; gate: every pixel 2 +- 0.01): "
        + json.dumps(bsdf))
    if not np.isfinite(img).all() or bsdf["max_dev"] > 0.01:
        fail("furnace, BSDF sampling only: off its analytic value")
    out["furnace_bsdf_only"] = bsdf

    scene, cam = bench.build_mis_box(DEVICE, RES)
    for mode, kw in (("path", {}), ("direct", dict(mode="direct")),
                     ("whitted", dict(mode="whitted")),
                     ("bsdf_only", dict(nee=False, emit_all_bounces=True))):
        cfg = PathConfig(max_depth=MAX_DEPTH, rr_threshold=1.0, **kw)
        want = {"path": (1, 1), "direct": (2, 1), "whitted": (1, 1),
                "bsdf_only": (1, 0)}[mode]
        # the warm-up wave records the kernels' inputs at bounces
        # MODE_BOUNCES (direct mode: both closest-hit launches a bounce,
        # the second one the BSDF-sampled ray toward the lights)
        its = {kind: tuple(b * k + j for b in MODE_BOUNCES for j in range(k))
               for kind, k in zip(("closest", "any"), want)}
        captured = capture_sweep_inputs(
            lambda: bench.wave(scene, cam, RES, 0, regen=False, cfg=cfg), its)
        reset_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            r, n_rays = bench.wave(scene, cam, RES, 1, regen=False,
                                   count_rays=True, cfg=cfg)
        torch.cuda.synchronize()
        launches = read_counts()
        rec = dict(wave_s=time.perf_counter() - t0, rays=int(n_rays),
                   launches=launches,
                   launches_per_bounce={k: v / (MAX_DEPTH + 1) for k, v in
                                        launches.items()},
                   mean=float((r.x + r.y + r.z).mean() / 3.0))
        rec["rays_per_s"] = rec["rays"] / rec["wave_s"]
        log(f"  mis_box fixed wave, {mode} ({RES}x{RES}, depth "
            f"{MAX_DEPTH}): " + json.dumps(rec))
        got = tuple(only(rec["launches"], SWEEPS,
                         f"mis_box {mode}").values())
        if got != tuple(w * (MAX_DEPTH + 1) for w in want) \
                or not np.isfinite(rec["mean"]):
            fail(f"mis_box {mode}: launches {got}")
        log(f"  kernels at the {mode} wave's inputs (launches {its}: bounces "
            f"{MODE_BOUNCES}; gates as in phase 2)")
        rec["kernels"] = phase_kernel_times(scene, captured)
        out[f"mis_box_{mode}"] = rec

    fscene_c = {dev: load_pbrt(os.path.join(ROOT, FLAGSHIP), device=dev)
                for dev in (DEVICE, "cpu")}
    st = fscene_c["cpu"][2]
    res_c, spp_c = 32, 4
    cam_c = make_perspective_camera(
        tf.from_matrix(st.camera_to_world), (res_c, res_c), st.fov,
        st.lens_radius, st.focal_dist)
    cfg = PathConfig(max_depth=st.max_depth, rr_threshold=1.0, nee=True)
    for name, ftype in (("gaussian", FILTER_GAUSSIAN),
                        ("triangle", FILTER_TRIANGLE)):
        imgs = {dev: render(sc, cam_c, res_c, res_c, spp_c, cfg,
                            ftype=ftype, fradius=2.0, seed=0).cpu()
                for dev, (sc, _, _) in fscene_c.items()}
        g, c = imgs[DEVICE], imgs["cpu"]
        cmp = dict(mean_rel=abs(float(g.mean() - c.mean()))
                   / abs(float(c.mean())),
                   pixels_close=float(torch.isclose(
                       g, c, rtol=1e-3, atol=1e-6).all(-1).float().mean()))
        log(f"  logo_cube, PixelFilter \"{name}\" radius 2, card vs CPU at "
            f"{res_c}x{res_c}, {spp_c} spp (gates: mean rel 1e-3, >= 99% "
            "of pixels rtol 1e-3): " + json.dumps(cmp))
        if cmp["mean_rel"] > 1e-3 or cmp["pixels_close"] < 0.99:
            fail(f"logo_cube with the {name} filter: card and CPU disagree")
        out[f"logo_cube_{name}"] = cmp
    return out



SHARD_SPP = 4          # samples of phase 14's fixed wave
SHARD_RANKS = 2        # gloo ranks on one card in phase 14
# Phase 14's gradient gate. Each rank sums its half of the lanes'
# float32 contributions to the texture values (index_add_ atomics) and
# the halves are then added; one process sums all 4 x 512^2 lanes in
# another order. Float32 sums of ~1e6 terms in another order differ by
# ~eps * sqrt(n) ~ 6e-5 relative; the phase prints both spreads (on an
# H100: one process against its own second step ~1e-6, two ranks
# against one process ~1.3e-5). A world-size-scaled backward is off by
# 100%.
GRAD_RTOL = 1e-4


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def sharded_runs(scene, cam, sharded, res):
    """Config 3's fixed wave as phase 14 runs it (res x res lanes, depth
    MAX_DEPTH, NEE, box filter, SHARD_SPP samples, seed 0), through
    ``render_sharded`` over the process group or ``render`` here: the
    image under no_grad, then the step (the backward of the image mean to
    the texture values, summed over the ranks when sharded). Returns
    (image, the step's image, gradient, record of each run's wall time and
    kernel launches, counts set to 0 just before each run)."""
    from fountain_tpu_torch.integrator.path import PathConfig
    from fountain_tpu_torch.integrator.render import render
    from fountain_tpu_torch.parallel import shard
    cfg = PathConfig(max_depth=MAX_DEPTH, rr_threshold=1.0, nee=True)
    fn = shard.render_sharded if sharded else render

    def run(step):
        tv = scene.textures.value.detach().clone().requires_grad_(step)
        s = _with_textures(scene, tv)
        _sync(scene.device)
        reset_counts()
        t0 = time.perf_counter()
        with torch.set_grad_enabled(step):
            img = fn(s, cam, res, res, SHARD_SPP, cfg, seed=0)
            if step:
                img.mean().backward()
                if sharded:
                    shard.all_reduce_grads([tv])
        _sync(scene.device)
        return (img.detach().cpu(), tv.grad,
                time.perf_counter() - t0, read_counts())
    img, _, fwd_s, fwd_l = run(False)
    img_step, grad, step_s, step_l = run(True)
    return img, img_step, grad.cpu(), dict(
        fwd_s=fwd_s, step_s=step_s, launches_fwd=fwd_l, launches_step=step_l)


def _gloo_rank(rank, device, out_dir, res):
    """One of phase 14's gloo ranks (``shard.run_ranks``): config 3 built
    on its device, then ``sharded_runs``; results to ``out_dir``."""
    scene, cam = build_scene(res, device)
    img, img_step, grad, rec = sharded_runs(scene, cam, True, res)
    rec.update(rank=rank, device=str(device),
               backend=torch.distributed.get_backend(),
               world=torch.distributed.get_world_size())
    torch.save(dict(img=img, img_step=img_step, grad=grad),
               os.path.join(out_dir, f"rank{rank}.pt"))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(rec, fh)


def _nccl_rank(rank, device, out_dir, res):
    """Phase 14's NCCL process at world size 1: the barrier, then
    ``render_sharded`` (its film through NCCL's all_reduce) against
    ``render`` on the same scene."""
    from fountain_tpu_torch.integrator.path import PathConfig
    from fountain_tpu_torch.integrator.render import render
    from fountain_tpu_torch.parallel import shard
    shard.barrier_sync()
    scene, cam = build_scene(res, device)
    cfg = PathConfig(max_depth=MAX_DEPTH, rr_threshold=1.0, nee=True)
    with torch.no_grad():
        _sync(device)
        reset_counts()
        img = shard.render_sharded(scene, cam, res, res, SHARD_SPP, cfg,
                                   n_devices=1, seed=0)
        _sync(device)
        launches = read_counts()
        ref = render(scene, cam, res, res, SHARD_SPP, cfg, seed=0)
    rec = dict(backend=torch.distributed.get_backend(),
               world=torch.distributed.get_world_size(),
               bit_equal=bool(torch.equal(img, ref)),
               max_abs=float((img - ref).abs().max()), launches=launches)
    with open(os.path.join(out_dir, "nccl.json"), "w") as fh:
        json.dump(rec, fh)


def phase_sharded(scene, cam):
    """Phase 14: the sharded render, the CLI's --devices, checkpoint /
    resume and the image codecs on the card. Fails on any gate."""
    import importlib.util
    import tempfile

    from fountain_tpu_torch.cli import mipmap_debug
    from fountain_tpu_torch.integrator.path import PathConfig
    from fountain_tpu_torch.integrator.render import render_samples
    from fountain_tpu_torch.io.checkpoint import (load_checkpoint,
                                                  save_checkpoint)
    from fountain_tpu_torch.io.image import decode_png, load_image, save_image
    from fountain_tpu_torch.parallel import shard
    from fountain_tpu_torch.scene.film import FILTER_BOX, make_film
    from fountain_tpu_torch.shading.mipmap import build_pyramid
    t_phase = time.perf_counter()
    out = {}
    cfg = PathConfig(max_depth=MAX_DEPTH, rr_threshold=1.0, nee=True)
    log(f"phase 14: config 3's fixed wave ({RES}x{RES} lanes, depth "
        f"{MAX_DEPTH}, NEE, box filter, {SHARD_SPP} spp, seed 0) sharded "
        f"over {SHARD_RANKS} gloo ranks on one card (gates: image rtol 1e-6 "
        f"atol 1e-6, gradient rtol {GRAD_RTOL} against one process)")
    torch.cuda.empty_cache()
    img1, img1_step, grad1, single = sharded_runs(scene, cam, False, RES)
    again = sharded_runs(scene, cam, False, RES)
    single["grad_self_max_rel"] = float(
        ((again[2] - grad1).abs() / grad1.abs().clamp_min(1e-12)).max())
    single["grad"] = grad1.reshape(-1).tolist()
    log("  one process (render; grad_self_max_rel: a second step against "
        "the first): " + json.dumps(single))
    rank_dev = "cuda:0" if DEVICE == "cuda" else "cpu"
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        t0 = time.perf_counter()
        shard.run_ranks(_gloo_rank, [rank_dev] * SHARD_RANKS,
                        args=(tmp, RES), backend="gloo")
        spawn_s = time.perf_counter() - t0
        ranks = []
        for r in range(SHARD_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as fh:
                rec = json.load(fh)
            rec.update(torch.load(os.path.join(tmp, f"rank{r}.pt")))
            ranks.append(rec)
        t0 = time.perf_counter()
        shard.run_ranks(_nccl_rank, [rank_dev], args=(tmp, RES),
                        backend="nccl" if DEVICE == "cuda" else "gloo")
        nccl_spawn_s = time.perf_counter() - t0
        with open(os.path.join(tmp, "nccl.json")) as fh:
            nccl = json.load(fh)
    scale = float(grad1.abs().max())
    for rec in ranks:
        img, img_s, grad = rec.pop("img"), rec.pop("img_step"), \
            rec.pop("grad")
        rec["img_max_rel"] = float(((img - img1).abs()
                                    / img1.abs().clamp_min(1e-6)).max())
        rec["img_close"] = bool(torch.allclose(img, img1, rtol=1e-6,
                                               atol=1e-6)
                                and torch.allclose(img_s, img1_step,
                                                   rtol=1e-6, atol=1e-6))
        rec["grad_max_rel"] = float(((grad - grad1).abs()
                                     / grad1.abs().clamp_min(
                                         1e-6 * scale)).max())
        rec["grad_close"] = bool(torch.allclose(grad, grad1, rtol=GRAD_RTOL,
                                                atol=1e-7 * scale))
        rec["grad"] = grad.reshape(-1).tolist()
        log(f"  gloo rank {rec['rank']} of {rec['world']} on "
            f"{rec['device']}: " + json.dumps(rec))
        if not (rec["img_close"] and rec["grad_close"]):
            fail(f"phase 14: rank {rec['rank']}'s image or gradient differs "
                 "from one process's")
        for run in ("launches_fwd", "launches_step"):
            if min(only(rec[run], SWEEPS, f"rank {rec['rank']}").values()) \
                    < 1:
                fail(f"phase 14: rank {rec['rank']} launched no sweep in "
                     f"{run}")
    log(f"  gloo ranks: {spawn_s:.2f} s for the whole spawn (start, init, "
        f"scene, both runs; one process's runs: {single['fwd_s']:.3f} + "
        f"{single['step_s']:.3f} s)")
    nccl["spawn_s"] = nccl_spawn_s
    log("  NCCL at world size 1 (gate: bit-equal to render): "
        + json.dumps(nccl))
    if not nccl["bit_equal"] \
            or min(only(nccl["launches"], SWEEPS, "NCCL").values()) < 1 \
            or nccl["world"] != 1:
        fail("phase 14: the NCCL render differs from render")
    out.update(single=single, ranks=ranks, nccl=nccl)

    log(f"  kernels at rank 1's inputs (lanes {RES * RES // 2}.. of "
        f"{RES * RES}, launch 0: bounce 0 of sample 0; gates as in phase 2)")
    with torch.no_grad():
        captured = capture_sweep_inputs(
            lambda: shard.render_shard(scene, cam, RES, RES, SHARD_SPP, cfg,
                                       FILTER_BOX, 0.5, 0, 1, SHARD_RANKS),
            (0,))
    out["kernels"] = phase_kernel_times(scene, captured)

    from fountain_tpu_torch.cli import render as cli
    n_cards = torch.cuda.device_count()
    try:
        cli.main([os.path.join(ROOT, FURNACE), "--devices", "2", "-o",
                  os.path.join(build, "furnace_devices2.exr")])
        raised = None
    except RuntimeError as e:
        raised = str(e)
    log(f"  CLI --devices 2 on {n_cards} card(s): raised {raised!r}")
    if n_cards < 2 and raised is None:
        fail("phase 14: --devices 2 did not raise on a one-card machine")
    res, _ = run_cli([os.path.join(ROOT, FLAGSHIP), "--devices", "1",
                      "--samples", "2", "-o",
                      os.path.join(build, "logo_cube_devices1.exr")],
                     "logo_cube --devices 1")
    log("  CLI logo_cube --devices 1 --samples 2: " + json.dumps(res))
    if not (res["finite"] and res["exr_equal"]) \
            or min(only(res["launches"], SWEEPS, "--devices 1").values()) < 1:
        fail("phase 14: --devices 1 did not render through both kernels")
    out["cli_devices1"] = res

    with torch.no_grad():
        run = lambda s0, s1, film: render_samples(  # noqa: E731
            scene, cam, RES, RES, s0, s1, SHARD_SPP, film, cfg, seed=0)
        full = run(0, SHARD_SPP, make_film(RES, RES, DEVICE))
        path = os.path.join(build, "config3.ckpt.npz")
        save_checkpoint(path, run(0, 2, make_film(RES, RES, DEVICE)), 2,
                        SHARD_SPP, seed=0, params=scene.textures.value)
        film, s0, spp, seed, tv = load_checkpoint(
            path, params_like=scene.textures.value, device=DEVICE)
        resumed = render_samples(scene, cam, RES, RES, s0, spp, spp, film,
                                 cfg, seed=seed)
    keys = ("r_sum", "g_sum", "b_sum", "weight_sum")
    ckpt = dict(bit_equal=all(torch.equal(getattr(full, k),
                                          getattr(resumed, k)) for k in keys),
                params_equal=bool(torch.equal(tv, scene.textures.value)),
                film_device=str(film.r_sum.device))
    log(f"  checkpoint on the card: samples [0, 2), save, load, [2, "
        f"{SHARD_SPP}) against [0, {SHARD_SPP}) (gate: bit-equal): "
        + json.dumps(ckpt))
    if not (ckpt["bit_equal"] and ckpt["params_equal"]):
        fail("phase 14: the resumed render differs")
    out["checkpoint"] = ckpt

    logo = os.path.join(ROOT, "data", "logo.png")
    mip_dir = os.path.join(build, "mipmap_debug")
    if mipmap_debug.main([logo, "-o", mip_dir]) != 0:
        fail("phase 14: mipmap_debug failed")
    level = load_image(os.path.join(mip_dir, "logo_L3.png"), gamma=False,
                       flip_y=False)
    want = build_pyramid(load_image(logo))[3][::-1]
    srgb = np.where(want <= 0.0031308, 12.92 * want,
                    1.055 * np.clip(want, 0, 1) ** (1 / 2.4) - 0.055)
    jpg = os.path.join(build, "logo.jpg")
    save_image(jpg, load_image(logo, flip_y=False))
    with open(logo, "rb") as fh:
        src = decode_png(fh.read()).astype(np.float64)
    back = np.asarray(load_image(jpg, gamma=False, flip_y=False)) * 255.0
    io_rec = dict(pillow_installed=importlib.util.find_spec("PIL")
                  is not None, levels=len(os.listdir(mip_dir)) - 1,
                  level3_shape=list(level.shape),
                  level3_max_err_levels=float(np.abs(level - srgb).max()
                                              * 255.0),
                  jpeg_bytes=os.path.getsize(jpg),
                  jpeg_mean_err_levels=float(np.abs(back - src).mean()))
    log("  image codecs (gates: the level within one 8-bit level, the JPEG "
        "within 3 levels on average): " + json.dumps(io_rec))
    if io_rec["level3_shape"] != [32, 32, 3] \
            or io_rec["level3_max_err_levels"] > 1.0 + 1e-3 \
            or io_rec["jpeg_mean_err_levels"] > 3.0:
        fail("phase 14: the image codecs disagree")
    out["image_io"] = io_rec
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 14 took {out['phase_s']:.1f} s (cap 120 s)")
    return out


SCATTER_BOUNCES = (0, 3)   # bounces whose gathers' backward phase 15 times
SCATTER_RTOL = 1e-5        # relative L2 against float64 index_add_
SCATTER_REPS = 10


def plain_fixed_wave(scene, o, d, lane, sample, spread, cfg, seed,
                     count_rays, detach_sampling):
    """The plain loop (op by op) in place of ``path._graphed_wave``."""
    from fountain_tpu_torch.geometry import intersect
    from fountain_tpu_torch.integrator import path
    detach = path._detach if detach_sampling else path._attached
    return intersect.answer_queries(scene, path._fixed_wave(
        scene, path._first_lanes(o, d, lane, sample, spread), cfg, seed,
        count_rays, detach))


def capture_scatter_inputs(scene, cam, seed, bounces):
    """One flagship step through the plain loop, recording the backward
    input (grad, idx) of each differentiable gather whose forward ran in
    one of ``bounces`` (its closest-hit sweeps launched before it, less
    one); returns them by (table shape, bounce), in backward order."""
    from fountain_tpu_torch import bench
    from fountain_tpu_torch.core import gather
    from fountain_tpu_torch.geometry import tri_sweep as ts
    from fountain_tpu_torch.integrator import path
    base, graphed = gather._GatherRows, path._graphed_wave
    captured = {}

    class Recording(base):
        @staticmethod
        def forward(ctx, table, idx):
            ctx.bounce = ts.launch_counts["tri_sweep_closest"] - 1
            return base.forward(ctx, table, idx)

        @staticmethod
        def backward(ctx, grad):
            if ctx.bounce in bounces:
                captured.setdefault((tuple(ctx.shape), ctx.bounce), []) \
                    .append((grad.clone(), ctx.saved_tensors[0].clone()))
            return base.backward(ctx, grad)

    gather._GatherRows, path._graphed_wave = Recording, plain_fixed_wave
    reset_counts()
    try:
        bench.flagship_step(scene, cam, RES, seed)
        torch.cuda.synchronize()
    finally:
        gather._GatherRows, path._graphed_wave = base, graphed
    return captured


def graph_ms(fn, reps=SCATTER_REPS):
    """CUDA events around replays of one CUDA graph of ``fn()``: ms a
    replay (a warm call first, outside the graph)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    return events_ms(lambda: graph.replay() or 0, reps)


def phase_scatter():
    """The scatter kernel (``csrc/scatter_rows.cu``) at the flagship
    step's own inputs. Fails on any gate."""
    from fountain_tpu_torch import bench
    from fountain_tpu_torch.core import gather
    t_phase = time.perf_counter()
    log(f"phase 15: the gathers' backward kernel at the flagship step's "
        f"inputs ({RES}x{RES} lanes, bounces {SCATTER_BOUNCES}): held to "
        f"float64 index_add_ (rel L2 {SCATTER_RTOL}); ms a call of the "
        "wrapper (zero fill + kernel), of the library call alone and of "
        "zeros + index_add_ (library_ms), each in one CUDA graph of the "
        "bounce's calls; the plain version eager; the bytes bound")
    scene, cam = bench.build_flagship(DEVICE)
    # the main path: a fresh recording launches once a differentiable
    # gather (captured into the backward graph), a replay from no host call
    gather.reset_launch_counts()
    bench.flagship_step(scene, cam, RES, 1)
    first = dict(gather.launch_counts)
    bench.flagship_step(scene, cam, RES, 2)
    want = {"scatter_rows_shared": 204, "scatter_rows_global": 624}
    log(f"  launches of a recording step {json.dumps(first)}, after a "
        f"replayed step {json.dumps(gather.launch_counts)}")
    if first != want or gather.launch_counts != want:
        fail(f"scatter launches {first}, {gather.launch_counts}: "
             f"expected {want} in the recording step and none after")
    captured = capture_scatter_inputs(scene, cam, 3, SCATTER_BOUNCES)
    lib = gather._library()
    rows = {}
    for (shape, bounce), calls in sorted(captured.items()):
        table = "x".join(map(str, shape))
        stats = torch.zeros(3, dtype=torch.int64, device=DEVICE)
        err = lib_err = 0.0
        for g, i in calls:
            ref = torch.zeros(shape, dtype=torch.float64,
                              device=DEVICE).index_add_(0, i, g.double())
            norm = float(ref.norm())

            def rel(x):
                d = x.double() - ref
                return float(d.norm()) / norm if norm \
                    else float(d.abs().max())
            err = max(err, rel(gather.scatter_rows(g, i, shape,
                                                   stats=stats)))
            lib_err = max(lib_err, rel(torch.zeros(
                shape, device=DEVICE).index_add_(0, i, g)))
        if err > SCATTER_RTOL or not torch.isfinite(torch.tensor(err)):
            fail(f"scatter_rows into {table} at bounce {bounce}: rel L2 "
                 f"{err} against float64 index_add_")
        outs = [torch.zeros(shape, device=DEVICE) for _ in calls]
        flat = [(g.reshape(g.shape[0], -1).contiguous(), i.contiguous())
                for g, i in calls]

        def kernel_only():
            for (g, i), o in zip(flat, outs):
                e = lib.scatter_rows(*gather.launch_args(g, i, o)[1])
                if e:
                    fail(f"scatter_rows launch failed: {e}")

        n = len(calls)
        lanes = calls[0][1].shape[0]
        cols = flat[0][0].shape[1]
        bytes_ = lanes * (4 * cols + calls[0][1].element_size()) \
            + shape[0] * cols * 4
        lanes_seen, nonzero, atomics = stats.tolist()
        row = dict(
            calls=n, lanes=lanes, rel_l2=err, library_rel_l2=lib_err,
            ms=graph_ms(lambda: [gather.scatter_rows(g, i, shape)
                                 for g, i in calls]) / n,
            kernel_ms=graph_ms(kernel_only) / n,
            library_ms=graph_ms(lambda: [torch.zeros(
                shape, device=DEVICE).index_add_(0, i, g)
                for g, i in calls]) / n,
            plain_ms=time_cuda(lambda: [gather.scatter_rows_plain(
                g, i, shape) for g, i in calls], 3) / n,
            bound_ms=bytes_ / HBM_BYTES_PER_S * 1e3,
            nonzero_share=nonzero / lanes_seen,
            atomics_per_call=atomics / n)
        log(f"  scatter_rows into {table}, bounce {bounce}: "
            + json.dumps(row))
        rows[(table, bounce)] = row
    out = dict(launches_per_step=want, rows=rows,
               phase_s=time.perf_counter() - t_phase)
    log(f"  phase 15 took {out['phase_s']:.1f} s")
    return out


def main():
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is false; this script "
            "needs an NVIDIA card")
        return 1
    sys.path.insert(0, ROOT)
    from concurrent.futures import ThreadPoolExecutor

    from fountain_tpu_torch.core import gather
    from fountain_tpu_torch.geometry import bvh_walk as bw
    from fountain_tpu_torch.geometry import tri_sweep as ts

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"phase 1: card {smi}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    # one nvcc for each source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(ts.SOURCES)) as pool:
        libs = dict(zip(ts.SOURCES, pool.map(ts.build_library, ts.SOURCES)))
    log(f"  built {', '.join(os.path.relpath(p, ROOT) for p in libs.values())}"
        f" in {time.perf_counter() - t0:.1f} s (nvcc "
        f"{' '.join(ts.NVCC_FLAGS)}; per source {json.dumps(ts.SOURCES)})")
    for src, text in ts.build_logs.items():
        for line in text.splitlines():
            log(f"  nvcc {src}: " + line)
    info = {name: ts.kernel_info(name) for name in ts.KERNELS}
    info.update({name: bw.kernel_info(name) for name in bw.KERNELS})
    info.update({f"scatter_rows_int{8 * b}_{level}": gather.kernel_info(
        b, level == "shared") for b in (4, 8)
        for level in ("global", "shared")})
    for name, facts in info.items():
        log(f"  {name}: " + json.dumps(facts))
        if facts["local_bytes"]:
            fail(f"{name} spills to local memory")

    scene, cam = build_scene(RES, DEVICE)
    err_t = stamp(phase_parity(scene))
    wave, captured = stamp(phase_wave(scene, cam))
    stamp(phase_gpu_vs_cpu())
    log("phase 5: kernels at the wave's shapes (iterations 0 and 8; gates "
        "as in phase 2)")
    times = stamp(phase_kernel_times(scene, captured))
    stamp(phase_ray_order(scene, cam))
    prof = stamp(phase_profile(scene, cam))
    step = stamp(phase_step(scene, cam))
    flag = stamp(phase_flagship())
    fstep = stamp(phase_flagship_step())
    allc = stamp(phase_all_configs(step, fstep))
    large = stamp(phase_large_scene())
    modes = stamp(phase_modes())
    sharded = stamp(phase_sharded(scene, cam))
    scatter = stamp(phase_scatter())
    paths = {"config3_wave": wave["launches"],
             "config3_step": step["launches_per_step"],
             "logo_cube_cli_regen": flag["cli_regen"]["launches"],
             "logo_cube_cli_fixed": flag["cli_fixed"]["launches"],
             "furnace_cli_fixed": flag["furnace_fixed"]["launches"],
             "furnace_cli_regen": flag["furnace_regen"]["launches"]}
    for est, rec in fstep.items():
        paths[f"logo_cube_step_{est}_fwd"] = rec["launches_fwd"]
        paths[f"logo_cube_step_{est}_bwd"] = rec["launches_bwd"]
    # configs 1 and 4 hold spheres only: their waves launch no sweep
    for name, row in allc["rows"].items():
        paths[f"{name}_fixed_wave"] = row["launches"]
    paths["large_277k_wave"] = large["wave"]["launches"]
    paths["large_277k_step"] = large["step"]["launches_per_step"]
    for key, rec in modes.items():
        if "launches" in rec:
            paths[key] = rec["launches"]
    mis_box = {key[len("mis_box_"):]: rec for key, rec in modes.items()
               if key.startswith("mis_box_")}
    for run in ("fwd", "step"):
        paths[f"config3_fixed_{run}"] = sharded["single"][f"launches_{run}"]
        for rec in sharded["ranks"]:
            paths[f"config3_sharded_rank{rec['rank']}_{run}"] = \
                rec[f"launches_{run}"]
    paths["config3_sharded_nccl_world1"] = sharded["nccl"]["launches"]
    paths["logo_cube_cli_devices1"] = sharded["cli_devices1"]["launches"]

    kernels = []
    for name, replaces in (
            ("tri_sweep_closest",
             "fountain_tpu/geometry/pallas_tri.py:247 (_kernel)"),
            ("tri_sweep_any",
             "fountain_tpu/geometry/pallas_tri.py:310 (_kernel_any)")):
        r8 = times[(name, 8)]
        kernels.append(dict(
            name=name, route="cuda",
            source="fountain_tpu_torch/csrc/tri_sweep.cu",
            replaces=replaces, launches=wave["launches"][name],
            launches_per_step=step["launches_per_step"][name],
            launches_by_path={k: v[name] for k, v in paths.items()},
            max_abs_err=max(r8["max_abs_err"], times[(name, 0)]["max_abs_err"],
                            *(flag["kernels"][(name, it)]["max_abs_err"]
                              for it in FLAG_ITS),
                            *(rec["kernels"][(name, it)]["max_abs_err"]
                              for rec in fstep.values() for it in STEP_ITS),
                            *(large["kernels"][(name, it)]["max_abs_err"]
                              for it in (0, 8)),
                            *(row["max_abs_err"] for rec in mis_box.values()
                              for (k, _), row in rec["kernels"].items()
                              if k == name),
                            sharded["kernels"][(name, 0)]["max_abs_err"],
                            0.0 if name == "tri_sweep_any"
                            else max(err_t, large["random_max_abs_err"])),
            ms=r8["ms"], plain_ms=r8["plain_ms"], bound_ms=r8["bound_ms"],
            bound_by=r8["bound_by"], library_ms=None,
            kernel_ms=r8["kernel_ms"],
            profiler_ms_per_launch=prof.get(name, {}).get("ms_per_launch"),
            build=info[name],
            it0={k: times[(name, 0)][k] for k in ROW_KEYS}
            | {"profiler_ms": prof.get(name, {}).get("it0_ms")},
            it8={k: r8[k] for k in ROW_KEYS}
            | {"profiler_ms": prof.get(name, {}).get("it8_ms")},
            logo_cube={f"it{it}": {k: flag["kernels"][(name, it)][k]
                                   for k in ROW_KEYS} for it in FLAG_ITS},
            logo_cube_step={est: {f"bounce{it}": {
                k: rec["kernels"][(name, it)][k] for k in ROW_KEYS}
                for it in STEP_ITS} for est, rec in fstep.items()},
            large_mesh={f"it{it}": {k: large["kernels"][(name, it)][k]
                                    for k in ROW_KEYS} for it in (0, 8)},
            mis_box={mode: {f"launch{it}": {k: row[k] for k in ROW_KEYS}
                            for (k_, it), row in rec["kernels"].items()
                            if k_ == name}
                     for mode, rec in mis_box.items()},
            sharded_rank1={"launch0": {
                k: sharded["kernels"][(name, 0)][k] for k in ROW_KEYS}},
            launches_per_flagship_step={
                est: dict(fwd=rec["launches_fwd"][name],
                          bwd=rec["launches_bwd"][name])
                for est, rec in fstep.items()}))
    for name in WALKS:
        rows = {it: large["walks"][(name, it)] for it in WALK_ITS}
        r8 = rows[8]
        sweep = "tri_sweep_any" if name == "bvh_walk_any" \
            else "tri_sweep_closest"
        kernels.append(dict(
            name=name, route="cuda",
            source="fountain_tpu_torch/csrc/bvh_walk.cu",
            replaces="fountain_tpu/geometry/bvh.py:251 (bvh_intersect, a "
                     "jnp while_loop, no pallas_call)",
            launches=large["wave"]["launches"][name],
            launches_per_step=large["step"]["launches_per_step"][name],
            launches_by_path={k: v[name] for k, v in paths.items()},
            max_abs_err=max(large["walk_random_max_abs_err"],
                            *(r["max_abs_err"] for r in rows.values())),
            ms=r8["ms"], plain_ms=r8["plain_ms"], bound_ms=r8["bound_ms"],
            bound_by=r8["bound_by"], library_ms=None,
            kernel_ms=r8["kernel_ms"], build=info[name],
            large_mesh={f"it{it}": dict(row, sweep_at_same_rays={
                k: large["kernels"][(sweep, it)][k] for k in ROW_KEYS})
                for it, row in rows.items()}))
    kernels.append(dict(
        name="scatter_rows", route="cuda",
        source="fountain_tpu_torch/csrc/scatter_rows.cu",
        replaces="none: the JAX package's gather backward "
                 "(fountain_tpu/core/gather.py) is a one-hot matmul or "
                 "XLA's scatter-add, no pallas_call; here it replaces "
                 "index_add_, the backward of index_select "
                 "(core/gather.py gather_rows)",
        launches_per_flagship_step=scatter["launches_per_step"],
        build={k: v for k, v in info.items()
               if k.startswith("scatter_rows")},
        logo_cube_step={f"{table}_bounce{b}": row
                        for (table, b), row in scatter["rows"].items()}))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The differentiable steps of BASELINE configs 3 and 5, and fwd+bwd rays/s.

Counterpart of the repository's root ``bench.py``: rounded_cube.ply (LBVH
leaf order) with a matte material under the image-mapped env light
sky.exr. One step traces a path-regeneration wave (512x512 lanes, depth 5,
NEE, Russian roulette, 24 iterations; ``--no-regen``: the fixed wave) and
takes the gradient of the mean completed radiance with respect to the
texture value table, with autograd. Rays are counted as the root bench
counts them: one closest-hit ray per live lane per iteration plus one
shadow ray per NEE lane.

    python -m fountain_tpu_torch.bench [--res N] [--steps N] [--cpu]
                                       [--no-regen]

runs on the CUDA card (and raises without one) unless ``--cpu`` is given,
and prints one JSON line {"metric": "rays_per_s_fwd_bwd", "value": ...,
"unit": "rays/s", "vs_baseline": ...}, with a ``#`` line of details on
stderr.

    python -m fountain_tpu_torch.bench --all [--res N] [--cpu]

measures all five BASELINE configs as the JAX package's
``tools/bench_all.py`` does (``measure_all``): each config's fixed wave
(512x512 lanes, depth 5, NEE, Russian roulette, zero ray-cone spread),
its rays, and its forward time over 8 waves after a warm-up; configs 3
and 5 also a fwd+bwd step of that wave. One JSON line per config, with
bench_all's keys (``rays_per_wave``, ``fwd_ms``, ``fwd_rays_per_s``,
``fwdbwd_ms``, ``fwdbwd_rays_per_s``, ``grad_finite``) and each sweep's
launches in a forward wave. ``build_large_scene`` builds the JAX
package's 277,248-face gate mesh (``tools/large_scene.py``).

The flagship step (``flagship_step``, ``measure_flagship``; timed by
``chip_smoke.py``, no command line of its own) is the JAX package's
``tools/bench_all.py`` measurement of config 5: testscenes/logo_cube.pbrt
as ``load_pbrt`` builds it, one fixed wave of 512x512 lanes through the
file's camera (depth 5, NEE, Russian roulette, zero ray-cone spread, the
step's seed), and the gradient of (r.x + r.y + r.z).sum() / 3 with
respect to the texture value table and the image atlas's texels (sky.exr
and the sphere's roughness map logo.png), with either estimator. The
file's film is 256x256, so three quarters of the lanes have a pixel
coordinate past it, as in the JAX measurement: their rays leave the
camera outside its field of view.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from fountain_tpu_torch.device import resolve_device
from fountain_tpu_torch.integrator.path import PathConfig, trace_paths
from fountain_tpu_torch.integrator.render import RayFn

# the root bench.py's estimate of a CPU path tracer on the same workload
CPU_BASELINE_RAYS_PER_S = 3.0e6
RES = 512
MAX_DEPTH = 5
N_TIMED = 16
REGEN_ITERS = 24
CPU_RES = 32
CPU_N_TIMED = 2
DATA = Path(__file__).resolve().parents[1] / "data"
FLAGSHIP = Path(__file__).resolve().parents[1] / "testscenes" / \
    "logo_cube.pbrt"
FURNACE = FLAGSHIP.parent / "furnace_empty.pbrt"
CFG = PathConfig(max_depth=MAX_DEPTH, rr_threshold=1.0, nee=True)


def build_scene(res: int, device=None):
    """BASELINE config 3 and the root bench's camera ((25, -30, 18) looking
    at the origin, 45 degree fov) at res x res; on ``device`` (default
    cuda)."""
    from fountain_tpu_torch.core import transform as tf
    from fountain_tpu_torch.geometry.bvh import attach_bvh
    from fountain_tpu_torch.io.exr import read_exr
    from fountain_tpu_torch.io.ply import load_ply
    from fountain_tpu_torch.scene.build import SceneBuilder
    from fountain_tpu_torch.scene.camera import make_perspective_camera
    mesh = load_ply(DATA / "rounded_cube.ply")
    b = SceneBuilder()
    env_tex = b.add_image_texture(b.add_image(read_exr(DATA / "sky.exr")))
    mat = b.add_matte(kd=[0.6, 0.5, 0.4])
    b.add_triangle_mesh(mesh.positions, mesh.indices, normals=mesh.normals,
                        mat_id=mat)
    b.add_infinite_light([1.0, 1.0, 1.0], env_tex=env_tex)
    scene = attach_bvh(b.build(device=device))
    cam = make_perspective_camera(
        tf.look_at([25.0, -30.0, 18.0], [0.0, 0.0, 0.0], [0.0, 0.0, 1.0]),
        (res, res), fov_deg=45.0)
    return scene, cam


def make_ray_fn(cam, res: int, seed):
    """``ray_fn(lane, sample) -> (o, d, spread)``: jittered camera rays of
    pixel lanes (row-major) with zero ray-cone spread, as the root bench
    traces them."""
    return RayFn(cam, res, seed, spp_total=None)


def wave(scene, cam, res: int, seed, n_iters: int = REGEN_ITERS,
         regen: bool = True, count_rays: bool = False,
         detach_sampling: bool = True, cfg: PathConfig = CFG):
    """One wave of the step's forward pass: a RegenResult, or with
    ``regen=False`` the fixed wave's radiance (and n_rays)."""
    n = res * res
    lane = torch.arange(n, dtype=torch.int32, device=scene.device)
    sample = torch.zeros(n, dtype=torch.int32, device=scene.device)
    ray_fn = make_ray_fn(cam, res, seed)
    o, d, _ = ray_fn(lane, sample)
    return trace_paths(scene, o, d, lane, sample, cfg, seed=seed,
                       detach_sampling=detach_sampling,
                       count_rays=count_rays,
                       regen_fn=ray_fn if regen else None, n_iters=n_iters)


def count_rays(scene, cam, res: int, seed=0, n_iters: int = REGEN_ITERS,
               regen: bool = True) -> int:
    """Rays one wave traces (forward accounting, no autograd)."""
    with torch.no_grad():
        out = wave(scene, cam, res, seed, n_iters, regen, count_rays=True)
    return int(out.n_rays if regen else out[1])


def loss_of(out, regen: bool = True) -> torch.Tensor:
    """The bench loss: mean completed radiance over lanes and channels
    (the regeneration wave divides by the completed samples)."""
    if regen:
        total = (out.accum.x + out.accum.y + out.accum.z).sum()
        return total / (3.0 * out.n_done.sum().clamp_min(1).to(
            torch.float32))
    return (out.x + out.y + out.z).mean() / 3.0


def step(scene, cam, res: int, tex_value: torch.Tensor, seed,
         n_iters: int = REGEN_ITERS, regen: bool = True):
    """One differentiable step: (loss, d loss / d tex_value). The scene is
    not changed: a leaf copy of ``tex_value`` replaces its texture
    values."""
    tv = tex_value.detach().clone().requires_grad_(True)
    s = dataclasses.replace(
        scene, textures=dataclasses.replace(scene.textures, value=tv))
    loss = loss_of(wave(s, cam, res, seed, n_iters, regen), regen)
    loss.backward()
    return loss.detach(), tv.grad


def build_flagship(device=None, film_res=None):
    """testscenes/logo_cube.pbrt as ``load_pbrt`` builds it: (scene,
    camera) on ``device`` (default cuda). ``film_res``: the file's camera
    with a film of that many pixels a side instead of its own 256 (small
    waves that still cover the frame)."""
    from fountain_tpu_torch.core import transform as tf
    from fountain_tpu_torch.io.pbrt import load_pbrt
    from fountain_tpu_torch.scene.camera import make_perspective_camera
    scene, cam, st = load_pbrt(str(FLAGSHIP), device=device)
    if film_res is not None:
        cam = make_perspective_camera(
            tf.from_matrix(st.camera_to_world), (film_res, film_res),
            st.fov, st.lens_radius, st.focal_dist)
    return scene, cam


def with_params(scene, tex_value, texels):
    """The scene with its texture value table and atlas texels replaced."""
    return dataclasses.replace(
        scene, textures=dataclasses.replace(scene.textures, value=tex_value),
        env_images=dataclasses.replace(scene.env_images, texels=texels))


def flagship_forward(scene, cam, res: int, seed,
                     detach_sampling: bool = True, cfg: PathConfig = CFG):
    """The flagship step's forward pass: (loss, texture value leaf, atlas
    texel leaf). The loss is (r.x + r.y + r.z).sum() / 3 over one fixed
    wave of res x res lanes; leaf copies of both tables replace the
    scene's own, which is not changed."""
    tv = scene.textures.value.detach().clone().requires_grad_(True)
    texels = scene.env_images.texels.detach().clone().requires_grad_(True)
    r = wave(with_params(scene, tv, texels), cam, res, seed, regen=False,
             detach_sampling=detach_sampling, cfg=cfg)
    return (r.x + r.y + r.z).sum() / 3.0, tv, texels


def flagship_step(scene, cam, res: int, seed, detach_sampling: bool = True,
                  cfg: PathConfig = CFG):
    """One differentiable step of the flagship: (loss, d loss / d texture
    values, d loss / d atlas texels), by autograd."""
    loss, tv, texels = flagship_forward(scene, cam, res, seed,
                                        detach_sampling, cfg)
    loss.backward()
    return loss.detach(), tv.grad, texels.grad


def _split_launches(counts: dict):
    """(the sweeps' counts, the walks' counts) of a kernel_launches() dict."""
    from fountain_tpu_torch.geometry.bvh_walk import KERNELS
    return ({k: v for k, v in counts.items() if k not in KERNELS},
            {k: v for k, v in counts.items() if k in KERNELS})


def measure_flagship(scene, cam, res: int, n_timed: int,
                     detach_sampling: bool = True) -> dict:
    """A warm-up flagship step (seed 0), then ``n_timed`` timed steps
    (seeds 1..n_timed; host clock, each ending in a synchronize on a card)
    with each sweep's launches in a step's forward and backward passes
    (``launches_*``) and each walk's (``walk_launches_*``). Returns the
    numbers as a JSON-ready dict."""
    from fountain_tpu_torch.geometry.intersect import (kernel_launches,
                                                       reset_kernel_launches)
    cuda = scene.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    rays = count_rays(scene, cam, res, 0, regen=False)
    flagship_step(scene, cam, res, 0, detach_sampling)      # warm-up
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(n_timed):
        reset_kernel_launches()
        t0 = time.perf_counter()
        loss, tv, texels = flagship_forward(scene, cam, res, i + 1,
                                            detach_sampling)
        fwd = kernel_launches()
        loss.backward()
        sync()
        times.append(time.perf_counter() - t0)
        bwd = {k: v - fwd[k] for k, v in kernel_launches().items()}
    g_tv, g_tx = tv.grad, texels.grad
    (fwd, walk_fwd), (bwd, walk_bwd) = _split_launches(fwd), \
        _split_launches(bwd)
    return dict(
        estimator="detached" if detach_sampling else "attached", res=res,
        rays_per_wave=rays, step_s=times,
        median_step_s=statistics.median(times),
        rays_per_s_fwd_bwd=n_timed * rays / sum(times),
        loss=float(loss.detach()), grad_tex_value_sum=float(g_tv.sum()),
        grad_texels_sum=float(g_tx.sum()),
        grad_finite=bool(torch.isfinite(g_tv).all()
                         and torch.isfinite(g_tx).all()),
        launches_fwd=fwd, launches_bwd=bwd, walk_launches_fwd=walk_fwd,
        walk_launches_bwd=walk_bwd,
        max_memory_allocated=torch.cuda.max_memory_allocated()
        if cuda else None)


def build_furnace(device=None, res: int = RES):
    """BASELINE config 1: testscenes/furnace_empty.pbrt (a matte sphere
    of albedo 0.5 that emits L = 1 inward) with bench_all's camera
    ((0, -2, 0) looking at the origin, 60 degree fov) at res x res."""
    from fountain_tpu_torch.core import transform as tf
    from fountain_tpu_torch.io.pbrt import load_pbrt
    from fountain_tpu_torch.scene.camera import make_perspective_camera
    scene, _, _ = load_pbrt(str(FURNACE), device=device)
    cam = make_perspective_camera(
        tf.look_at([0.0, -2.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 1.0]),
        (res, res), fov_deg=60.0)
    return scene, cam


def build_mis_box(device=None, res: int = RES):
    """BASELINE config 2, as bench_all builds it: a diffuse box of five
    quads (white, red and green walls, 556 units a side) lit by a
    130 x 104 quad mesh area light (L = 15) under its ceiling."""
    from fountain_tpu_torch.core import transform as tf
    from fountain_tpu_torch.geometry.bvh import attach_bvh
    from fountain_tpu_torch.scene.build import SceneBuilder
    from fountain_tpu_torch.scene.camera import make_perspective_camera
    b = SceneBuilder()

    def quad(p0, p1, p2, p3, mat):
        return b.add_triangle_mesh(
            np.asarray([p0, p1, p2, p3], np.float32),
            np.asarray([[0, 1, 2], [0, 2, 3]], np.int32), mat_id=mat)

    white = b.add_matte(kd=[0.73, 0.73, 0.73])
    red = b.add_matte(kd=[0.65, 0.05, 0.05])
    green = b.add_matte(kd=[0.12, 0.45, 0.15])
    s, w = 278.0, 556.0
    quad([0, 0, 0], [w, 0, 0], [w, w, 0], [0, w, 0], white)        # floor
    quad([0, 0, w], [0, w, w], [w, w, w], [w, 0, w], white)        # ceiling
    quad([0, w, 0], [w, w, 0], [w, w, w], [0, w, w], white)        # back
    quad([0, 0, 0], [0, w, 0], [0, w, w], [0, 0, w], red)
    quad([w, 0, 0], [w, 0, w], [w, w, w], [w, w, 0], green)
    lm = quad([s - 65, s - 52, w - 1], [s + 65, s - 52, w - 1],
              [s + 65, s + 52, w - 1], [s - 65, s + 52, w - 1], white)
    b.add_area_light_mesh(lm, [15.0, 15.0, 15.0])
    scene = attach_bvh(b.build(device=device))
    cam = make_perspective_camera(
        tf.look_at([s, -800.0, s], [s, 0.0, s], [0.0, 0.0, 1.0]),
        (res, res), fov_deg=40.0)
    return scene, cam


def build_metal(device=None, res: int = RES):
    """BASELINE config 4, as bench_all builds it: a copper sphere of
    radius 6 whose GGX roughness is the image data/logo.png (u scaled by
    2), under a uniform infinite light. Spheres only: no sweep runs."""
    from fountain_tpu_torch.core import transform as tf
    from fountain_tpu_torch.io.image import load_image
    from fountain_tpu_torch.scene.build import SceneBuilder
    from fountain_tpu_torch.scene.camera import make_perspective_camera
    b = SceneBuilder()
    logo = b.add_image(load_image(str(DATA / "logo.png")))
    rough = b.add_image_texture(logo, uscale=2.0)
    mat = b.add_metal(eta3=[0.2004, 0.9228, 1.102],
                      k3=[3.913, 2.448, 2.137], roughness=rough)
    b.add_sphere(radius=6.0, mat_id=mat)
    b.add_infinite_light([1.0, 1.0, 1.0])
    scene = b.build(device=device)
    cam = make_perspective_camera(
        tf.look_at([0.0, -20.0, 6.0], [0.0, 0.0, 0.0], [0.0, 0.0, 1.0]),
        (res, res), fov_deg=45.0)
    return scene, cam


# bench_all's five configs: name -> (build function, what a fwd+bwd step
# differentiates: None, "textures" (the texture values) or "flagship"
# (the texture values and the atlas texels))
CONFIGS = {
    "furnace_empty": (build_furnace, None),
    "mis_box": (build_mis_box, None),
    "rounded_cube_env": (lambda device=None, res=RES:
                         build_scene(res, device), "textures"),
    "metal_textured_ggx": (build_metal, None),
    "logo_cube_flagship": (lambda device=None, res=RES:
                           build_flagship(device), "flagship"),
}


def build_large_scene(device=None, res: int = RES):
    """The JAX package's large-scene gate (``tools/large_scene.py``):
    data/rounded_cube.ply welded and Loop-subdivided 3 times (277,248
    faces) with its limit normals, matte kd (0.6, 0.5, 0.4),
    under a uniform infinite light, with config 3's camera; then leaf
    order, the BVH and the per-face tables (``attach_bvh``). Returns
    (scene, camera, host seconds of the subdivision, of the whole build,
    and of its native node build and its tables)."""
    from fountain_tpu_torch.core import transform as tf
    from fountain_tpu_torch.geometry.bvh import attach_bvh
    from fountain_tpu_torch.geometry.loop_subdiv import (loop_subdivide,
                                                         weld_vertices)
    from fountain_tpu_torch.io.ply import load_ply
    from fountain_tpu_torch.scene.build import SceneBuilder
    from fountain_tpu_torch.scene.camera import make_perspective_camera
    mesh = load_ply(DATA / "rounded_cube.ply")
    t0 = time.perf_counter()
    # the PLY duplicates shared vertices (per-face normals): weld first,
    # or Loop's boundary rules open cracks along every seam
    p, f, nrm = loop_subdivide(*weld_vertices(mesh.positions, mesh.indices),
                               n_levels=3)
    t1 = time.perf_counter()
    b = SceneBuilder()
    mat = b.add_matte(kd=[0.6, 0.5, 0.4])
    b.add_triangle_mesh(p, f, normals=nrm, mat_id=mat)
    b.add_infinite_light([1.0, 1.0, 1.0])
    parts = {}
    scene = attach_bvh(b.build(device=device), times=parts)
    t2 = time.perf_counter()
    cam = make_perspective_camera(
        tf.look_at([25.0, -30.0, 18.0], [0.0, 0.0, 0.0], [0.0, 0.0, 1.0]),
        (res, res), fov_deg=45.0)
    return scene, cam, dict(subdivide_s=t1 - t0, build_s=t2 - t1, **parts)


def _fixed_forward(scene, cam, res, seed, cfg=CFG):
    """The summed radiance / 3 of one fixed wave, without autograd."""
    with torch.no_grad():
        r = wave(scene, cam, res, seed, regen=False, cfg=cfg)
        return (r.x + r.y + r.z).sum() / 3.0


def measure_config(name: str, scene, cam, res: int = RES, reps: int = 8,
                   fwdbwd: bool = True) -> dict:
    """bench_all's row of one config: the fixed wave's rays (seed 0), its
    forward time (a warm-up, then ``reps`` waves of seeds 1..reps, each
    ending in a synchronize on a card) and, for configs with a step
    (``CONFIGS``) when ``fwdbwd``, the same for fwd+bwd; each sweep's
    (``launches``) and each walk's (``walk_launches``) launches in one
    forward wave."""
    from fountain_tpu_torch.geometry.intersect import (kernel_launches,
                                                       reset_kernel_launches)
    sync = torch.cuda.synchronize if scene.device.type == "cuda" \
        else (lambda: None)
    rays = count_rays(scene, cam, res, 0, regen=False)
    _fixed_forward(scene, cam, res, 0)
    sync()
    reset_kernel_launches()
    t0 = time.perf_counter()
    for i in range(reps):
        _fixed_forward(scene, cam, res, i + 1)
        sync()
    dt = (time.perf_counter() - t0) / reps
    sweeps, walks = _split_launches(
        {k: v // reps for k, v in kernel_launches().items()})
    row = dict(config=name, res=res, rays_per_wave=rays, fwd_ms=dt * 1e3,
               fwd_rays_per_s=rays / dt, launches=sweeps,
               walk_launches=walks)
    params = CONFIGS[name][1]
    if fwdbwd and params is not None:
        def one(seed):
            if params == "flagship":
                _, g_tv, g_tx = flagship_step(scene, cam, res, seed)
                return (g_tv, g_tx)
            return (step(scene, cam, res, scene.textures.value, seed,
                         regen=False)[1],)
        one(0)
        sync()
        t0 = time.perf_counter()
        for i in range(reps):
            grads = one(i + 1)
            sync()
        dt = (time.perf_counter() - t0) / reps
        row.update(fwdbwd_ms=dt * 1e3, fwdbwd_rays_per_s=rays / dt,
                   grad_finite=all(bool(torch.isfinite(g).all())
                                   for g in grads))
    return row


def measure_all(device=None, res: int = RES, reps: int = 8,
                fwdbwd: bool = True):
    """``measure_config`` of every config in ``CONFIGS``, each built on
    ``device`` (default cuda) at res x res; yields the rows in turn."""
    for name, (build, _) in CONFIGS.items():
        scene, cam = build(device, res)
        yield measure_config(name, scene, cam, res, reps, fwdbwd)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the CPU")
    ap.add_argument("--res", type=int, default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--no-regen", action="store_true",
                    help="the fixed wave instead of path regeneration")
    ap.add_argument("--all", action="store_true",
                    help="all five BASELINE configs, one JSON line each")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    res = args.res or (CPU_RES if args.cpu else RES)
    if args.all:
        for row in measure_all(dev, res, reps=args.steps or 8):
            print(json.dumps(row), flush=True)
        return 0
    n_timed = args.steps or (CPU_N_TIMED if args.cpu else N_TIMED)
    regen = not args.no_regen
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    scene, cam = build_scene(res, dev)
    rays_per_wave = count_rays(scene, cam, res, 0, regen=regen)
    tv = scene.textures.value
    step(scene, cam, res, tv, 0, regen=regen)                # warm-up
    sync()
    t0 = time.perf_counter()
    for i in range(n_timed):
        loss, _ = step(scene, cam, res, tv, i + 1, regen=regen)
    sync()
    dt = time.perf_counter() - t0

    rays_per_s = n_timed * rays_per_wave / dt
    occupancy = rays_per_wave / (res * res * (REGEN_ITERS if regen
                                              else MAX_DEPTH + 1))
    print(json.dumps({
        "metric": "rays_per_s_fwd_bwd",
        "value": round(rays_per_s, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_s / CPU_BASELINE_RAYS_PER_S, 3),
    }), flush=True)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# device={name} res={res} depth={MAX_DEPTH} "
          f"rays/wave={rays_per_wave} steps={n_timed} dt={dt:.3f}s "
          f"loss={float(loss):.5f} lane_occupancy={occupancy:.3f}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

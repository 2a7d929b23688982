"""Pixel-sharded rendering over ``torch.distributed`` (PyTorch).

Counterpart of ``fountain_tpu/parallel/shard.py``. The JAX package shards
the pixel lanes over a device mesh with ``shard_map`` and sums the films
with ``psum``; here each rank of a process group is one shard:

- rank ``r`` of ``n`` traces the pixel lanes ``[r * per, min((r + 1) *
  per, total))``, ``per = ceil(total / n)``, into a full-size partial film
  (``render_shard``). The last shard traces only its real lanes: PyTorch
  needs no equal shapes, so no lane beyond the image is traced;
- the scene tables are replicated, one copy on each rank's device;
- the partial films are summed with ``all_reduce(SUM)``, the collective
  counterpart of the psum (``render_sharded``);
- the counter RNG keys off the global lane, so the image is independent
  of the number of ranks. With the box filter each pixel is owned by one
  shard, so the sum adds only zeros to it.

Gradients: the film sum is an autograd function whose backward is the
identity. A loss of the summed image is replicated on every rank, so every
rank holds the same upstream gradient, and its own lanes carry it to the
scene parameters; ``all_reduce_grads`` then sums the parameter gradients
over the ranks. (``torch.distributed.nn.functional.all_reduce`` would
all-reduce the upstream gradient too and scale the result by the world
size.)

Unlike the JAX package, ``render_devices`` raises when fewer cards exist
than were asked for instead of truncating the mesh, and a rank's wave
scales its ray-cone spread by ``1 / sqrt(spp)`` as ``render`` does (the
JAX package's shard body leaves it at 1). Both are recorded in ROADMAP
C.3.

Processes: ``run_ranks`` spawns one process a rank (``torch.multiprocessing``,
a ``file://`` rendezvous in a temporary directory), initialises the
process group in each and runs a function there; the render CLI's
``--devices N`` goes through it.
"""
from __future__ import annotations

import os
import tempfile
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from fountain_tpu_torch.integrator.path import PathConfig
from fountain_tpu_torch.integrator.render import render_wave
from fountain_tpu_torch.scene.camera import PerspectiveCamera
from fountain_tpu_torch.scene.film import (FILTER_BOX, Film,
                                           add_samples_aligned, finalize,
                                           make_film)
from fountain_tpu_torch.scene.types import Scene


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_ids: Optional[Sequence[int]] = None,
                     backend: Optional[str] = None) -> int:
    """Join the process group, prove it with ``barrier_sync`` and return
    this process's rank.

    ``coordinator_address`` is ``host:port`` (a ``tcp://`` rendezvous) or a
    full init URL (``tcp://...``, ``file://...``); without one, torchrun's
    environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``) is read. ``local_device_ids`` names this rank's card
    (its first entry becomes the current CUDA device); a rank that names
    none is a CPU rank. The backend is ``nccl`` for CUDA ranks and
    ``gloo`` for CPU ranks unless ``backend`` names one. With one process
    and no coordinator nothing is initialised and the rank is 0.
    """
    if local_device_ids is not None:
        torch.cuda.set_device(int(local_device_ids[0]))
    from_env = coordinator_address is None and "MASTER_ADDR" in os.environ
    multi = ((num_processes or 1) > 1 or coordinator_address is not None
             or from_env)
    if multi and not dist.is_initialized():
        if backend is None:
            backend = "gloo" if local_device_ids is None else "nccl"
        if from_env:
            init = "env://"
        elif coordinator_address is None:
            raise ValueError(f"num_processes={num_processes} needs a "
                             "coordinator_address or torchrun's environment")
        else:
            init = (coordinator_address if "://" in coordinator_address
                    else f"tcp://{coordinator_address}")
        if init != "env://" and (num_processes is None or process_id is None):
            raise ValueError("a coordinator_address needs num_processes and "
                             "process_id")
        dist.init_process_group(
            backend, init_method=init,
            world_size=-1 if num_processes is None else num_processes,
            rank=-1 if process_id is None else process_id)
    barrier_sync()
    return dist.get_rank() if dist.is_initialized() else 0


def barrier_sync() -> None:
    """Prove that every rank answers: an ``all_reduce`` of a 1 on each rank
    must sum to the world size (the JAX package's ``psum(1)``). Without a
    process group the world is this process and the proof is trivial."""
    if not dist.is_initialized():
        return
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    one = torch.ones(1, dtype=torch.int32, device=dev)
    dist.all_reduce(one)
    total, world = int(one.item()), dist.get_world_size()
    if total != world:
        raise RuntimeError(f"init barrier failed: {total} != {world}")


def render_devices(n_devices: Optional[int] = None) -> list:
    """The cards of an ``n_devices``-rank render on this host, one a rank:
    ``cuda:0`` .. ``cuda:n-1`` (all cards when None). Raises when fewer
    cards exist than were asked for (the JAX package's mesh truncates)."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if n_devices is None else n_devices
    if n < 1 or n > have:
        raise RuntimeError(f"{n} CUDA devices asked for, {have} present")
    return [torch.device("cuda", i) for i in range(n)]


def shard_lanes(total: int, shard: int, n_shards: int):
    """(first lane, lane count) of shard ``shard`` of ``n_shards`` over
    ``total`` pixel lanes: ``ceil(total / n_shards)`` lanes a shard, the
    last one ragged (or empty)."""
    per = -(-total // n_shards)
    begin = min(shard * per, total)
    return begin, min(per, total - begin)


def render_shard(scene: Scene, camera: PerspectiveCamera, xres: int,
                 yres: int, spp: int, cfg: PathConfig, ftype: int,
                 fradius: float, seed, shard: int, n_shards: int,
                 detach_sampling: bool = True) -> Film:
    """One shard's partial film (full size): ``spp`` samples of its pixel
    lanes (``shard_lanes``), splatted with the film filter. The films of
    all ``n_shards`` shards sum to ``render``'s film."""
    begin, n = shard_lanes(xres * yres, shard, n_shards)
    film = make_film(xres, yres, scene.device)
    for s in range(spp if n > 0 else 0):
        fx, fy, radiance = render_wave(
            scene, camera, xres, yres, s, cfg, seed=seed,
            lane_offset=begin, n_lanes=n, detach_sampling=detach_sampling,
            diff_scale=1.0 / max(spp, 1) ** 0.5)
        film = add_samples_aligned(film, fx, fy, radiance, ftype=ftype,
                                   radius=fradius, lane_offset=begin)
    return film


class _SumOverRanks(torch.autograd.Function):
    """``all_reduce(SUM)`` forward, identity backward: the upstream gradient
    of a loss replicated on every rank is already the same everywhere."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad


def render_sharded(scene: Scene, camera: PerspectiveCamera, xres: int,
                   yres: int, spp: int, cfg: PathConfig = PathConfig(),
                   n_devices: Optional[int] = None, ftype: int = FILTER_BOX,
                   fradius: float = 0.5, seed=0,
                   detach_sampling: bool = True) -> torch.Tensor:
    """The image [yres, xres, 3], its pixel lanes sharded over the ranks of
    the process group (this rank renders its shard on the scene's
    device); every rank returns the whole image. ``n_devices``, when
    given, must equal the world size. Without a process group the world
    is this process: one shard, the image of ``render``, and no
    collective.

    The image equals ``render``'s up to float addition order (bitwise for
    radius-0.5 filters, where one shard owns each pixel); it is
    differentiable, see the module docstring for the gradients."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices} but the process group has "
                         f"{world} ranks (init_distributed / run_ranks)")
    rank = dist.get_rank() if dist.is_initialized() else 0
    film = render_shard(scene, camera, xres, yres, spp, cfg, ftype, fradius,
                        seed, rank, world, detach_sampling)
    if dist.is_initialized():
        planes = _SumOverRanks.apply(torch.stack(
            [film.r_sum, film.g_sum, film.b_sum, film.weight_sum]))
        film = Film(*planes.unbind(0))
    return finalize(film)


def all_reduce_grads(tensors: Sequence[torch.Tensor]) -> None:
    """Sum the ``.grad`` of each tensor over the ranks, in place (a tensor
    without a gradient counts as zeros): after a sharded backward each
    rank's gradient holds only its own lanes' share."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    grads = [t.grad if t.grad is not None else torch.zeros_like(t)
             for t in tensors]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    for t, g in zip(tensors, flat.split([g.numel() for g in grads])):
        t.grad = g.view_as(t).clone()


def _rank_main(rank: int, fn, devices: Sequence[str], init: str,
               backend: Optional[str], args: tuple) -> None:
    device = torch.device(devices[rank])
    init_distributed(init, len(devices), rank,
                     local_device_ids=(None if device.type == "cpu"
                                       else [device.index]),
                     backend=backend)
    try:
        fn(rank, device, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, devices: Sequence, args: tuple = (),
              backend: Optional[str] = None) -> None:
    """Run ``fn(rank, device, *args)`` in one spawned process a rank, rank
    ``r`` on ``devices[r]`` (``"cpu"`` or ``"cuda:k"``), all joined in one
    process group (``init_distributed``'s backend rule: ``nccl`` when the
    ranks are cards, ``gloo`` on the CPU, unless ``backend`` names one).
    ``fn`` must be picklable (a module-level function). A rank that raises
    ends every rank, and this call raises."""
    devices = [str(torch.device(d)) for d in devices]
    for d in devices:
        if d.startswith("cuda") and ":" not in d:
            raise ValueError(f"name the card of every CUDA rank, got {d}")
    with tempfile.TemporaryDirectory(prefix="fountain-rdv-") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        torch.multiprocessing.spawn(
            _rank_main, args=(fn, devices, init, backend, tuple(args)),
            nprocs=len(devices), join=True)

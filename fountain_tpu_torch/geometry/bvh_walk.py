"""The BVH walk: hand-written CUDA kernels and their wrappers.

Counterpart of ``bvh_intersect`` in ``fountain_tpu/geometry/bvh.py``,
which the JAX package runs in place of its Pallas sweep on every backend
but the TPU once a mesh has more than ``tensor_tri.MAX_DENSE_FACES``
faces. Both walks, closest hit and any hit, are CUDA C++ kernels for
Hopper (``csrc/bvh_walk.cu``, one thread a ray), built with nvcc by
``tri_sweep.build_library`` on first use and loaded with ctypes.

Dispatch is by tensor device: rays on the CPU take the plain PyTorch walk
(``bvh.bvh_intersect``); rays on a CUDA device launch the kernel, or raise.
Each wrapper adds one to its launch count where it launches its kernel,
and nowhere else.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from fountain_tpu_torch.core.vecmath import V3, gamma
from fountain_tpu_torch.geometry.bvh import SLAB_SCALE, bvh_intersect
from fountain_tpu_torch.geometry.tri_sweep import build_library, ray_columns

# launches per kernel; reset and read by callers that account for a run
launch_counts = {"bvh_walk_closest": 0, "bvh_walk_any": 0}
KERNELS = tuple(launch_counts)
# the f32 constants the kernels take, as the plain walk rounds them
_CONSTS = (SLAB_SCALE, gamma(2), gamma(3), gamma(5))


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


_LIB = None
_LIB_LOCK = threading.Lock()


def _library():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build_library("bvh_walk")))
            p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            common = [p, p, p, p, p, p, p, i, p, i, p, i, fl, fl, fl, fl]
            lib.bvh_walk_closest.argtypes = common + [p, p, p]
            lib.bvh_walk_closest.restype = ctypes.c_int
            lib.bvh_walk_any.argtypes = common + [p, p]
            lib.bvh_walk_any.restype = ctypes.c_int
            lib.bvh_walk_info.argtypes = [i, p]
            lib.bvh_walk_info.restype = ctypes.c_int
            lib.bvh_walk_error_string.argtypes = [ctypes.c_int]
            lib.bvh_walk_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def _check(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.bvh_walk_error_string(err).decode()}")


def _ray_args(nodes8, tri_verts, o: V3, d: V3, t_max):
    """Validate a walk's inputs (flat [N] f32 rays on one CUDA device, the
    tables there too) and return the ray tensors the kernel reads."""
    dev = t_max.device
    cols = ray_columns(o, d, t_max)
    if nodes8.device != dev or tri_verts.device != dev:
        raise ValueError("BVH tables and rays must be on the same device")
    if (nodes8.dtype != torch.float32 or nodes8.dim() != 2
            or nodes8.shape[1] != 8 or not nodes8.is_contiguous()
            or nodes8.data_ptr() % 16
            or tri_verts.dtype != torch.float32
            or tri_verts.shape[1:] != (3, 3)
            or not tri_verts.is_contiguous()):
        raise ValueError("malformed BVH tables")
    return cols


def launch_args(nodes8, tri_verts, cols, outs):
    """The C call's arguments after the kernel's name: ray columns, node
    rows, vertices, the f32 constants, outputs and PyTorch's current
    stream (for timing the library call alone, outputs preallocated)."""
    stream = torch.cuda.current_stream(cols[0].device).cuda_stream
    return (*(c.data_ptr() for c in cols), cols[0].shape[0],
            nodes8.data_ptr(), nodes8.shape[0], tri_verts.data_ptr(),
            tri_verts.shape[0], *_CONSTS, *(x.data_ptr() for x in outs),
            stream)


def _launch(name: str, nodes8, tri_verts, cols, outs):
    lib = _library()
    with torch.cuda.device(cols[0].device):
        err = getattr(lib, name)(*launch_args(nodes8, tri_verts, cols, outs))
    _check(lib, err, name)
    launch_counts[name] += 1


def kernel_info(name: str, device="cuda") -> dict:
    """Build facts of a walk kernel on a card, as
    ``tri_sweep.kernel_info`` reports them."""
    lib = _library()
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device):
        _check(lib, lib.bvh_walk_info(int(name == "bvh_walk_any"), out),
               name)
    keys = ("registers", "shared_bytes", "local_bytes", "blocks_per_sm",
            "threads", "sms")
    return dict(zip(keys, out))


def closest_hit_kernel(nodes8, tri_verts, o: V3, d: V3, t_max):
    """Closest-hit walk on the card (``bvh_walk_closest``). Returns (t,
    idx) with t = inf and idx = -1 on a miss."""
    cols = _ray_args(nodes8, tri_verts, o, d, t_max)
    t_out = torch.empty_like(cols[-1])
    idx_out = torch.empty(t_out.shape, dtype=torch.int32, device=t_out.device)
    _launch("bvh_walk_closest", nodes8, tri_verts, cols, (t_out, idx_out))
    return t_out, idx_out


def any_hit_kernel(nodes8, tri_verts, o: V3, d: V3, t_max):
    """Any-hit walk on the card (``bvh_walk_any``): occluded [N] bool."""
    cols = _ray_args(nodes8, tri_verts, o, d, t_max)
    occ = torch.empty(cols[-1].shape, dtype=torch.bool,
                      device=cols[-1].device)
    _launch("bvh_walk_any", nodes8, tri_verts, cols, (occ,))
    return occ


def closest_hit_plain(nodes8, tri_verts, o: V3, d: V3, t_max,
                      stats: dict | None = None):
    """Plain PyTorch version of the closest-hit kernel, same outputs."""
    t, idx, found = bvh_intersect(nodes8, tri_verts, o.stack(), d.stack(),
                                  t_max, stats=stats)
    return t, torch.where(found, idx, -1)


def any_hit_plain(nodes8, tri_verts, o: V3, d: V3, t_max,
                  stats: dict | None = None):
    """Plain PyTorch version of the any-hit kernel, same output."""
    return bvh_intersect(nodes8, tri_verts, o.stack(), d.stack(), t_max,
                         any_hit=True, stats=stats)[2]


def walk_intersect(nodes8, tri_verts, o: V3, d: V3, t_max,
                   any_hit: bool = False):
    """Closest-hit (or any-hit) walk, with ``tri_sweep.mt_intersect_kernel``'s
    contract: a non-finite ``t_max`` means no limit (3e38), ``t_max <= 0``
    marks a dead lane, a miss is (t=inf, idx=0, found=False), and in
    any-hit mode only the boolean is meaningful. Rays on the CPU take the
    plain walk, rays on a CUDA device launch the kernel. The rays are
    detached on both branches: a walk carries no gradient."""
    o = V3(o.x.detach(), o.y.detach(), o.z.detach())
    d = V3(d.x.detach(), d.y.detach(), d.z.detach())
    t_max = t_max.detach()
    if t_max.device.type == "cpu":
        closest, anyhit = closest_hit_plain, any_hit_plain
    elif t_max.device.type == "cuda":
        closest, anyhit = closest_hit_kernel, any_hit_kernel
    else:
        raise ValueError(f"no BVH walk for device {t_max.device}")
    if any_hit:
        occ = anyhit(nodes8, tri_verts, o, d, t_max)
        return torch.zeros_like(t_max), torch.zeros_like(
            occ, dtype=torch.int32), occ
    t, idx = closest(nodes8, tri_verts, o, d, t_max)
    found = idx >= 0
    return t, idx.clamp_min(0), found

"""The two triangle sweeps: hand-written CUDA kernels and their wrappers.

Counterpart of ``fountain_tpu/geometry/pallas_tri.py``. The TPU package
ran a closest-hit and an any-hit Möller–Trumbore sweep as Pallas kernels
(``_kernel`` and ``_kernel_any``); here both are CUDA C++ kernels for
Hopper (``csrc/tri_sweep.cu``), built with nvcc into a shared library with
a plain C interface on first use and loaded with ctypes.

Both are bound by FP32 work over the (ray, face) pairs that survive a
conservative cull of 128-face blocks against the rays' slab tests. The
kernels run persistent thread blocks that claim 256-lane chunks from a
global counter (kept per stream; the launch's last claim sets it back
to zero), queue only live
lanes, stage each needed block with a TMA bulk copy into one of two
shared-memory stages while the previous one is tested, and test each
listed (ray, block) pair with 128 threads, one face each, so no lane idles
on a block its ray does not need. A pair takes only the 19 multiply-adds
of a face's 16 non-zero coefficients (``SweepTable.coef``), in the plain
version's order, so the results keep its bits. Rays are taken in the
caller's lane order: a Morton sort of the rays in the wrapper did not make
the wave faster (``chip_smoke.py`` phase 6 times waves in both orders;
``PERF.md`` has the numbers).

Dispatch is by tensor device: rays on the CPU take the plain PyTorch
version (``tensor_tri.mt_intersect``, the oracle); rays on a CUDA device
launch the kernel, or raise. Each wrapper adds one to its launch count
where it launches its kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from fountain_tpu_torch.core.vecmath import V3
from fountain_tpu_torch.geometry.tensor_tri import (TriFeatures,
                                                    build_tri_features,
                                                    mt_intersect)

BLOCK_FACES = 128      # faces per leaf block (one shared-memory stage)
COEF_PER_FACE = 16     # the non-zero ones of a face's 10 x 4 coefficients

# Where each of a face's 16 kernel coefficients sits in the plain
# version's [10, F, 4] table (ray feature k, quantity): rows of 4, in the
# order the kernel's FMA chains read them. Quantity 0 is det (-n against
# d), 1 is u (w2, e2), 2 is v (-w1, -e1), 3 is t (n against o, then -k);
# t's n is -det's, so the kernel reads it from row 0.
_COMPACT = ((0, 0), (1, 0), (2, 0), (9, 3),
            (0, 1), (1, 1), (2, 1), (3, 1),
            (4, 1), (5, 1), (0, 2), (1, 2),
            (2, 2), (3, 2), (4, 2), (5, 2))

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# each CUDA source of the port and its flags beyond NVCC_FLAGS: the BVH
# walk's Woop test needs every product and sum rounded on its own (its
# Veltkamp split is exact only so), the sweep's FMAs are deliberate;
# scatter_rows is core/gather.py's kernel
SOURCES = {"tri_sweep": [], "bvh_walk": ["-fmad=false"], "scatter_rows": []}

# launches per kernel; reset and read by callers that account for a run
launch_counts = {"tri_sweep_closest": 0, "tri_sweep_any": 0}
KERNELS = tuple(launch_counts)


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


@dataclass
class SweepTable:
    """Face tables of both sweeps, faces in LBVH leaf order.

    feat:   [10, F, 4] f32 coefficients (the plain version's table);
    coef:   [Fpad / 128, 4, 128, 4] f32, each face's 16 non-zero
            coefficients (see ``_COMPACT``) as 4 rows of 4, row-major within
            each 128-face block ([block][row][face][4]; one block is one
            contiguous 8 KB stage), padded with zero faces (det = 0, never
            accepted) to a multiple of 128;
    bounds: [Fpad / 128, 8] f32 block AABBs (min xyz, max xyz, 0, 0),
            widened so the kernels' block cull stays conservative.
    """
    feat: TriFeatures
    coef: torch.Tensor
    bounds: torch.Tensor

    @property
    def count(self) -> int:
        return self.feat.count

    @property
    def n_blocks(self) -> int:
        return self.bounds.shape[0]


def pack_sweep_table(tri_verts: np.ndarray, device,
                     feat: TriFeatures | None = None) -> SweepTable:
    """Build both sweeps' tables from [F, 3, 3] leaf-ordered vertices.

    ``feat`` (optional) supplies the [10, F, 4] coefficients instead of
    computing them, so a scene carried over from another build traces the
    identical table.
    """
    tv = np.asarray(tri_verts, np.float32)
    f = len(tv)
    if feat is None:
        feat = build_tri_features(tv, device)
    n_blk = max(-(-f // BLOCK_FACES), 1)
    coef = torch.zeros((n_blk * BLOCK_FACES, COEF_PER_FACE),
                       dtype=torch.float32, device=device)
    coef[:f] = compact_coefficients(feat.packed)
    coef = coef.reshape(n_blk, BLOCK_FACES, 4, 4).permute(0, 2, 1, 3) \
        .contiguous()
    bounds = np.zeros((n_blk, 8), np.float32)
    for b in range(n_blk):
        blk = tv[b * BLOCK_FACES:(b + 1) * BLOCK_FACES].reshape(-1, 3)
        if not len(blk):
            # all-padding block: an empty (inverted) box no ray enters
            bounds[b, 0:3], bounds[b, 3:6] = 1.0, -1.0
            continue
        lo, hi = blk.min(0), blk.max(0)
        # The watertight slack accepts hits up to ~REL_EPS (1e-4) outside a
        # face in barycentric units; widen by 1e-3 of the block extent plus
        # a few ulps of the coordinates so the cull never drops such a hit.
        pad = 1e-3 * float((hi - lo).max()) \
            + 1e-6 * float(np.abs(blk).max()) + 1e-30
        bounds[b, 0:3] = lo - pad
        bounds[b, 3:6] = hi + pad
    return SweepTable(feat=feat, coef=coef,
                      bounds=torch.as_tensor(bounds, device=device))


def compact_coefficients(packed: torch.Tensor) -> torch.Tensor:
    """[F, 16]: the non-zero coefficients of a [10, F, 4] table, in the
    kernel's order. Raises unless the other 24 are zero and t's normal is
    det's negated, as ``build_tri_features`` makes them."""
    dense = torch.zeros_like(packed)
    k, qty = zip(*_COMPACT)
    dense[list(k), :, list(qty)] = packed[list(k), :, list(qty)]
    dense[6:9, :, 3] = -packed[0:3, :, 0]
    if not torch.equal(dense, packed):
        raise ValueError("face table is not the Möller–Trumbore table of "
                         "build_tri_features")
    return packed[list(k), :, list(qty)].T.contiguous()


def dense_coefficients(compact: torch.Tensor) -> torch.Tensor:
    """The [10, F, 4] table that [F, 16] compact coefficients stand for."""
    dense = compact.new_zeros((10, compact.shape[0], 4))
    k, qty = zip(*_COMPACT)
    dense[list(k), :, list(qty)] = compact.T
    dense[6:9, :, 3] = -compact[:, 0:3].T
    return dense


# ---------------------------------------------------------------------------
# Building and loading the CUDA library
# ---------------------------------------------------------------------------

_LIB = None
_LIB_LOCK = threading.Lock()
build_logs: dict = {}    # nvcc's output of each build, by source name


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the kernels of fountain_tpu_torch/csrc")
    return path


def build_library(name: str = "tri_sweep") -> Path:
    """Compile csrc/<name>.cu (a key of SOURCES; once per source content
    and flags) into build/kernels/ and return the library's path. Raises
    on failure, with nvcc's output."""
    src = _CSRC / f"{name}.cu"
    flags = NVCC_FLAGS + SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(flags).encode()).hexdigest()[:12]
    lib = _BUILD_DIR / f"lib{name}_{digest}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *flags, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    build_logs[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{build_logs[name]}")
    os.replace(tmp, lib)
    return lib


def _library():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build_library()))
            p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            common = [p, p, p, p, p, p, p, i, p, p, i, fl, p]
            lib.tri_sweep_closest.argtypes = common + [p, p, p]
            lib.tri_sweep_closest.restype = ctypes.c_int
            lib.tri_sweep_any.argtypes = common + [p, p]
            lib.tri_sweep_any.restype = ctypes.c_int
            lib.tri_sweep_info.argtypes = [i, p]
            lib.tri_sweep_info.restype = ctypes.c_int
            lib.tri_sweep_error_string.argtypes = [ctypes.c_int]
            lib.tri_sweep_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def _check(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.tri_sweep_error_string(err).decode()}")


def ray_columns(o: V3, d: V3, t_cap):
    """The seven ray columns a kernel reads (o, d, t_cap: flat [N] f32,
    contiguous), checked to lie on one device."""
    dev = t_cap.device
    cols = [c.to(torch.float32).expand(t_cap.shape).contiguous()
            for c in (*o, *d)] + [t_cap.to(torch.float32).contiguous()]
    for c in cols:
        if c.device != dev or c.dim() != 1:
            raise ValueError("ray tensors must be flat [N] on one device")
    return cols


def _ray_args(table: SweepTable, o: V3, d: V3, t_cap):
    """Validate a sweep's inputs (flat [N] f32 on one CUDA device) and
    return the tensors whose pointers the kernel reads."""
    dev = t_cap.device
    cols = ray_columns(o, d, t_cap)
    if table.coef.device != dev or table.bounds.device != dev:
        raise ValueError("face table and rays must be on the same device")
    if (table.coef.dtype != torch.float32 or not table.coef.is_contiguous()
            or table.coef.shape != (table.n_blocks, COEF_PER_FACE // 4,
                                    BLOCK_FACES, 4)
            or not table.bounds.is_contiguous()):
        raise ValueError("malformed face table")
    return cols


_COUNTERS: dict = {}


def _chunk_counter(dev: torch.device, stream: int) -> torch.Tensor:
    """The kernels' chunk counter for one stream: an int32, zeroed once
    here; each launch leaves it at zero again, and launches on one stream
    run one after another."""
    key = (dev.index, stream)
    with _LIB_LOCK:
        if key not in _COUNTERS:
            _COUNTERS[key] = torch.zeros(1, dtype=torch.int32, device=dev)
        return _COUNTERS[key]


def launch_args(table: SweepTable, cols, t_eps: float, outs):
    """The C call's arguments after the kernel's name: ray columns, face
    table, the stream's chunk counter, outputs and PyTorch's current
    stream (for timing the library call alone, with everything
    preallocated)."""
    dev = cols[0].device
    stream = torch.cuda.current_stream(dev).cuda_stream
    return (*(c.data_ptr() for c in cols), cols[0].shape[0],
            table.coef.data_ptr(), table.bounds.data_ptr(), table.n_blocks,
            t_eps, _chunk_counter(dev, stream).data_ptr(),
            *(x.data_ptr() for x in outs), stream)


def _launch(name: str, table: SweepTable, cols, t_eps: float, outs):
    lib = _library()
    with torch.cuda.device(cols[0].device):
        err = getattr(lib, name)(*launch_args(table, cols, t_eps, outs))
    _check(lib, err, name)
    launch_counts[name] += 1


def kernel_info(name: str, device="cuda") -> dict:
    """Build facts of a kernel on a card: registers per thread, dynamic
    shared memory per thread block, local memory (spills) per thread,
    thread blocks per SM, threads per block and SMs."""
    lib = _library()
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device):
        _check(lib, lib.tri_sweep_info(int(name == "tri_sweep_any"), out),
               name)
    keys = ("registers", "shared_bytes", "local_bytes", "blocks_per_sm",
            "threads", "sms")
    return dict(zip(keys, out))


def closest_hit_kernel(table: SweepTable, o: V3, d: V3, t_cap,
                       t_eps: float = 1e-4):
    """Closest-hit sweep on the card (``tri_sweep_closest``, the port of
    ``pallas_tri._kernel``). Returns (t, idx) with t = t_cap and idx = -1
    on a miss. Launches once on PyTorch's current stream; its only scratch
    is the stream's chunk counter, which the launch leaves at zero."""
    cols = _ray_args(table, o, d, t_cap)
    t_out = torch.empty_like(cols[-1])
    idx_out = torch.empty(t_out.shape, dtype=torch.int32, device=t_out.device)
    _launch("tri_sweep_closest", table, cols, t_eps, (t_out, idx_out))
    return t_out, idx_out


def any_hit_kernel(table: SweepTable, o: V3, d: V3, t_cap,
                   t_eps: float = 1e-4):
    """Any-hit sweep on the card (``tri_sweep_any``, the port of
    ``pallas_tri._kernel_any``). Returns occluded [N] bool; scratch and
    stream as for the closest hit."""
    cols = _ray_args(table, o, d, t_cap)
    occ = torch.empty(cols[-1].shape, dtype=torch.bool,
                      device=cols[-1].device)
    _launch("tri_sweep_any", table, cols, t_eps, (occ,))
    return occ


def closest_hit_plain(table: SweepTable, o: V3, d: V3, t_cap,
                      t_eps: float = 1e-4):
    """Plain PyTorch version of the closest-hit kernel, same outputs."""
    t, idx, found = mt_intersect(table.feat, o.stack(), d.stack(), t_cap,
                                 t_eps=t_eps)
    return torch.where(found, t, t_cap), torch.where(found, idx, -1)


def any_hit_plain(table: SweepTable, o: V3, d: V3, t_cap,
                  t_eps: float = 1e-4):
    """Plain PyTorch version of the any-hit kernel, same output."""
    return mt_intersect(table.feat, o.stack(), d.stack(), t_cap,
                        t_eps=t_eps, any_hit=True)[2]


def mt_intersect_kernel(table: SweepTable, o: V3, d: V3, t_max,
                        t_eps: float = 1e-4, any_hit: bool = False):
    """Closest-hit (or any-hit) sweep over the scene's faces.

    Keeps the contract of the JAX package's ``mt_intersect_pallas``:
    ``t_max = inf`` becomes the cap 3e38, ``t_max < 0`` marks a dead lane,
    a miss is (t=inf, idx=0, found=False), and in any-hit mode only the
    boolean is meaningful.
    Rays on the CPU take the plain version; rays on a CUDA device launch
    the kernel. The rays are detached on both branches: a sweep carries no
    gradient (as ``mt_intersect_pallas`` detaches its inputs).
    """
    o = V3(o.x.detach(), o.y.detach(), o.z.detach())
    d = V3(d.x.detach(), d.y.detach(), d.z.detach())
    t_max = t_max.detach()
    t_cap = torch.where(torch.isfinite(t_max), t_max,
                        torch.full_like(t_max, 3e38))
    if t_cap.device.type == "cpu":
        closest, anyhit = closest_hit_plain, any_hit_plain
    elif t_cap.device.type == "cuda":
        closest, anyhit = closest_hit_kernel, any_hit_kernel
    else:
        raise ValueError(f"no sweep for device {t_cap.device}")
    if any_hit:
        occ = anyhit(table, o, d, t_cap, t_eps)
        return torch.zeros_like(t_cap), torch.zeros_like(
            occ, dtype=torch.int32), occ
    t, idx = closest(table, o, d, t_cap, t_eps)
    found = idx >= 0
    return torch.where(found, t, float("inf")), idx.clamp_min(0), found

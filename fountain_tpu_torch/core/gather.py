"""Row gathers of tables that may require grad, and their backward.

Counterpart of ``gather_rows`` in ``fountain_tpu/core/gather.py``, whose
custom VJP gives a table of at most 512 rows a one-hot matmul backward and
a larger one XLA's scatter-add (no pallas_call); its select-sums for tiny
tables are TPU workarounds and are not ported.

``gather_rows(table, idx)`` is ``torch.index_select(table, 0, idx)`` for
every table of the port that can require grad (``vecmath.gather3``, the
texture, shading and light tables). What runs depends only on what the
call shows:
- no grad mode, or a table that does not require grad: ``index_select``
  itself, with no autograd function (the render waves keep their kernels);
- a CPU table: ``index_select``, whose backward is ``index_add_``;
- a CUDA table under autograd: ``_GatherRows``, whose forward is
  ``index_select`` (the same bits) and whose backward is ``scatter_rows``,
  the hand-written CUDA kernel of ``csrc/scatter_rows.cu`` (its note says
  why: ~99% of the gradient rows are zero and the rest share a few rows).
  It saves the index and the table's shape, never the table.

``scatter_rows`` launches the kernel for CUDA tensors, or raises; on the
CPU it takes the plain version, ``scatter_rows_plain``. The library is
built with nvcc by ``tri_sweep.build_library`` on first use and loaded
with ctypes. ``launch_counts`` counts the wrapper's launches by the
kernel's memory level (a launch recorded into a CUDA graph counts once,
when captured).
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch
from torch.autograd.function import once_differentiable

# output tables of at most this many bytes accumulate in shared memory
# (the texture value and shading tables); larger ones (the texel atlas)
# take global atomics
SHARED_BYTES = 12 * 1024

# launches by memory level; reset and read by callers that account for a run
launch_counts = {"scatter_rows_shared": 0, "scatter_rows_global": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` [N] (int32 or int64) of ``table`` [R, ...]."""
    if (table.requires_grad and table.device.type == "cuda"
            and torch.is_grad_enabled()):
        return _GatherRows.apply(table, idx)
    return torch.index_select(table, 0, idx)


class _GatherRows(torch.autograd.Function):
    """``index_select`` whose backward is the ``scatter_rows`` kernel."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.shape = table.shape
        return torch.index_select(table, 0, idx)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return scatter_rows(grad, idx, ctx.shape), None


def scatter_rows_plain(grad: torch.Tensor, idx: torch.Tensor,
                       shape) -> torch.Tensor:
    """Plain PyTorch version of the kernel: a zero table of ``shape`` with
    each lane's row of ``grad`` added at ``idx``, rows that are all +-0
    left out (the kernel's rule; exact, since the table starts at +0)."""
    n = idx.shape[0]
    keep = grad.reshape(n, math.prod(shape[1:])).ne(0).any(1)
    out = torch.zeros(shape, dtype=grad.dtype, device=grad.device)
    return out.index_add_(0, idx[keep],
                          grad.reshape(n, *shape[1:])[keep])


def scatter_rows(grad: torch.Tensor, idx: torch.Tensor, shape,
                 stats: torch.Tensor | None = None) -> torch.Tensor:
    """``index_select``'s backward: a zero f32 table of ``shape`` [R, ...]
    with ``grad`` [N, ...] added row by row at ``idx`` [N]. On a card one
    launch of ``scatter_rows`` on the current stream; ``stats`` ([3] int64
    there, or None) is added the lanes seen, the lanes with a non-zero row
    and the atomic adds issued. On the CPU the plain version (``stats``
    must be None)."""
    if grad.device.type == "cpu":
        if stats is not None:
            raise ValueError("statistics are counted on a card only")
        return scatter_rows_plain(grad, idx, shape)
    if grad.device.type != "cuda":
        raise ValueError(f"no scatter for device {grad.device}")
    dev = grad.device
    shape = tuple(shape)
    n = idx.shape[0]
    c = math.prod(shape[1:])
    if (grad.dtype != torch.float32 or idx.dim() != 1
            or idx.dtype not in (torch.int32, torch.int64)
            or idx.device != dev or len(shape) < 1
            or tuple(grad.shape) != (n, *shape[1:])):
        raise ValueError("scatter_rows takes f32 grad [N, ...] and an "
                         "int32 or int64 index [N] on one device")
    if stats is not None and (stats.dtype != torch.int64
                              or stats.shape != (3,) or stats.device != dev
                              or not stats.is_contiguous()):
        raise ValueError("stats must be a [3] int64 tensor on the card")
    out = torch.zeros(shape, dtype=torch.float32, device=dev)
    if n == 0 or c == 0:
        return out
    name, args = launch_args(grad.reshape(n, c).contiguous(),
                             idx.contiguous(), out, stats)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.scatter_rows(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.scatter_rows_error_string(err).decode()}")
    launch_counts[name] += 1
    return out


def launch_args(grad, idx, out, stats=None):
    """(the variant's name, the C call's arguments) of a checked, non-empty
    scatter of contiguous ``grad`` [N, C] at contiguous ``idx`` [N] into
    ``out`` [R, ...] on PyTorch's current stream; the caller keeps the
    tensors alive until the launch (for timing the library call alone,
    with ``out`` preallocated)."""
    (n, c), rows = grad.shape, out.shape[0]
    shared = out.numel() * 4 <= SHARED_BYTES
    dev = out.device
    args = (grad.data_ptr(), idx.data_ptr(), idx.element_size(), n, c, rows,
            out.data_ptr(), None if stats is None else stats.data_ptr(),
            int(shared),
            torch.cuda.get_device_properties(dev).multi_processor_count,
            torch.cuda.current_stream(dev).cuda_stream)
    return ("scatter_rows_shared" if shared else "scatter_rows_global"), args


_LIB = None
_LIB_LOCK = threading.Lock()


def _library():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            # imported here: tri_sweep imports vecmath, which imports this
            from fountain_tpu_torch.geometry.tri_sweep import build_library
            lib = ctypes.CDLL(str(build_library("scatter_rows")))
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.scatter_rows.argtypes = [p, p, i, ll, i, ll, p, p, i, i, p]
            lib.scatter_rows.restype = ctypes.c_int
            lib.scatter_rows_info.argtypes = [i, i, p]
            lib.scatter_rows_info.restype = ctypes.c_int
            lib.scatter_rows_error_string.argtypes = [ctypes.c_int]
            lib.scatter_rows_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def kernel_info(idx_bytes: int, shared: bool, device="cuda") -> dict:
    """Build facts of one variant of the kernel on a card, as
    ``tri_sweep.kernel_info`` reports them."""
    lib = _library()
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device):
        err = lib.scatter_rows_info(idx_bytes, int(shared), out)
    if err != 0:
        raise RuntimeError(f"scatter_rows_info failed: "
                           f"{lib.scatter_rows_error_string(err).decode()}")
    keys = ("registers", "shared_bytes", "local_bytes", "blocks_per_sm",
            "threads", "sms")
    return dict(zip(keys, out))

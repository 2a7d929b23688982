"""Counter-based deterministic RNG (PCG4D), bit-exact with fountain_tpu.

Every random number is a pure function of (lane, sample, dimension, seed),
as in ``fountain_tpu/core/rng.py``. PyTorch lacks uint32 arithmetic on
some backends, so the uint32 wraparound is emulated in int64 with
``& 0xFFFFFFFF``; products are split into 16-bit halves so no int64
product overflows. A Python-int counter or seed stays a Python int, and
its arithmetic runs on the host until it meets a tensor: no host-to-device
copy, so a CUDA graph can hold the hash (a seed that changes between
replays comes in as a device tensor).
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _u32(a, like: torch.Tensor | None = None):
    """Value as uint32 held in int64 (negative int32 wrap like astype); a
    Python int stays one."""
    if isinstance(a, int):
        return a & _M32
    t = torch.as_tensor(a, device=None if like is None else like.device)
    return t.to(torch.int64) & _M32


def _mul32(a, b):
    """(a * b) mod 2^32 for a, b in [0, 2^32) (tensors or Python ints)."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def pcg4d(a, b, c, d):
    """PCG4D hash: 4 x uint32 in -> 4 x uint32 out (as int64 tensors of
    the inputs' broadcast shape)."""
    ref = next((t for t in (a, b, c, d) if isinstance(t, torch.Tensor)),
               None)
    if ref is None:
        a = torch.as_tensor(a)
    # every output mixes in all four inputs, so it has the full shape
    x, y, z, w = (_u32(v, ref) for v in (a, b, c, d))
    mul, add = 1664525, 1013904223
    x = (_mul32(x, mul) + add) & _M32
    y = (_mul32(y, mul) + add) & _M32
    z = (_mul32(z, mul) + add) & _M32
    w = (_mul32(w, mul) + add) & _M32
    x = (x + _mul32(y, w)) & _M32
    y = (y + _mul32(z, x)) & _M32
    z = (z + _mul32(x, y)) & _M32
    w = (w + _mul32(y, z)) & _M32
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = (x + _mul32(y, w)) & _M32
    y = (y + _mul32(z, x)) & _M32
    z = (z + _mul32(x, y)) & _M32
    w = (w + _mul32(y, z)) & _M32
    return x, y, z, w


def _to_unit_float(u: torch.Tensor) -> torch.Tensor:
    """uint32 -> f32 in [0, 1): top 24 bits scaled by 2^-24 (exact)."""
    return (u >> 8).to(torch.float32) * (2.0 ** -24)


def uniform4(lane, sample, dim, seed=0):
    """Four independent U[0,1) f32 tensors for (lane, sample, dim, seed)."""
    return tuple(_to_unit_float(h) for h in pcg4d(lane, sample, dim, seed))


def uniform1(lane, sample, dim, seed=0):
    return uniform4(lane, sample, dim, seed)[0]

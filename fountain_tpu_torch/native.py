"""The native (C++) LBVH build, compiled with g++ and loaded with ctypes.

Counterpart of ``fountain_tpu/native.py``: ``csrc/lbvh.cc`` (the port's
copy of ``native/lbvh.cc``) is built at first use into ``build/native/``
and called through its plain C interface. Unlike the JAX package's bridge
there is no switch and no fallback: a failed build raises with the
compiler's output. The numpy ``geometry.bvh.build_lbvh`` is the reference
the tests hold this build to, byte for byte.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "csrc" / "lbvh.cc"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
# no FMA contraction: the centroid and lattice arithmetic must round as
# numpy's float32 does
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off"]

_LIB = None
_LOCK = threading.Lock()


def build_library() -> Path:
    """Compile csrc/lbvh.cc (once per source content and flags) and return
    the library's path. Raises on failure."""
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    lib = _BUILD_DIR / f"liblbvh_{digest}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {_SRC}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _library():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build_library()))
            fp = ctypes.POINTER(ctypes.c_float)
            ip = ctypes.POINTER(ctypes.c_int32)
            lib.lbvh_build.restype = ctypes.c_int
            lib.lbvh_build.argtypes = [fp, fp, ctypes.c_int, ctypes.c_int,
                                       fp, fp, ip, ip]
            _LIB = lib
        return _LIB


def lbvh_build(bounds_min: np.ndarray, bounds_max: np.ndarray,
               leaf_size: int):
    """Native LBVH build over F > 0 primitive boxes: (nodes_min [M, 3],
    nodes_max [M, 3], meta [M, 3] int32, order [F] int32), as
    ``geometry.bvh.build_lbvh`` returns them."""
    n = len(bounds_min)
    if n <= 0:
        raise ValueError("the native LBVH build needs at least one box")
    bmin = np.ascontiguousarray(bounds_min, np.float32)
    bmax = np.ascontiguousarray(bounds_max, np.float32)
    cap = 2 * n + 1
    nodes_min = np.empty((cap, 3), np.float32)
    nodes_max = np.empty((cap, 3), np.float32)
    meta = np.empty((cap, 3), np.int32)
    order = np.empty((n,), np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    m = _library().lbvh_build(
        bmin.ctypes.data_as(fp), bmax.ctypes.data_as(fp), n, int(leaf_size),
        nodes_min.ctypes.data_as(fp), nodes_max.ctypes.data_as(fp),
        meta.ctypes.data_as(ip), order.ctypes.data_as(ip))
    if m <= 0:
        raise RuntimeError(f"lbvh_build returned {m} for {n} boxes")
    return nodes_min[:m].copy(), nodes_max[:m].copy(), meta[:m].copy(), order

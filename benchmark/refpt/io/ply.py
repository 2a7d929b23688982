# Frozen copy of fountain_tpu_torch/io/ply.py (commit 6354002): the benchmark's plain reference; edit never.
"""Minimal PLY mesh loader (ascii + binary little/big endian).

The port's own copy of ``fountain_tpu/io/ply.py`` (the port imports
nothing of the JAX package). Supports
the property sets PBRT scenes use: vertex x/y/z [+ nx/ny/nz] [+ u/v or s/t],
and polygonal faces (fan-triangulated like the reference's plydough usage).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


@dataclass
class PlyMesh:
    positions: np.ndarray            # [V, 3] f32
    indices: np.ndarray              # [F, 3] i32
    normals: Optional[np.ndarray]    # [V, 3] f32 or None
    uv: Optional[np.ndarray]         # [V, 2] f32 or None


def load_ply(path: str) -> PlyMesh:
    with open(path, "rb") as fh:
        data = fh.read()

    # --- header
    end = data.find(b"end_header")
    if end < 0:
        raise ValueError(f"{path}: no end_header")
    header = data[:end].decode("ascii", "replace").splitlines()
    body = data[end:]
    body = body[body.find(b"\n") + 1:]

    fmt = None
    elements = []   # (name, count, [(prop_name, dtype, is_list, count_dtype)])
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append((parts[4], _PLY_DTYPES[parts[3]],
                                        True, _PLY_DTYPES[parts[2]]))
            else:
                elements[-1][2].append((parts[2], _PLY_DTYPES[parts[1]],
                                        False, None))

    if fmt == "ascii":
        vert, faces = _parse_ascii(body, elements)
    else:
        endian = "<" if fmt == "binary_little_endian" else ">"
        vert, faces = _parse_binary(body, elements, endian)

    positions = np.stack([vert["x"], vert["y"], vert["z"]], -1)
    normals = None
    if "nx" in vert:
        normals = np.stack([vert["nx"], vert["ny"], vert["nz"]], -1)
    uv = None
    for ukey, vkey in (("u", "v"), ("s", "t")):
        if ukey in vert:
            uv = np.stack([vert[ukey], vert[vkey]], -1)
            break

    # fan-triangulate polygons
    tris = []
    for f in faces:
        for k in range(1, len(f) - 1):
            tris.append((f[0], f[k], f[k + 1]))
    indices = np.asarray(tris, np.int32).reshape(-1, 3)
    return PlyMesh(positions=positions.astype(np.float32),
                   indices=indices,
                   normals=None if normals is None
                   else normals.astype(np.float32),
                   uv=None if uv is None else uv.astype(np.float32))


def _parse_ascii(body: bytes, elements):
    tokens = body.split()
    pos = 0
    vert = {}
    faces = []
    for name, count, props in elements:
        if name == "vertex":
            scalar_names = [p[0] for p in props]
            n_props = len(props)
            arr = np.array(tokens[pos:pos + count * n_props], dtype=np.float64)
            pos += count * n_props
            arr = arr.reshape(count, n_props)
            for j, pname in enumerate(scalar_names):
                vert[pname] = arr[:, j].astype(np.float32)
        elif name == "face":
            for _ in range(count):
                n = int(tokens[pos]); pos += 1
                faces.append([int(t) for t in tokens[pos:pos + n]])
                pos += n
        else:  # skip unknown element
            n_props = len(props)
            pos += count * n_props
    return vert, faces


def _parse_binary(body: bytes, elements, endian: str):
    off = 0
    vert = {}
    faces = []
    for name, count, props in elements:
        if name == "vertex" and all(not p[2] for p in props):
            dt = np.dtype([(p[0], endian + p[1]) for p in props])
            arr = np.frombuffer(body, dt, count=count, offset=off)
            off += dt.itemsize * count
            for p in props:
                vert[p[0]] = arr[p[0]].astype(np.float32)
        elif name == "face":
            # variable-length lists: assume uniform arity (common case),
            # verified against the byte count; fall back to a python loop.
            (pname, idx_dt, is_list, cnt_dt) = props[0]
            cnt_size = np.dtype(cnt_dt).itemsize
            idx_size = np.dtype(idx_dt).itemsize
            first_n = int(np.frombuffer(body, endian + cnt_dt, 1, off)[0])
            stride = cnt_size + first_n * idx_size
            if off + stride * count <= len(body):
                raw = np.frombuffer(body, np.uint8, stride * count, off)
                raw = raw.reshape(count, stride)
                counts = raw[:, :cnt_size].copy().view(endian + cnt_dt)[:, 0]
                if np.all(counts == first_n):
                    idx = raw[:, cnt_size:].copy().view(endian + idx_dt)
                    faces = [tuple(r) for r in idx.reshape(count, first_n)]
                    off += stride * count
                    continue
            for _ in range(count):  # ragged fallback
                n = int(np.frombuffer(body, endian + cnt_dt, 1, off)[0])
                off += cnt_size
                faces.append(tuple(np.frombuffer(body, endian + idx_dt, n,
                                                 off)))
                off += n * idx_size
        else:
            dt = np.dtype([(p[0], endian + p[1]) for p in props
                           if not p[2]])
            off += dt.itemsize * count
    return vert, faces

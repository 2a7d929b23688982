# Frozen copy of fountain_tpu_torch/io/exr.py (commit 6354002): the benchmark's plain reference; edit never.
"""Minimal OpenEXR I/O in pure numpy (uncompressed scanlines).

The port's own copy of ``fountain_tpu/io/exr.py`` (the port imports
nothing of the JAX package): ``write_exr`` writes the same bytes for the
same array, ``read_exr`` reads RGB float32/float16 NO_COMPRESSION
scanline files.
"""
from __future__ import annotations

import struct

import numpy as np

_MAGIC = 20000630
_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2


def _attr(name: str, typ: str, data: bytes) -> bytes:
    return name.encode() + b"\0" + typ.encode() + b"\0" + \
        struct.pack("<i", len(data)) + data


def write_exr(path: str, image: np.ndarray) -> None:
    """Write an [H, W, 3] float image as an uncompressed RGB float EXR."""
    img = np.asarray(image, np.float32)
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"write_exr: RGB only, got {c} channels")
    # channel list, alphabetical (B, G, R), FLOAT
    chlist = b"".join(name + b"\0" + struct.pack("<i", _PT_FLOAT)
                      + b"\x00\x00\x00\x00" + struct.pack("<ii", 1, 1)
                      for name in (b"B", b"G", b"R")) + b"\0"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = b"".join([
        _attr("channels", "chlist", chlist),
        _attr("compression", "compression", b"\x00"),  # NO_COMPRESSION
        _attr("dataWindow", "box2i", box),
        _attr("displayWindow", "box2i", box),
        _attr("lineOrder", "lineOrder", b"\x00"),      # INCREASING_Y
        _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
        _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0)),
        _attr("screenWindowWidth", "float", struct.pack("<f", 1.0)),
    ]) + b"\0"
    preamble = struct.pack("<ii", _MAGIC, 2) + header
    row_bytes = 8 + 3 * 4 * w  # y + size prefix + 3 channels
    data_start = len(preamble) + 8 * h
    offsets = data_start + row_bytes * np.arange(h, dtype=np.uint64)
    # per scanline: the B, G and R rows, channel-major in header order
    bgr = img[..., ::-1]
    chunks = b"".join(
        struct.pack("<ii", y, 12 * w) + bgr[y].T.astype("<f4").tobytes()
        for y in range(h))
    with open(path, "wb") as fh:
        fh.write(preamble)
        fh.write(offsets.astype("<u8").tobytes())
        fh.write(chunks)


def read_exr(path: str) -> np.ndarray:
    """Read an uncompressed scanline RGB EXR (NO_COMPRESSION float/half
    RGB file). Returns [H, W, 3] float32."""
    with open(path, "rb") as fh:
        data = fh.read()
    magic, version = struct.unpack_from("<ii", data, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200:
        raise ValueError("tiled EXR not supported")

    pos = 8
    channels = []
    compression = None
    data_window = None
    while data[pos] != 0:
        name_end = data.index(b"\0", pos)
        name = data[pos:name_end].decode()
        pos = name_end + 1
        type_end = data.index(b"\0", pos)
        typ = data[pos:type_end].decode()
        pos = type_end + 1
        size = struct.unpack_from("<i", data, pos)[0]
        pos += 4
        payload = data[pos:pos + size]
        pos += size
        if name == "channels":
            cp = 0
            while payload[cp] != 0:
                ce = payload.index(b"\0", cp)
                cname = payload[cp:ce].decode()
                ptype = struct.unpack_from("<i", payload, ce + 1)[0]
                channels.append((cname, ptype))
                cp = ce + 1 + 16
        elif name == "compression":
            compression = payload[0]
        elif name == "dataWindow":
            data_window = struct.unpack("<iiii", payload)
    pos += 1  # header terminator

    if compression != 0:
        raise ValueError(f"{path}: only NO_COMPRESSION supported "
                         f"(got {compression})")
    x0, y0, x1, y1 = data_window
    w = x1 - x0 + 1
    h = y1 - y0 + 1

    offsets = np.frombuffer(data, "<u8", h, pos)
    dt = {_PT_HALF: np.dtype("<f2"), _PT_FLOAT: np.dtype("<f4"),
          _PT_UINT: np.dtype("<u4")}
    out = {name: np.zeros((h, w), np.float32) for name, _ in channels}
    for i, off in enumerate(offsets):
        y, size = struct.unpack_from("<ii", data, int(off))
        p = int(off) + 8
        for cname, ptype in channels:  # stored in header (alphabetical) order
            n = w * dt[ptype].itemsize
            row = np.frombuffer(data, dt[ptype], w, p).astype(np.float32)
            out[cname][y - y0] = row
            p += n
    if all(k in out for k in "RGB"):
        return np.stack([out["R"], out["G"], out["B"]], -1)
    # grayscale fallback
    first = next(iter(out.values()))
    return np.stack([first] * 3, -1)

"""Image loading and saving: EXR (own reader/writer) and PNG (own codec).

Counterpart of ``fountain_tpu/io/image.py``. LDR images are sRGB-decoded
to linear on load and flipped so that v = 0 is the bottom row; EXR stays
linear. The JAX package decodes and encodes PNG through Pillow; the port
has its own codec on ``zlib`` and numpy: 8-bit gray, RGB and RGBA,
non-interlaced, all five filter types. Anything else raises ValueError.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from fountain_tpu_torch.io.exr import read_exr, write_exr

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}   # color type -> samples a pixel


def _srgb_to_linear(v: np.ndarray) -> np.ndarray:
    return np.where(v <= 0.04045, v / 12.92,
                    ((v + 0.055) / 1.055) ** 2.4).astype(np.float32)


def _linear_to_srgb(v: np.ndarray) -> np.ndarray:
    v = np.clip(v, 0.0, 1.0)
    return np.where(v <= 0.0031308, 12.92 * v,
                    1.055 * v ** (1.0 / 2.4) - 0.055).astype(np.float32)


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo PNG's per-scanline filters -> [h, stride] uint8."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError("png: image data has the wrong size")
    rows = rows.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:].astype(np.int64)
        if ftype == 0:                                  # None
            cur = line
        elif ftype == 2:                                # Up
            cur = (line + prev) & 0xFF
        elif ftype == 1:                                # Sub: per channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype in (3, 4):                           # Average, Paeth
            cur = line.tolist()
            b = prev.tolist()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    pred = (a + b[i]) >> 1
                else:
                    c = b[i - bpp] if i >= bpp else 0
                    p = a + b[i] - c
                    pa, pb, pc = abs(p - a), abs(p - b[i]), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else \
                        (b[i] if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.asarray(cur, np.int64)
        else:
            raise ValueError(f"png: unknown filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W, C] uint8 (C = 1, 3 or 4)."""
    if data[:8] != _PNG_SIG:
        raise ValueError("png: bad signature")
    pos, idat, ihdr = 8, [], None
    while pos < len(data):
        length, ctype = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if ihdr is None:
        raise ValueError("png: no IHDR chunk")
    w, h, depth, color, comp, filt, interlace = ihdr
    if depth != 8 or color not in _PNG_CHANNELS or interlace != 0 \
            or comp != 0 or filt != 0:
        raise ValueError(
            f"png: only 8-bit gray/RGB/RGBA non-interlaced images are "
            f"supported (bit depth {depth}, color type {color}, "
            f"interlace {interlace})")
    ch = _PNG_CHANNELS[color]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch)
    return px.reshape(h, w, ch)


def encode_png(img: np.ndarray) -> bytes:
    """[H, W, 3] uint8 -> PNG bytes (RGB, filter None on every row)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"encode_png: RGB only, got {c} channels")

    def chunk(ctype: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, w * 3)], axis=1).tobytes()
    return (_PNG_SIG
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


# process-global decode cache keyed by (abspath, gamma, flip_y, mtime): a
# file rewritten between scene builds does not serve the stale decode
_DECODE_CACHE: dict = {}


def load_image(path: str, gamma: bool = None, flip_y: bool = True
               ) -> np.ndarray:
    """Load an image as linear float32 [H, W, 3].

    ``gamma=None`` decides by format: PNG is sRGB-decoded, EXR is linear.
    Decodes are cached; the returned array is shared and frozen, so an
    in-place change raises instead of corrupting later builds."""
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        mtime = None
    key = (os.path.abspath(path), gamma, flip_y, mtime)
    hit = _DECODE_CACHE.get(key)
    if hit is not None:
        return hit
    ext = os.path.splitext(path)[1].lower()
    if ext == ".exr":
        img = read_exr(path)
    elif ext == ".png":
        with open(path, "rb") as fh:
            px = decode_png(fh.read())
        rgb = np.repeat(px, 3, axis=2) if px.shape[2] == 1 else px[..., :3]
        arr = rgb.astype(np.float32) / 255.0
        img = _srgb_to_linear(arr) if (gamma is None or gamma) else arr
    else:
        raise ValueError(f"{path}: only .png and .exr images are supported")
    if flip_y:
        img = img[::-1].copy()
    img = np.ascontiguousarray(img.astype(np.float32))
    img.flags.writeable = False
    _DECODE_CACHE[key] = img
    return img


def save_image(path: str, img: np.ndarray) -> None:
    """Save linear float32 [H, W, 3]: EXR stays linear, PNG is sRGB
    encoded."""
    ext = os.path.splitext(path)[1].lower()
    img = np.asarray(img, np.float32)
    if ext == ".exr":
        write_exr(path, img)
    elif ext == ".png":
        ldr = (np.clip(_linear_to_srgb(img), 0, 1) * 255.0 + 0.5).astype(
            np.uint8)
        with open(path, "wb") as fh:
            fh.write(encode_png(ldr))
    else:
        raise ValueError(f"{path}: only .png and .exr outputs are supported")

# Frozen copy of fountain_tpu_torch/io/image.py (commit 6354002): the benchmark's plain reference; edit never.
"""Image loading and saving: EXR, PNG and JPEG, on ``zlib`` and numpy.

Counterpart of ``fountain_tpu/io/image.py``. LDR images are sRGB-decoded
to linear on load and flipped so that v = 0 is the bottom row; EXR stays
linear. The JAX package decodes and encodes through Pillow; the port has
codecs of its own, so that a machine without Pillow reads and writes the
same files:

- PNG read: every color type (gray, RGB, palette, gray + alpha, RGBA),
  bit depths 1, 2, 4, 8 and 16, all five filters, Adam7 interlace. The
  result is Pillow's ``convert("RGB")``: alpha dropped, gray replicated,
  gray below 8 bits scaled to 0..255, 16-bit samples cut to their high
  byte. One divergence (ROADMAP C.3): Pillow saturates 16-bit gray at
  255; the port takes its high byte, as Pillow does for 16-bit RGB.
- JPEG read: baseline (and extended) sequential Huffman, 8-bit, 1 or 3
  components, sampled 4:4:4, 4:2:2 or 4:2:0, restart markers,
  interleaved or not. libjpeg's integer
  ("islow") IDCT, its "fancy" triangle upsampling and its YCbCr table
  arithmetic, so the result lands within one level of Pillow's decode.
- PNG write: 8-bit RGB. JPEG write: baseline, quality 75, 4:2:0, the
  Annex K tables (Pillow's defaults).

Any other format, a progressive or arithmetic-coded JPEG, a CMYK one or
one of another sampling raises a ValueError that names it.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from refpt.io.exr import read_exr, write_exr

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# color type -> (samples a pixel, allowed bit depths)
_PNG_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
              4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _srgb_to_linear(v: np.ndarray) -> np.ndarray:
    return np.where(v <= 0.04045, v / 12.92,
                    ((v + 0.055) / 1.055) ** 2.4).astype(np.float32)


def _linear_to_srgb(v: np.ndarray) -> np.ndarray:
    v = np.clip(v, 0.0, 1.0)
    return np.where(v <= 0.0031308, 12.92 * v,
                    1.055 * v ** (1.0 / 2.4) - 0.055).astype(np.float32)


# ---------------------------------------------------------------- PNG

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


def _png_samples(raw: bytes, w: int, h: int, ch: int, depth: int
                 ) -> np.ndarray:
    """One (sub)image's filtered scanlines -> samples [h, w, ch]."""
    stride = (w * ch * depth + 7) // 8
    rows = _unfilter(raw, h, stride, max(1, ch * depth // 8))
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, w, ch)
    if depth == 8:
        return rows.reshape(h, w, ch)
    per = 8 // depth
    shifts = np.arange(per - 1, -1, -1, dtype=np.uint8) * depth
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(h, -1)[:, :w * ch].reshape(h, w, ch)


def _parse_png(data: bytes):
    """PNG bytes -> (samples [H, W, C], bit depth, color type, palette)."""
    if data[:8] != _PNG_SIG:
        raise ValueError("png: bad signature")
    pos, idat, ihdr, palette = 8, [], None, None
    while pos < len(data):
        length, ctype = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if ihdr is None:
        raise ValueError("png: no IHDR chunk")
    w, h, depth, color, comp, filt, interlace = ihdr
    if color not in _PNG_TYPES or depth not in _PNG_TYPES[color][1] \
            or comp != 0 or filt != 0 or interlace not in (0, 1):
        raise ValueError(f"png: unsupported header (bit depth {depth}, "
                         f"color type {color}, interlace {interlace})")
    if color == 3 and palette is None:
        raise ValueError("png: palette image without a PLTE chunk")
    ch = _PNG_TYPES[color][0]
    raw = zlib.decompress(b"".join(idat))
    if not interlace:
        px = _png_samples(raw, w, h, ch, depth)
    else:
        px = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
            if pw <= 0 or ph <= 0:
                continue
            n = ph * (1 + (pw * ch * depth + 7) // 8)
            px[y0::dy, x0::dx] = _png_samples(raw[:n], pw, ph, ch, depth)
            raw = raw[n:]
    return px, depth, color, palette


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> samples [H, W, C] as stored (uint8, or uint16 at 16
    bits; gray below 8 bits unscaled); a palette image comes back as its
    palette's RGB."""
    px, _, color, palette = _parse_png(data)
    if color == 3:
        return palette[np.minimum(px[..., 0], len(palette) - 1)]
    return px


def _png_rgb8(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W, 3] uint8 as Pillow's ``convert("RGB")``, but
    16-bit gray keeps its high byte (Pillow saturates it)."""
    px, depth, color, palette = _parse_png(data)
    if color == 3:
        return palette[np.minimum(px[..., 0], len(palette) - 1)]
    if depth == 16:
        px = (px >> 8).astype(np.uint8)
    elif depth < 8:
        px = (px * (255 // ((1 << depth) - 1))).astype(np.uint8)
    rgb = px[..., :3] if color in (2, 6) else np.repeat(px[..., :1], 3, 2)
    return np.ascontiguousarray(rgb)


def _png_chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """[H, W, 3] uint8 -> PNG bytes (RGB, filter None on every row)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"encode_png: RGB only, got {c} channels")
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, w * 3)], axis=1).tobytes()
    return (_PNG_SIG
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                              0))
            + _png_chunk(b"IDAT", zlib.compress(raw, 6))
            + _png_chunk(b"IEND", b""))


# --------------------------------------------------------------- JPEG

def _zigzag() -> np.ndarray:
    """Natural (row-major) index of each zigzag position."""
    order = []
    for s in range(15):
        rows = range(max(0, s - 7), min(s, 7) + 1)
        for r in (rows if s % 2 else reversed(rows)):
            order.append(r * 8 + (s - r))
    return np.asarray(order)


_ZIGZAG = _zigzag()
_SOF_NAMES = {0xC2: "progressive", 0xC3: "lossless",
              0xC5: "differential sequential", 0xC6: "differential "
              "progressive", 0xC7: "differential lossless",
              0xC9: "arithmetic-coded sequential",
              0xCA: "arithmetic-coded progressive",
              0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded "
              "differential sequential", 0xCE: "arithmetic-coded "
              "differential progressive", 0xCF: "arithmetic-coded "
              "differential lossless"}

# Annex K: quantization tables (natural order) and Huffman tables
# (counts of codes of length 1..16, then the symbols).
_QLUM = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_QCHR = np.full(64, 99)
_QCHR[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]
_AC_LUM_VALS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa")
_AC_CHR_VALS = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa")
_HUFF = {  # (class, id) -> (counts, symbols): class 0 DC, 1 AC; the
    # order libjpeg writes them in
    (0, 0): ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
             bytes(range(12))),
    (1, 0): ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125),
             _AC_LUM_VALS),
    (0, 1): ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
             bytes(range(12))),
    (1, 1): ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119),
             _AC_CHR_VALS),
}


def _huff_codes(counts, symbols):
    """Canonical codes: [(symbol, length, code)]."""
    out, code, k = [], 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            out.append((symbols[k], length, code))
            code += 1
            k += 1
        code <<= 1
    return out


def _huff_lookup(counts, symbols):
    """A 16-bit peek -> (symbol, length) table, as two lists (length 0
    marks a code that does not exist)."""
    sym = np.zeros(1 << 16, np.int64)
    length = np.zeros(1 << 16, np.int64)
    for s, n, code in _huff_codes(counts, symbols):
        lo = code << (16 - n)
        sym[lo:lo + (1 << (16 - n))] = s
        length[lo:lo + (1 << (16 - n))] = n
    return sym.tolist(), length.tolist()


# libjpeg's islow IDCT (jidctint.c): 13-bit constants, 2 extra bits in
# the first pass
_CB, _P1 = 13, 2
_F = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373,
          f1175=9633, f1501=12299, f1847=15137, f1961=16069, f2053=16819,
          f2562=20995, f3072=25172)


def _idct_1d(x):
    """One pass of the islow IDCT over the 8 inputs ``x`` (int64 arrays);
    returns the 8 outputs before their descale."""
    f = _F
    z1 = (x[2] + x[6]) * f["f0541"]
    tmp2 = z1 - x[6] * f["f1847"]
    tmp3 = z1 + x[2] * f["f0765"]
    tmp0 = (x[0] + x[4]) << _CB
    tmp1 = (x[0] - x[4]) << _CB
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = x[7], x[5], x[3], x[1]
    z5 = (o0 + o2 + o1 + o3) * f["f1175"]
    z1 = (o0 + o3) * -f["f0899"]
    z2 = (o1 + o2) * -f["f2562"]
    z3 = (o0 + o2) * -f["f1961"] + z5
    z4 = (o1 + o3) * -f["f0390"] + z5
    a0 = o0 * f["f0298"] + z1 + z3
    a1 = o1 * f["f2053"] + z2 + z4
    a2 = o2 * f["f3072"] + z2 + z3
    a3 = o3 * f["f1501"] + z1 + z4
    return (t10 + a3, t11 + a2, t12 + a1, t13 + a0,
            t13 - a0, t12 - a1, t11 - a2, t10 - a3)


def _idct_range_table() -> np.ndarray:
    """libjpeg's post-IDCT range limit, indexed by (value & 1023): clamps
    value + 128 to 0..255 for values in [-512, 511]."""
    i = np.arange(1024)
    return np.where(i < 128, i + 128, np.where(i < 512, 255, np.where(
        i < 896, 0, i - 896))).astype(np.uint8)


_RANGE = _idct_range_table()


def _idct_islow(coef: np.ndarray) -> np.ndarray:
    """Dequantized blocks [N, 8, 8] (int64, natural order) -> samples
    [N, 8, 8] uint8, as libjpeg's ``jpeg_idct_islow``."""
    def descale(v, n):
        return (v + (1 << (n - 1))) >> n
    cols = _idct_1d([coef[:, k, :] for k in range(8)])        # pass 1
    ws = np.stack([descale(c, _CB - _P1) for c in cols], axis=1)
    rows = _idct_1d([ws[:, :, k] for k in range(8)])          # pass 2
    out = np.stack([descale(r, _CB + _P1 + 3) for r in rows], axis=2)
    return _RANGE[out & 1023]


def _upsample(plane: np.ndarray, h: int, v: int) -> np.ndarray:
    """A component plane [rows, cols] (its real samples only) upsampled by
    (h, v) = (1, 1), (2, 1) or (2, 2) as libjpeg does with fancy
    upsampling on: the triangle filters (edges replicate), or
    replication for a plane at most 2 samples wide."""
    x = plane.astype(np.int64)
    n_rows, n_cols = x.shape
    if (h, v) == (1, 1):
        return plane
    if n_cols <= 2:
        return np.repeat(np.repeat(plane, v, 0), h, 1)
    if (h, v) == (2, 1):
        left = np.concatenate([x[:, :1], x[:, :-1]], 1)
        right = np.concatenate([x[:, 1:], x[:, -1:]], 1)
        out = np.empty((n_rows, 2 * n_cols), np.int64)
        out[:, 0::2] = (3 * x + left + 1) >> 2
        out[:, 1::2] = (3 * x + right + 2) >> 2
        return out.astype(np.uint8)
    up = np.concatenate([x[:1], x[:-1]], 0)
    down = np.concatenate([x[1:], x[-1:]], 0)
    out = np.empty((2 * n_rows, 2 * n_cols), np.int64)
    for k, other in ((0, up), (1, down)):
        cs = 3 * x + other
        left = np.concatenate([cs[:, :1], cs[:, :-1]], 1)
        right = np.concatenate([cs[:, 1:], cs[:, -1:]], 1)
        out[k::2, 0::2] = (3 * cs + left + 8) >> 4
        out[k::2, 1::2] = (3 * cs + right + 7) >> 4
    return out.astype(np.uint8)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """libjpeg's table-based YCbCr -> RGB (jdcolor.c, 16-bit fixed
    point)."""
    one_half = 1 << 15
    fix = lambda c: int(c * 65536 + 0.5)  # noqa: E731
    y, cb, cr = (a.astype(np.int64) for a in (y, cb, cr))
    xb, xr = cb - 128, cr - 128
    r = y + ((fix(1.40200) * xr + one_half) >> 16)
    g = y + ((-fix(0.34414) * xb + one_half - fix(0.71414) * xr) >> 16)
    b = y + ((fix(1.77200) * xb + one_half) >> 16)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


class _Bits:
    """MSB-first bit reader over one entropy-coded segment (unstuffed)."""

    def __init__(self, data: bytes):
        self.data = data + b"\0\0\0\0"
        self.pos = 0

    def peek16(self) -> int:
        p = self.pos
        return (int.from_bytes(self.data[p >> 3:(p >> 3) + 3], "big")
                >> (8 - (p & 7))) & 0xFFFF

    def receive(self, s: int) -> int:
        """The next ``s`` bits as a signed coefficient (EXTEND)."""
        if s == 0:
            return 0
        v = self.peek16() >> (16 - s)
        self.pos += s
        return v if v >= 1 << (s - 1) else v - (1 << s) + 1


def _entropy_segments(data: bytes, pos: int):
    """Split the entropy-coded data of a scan at its restart markers and
    unstuff it -> (segments, position of the marker after the scan)."""
    segs, out = [], bytearray()
    while True:
        i = data.find(b"\xff", pos)
        if i < 0 or i + 1 >= len(data):
            raise ValueError("jpeg: scan data runs past the end")
        out += data[pos:i]
        m = data[i + 1]
        if m == 0x00:                   # stuffed 0xFF
            out.append(0xFF)
            pos = i + 2
        elif m == 0xFF:                 # fill byte
            pos = i + 1
        elif 0xD0 <= m <= 0xD7:         # restart marker
            segs.append(bytes(out))
            out = bytearray()
            pos = i + 2
        else:
            segs.append(bytes(out))
            return segs, i


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _decode_scan(segs, comps, scan, frame, tables, restart: int) -> None:
    """Huffman-decode one sequential scan into the components' coefficient
    arrays (zigzag order)."""
    hmax, vmax, X, Y = frame
    if len(scan) == 1:      # non-interleaved: one block an MCU
        c = comps[scan[0][0]]
        bw = _ceil_div(_ceil_div(X * c["h"], hmax), 8)
        bh = _ceil_div(_ceil_div(Y * c["v"], vmax), 8)
        mcus = [[(scan[0], r, q)] for r in range(bh) for q in range(bw)]
    else:
        mx, my = _ceil_div(X, 8 * hmax), _ceil_div(Y, 8 * vmax)
        mcus = [[(sc, m_y * comps[sc[0]]["v"] + j, m_x * comps[sc[0]]["h"] + i)
                 for sc in scan for j in range(comps[sc[0]]["v"])
                 for i in range(comps[sc[0]]["h"])]
                for m_y in range(my) for m_x in range(mx)]
    per_seg = restart if restart else len(mcus)
    for k, mcu_run in enumerate(range(0, len(mcus), per_seg)):
        if k >= len(segs):
            raise ValueError("jpeg: fewer restart intervals than MCUs need")
        bits = _Bits(segs[k])
        pred = {sc[0]: 0 for sc in scan}
        for mcu in mcus[mcu_run:mcu_run + per_seg]:
            for (cid, td, ta), r, q in mcu:
                dsym, dlen = tables[(0, td)]
                asym, alen = tables[(1, ta)]
                blk = comps[cid]["coef"][r, q]
                p = bits.peek16()
                s = dsym[p]
                if not dlen[p]:
                    raise ValueError("jpeg: bad Huffman code")
                bits.pos += dlen[p]
                pred[cid] += bits.receive(s)
                blk[0] = pred[cid]
                i = 1
                while i < 64:
                    p = bits.peek16()
                    if not alen[p]:
                        raise ValueError("jpeg: bad Huffman code")
                    bits.pos += alen[p]
                    rs = asym[p]
                    run, s = rs >> 4, rs & 15
                    if s == 0:
                        if run != 15:
                            break       # end of block
                        i += 16
                        continue
                    i += run
                    if i > 63:
                        raise ValueError("jpeg: coefficient index past 63")
                    blk[i] = bits.receive(s)
                    i += 1


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> [H, W, 3] uint8 (a gray image replicated), as
    libjpeg decodes it with its defaults (islow IDCT, fancy upsampling).
    Raises ValueError on what it does not take (progressive, arithmetic
    coding, 12-bit samples, CMYK)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("jpeg: no SOI marker")
    pos, qt, tables, comps, frame = 2, {}, {}, {}, None
    restart, adobe, jfif = 0, None, False
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"jpeg: expected a marker at byte {pos}")
        m = data[pos + 1]
        if m == 0xFF:
            pos += 1
            continue
        if m == 0xD9:                       # EOI
            break
        seg_len = struct.unpack_from(">H", data, pos + 2)[0]
        body = data[pos + 4:pos + 2 + seg_len]
        pos += 2 + seg_len
        if m == 0xDB:                       # DQT
            k = 0
            while k < len(body):
                pq, tq = body[k] >> 4, body[k] & 15
                n = 128 if pq else 64
                vals = np.frombuffer(body[k + 1:k + 1 + n],
                                     ">u2" if pq else np.uint8)
                nat = np.zeros(64, np.int64)
                nat[_ZIGZAG] = vals
                qt[tq] = nat
                k += 1 + n
        elif m == 0xC4:                     # DHT
            k = 0
            while k < len(body):
                tc, th = body[k] >> 4, body[k] & 15
                counts = body[k + 1:k + 17]
                n = sum(counts)
                tables[(tc, th)] = _huff_lookup(counts,
                                                body[k + 17:k + 17 + n])
                k += 17 + n
        elif m in (0xC0, 0xC1):             # baseline, extended sequential
            prec, Y, X, nf = struct.unpack_from(">BHHB", body)
            if prec != 8:
                raise ValueError(f"jpeg: {prec}-bit samples are not "
                                 "supported")
            if nf not in (1, 3):
                raise ValueError(f"jpeg: {nf} components (only gray and "
                                 "YCbCr/RGB are supported)")
            if Y == 0:
                raise ValueError("jpeg: height given by a DNL marker")
            for k in range(nf):
                cid, hv, tq = body[6 + 3 * k:9 + 3 * k]
                comps[cid] = dict(h=hv >> 4, v=hv & 15, tq=tq, order=k)
            hmax = max(c["h"] for c in comps.values())
            vmax = max(c["v"] for c in comps.values())
            for c in comps.values():
                if (hmax % c["h"] or vmax % c["v"] or (
                        hmax // c["h"], vmax // c["v"]) not in (
                        (1, 1), (2, 1), (2, 2))):
                    raise ValueError(
                        "jpeg: sampling factors "
                        + ",".join(f"{d['h']}x{d['v']}"
                                   for d in comps.values())
                        + " are not supported (4:4:4, 4:2:2, 4:2:0 only)")
            mx, my = _ceil_div(X, 8 * hmax), _ceil_div(Y, 8 * vmax)
            for c in comps.values():
                c["coef"] = np.zeros((my * c["v"], mx * c["h"], 64),
                                     np.int64)
            frame = (hmax, vmax, X, Y)
        elif m in _SOF_NAMES:
            raise ValueError(f"jpeg: {_SOF_NAMES[m]} JPEG is not supported "
                             "(baseline sequential only)")
        elif m == 0xDD:                     # DRI
            restart = struct.unpack(">H", body[:2])[0]
        elif m == 0xE0 and body[:5] == b"JFIF\0":
            jfif = True
        elif m == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif m == 0xDA:                     # SOS
            if frame is None:
                raise ValueError("jpeg: scan before the frame header")
            ns = body[0]
            scan = [(body[1 + 2 * k], body[2 + 2 * k] >> 4,
                     body[2 + 2 * k] & 15) for k in range(ns)]
            segs, pos = _entropy_segments(data, pos)
            _decode_scan(segs, comps, scan, frame, tables, restart)
    if frame is None:
        raise ValueError("jpeg: no frame header")
    hmax, vmax, X, Y = frame
    planes = []
    for c in sorted(comps.values(), key=lambda c: c["order"]):
        coef = c["coef"]
        bh, bw = coef.shape[:2]
        nat = np.zeros_like(coef)
        nat[..., _ZIGZAG] = coef
        blocks = _idct_islow((nat * qt[c["tq"]]).reshape(-1, 8, 8))
        plane = blocks.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(
            bh * 8, bw * 8)
        rows, cols = _ceil_div(Y * c["v"], vmax), _ceil_div(X * c["h"], hmax)
        plane = _upsample(plane[:rows, :cols], hmax // c["h"],
                          vmax // c["v"])
        planes.append(plane[:Y, :X])
    if len(planes) == 1:
        return np.repeat(planes[0][..., None], 3, 2)
    ids = sorted(comps, key=lambda k: comps[k]["order"])
    rgb = (adobe == 0) if adobe is not None else (
        not jfif and ids == [ord("R"), ord("G"), ord("B")])
    if rgb:
        return np.stack(planes, -1)
    return _ycc_to_rgb(*planes)


_JPEG_QUALITY = 75      # Pillow's default


def _jpeg_quant(base: np.ndarray) -> np.ndarray:
    """libjpeg's ``jpeg_set_quality`` scaling of an Annex K table (its
    rule for a quality of 50 or more)."""
    scale = 200 - 2 * _JPEG_QUALITY
    return np.clip((base * scale + 50) // 100, 1, 255)


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, code: int, length: int) -> None:
        self.acc = (self.acc << length) | code
        self.n += length
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)
    c = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16)
    c[0] *= np.sqrt(0.5)
    return c * 0.5


def encode_jpeg(img: np.ndarray) -> bytes:
    """[H, W, 3] uint8 -> baseline JPEG bytes: JFIF YCbCr, 4:2:0, the
    Annex K quantization tables at quality 75 and the Annex K Huffman
    tables (Pillow's defaults)."""
    img = np.ascontiguousarray(img, np.uint8)
    H, W, c = img.shape
    if c != 3:
        raise ValueError(f"encode_jpeg: RGB only, got {c} channels")
    rgb = img.astype(np.float64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    ycc = [0.299 * r + 0.587 * g + 0.114 * b,
           -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0,
           0.5 * r - 0.418688 * g - 0.081312 * b + 128.0]
    ph, pw = _ceil_div(H, 16) * 16, _ceil_div(W, 16) * 16  # edge replicated
    ycc = [np.pad(p, ((0, ph - H), (0, pw - W)), mode="edge") for p in ycc]
    ycc[1:] = [(p[0::2, 0::2] + p[1::2, 0::2] + p[0::2, 1::2]
                + p[1::2, 1::2]) / 4.0 for p in ycc[1:]]
    qts = [_jpeg_quant(_QLUM), _jpeg_quant(_QCHR)]
    dct = _dct_matrix()
    coefs = []
    for k, p in enumerate(ycc):
        bh, bw = p.shape[0] // 8, p.shape[1] // 8
        blocks = (p - 128.0).reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        f = dct @ blocks @ dct.T
        q = np.round(f / qts[min(k, 1)].reshape(8, 8)).astype(np.int64)
        coefs.append(q.reshape(bh, bw, 64)[..., _ZIGZAG])
    codes = {key: {s: (code, n) for s, n, code in _huff_codes(*spec)}
             for key, spec in _HUFF.items()}
    bw_ = _BitWriter()
    pred = [0, 0, 0]

    def put_value(v: int, s: int) -> None:
        if s:
            bw_.put(v if v > 0 else v + (1 << s) - 1, s)

    for my in range(ph // 16):
        for mx in range(pw // 16):
            for k, (dy, dx) in ([(0, (j, i)) for j in (0, 1) for i in (0, 1)]
                                + [(1, (0, 0)), (2, (0, 0))]):
                blk = coefs[k][(2 * my + dy) if k == 0 else my,
                               (2 * mx + dx) if k == 0 else mx]
                t = min(k, 1)
                diff = int(blk[0]) - pred[k]
                pred[k] = int(blk[0])
                s = abs(diff).bit_length()
                bw_.put(*codes[(0, t)][s])
                put_value(diff, s)
                last = 0
                for i in (np.nonzero(blk[1:])[0] + 1).tolist():
                    run = i - last - 1
                    while run > 15:
                        bw_.put(*codes[(1, t)][0xF0])
                        run -= 16
                    v = int(blk[i])
                    s = abs(v).bit_length()
                    bw_.put(*codes[(1, t)][(run << 4) | s])
                    put_value(v, s)
                    last = i
                if last != 63:
                    bw_.put(*codes[(1, t)][0x00])
    scan = bw_.flush()

    def seg(marker: int, body: bytes) -> bytes:
        return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body
    out = b"\xff\xd8" + seg(0xE0, b"JFIF\0\x01\x01\x00\x00\x01\x00\x01\0\0")
    for t, q in enumerate(qts):
        out += seg(0xDB, bytes([t]) + bytes(q[_ZIGZAG].astype(np.uint8)))
    out += seg(0xC0, struct.pack(">BHHB", 8, H, W, 3)
               + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
    for (tc, th), (counts, symbols) in _HUFF.items():
        out += seg(0xC4, bytes([tc << 4 | th]) + bytes(counts) + symbols)
    out += seg(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    return out + scan + b"\xff\xd9"


# ---------------------------------------------------------- load / save

def _decode_ldr(data: bytes, name: str) -> np.ndarray:
    """PNG or JPEG bytes (told apart by their signature) -> [H, W, 3]
    uint8."""
    if data[:8] == _PNG_SIG:
        return _png_rgb8(data)
    if data[:3] == b"\xff\xd8\xff":
        return decode_jpeg(data)
    raise ValueError(f"{name}: not a PNG or JPEG file (EXR is read by its "
                     ".exr extension); other formats are not supported")


# process-global decode cache keyed by (abspath, gamma, flip_y, mtime): a
# file rewritten between scene builds does not serve the stale decode
_DECODE_CACHE: dict = {}


def load_image(path: str, gamma: bool = None, flip_y: bool = True
               ) -> np.ndarray:
    """Load an image as linear float32 [H, W, 3].

    ``gamma=None`` decides by format: PNG and JPEG are sRGB-decoded, EXR
    is linear. Decodes are cached; the returned array is shared and
    frozen, so an in-place change raises instead of corrupting later
    builds."""
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        mtime = None
    key = (os.path.abspath(path), gamma, flip_y, mtime)
    hit = _DECODE_CACHE.get(key)
    if hit is not None:
        return hit
    if os.path.splitext(path)[1].lower() == ".exr":
        img = read_exr(path)
    else:
        with open(path, "rb") as fh:
            arr = _decode_ldr(fh.read(), path).astype(np.float32) / 255.0
        img = _srgb_to_linear(arr) if (gamma is None or gamma) else arr
    if flip_y:
        img = img[::-1].copy()
    img = np.ascontiguousarray(img.astype(np.float32))
    img.flags.writeable = False
    _DECODE_CACHE[key] = img
    return img


def save_image(path: str, img: np.ndarray) -> None:
    """Save linear float32 [H, W, 3]: EXR stays linear; PNG and JPEG
    (.png, .jpg, .jpeg) are sRGB encoded."""
    ext = os.path.splitext(path)[1].lower()
    img = np.asarray(img, np.float32)
    if ext == ".exr":
        write_exr(path, img)
        return
    encode = {".png": encode_png, ".jpg": encode_jpeg,
              ".jpeg": encode_jpeg}.get(ext)
    if encode is None:
        raise ValueError(f"{path}: only .exr, .png, .jpg and .jpeg outputs "
                         "are supported")
    ldr = (np.clip(_linear_to_srgb(img), 0, 1) * 255.0 + 0.5).astype(
        np.uint8)
    with open(path, "wb") as fh:
        fh.write(encode(ldr))

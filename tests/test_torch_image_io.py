"""The port's image codecs (``fountain_tpu_torch/io/image.py``) against
the JAX package's ``load_image``/``save_image``, which go through Pillow,
and the ``mipmap_debug`` CLI of both packages.

Fixtures are written in this process: by Pillow where Pillow writes the
type (8-bit gray, gray + alpha, RGB, RGBA, palettes of 1-8 bits, 1-bit
and 16-bit gray, JPEG), by ``_raw_png`` below where it does not (16-bit
color, 2- and 4-bit gray, Adam7 interlace). Pillow's decode is the
reference in every case.
"""
import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from fountain_tpu.io.image import load_image as jload
from fountain_tpu_torch.io import image as timg

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# (color type, bit depth) of every PNG the standard allows
PNG_KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16),
             (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8),
             (6, 16)]
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _scanlines(samples, ch, depth, rng):
    """Samples [h, w * ch] -> PNG scanlines, each with a random filter
    (None, Sub, Up, Average or Paeth)."""
    h = samples.shape[0]
    if depth == 16:
        rows = [s.astype(">u2").tobytes() for s in samples]
    elif depth == 8:
        rows = [s.astype(np.uint8).tobytes() for s in samples]
    else:
        per = 8 // depth
        pad = (-samples.shape[1]) % per
        packed = np.concatenate([samples, np.zeros((h, pad), samples.dtype)],
                                1).reshape(h, -1, per).astype(np.int64)
        packed = (packed << (np.arange(per - 1, -1, -1) * depth)).sum(-1)
        rows = [s.astype(np.uint8).tobytes() for s in packed]
    bpp = max(1, ch * depth // 8)
    out, prev = b"", np.zeros(len(rows[0]), np.int64)
    for row in rows:
        cur = np.frombuffer(row, np.uint8).astype(np.int64)
        f = int(rng.integers(0, 5))
        a = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if f == 0:
            pred = 0 * cur
        elif f == 1:
            pred = a
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (a + prev) >> 1
        else:
            p = a + prev - c
            pa, pb, pc = abs(p - a), abs(p - prev), abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, prev, c))
        out += bytes([f]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = cur
    return out


def _raw_png(px, color, depth, interlace, palette=None, seed=0):
    """A PNG of samples ``px`` [h, w, ch] written without Pillow."""
    rng = np.random.default_rng(seed)
    h, w, ch = px.shape
    if interlace:
        raw = b"".join(_scanlines(px[y0::dy, x0::dx].reshape(
            len(range(y0, h, dy)), -1), ch, depth, rng)
            for x0, y0, dx, dy in ADAM7
            if x0 < w and y0 < h)
    else:
        raw = _scanlines(px.reshape(h, -1), ch, depth, rng)

    def chunk(t, body):
        return (struct.pack(">I", len(body)) + t + body
                + struct.pack(">I", zlib.crc32(t + body) & 0xFFFFFFFF))
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if palette is not None:
        out += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


def _both(tmp_path, name, data, gamma=False):
    """(port, JAX) decodes of the file bytes ``data``, flipped as
    load_image flips them, in 0..255."""
    path = tmp_path / name
    path.write_bytes(data)
    return (np.asarray(timg.load_image(str(path), gamma=gamma)) * 255.0,
            np.asarray(jload(str(path), gamma=gamma)) * 255.0)


@pytest.mark.parametrize("kind", PNG_KINDS, ids=lambda k: f"c{k[0]}d{k[1]}")
def test_png_every_type_and_depth_as_pillow(kind, tmp_path):
    """Non-interlaced and Adam7 (13 x 11: every pass partly filled), equal
    to Pillow's ``convert("RGB")`` (tolerance 0), except 16-bit gray,
    where the port keeps the high byte and Pillow saturates (ROADMAP
    C.3)."""
    color, depth = kind
    rng = np.random.default_rng(depth * 10 + color)
    px = rng.integers(0, 1 << depth, (11, 13, CHANNELS[color]))
    pal = (rng.integers(0, 256, (1 << depth, 3)) if color == 3 else None)
    for interlace in (0, 1):
        data = _raw_png(px, color, depth, interlace, pal, seed=interlace)
        t, j = _both(tmp_path, f"k{interlace}.png", data)
        if kind == (0, 16):
            np.testing.assert_array_equal(t[::-1, :, 0], px[..., 0] >> 8)
            np.testing.assert_array_equal(      # Pillow saturates
                j[::-1, :, 0], np.minimum(px[..., 0], 255))
        else:
            np.testing.assert_array_equal(t, j)
    if color == 3:
        np.testing.assert_array_equal(timg.decode_png(data), pal[px[..., 0]])
    else:
        np.testing.assert_array_equal(timg.decode_png(data), px)


@pytest.mark.parametrize("mode", ["1", "L", "LA", "RGB", "RGBA", "P1", "P2",
                                  "P4", "P8", "I;16"])
def test_png_written_by_pillow(mode, tmp_path):
    """Pillow's own PNGs of each mode it writes decode as Pillow decodes
    them (16-bit gray: the high byte, as above)."""
    rng = np.random.default_rng(len(mode))
    base = rng.integers(0, 256, (21, 17, 3)).astype(np.uint8)
    base[:6] = (np.arange(17)[None, :, None] * 15).astype(np.uint8)
    if mode[0] == "P":
        im = Image.fromarray(base).convert("P", palette=Image.ADAPTIVE,
                                           colors=1 << int(mode[1:]))
        kw = dict(bits=int(mode[1:]))
    elif mode == "I;16":
        v16 = rng.integers(0, 65536, (21, 17)).astype(np.uint16)
        im = Image.frombytes("I;16", (17, 21), v16.tobytes())
        kw = {}
    else:
        im = Image.fromarray(base).convert(mode)
        kw = {}
    buf = io.BytesIO()
    im.save(buf, "PNG", **kw)
    t, j = _both(tmp_path, "p.png", buf.getvalue())
    if mode == "I;16":
        np.testing.assert_array_equal(t[::-1, :, 0], v16 >> 8)
    else:
        np.testing.assert_array_equal(t, j)


def _smooth(h, w, seed=0):
    """A test picture JPEG keeps well: ramps, a disc and mild noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255.0 / w, y * 255.0 / h,
                    128 + 100 * np.sin(x / 5.0) * np.cos(y / 7.0)], -1)
    img[(x - w / 2) ** 2 + (y - h / 3) ** 2 < (h / 4) ** 2] = (220, 40, 90)
    img += rng.normal(0, 4, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("kind", ["444", "422", "420", "gray", "restart"])
def test_jpeg_decode_as_pillow(kind, tmp_path):
    """Pillow's baseline JPEGs (53 x 37, not a whole number of MCUs)
    decode within one 8-bit level of Pillow's own decode (libjpeg-turbo:
    islow IDCT, fancy upsampling)."""
    src = _smooth(37, 53, seed=len(kind))
    im = Image.fromarray(src)
    kw = dict(quality=90)
    if kind == "gray":
        im = im.convert("L")
    elif kind == "restart":
        kw.update(subsampling=2, restart_marker_blocks=3)
    else:
        kw["subsampling"] = {"444": 0, "422": 1, "420": 2}[kind]
    buf = io.BytesIO()
    im.save(buf, "JPEG", **kw)
    t, j = _both(tmp_path, "p.jpg", buf.getvalue())
    np.testing.assert_allclose(t, j, rtol=0, atol=1.0 + 1e-4)


def test_jpeg_writer_as_pillow_reads_it(tmp_path):
    """A port-written JPEG of data/logo.png (quality 75, 4:2:0, Annex K
    tables: Pillow's defaults) decoded by Pillow is within 3/255 of its
    source on average (Pillow's own writer: 2.05/255); the port decodes it
    within one level of Pillow; its tables are the ones Pillow writes; a
    progressive JPEG, a 4:1:1 one and a BMP raise."""
    src = np.asarray(Image.open("data/logo.png").convert("RGB"))
    img = jload("data/logo.png", flip_y=False)             # linear
    timg.save_image(str(tmp_path / "t.jpg"), img)
    data = (tmp_path / "t.jpg").read_bytes()
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"),
                     np.float64)
    err = np.abs(pil - src).mean()
    assert err <= 3.0, err
    t, j = _both(tmp_path, "t2.jpg", data)
    np.testing.assert_allclose(t, j, rtol=0, atol=1.0 + 1e-4)

    buf = io.BytesIO()
    Image.fromarray(src).save(buf, "JPEG")
    pil_data = buf.getvalue()
    for marker in (b"\xff\xc4", b"\xff\xdb"):   # DHT, DQT segments
        def segs(d):
            out, i = [], d.find(marker)
            while i >= 0:
                n = struct.unpack(">H", d[i + 2:i + 4])[0]
                out.append(d[i + 4:i + 2 + n])
                i = d.find(marker, i + 2 + n)
            return b"".join(out)
        assert segs(data) == segs(pil_data)

    Image.fromarray(src).save(tmp_path / "p.jpg", progressive=True)
    with pytest.raises(ValueError, match="progressive"):
        timg.load_image(str(tmp_path / "p.jpg"))
    sof = pil_data.index(b"\xff\xc0")      # luma 2x2 -> 4x1 (4:1:1)
    k = sof + 11
    assert pil_data[k] == 0x22
    (tmp_path / "s.jpg").write_bytes(pil_data[:k] + b"\x41"
                                     + pil_data[k + 1:])
    with pytest.raises(ValueError, match="sampling factors 4x1"):
        timg.load_image(str(tmp_path / "s.jpg"))
    Image.fromarray(src).save(tmp_path / "p.bmp")
    with pytest.raises(ValueError, match="not a PNG or JPEG"):
        timg.load_image(str(tmp_path / "p.bmp"))
    with pytest.raises(ValueError, match=".bmp"):
        timg.save_image(str(tmp_path / "o.bmp"), img)


def test_mipmap_debug_as_jax(tmp_path, capsys):
    """Both CLIs on data/logo.png: the same file names, stderr lines and
    level sizes; each level within one 8-bit level of JAX's."""
    from fountain_tpu.cli.mipmap_debug import main as jmain
    from fountain_tpu_torch.cli.mipmap_debug import main as tmain
    assert jmain(["data/logo.png", "-o", str(tmp_path / "j")]) == 0
    jerr = capsys.readouterr().err
    assert tmain(["data/logo.png", "-o", str(tmp_path / "t")]) == 0
    terr = capsys.readouterr().err
    assert terr.replace("/t/", "/j/") == jerr
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    assert len(names) == 10        # 256 x 256: 9 levels + resampled
    for name in names:
        a = np.asarray(Image.open(tmp_path / "j" / name), np.int64)
        b = timg.decode_png((tmp_path / "t" / name).read_bytes())
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1, name

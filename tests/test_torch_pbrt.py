"""Port parity: the PBRT frontend, image I/O and the render CLI.

- ``load_pbrt`` of logo_cube.pbrt and furnace_empty.pbrt builds the same
  tables as the JAX package's (through the dotted leaf paths of
  ``scene_from_arrays``): integer leaves equal, floats allclose 1e-6.
- The port's PNG decoder equals the JAX package's ``load_image`` (which
  decodes through Pillow) on data/logo.png and on PNGs that Pillow
  writes here in L, RGB and RGBA, and it undoes all five filter types.
- ``write_exr`` writes the JAX package's bytes; a saved PNG reads back.
- The CLI renders the furnace on the CPU. The furnace's radiance is
  1 / (1 - 0.5) = 2 in every pixel; with Russian roulette a pixel's
  estimate is noisy. Observed when this file was written: ``--regen`` at
  the file's 128 spp, mean 1.99929, largest |pixel - 2| 0.2031; the fixed
  wave at 32 spp, mean 1.99417, largest |pixel - 2| 0.1797. Gates: the
  mean within 0.02 of 2 (about 4 standard errors at 32 spp), every pixel
  within 0.4 (tests/test_regen.py's per-pixel gate for the regeneration
  estimator). The reference's per-pixel epsilon of 0.1 needs 256 spp of
  the fixed wave (as tests/test_furnace.py renders it); chip_smoke.py
  checks it on the card.
"""
import functools
import pathlib
import struct
import zlib

import numpy as np
import pytest
import torch

from tests.test_torch_scene import jax_arrays

SCENES = ("testscenes/logo_cube.pbrt", "testscenes/furnace_empty.pbrt")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _loaded(path):
    from fountain_tpu.io.pbrt import load_pbrt as jload
    from fountain_tpu_torch.io.pbrt import load_pbrt as tload
    return jload(path), tload(path, device="cpu")


@pytest.mark.parametrize("path", SCENES)
def test_load_pbrt_tables_equal_jax(path):
    from fountain_tpu_torch.scene.build import scene_from_arrays
    (js, jcam, jst), (ts, tcam, tst) = _loaded(path)
    bridged = scene_from_arrays(jax_arrays(js), device="cpu")
    close = functools.partial(np.testing.assert_allclose, rtol=1e-6,
                              atol=1e-6)
    for grp in ("spheres", "triangles", "materials", "textures", "lights",
                "env_images", "env_dist"):
        a, b = getattr(ts, grp), getattr(bridged, grp)
        assert (a is None) == (b is None), grp
        if a is None:
            continue
        for name in a.__dataclass_fields__:
            x, y = getattr(a, name), getattr(b, name)
            if not isinstance(x, torch.Tensor):
                assert x == y, (grp, name)
                continue
            assert x.shape == y.shape, (grp, name)
            if x.dtype.is_floating_point:
                close(x.numpy(), y.numpy(), err_msg=f"{grp}.{name}")
            else:
                np.testing.assert_array_equal(x.numpy(), y.numpy(),
                                              err_msg=f"{grp}.{name}")
    close(ts.world_center.numpy(), bridged.world_center.numpy())
    close(ts.world_radius.numpy(), bridged.world_radius.numpy())
    assert (ts.tri_attr is None) == (bridged.tri_attr is None)
    if ts.tri_attr is not None:
        close(ts.tri_attr.numpy(), bridged.tri_attr.numpy())
        for f in ("coef", "bounds"):
            close(getattr(ts.tri_sweep, f).numpy(),
                  getattr(bridged.tri_sweep, f).numpy())
    assert (tst.xres, tst.yres, tst.spp, tst.max_depth, tst.integrator,
            tst.filter_name, tst.filter_radius, tst.output) == \
        (jst.xres, jst.yres, jst.spp, jst.max_depth, jst.integrator,
         jst.filter_name, jst.filter_radius, jst.output)
    close(tcam.camera_to_world.m.numpy(), np.asarray(jcam.camera_to_world.m))
    close(tcam.raster_to_camera.m.numpy(),
          np.asarray(jcam.raster_to_camera.m))
    assert tcam.lens_radius == pytest.approx(float(jcam.lens_radius))
    assert tcam.focal_dist == pytest.approx(float(jcam.focal_dist))


def test_logo_cube_content():
    """The flagship's content: the cube and the ground quad, a metal and a
    glass sphere, four materials, nested textures, two images in one
    atlas (sky.exr and logo.png)."""
    from fountain_tpu_torch.scene.types import (MAT_GLASS, MAT_MATTE,
                                                MAT_METAL)
    _, (ts, cam, st) = _loaded(SCENES[0])
    assert ts.triangles.count == 4332 + 2 and ts.spheres.count == 2
    assert sorted(ts.materials.mtype.tolist()) == sorted(
        [MAT_METAL, MAT_METAL, MAT_GLASS, MAT_MATTE])
    assert ts.textures.has_nested and ts.env_images.count == 2
    assert (st.xres, st.spp, st.max_depth) == (256, 64, 8)
    assert cam.lens_radius == pytest.approx(0.6)


def _png(px, filters):
    """An 8-bit PNG of ``px`` [H, W, C] with row y filtered by
    ``filters[y % len(filters)]`` (0 None, 1 Sub, 2 Up, 3 Average,
    4 Paeth)."""
    h, w, c = px.shape
    rows = px.reshape(h, w * c).astype(np.int64)
    raw = b""
    prev = np.zeros(w * c, np.int64)
    for y in range(h):
        f, cur = filters[y % len(filters)], rows[y]
        a = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        cc = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = a
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (a + prev) >> 1
        else:
            p = a + prev - cc
            pa, pb, pc = abs(p - a), abs(p - prev), abs(p - cc)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, prev, cc))
        raw += bytes([f]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = cur

    def chunk(t, body):
        return struct.pack(">I", len(body)) + t + body + struct.pack(
            ">I", zlib.crc32(t + body) & 0xFFFFFFFF)
    color = {1: 0, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_png_decoder_equals_jax_load_image(mode, tmp_path):
    from PIL import Image

    from fountain_tpu.io.image import load_image as jload
    from fountain_tpu_torch.io.image import decode_png
    from fountain_tpu_torch.io.image import load_image as tload
    np.testing.assert_array_equal(tload("data/logo.png"),
                                  jload("data/logo.png"))
    rng = np.random.default_rng(0)
    c = {"L": 1, "RGB": 3, "RGBA": 4}[mode]
    px = rng.integers(0, 256, (19, 23, c)).astype(np.uint8)
    px[:8] = (np.arange(23)[None, :, None] * 11).astype(np.uint8)  # ramps
    path = tmp_path / f"pil_{mode}.png"
    Image.fromarray(px[..., 0] if c == 1 else px, mode).save(path)
    np.testing.assert_array_equal(tload(str(path)), jload(str(path)))
    for f in range(5):                       # each filter type alone
        np.testing.assert_array_equal(decode_png(_png(px, [f])), px)
    np.testing.assert_array_equal(decode_png(_png(px, [0, 1, 2, 3, 4])), px)
    with pytest.raises(ValueError):   # a 16-bit header over 8-bit data
        decode_png(_png(px, [0]).replace(
            struct.pack(">IIBB", 23, 19, 8, {1: 0, 3: 2, 4: 6}[c]),
            struct.pack(">IIBB", 23, 19, 16, {1: 0, 3: 2, 4: 6}[c])))


def test_writers(tmp_path):
    from fountain_tpu.io.exr import write_exr as jwrite
    from fountain_tpu_torch.io.exr import read_exr, write_exr
    from fountain_tpu_torch.io.image import load_image, save_image
    img = np.random.default_rng(1).uniform(0, 3, (7, 11, 3)).astype(
        np.float32)
    jwrite(str(tmp_path / "j.exr"), img)
    write_exr(str(tmp_path / "t.exr"), img)
    assert (tmp_path / "j.exr").read_bytes() == (tmp_path / "t.exr"
                                                 ).read_bytes()
    np.testing.assert_array_equal(read_exr(str(tmp_path / "t.exr")), img)
    save_image(str(tmp_path / "t.png"), img)
    back = load_image(str(tmp_path / "t.png"), gamma=False, flip_y=False)
    ldr = np.clip(img, 0, 1)
    srgb = np.where(ldr <= 0.0031308, 12.92 * ldr,
                    1.055 * ldr ** (1 / 2.4) - 0.055)
    np.testing.assert_allclose(back, np.round(srgb * 255) / 255, atol=1e-6)


@pytest.mark.parametrize("extra", [["--regen"], ["--samples", "32"],
                                   ["--progress", "--samples", "32"]])
def test_cli_furnace_on_cpu(extra, tmp_path, capsys):
    from fountain_tpu_torch.cli.render import main
    from fountain_tpu_torch.io.exr import read_exr
    out = tmp_path / "furnace.exr"
    assert main([SCENES[1], "--cpu", "-o", str(out)] + extra) == 0
    err = capsys.readouterr().err
    assert "1 spheres, 0 tris, 1 lights" in err and "paths/s" in err
    img = read_exr(str(out))
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert abs(float(img.mean()) - 2.0) < 0.02, float(img.mean())
    np.testing.assert_allclose(img, 2.0, atol=0.4)


def test_cli_profile_writes_a_trace(tmp_path, capsys):
    from fountain_tpu_torch.cli.render import main
    out = tmp_path / "f.exr"
    assert main([SCENES[1], "--cpu", "--samples", "1", "-o", str(out),
                 "--profile", str(tmp_path / "prof")]) == 0
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert out.exists() and "profile trace written" in capsys.readouterr().err


def test_cli_refusals(tmp_path, monkeypatch):
    import torch

    from fountain_tpu_torch.cli.render import main
    from fountain_tpu_torch.io.pbrt import load_pbrt
    # --devices N wants N cards, and a one-card machine refuses 2 before
    # anything starts (--cpu --devices 2 renders: test_torch_shard.py)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 CUDA devices asked for"):
        main([SCENES[1], "--devices", "2"])
    monkeypatch.undo()
    text = pathlib.Path(SCENES[1]).read_text()
    cases = {
        "whitted": text.replace('Integrator "path"', 'Integrator "whitted"'),
        "filter": text.replace('PixelFilter "box"',
                               'PixelFilter "gaussian"'),
        "point": text.replace("WorldBegin", 'WorldBegin\nLightSource '
                              '"point" "rgb I" [1 1 1]'),
        "mesh light": text.replace('Shape "sphere" "float radius" 100',
                                   'Shape "trianglemesh" "integer indices"'
                                   ' [0 1 2] "point P" [0 0 0 1 0 0 0 1 0]'),
    }
    # content that raised before its port now renders
    for name, body in cases.items():
        path = tmp_path / f"{name.replace(' ', '_')}.pbrt"
        path.write_text(body)
        assert main([str(path), "--cpu", "--samples", "1", "-o",
                     str(tmp_path / "x.exr")]) == 0
    # what the JAX package refuses too
    path = tmp_path / "instance.pbrt"
    path.write_text(text.replace("WorldBegin",
                                 'WorldBegin\nObjectBegin "a"'))
    with pytest.raises(NotImplementedError):
        main([str(path), "--cpu", "--samples", "1", "-o",
              str(tmp_path / "x.exr")])
    if not torch.cuda.is_available():     # the default device is cuda
        with pytest.raises(RuntimeError):
            load_pbrt(SCENES[1])
        with pytest.raises(RuntimeError):
            main([SCENES[1], "-o", str(tmp_path / "x.exr")])

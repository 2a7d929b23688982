"""`mipmap_debug` CLI: dump every pyramid level of a texture as PNGs.

Counterpart of ``fountain_tpu/cli/mipmap_debug.py``, with the same
arguments, file names and stderr lines:

    python -m fountain_tpu_torch.cli.mipmap_debug texture.png [-o outdir]

writes ``<stem>_L<k>.png`` for each mip level and ``<stem>_resampled.png``
(the power-of-two resampled base). Host-side numpy: no device is used.
"""
from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fountain-tpu-torch mipmap_debug")
    ap.add_argument("texture", help="image file (png/jpg/exr)")
    ap.add_argument("-o", "--outdir", default=".")
    args = ap.parse_args(argv)

    from fountain_tpu_torch.io.image import load_image, save_image
    from fountain_tpu_torch.shading.mipmap import build_pyramid

    img = load_image(args.texture)
    pyr = build_pyramid(img)
    stem = os.path.splitext(os.path.basename(args.texture))[0]
    os.makedirs(args.outdir, exist_ok=True)
    base = os.path.join(args.outdir, stem)
    save_image(f"{base}_resampled.png", pyr[0][::-1])
    for k, level in enumerate(pyr):
        save_image(f"{base}_L{k}.png", level[::-1])
        print(f"L{k}: {level.shape[1]}x{level.shape[0]}", file=sys.stderr)
    print(f"wrote {len(pyr)} levels to {base}_L*.png", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

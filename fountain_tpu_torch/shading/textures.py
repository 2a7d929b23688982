"""Texture evaluation over the flattened texture table (PyTorch).

Counterpart of ``fountain_tpu/shading/textures.py`` for constant, uv and
image textures. Nested (checker/scale) texture graphs are not ported yet
and raise.
"""
from __future__ import annotations

import torch

from fountain_tpu_torch.core.vecmath import V3, where3
from fountain_tpu_torch.scene.types import TEX_IMAGE, TEX_UV, Textures


def eval_texture(tex: Textures, tid, u0, v0, tex_lookup=None,
                 width=None) -> V3:
    """Evaluate texture ids [N] at (u, v) [N] -> rgb V3.

    ``tex_lookup(image_id, u, v, width) -> V3`` is supplied by the mipmap
    layer when the scene has images; ``width`` is the uv-space filter
    footprint (None = finest level)."""
    if tex.has_nested:
        raise NotImplementedError(
            "checker/scale textures are not ported to fountain_tpu_torch")
    tid = tid.clamp(0, max(tex.count - 1, 0)).to(torch.int32)
    ttype = tex.ttype[tid]
    value = tex.value[tid]
    su, sv = tex.uv_scale[tid, 0], tex.uv_scale[tid, 1]
    du, dv = tex.uv_offset[tid, 0], tex.uv_offset[tid, 1]
    u = u0 * su + du
    v = v0 * sv + dv
    out = V3(value[:, 0], value[:, 1], value[:, 2])
    uv_rgb = V3(u - torch.floor(u), v - torch.floor(v), torch.zeros_like(u))
    out = where3(ttype == TEX_UV, uv_rgb, out)
    if tex_lookup is not None:
        w = None if width is None else width * torch.maximum(su, sv)
        img = tex_lookup(tex.image_id[tid], u, v, w)
        out = where3(ttype == TEX_IMAGE, img, out)
    return out

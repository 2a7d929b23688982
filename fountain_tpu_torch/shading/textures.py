"""Texture evaluation over the flattened texture table (PyTorch).

Counterpart of ``fountain_tpu/shading/textures.py``: constant, uv and
image textures, and the checker and scale graphs over them, resolved by a
fixed walk of ``MAX_TEX_DEPTH`` levels (scene compilation makes
sub-texture ids point down the table). Every gather of the table is
``gather.gather_rows``, so the backward of the value rows is its scatter.
"""
from __future__ import annotations

import torch

from fountain_tpu_torch.core.gather import gather_rows
from fountain_tpu_torch.core.vecmath import V3, gather3, where3, zeros3
from fountain_tpu_torch.scene.types import (TEX_CHECKER, TEX_IMAGE,
                                            TEX_SCALE, TEX_UV, Textures)

# nesting depth of the texture graph that is resolved (checker of scale of
# image etc.)
MAX_TEX_DEPTH = 3


def _leaf_value(tex: Textures, tid, u0, v0, tex_lookup=None,
                width=None) -> V3:
    """Evaluate the non-nesting texture types for per-lane ids at uv."""
    ttype = gather_rows(tex.ttype, tid)
    scale = gather_rows(tex.uv_scale, tid)
    offset = gather_rows(tex.uv_offset, tid)
    su, sv = scale[:, 0], scale[:, 1]
    u = u0 * su + offset[:, 0]
    v = v0 * sv + offset[:, 1]
    out = gather3(tex.value, tid)                     # constant
    uv_rgb = V3(u - torch.floor(u), v - torch.floor(v), torch.zeros_like(u))
    out = where3(ttype == TEX_UV, uv_rgb, out)
    if tex_lookup is not None:
        w = None if width is None else width * torch.maximum(su, sv)
        img = tex_lookup(gather_rows(tex.image_id, tid), u, v, w)
        out = where3(ttype == TEX_IMAGE, img, out)
    return out


def eval_texture(tex: Textures, tid, u, v, tex_lookup=None,
                 width=None) -> V3:
    """Evaluate texture ids [N] at (u, v) [N] -> rgb V3.

    ``tex_lookup(image_id, u, v, width) -> V3`` is supplied by the mipmap
    layer when the scene has images; ``width`` is the uv-space filter
    footprint (None = finest level)."""
    if tex.count == 0:
        return zeros3(u.shape, u.device)
    tid = tid.clamp(0, tex.count - 1).to(torch.int32)
    if not tex.has_nested:
        return _leaf_value(tex, tid, u, v, tex_lookup, width)

    # checker parity: the integer lattice of the top-level texture's
    # mapped uv
    scale = gather_rows(tex.uv_scale, tid)
    offset = gather_rows(tex.uv_offset, tid)
    cu = torch.floor(u * scale[:, 0] + offset[:, 0]).to(torch.int32)
    cv = torch.floor(v * scale[:, 1] + offset[:, 1]).to(torch.int32)
    checker_first = ((cu + cv) % 2) == 0

    cur = tid
    mult = None
    for _ in range(MAX_TEX_DEPTH):
        t = gather_rows(tex.ttype, cur)
        sub_a = gather_rows(tex.sub_a, cur)
        is_scale = t == TEX_SCALE
        nxt = torch.where(t == TEX_CHECKER,
                          torch.where(checker_first, sub_a,
                                      gather_rows(tex.sub_b, cur)),
                          torch.where(is_scale, sub_a, cur))
        scale_val = where3(is_scale, gather3(tex.value, cur), 1.0)
        mult = scale_val if mult is None else mult * scale_val
        cur = nxt.to(torch.int32)
    return mult * _leaf_value(tex, cur, u, v, tex_lookup, width)

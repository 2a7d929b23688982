# Frozen copy of fountain_tpu_torch/shading/mipmap.py (commit 6354002): the benchmark's plain reference; edit never.
"""Mipmapped image atlas: host-side pyramid build + per-lane lookups.

Counterpart of ``fountain_tpu/shading/mipmap.py``: the numpy pyramid
(Lanczos-2 resample of non-pow2 images, then 2x2 box levels) concatenated
into one flat texel table, and the trilinear lookup by filter width.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from refpt.core.vecmath import V3, gather3, where3

WRAP_REPEAT = 0
WRAP_CLAMP = 1
WRAP_BLACK = 2

MAX_LEVELS = 16  # images up to 32768^2


@dataclass
class ImageAtlas:
    texels: torch.Tensor        # [T, 3] f32, all levels concatenated
    level_offset: torch.Tensor  # [I, MAX_LEVELS] int32
    level_w: torch.Tensor       # [I, MAX_LEVELS] int32
    level_h: torch.Tensor       # [I, MAX_LEVELS] int32
    n_levels: torch.Tensor      # [I] int32
    wrap: torch.Tensor          # [I] int32

    @property
    def count(self) -> int:
        return self.n_levels.shape[0]


def _lanczos(x: np.ndarray, tau: float = 2.0) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < tau, np.sinc(x) * np.sinc(x / tau), 0.0)


def _resample_axis(img: np.ndarray, new_n: int, axis: int) -> np.ndarray:
    """Separable Lanczos-2 upsample along one axis (old_n -> new_n)."""
    old_n = img.shape[axis]
    if old_n == new_n:
        return img
    x_new = (np.arange(new_n) + 0.5) * old_n / new_n
    first = np.floor(x_new - 2.0 + 0.5).astype(np.int64)
    idx = first[:, None] + np.arange(4)[None, :]        # [new_n, 4]
    w = _lanczos(x_new[:, None] - (idx + 0.5))
    wsum = w.sum(axis=1, keepdims=True)
    w = w / np.where(wsum == 0.0, 1.0, wsum)
    idx = np.clip(idx, 0, old_n - 1)
    moved = np.moveaxis(img, axis, 0)
    out = np.einsum("nk,nk...->n...", w, moved[idx])
    return np.moveaxis(out.astype(np.float32), 0, axis)


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def build_pyramid(img: np.ndarray) -> List[np.ndarray]:
    """Full mip chain for one image: pow2 resample, then 2x2 box levels."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    if (h & (h - 1)) or (w & (w - 1)):
        img = _resample_axis(img, _next_pow2(w), axis=1)
        img = _resample_axis(img, _next_pow2(h), axis=0)
        h, w = img.shape[:2]
    levels = [img]
    while h > 1 or w > 1:
        nh, nw = max(h // 2, 1), max(w // 2, 1)
        ph = levels[-1][: nh * 2 if h > 1 else nh]
        if h > 1:
            ph = (ph[0::2] + ph[1::2]) * 0.5
        if w > 1:
            ph = (ph[:, 0::2] + ph[:, 1::2]) * 0.5
        levels.append(ph.astype(np.float32))
        h, w = nh, nw
    return levels


def build_atlas(images: Sequence[np.ndarray], wraps: Sequence[int],
                device) -> Optional[ImageAtlas]:
    """Compile [H, W, 3] images into one flat mipmapped atlas."""
    if not images:
        return None
    texels = []
    offsets = np.zeros((len(images), MAX_LEVELS), np.int64)
    lw = np.ones((len(images), MAX_LEVELS), np.int64)
    lh = np.ones((len(images), MAX_LEVELS), np.int64)
    nlev = np.zeros((len(images),), np.int64)
    cursor = 0
    for i, img in enumerate(images):
        pyr = build_pyramid(img)
        nlev[i] = len(pyr)
        for li, level in enumerate(pyr):
            offsets[i, li] = cursor
            lh[i, li], lw[i, li] = level.shape[:2]
            texels.append(level.reshape(-1, 3))
            cursor += level.shape[0] * level.shape[1]
        offsets[i, len(pyr):] = offsets[i, len(pyr) - 1]
    i32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32,
                                    device=device)
    return ImageAtlas(
        texels=torch.as_tensor(np.concatenate(texels), device=device),
        level_offset=i32(offsets), level_w=i32(lw), level_h=i32(lh),
        n_levels=i32(nlev), wrap=i32(list(wraps)))


def _wrap_coord(c, n, wrap):
    """Integer texel coordinate wrap; `ok` is False for Black-mode outside."""
    inside = (c >= 0) & (c < n)
    rep = torch.remainder(c, n.clamp_min(1))
    clamped = torch.minimum(torch.maximum(c, torch.zeros_like(c)), n - 1)
    idx = torch.where(wrap == WRAP_REPEAT, rep, clamped)
    ok = torch.where(wrap == WRAP_BLACK, inside, True)
    return idx, ok


def _bilerp_level(atlas: ImageAtlas, image_id, level, u, v) -> V3:
    """Bilinear fetch at one mip level (all arguments per lane)."""
    nl = atlas.n_levels[image_id]
    level = torch.minimum(torch.maximum(level, torch.zeros_like(level)),
                          nl - 1)
    flat = image_id * MAX_LEVELS + level
    off = atlas.level_offset.reshape(-1)[flat]
    w = atlas.level_w.reshape(-1)[flat]
    h = atlas.level_h.reshape(-1)[flat]
    wrap = atlas.wrap[image_id]

    s = u * w.to(torch.float32) - 0.5
    t = v * h.to(torch.float32) - 0.5
    s0 = torch.floor(s).to(torch.int32)
    t0 = torch.floor(t).to(torch.int32)
    ds = s - s0
    dt = t - t0

    def texel(si, ti):
        xi, okx = _wrap_coord(si, w, wrap)
        yi, oky = _wrap_coord(ti, h, wrap)
        return where3(okx & oky,
                      gather3(atlas.texels, off + yi * w + xi), 0.0)

    return (texel(s0, t0) * ((1 - ds) * (1 - dt))
            + texel(s0, t0 + 1) * ((1 - ds) * dt)
            + texel(s0 + 1, t0) * (ds * (1 - dt))
            + texel(s0 + 1, t0 + 1) * (ds * dt))


def lookup_trilinear(atlas: ImageAtlas, image_id, u, v, width=None) -> V3:
    """Trilinear (width-selected mip level) lookup. ``width``: per-lane
    filter width in uv space (None => finest level)."""
    image_id = image_id.clamp(0, atlas.count - 1).to(torch.int32)
    if width is None:
        return _bilerp_level(atlas, image_id, torch.zeros_like(image_id),
                             u, v)
    nl = atlas.n_levels[image_id].to(torch.float32)
    width = width.clamp_min(1e-8)
    lvl = nl - 1.0 + torch.log2(width)
    lvl = torch.minimum(torch.maximum(lvl, torch.zeros_like(lvl)), nl - 1.0)
    l0 = torch.floor(lvl).to(torch.int32)
    dl = lvl - l0.to(torch.float32)
    a = _bilerp_level(atlas, image_id, l0, u, v)
    b = _bilerp_level(atlas, image_id, l0 + 1, u, v)
    return a * (1.0 - dl) + b * dl

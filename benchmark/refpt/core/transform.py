# Frozen copy of fountain_tpu_torch/core/transform.py (commit 6354002): the benchmark's plain reference; edit never.
"""4x4 affine transforms with cached inverses (PyTorch, host-side).

Counterpart of the parts of ``fountain_tpu/core/transform.py`` that the
camera and the sphere tables use. Camera matrices are small f32 CPU
tensors built with the same f32 operation order as the JAX package;
inverses are taken in float64 on the host. Applying a shared matrix to a
wavefront reads its 16 entries as Python floats (exact for f32 values),
so the per-lane work is 9-12 fused multiply-adds on whatever device the
vectors live. Per-sphere or per-lane matrices ([..., 4, 4] on the
device) apply to [..., 3] arrays with broadcasting (``transform_points``
and its siblings), as the JAX package's batched transforms do.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from refpt.core.vecmath import V3, gamma

Float = torch.float32


def _inv(m: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.linalg.inv(m.numpy().astype(np.float64)),
                           dtype=Float)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    len2 = torch.sum(v * v, dim=-1)
    inv = torch.where(len2 > 0.0,
                      torch.reciprocal(torch.sqrt(len2.clamp_min(1e-30))),
                      0.0)
    return v * inv


@dataclass
class Transform:
    """m maps object->target space; m_inv is its cached inverse."""
    m: torch.Tensor      # [4, 4] f32, CPU
    m_inv: torch.Tensor  # [4, 4] f32, CPU

    @property
    def inverse(self) -> "Transform":
        return Transform(self.m_inv, self.m)

    def __matmul__(self, other: "Transform") -> "Transform":
        return Transform(self.m @ other.m, other.m_inv @ self.m_inv)


def translate(delta) -> Transform:
    delta = torch.as_tensor(delta, dtype=Float)
    m = torch.eye(4, dtype=Float)
    mi = torch.eye(4, dtype=Float)
    m[:3, 3] = delta
    mi[:3, 3] = -delta
    return Transform(m, mi)


def scale(sx, sy, sz) -> Transform:
    s = torch.tensor([sx, sy, sz, 1.0], dtype=Float)
    return Transform(torch.diag(s), torch.diag(1.0 / s))


def look_at(eye, look, up) -> Transform:
    """Camera-to-world from LookAt (PBRT convention: +z towards `look`)."""
    eye = torch.as_tensor(eye, dtype=Float)
    look = torch.as_tensor(look, dtype=Float)
    up = torch.as_tensor(up, dtype=Float)
    direction = _normalize(look - eye)
    right = _normalize(torch.linalg.cross(_normalize(up), direction))
    new_up = torch.linalg.cross(direction, right)
    zero, one = torch.zeros(1, dtype=Float), torch.ones(1, dtype=Float)
    m = torch.stack([torch.cat([right, zero]), torch.cat([new_up, zero]),
                     torch.cat([direction, zero]), torch.cat([eye, one])],
                    dim=-1)
    return Transform(m, _inv(m))


def perspective(fov_deg, near, far) -> Transform:
    """Perspective projection: z mapped to [0,1] over [near,far], x/y
    scaled by 1/tan(fov/2)."""
    fov = torch.deg2rad(torch.tensor(fov_deg, dtype=Float))
    inv_tan = 1.0 / torch.tan(fov / 2.0)
    persp = torch.tensor([
        [1.0, 0.0, 0.0, 0.0],
        [0.0, 1.0, 0.0, 0.0],
        [0.0, 0.0, far / (far - near), -far * near / (far - near)],
        [0.0, 0.0, 1.0, 0.0],
    ], dtype=Float)
    diag = torch.stack([inv_tan, inv_tan, torch.tensor(1.0),
                        torch.tensor(1.0)]).to(Float)
    m = torch.diag(diag) @ persp
    return Transform(m, _inv(m))


def transform_point(t: Transform, p: torch.Tensor) -> torch.Tensor:
    """Apply to one [3] point (host-side camera setup)."""
    m = t.m
    out = m[:3, :3] @ p + m[:3, 3]
    hw = m[3, :3] @ p + m[3, 3]
    return out / torch.where(hw == 0.0, 1.0, hw)


def transform_point_v3(t: Transform, p: V3) -> V3:
    m = t.m.tolist()
    x = m[0][0] * p.x + m[0][1] * p.y + m[0][2] * p.z + m[0][3]
    y = m[1][0] * p.x + m[1][1] * p.y + m[1][2] * p.z + m[1][3]
    z = m[2][0] * p.x + m[2][1] * p.y + m[2][2] * p.z + m[2][3]
    hw = m[3][0] * p.x + m[3][1] * p.y + m[3][2] * p.z + m[3][3]
    inv = 1.0 / torch.where(hw == 0.0, 1.0, hw)
    return V3(x * inv, y * inv, z * inv)


def transform_vector_v3(t: Transform, v: V3) -> V3:
    m = t.m.tolist()
    return V3(m[0][0] * v.x + m[0][1] * v.y + m[0][2] * v.z,
              m[1][0] * v.x + m[1][1] * v.y + m[1][2] * v.z,
              m[2][0] * v.x + m[2][1] * v.y + m[2][2] * v.z)


# --- batched matrices ([..., 4, 4], broadcast against [..., 3] arrays) ----


def _apply(m: torch.Tensor, v: torch.Tensor, w: float) -> torch.Tensor:
    """The affine part of m applied to [..., 3] with homogeneous coord w."""
    out = (m[..., :3, :3] * v[..., None, :]).sum(-1)
    if w != 0.0:
        out = out + m[..., :3, 3]
        hw = (m[..., 3, :3] * v).sum(-1) + m[..., 3, 3]
        out = out / torch.where(hw == 0.0, 1.0, hw)[..., None]
    return out


def transform_points(t: Transform, p: torch.Tensor) -> torch.Tensor:
    return _apply(t.m, p, 1.0)


def transform_vectors(t: Transform, v: torch.Tensor) -> torch.Tensor:
    return _apply(t.m, v, 0.0)


def transform_normals(t: Transform, n: torch.Tensor) -> torch.Tensor:
    """Normals transform by the inverse transpose."""
    return (t.m_inv[..., :3, :3].transpose(-1, -2) * n[..., None, :]).sum(-1)


def transform_points_with_input_error(t: Transform, p: torch.Tensor,
                                      p_err: torch.Tensor):
    """Transformed points with their propagated absolute error."""
    pt = transform_points(t, p)
    abs_m = t.m[..., :3, :].abs()
    err_in = (gamma(3) + 1.0) * (abs_m[..., :3] * p_err[..., None, :]).sum(-1)
    abs_term = (abs_m[..., :3] * p.abs()[..., None, :]).sum(-1) \
        + abs_m[..., 3]
    return pt, err_in + gamma(3) * abs_term


def from_matrix(m) -> Transform:
    """A Transform of a [4, 4] matrix, its inverse taken in float64."""
    m = torch.as_tensor(np.asarray(m, np.float32))
    return Transform(m, _inv(m))

"""Batched 3-vector math and floating-point error bounds (PyTorch).

Counterpart of ``fountain_tpu/core/vecmath.py``. Vectors stay
component-SoA: a ``V3`` is three flat ``[N]`` tensors, so the public
signatures compare one to one with the JAX package's.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from fountain_tpu_torch.core.gather import gather_rows

Float = torch.float32

# Machine epsilon / 2 for f32 (= 2^-24), as used by the error bounds.
MACHINE_EPSILON = 2.0 ** -24
# Shadow-ray clipping epsilon.
SHADOW_EPSILON = 1e-4
PI = 3.14159265358979323846
INV_PI = 1.0 / PI
PI_OVER_2 = PI / 2.0
PI_OVER_4 = PI / 4.0


@dataclass
class V3:
    """Wavefront 3-vector: three flat [N] tensors (x, y, z)."""
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __iter__(self):
        return iter((self.x, self.y, self.z))

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    @property
    def shape(self):
        return self.x.shape

    def stack(self) -> torch.Tensor:
        """Dense [N, 3] view (film/IO boundary only)."""
        return torch.stack(torch.broadcast_tensors(self.x, self.y, self.z),
                           dim=-1)

    def max_component(self):
        return torch.maximum(torch.maximum(self.x, self.y), self.z)

    def abs(self) -> "V3":
        return V3(self.x.abs(), self.y.abs(), self.z.abs())

    def any_positive(self):
        return (self.x > 0.0) | (self.y > 0.0) | (self.z > 0.0)

    def any_nonzero(self):
        return (self.x != 0.0) | (self.y != 0.0) | (self.z != 0.0)


_CONSTS = {}


def const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A cached 0-dim tensor of ``value`` on ``like``'s device and dtype
    (a binary op's operand without a fill launch). While a CUDA graph is
    captured, where no copy from the host can run, a value not cached yet
    is a fill in the graph instead, and stays uncached."""
    key = (value, like.device, like.dtype)
    c = _CONSTS.get(key)
    if c is None:
        if like.is_cuda and torch.cuda.is_current_stream_capturing():
            return torch.full((), value, dtype=like.dtype,
                              device=like.device)
        c = _CONSTS[key] = torch.tensor(value, dtype=like.dtype,
                                        device=like.device)
    return c


def maximum(x: torch.Tensor, c: float) -> torch.Tensor:
    """max(x, c) with the JAX package's gradient at a tie x == c (one
    half, as jnp.maximum; ``clamp_min`` passes all of it). For the clamps
    whose bound the argument reaches exactly (|cos| = 1, |x / s| = 1),
    where attached sampling differentiates them."""
    return torch.maximum(x, const(c, x))


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip: ``clamp`` with one half of the gradient at either bound."""
    return torch.minimum(torch.maximum(x, const(lo, x)), const(hi, x))


class _Sqrt0(torch.autograd.Function):
    """sqrt(max(x, 0)) with a zero gradient where x <= 0. The plain form's
    backward at x == 0 is a cotangent times sqrt's infinite slope: NaN
    when that cotangent is a masked zero, which a full-width wave meets
    (a ray tangent to a sphere, a half vector whose cos rounds to 1, a
    refraction at the critical angle). The value, and the gradient where
    x > 0, are the plain form's."""

    @staticmethod
    def forward(ctx, x):
        y = torch.sqrt(x.clamp_min(0.0))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return torch.where(y > 0.0, g / (2.0 * y), 0.0)


def sqrt0(x: torch.Tensor) -> torch.Tensor:
    return _Sqrt0.apply(x)


def zeros3(shape, device) -> V3:
    z = torch.zeros(shape, dtype=Float, device=device)
    return V3(z, z, z)


def gather3(table: torch.Tensor, idx) -> V3:
    """Rows ``idx`` [N] of an [R, 3] table as a V3, by ``gather_rows``
    (``index_select``; on a card under autograd its backward is the
    ``scatter_rows`` kernel; a ``table[idx]`` gather's backward would be
    an accumulating ``index_put_`` that serialises duplicate indices)."""
    r = gather_rows(table, idx)
    return V3(r[:, 0], r[:, 1], r[:, 2])


def where3(mask, a, b) -> V3:
    """Per-lane select between V3s (mask [N]; a/b V3 or scalar)."""
    ax, ay, az = (a.x, a.y, a.z) if isinstance(a, V3) else (a, a, a)
    bx, by, bz = (b.x, b.y, b.z) if isinstance(b, V3) else (b, b, b)
    return V3(torch.where(mask, ax, bx), torch.where(mask, ay, by),
              torch.where(mask, az, bz))


def gamma(n) -> float:
    """Conservative relative error bound for n chained fp ops."""
    ne = n * MACHINE_EPSILON
    return ne / (1.0 - ne)


def dot(a: V3, b: V3) -> torch.Tensor:
    return a.x * b.x + a.y * b.y + a.z * b.z


def absdot(a: V3, b: V3) -> torch.Tensor:
    return dot(a, b).abs()


def cross(a: V3, b: V3) -> V3:
    return V3(a.y * b.z - a.z * b.y,
              a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x)


def length(v: V3) -> torch.Tensor:
    return torch.sqrt(dot(v, v))


def normalize(v: V3) -> V3:
    """Normalize; 0-length vectors map to 0."""
    len2 = dot(v, v)
    inv = torch.where(len2 > 0.0,
                      torch.reciprocal(torch.sqrt(len2.clamp_min(1e-30))),
                      0.0)
    return v * inv


def coordinate_system(v1: V3):
    """Orthonormal basis (v1, v2, v3) from a unit vector v1 (branch-free)."""
    x, y, z = v1
    use_x = x.abs() > y.abs()
    inv_a = torch.reciprocal(torch.sqrt(
        torch.where(use_x, x * x + z * z, y * y + z * z)))
    zero = torch.zeros_like(x)
    v2 = where3(use_x, V3(-z * inv_a, zero, x * inv_a),
                V3(zero, z * inv_a, -y * inv_a))
    return v1, v2, cross(v1, v2)


class _NextFloat(torch.autograd.Function):
    """``nextafter`` with an identity tangent (its derivative is 1 almost
    everywhere), as the JAX package's custom_jvp: PyTorch releases before
    2.12 define no derivative for it."""

    @staticmethod
    def forward(ctx, x, toward: float):
        return torch.nextafter(x, const(toward, x))

    @staticmethod
    def backward(ctx, g):
        return g, None


def next_float_up(x: torch.Tensor) -> torch.Tensor:
    return _NextFloat.apply(x, float("inf"))


def next_float_down(x: torch.Tensor) -> torch.Tensor:
    return _NextFloat.apply(x, float("-inf"))


def offset_ray_origin(p: V3, p_err: V3, n: V3, w: V3) -> V3:
    """Offset a spawned ray's origin along the normal past the error bound,
    then round each component away from p."""
    d = dot(n.abs(), p_err)
    offset = n * torch.where(dot(w, n) < 0.0, -d, d)

    def bump(po, off):
        return torch.where(off > 0.0, next_float_up(po),
                           torch.where(off < 0.0, next_float_down(po), po))
    po = p + offset
    return V3(bump(po.x, offset.x), bump(po.y, offset.y),
              bump(po.z, offset.z))


def refract(wi: V3, n: V3, eta):
    """Refract ``wi`` about ``n`` with relative IOR eta = eta_i / eta_t.
    Returns (wt, valid); valid is False on total internal reflection."""
    cos_theta_i = dot(n, wi)
    sin2_theta_i = (1.0 - cos_theta_i * cos_theta_i).clamp_min(0.0)
    sin2_theta_t = eta * eta * sin2_theta_i
    valid = sin2_theta_t < 1.0
    cos_theta_t = sqrt0(1.0 - sin2_theta_t)
    return (-wi) * eta + n * (eta * cos_theta_i - cos_theta_t), valid

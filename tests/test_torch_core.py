"""Port parity: core numerics (RNG, vecmath, sampling) and the device rule.

Inputs are made with numpy from a seed and go through the JAX function and
its counterpart in fountain_tpu_torch on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fountain_tpu.core import rng as jrng
from fountain_tpu.core import sampling as jsam
from fountain_tpu.core import vecmath as jvm
from fountain_tpu_torch.core import rng as trng
from fountain_tpu_torch.core import sampling as tsam
from fountain_tpu_torch.core import vecmath as tvm
from fountain_tpu_torch.device import resolve_device


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_uniform4_bit_exact_including_high_counters():
    """Tolerance: none, the RNG must match bit for bit."""
    r = np.random.default_rng(0)
    n = 4096
    lane = r.integers(0, 2 ** 32, n, dtype=np.uint64)
    sample = r.integers(0, 2 ** 32, n, dtype=np.uint64)
    dim = r.integers(0, 2 ** 32, n, dtype=np.uint64)
    lane[:8] = [0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1, 2 ** 31 + 7, 5, 9]
    assert (lane >= 2 ** 31).sum() > 100
    for seed in (0, 3, 2 ** 31 + 11):
        ju = jrng.uniform4(jnp.asarray(lane.astype(np.uint32)),
                           jnp.asarray(sample.astype(np.uint32)),
                           jnp.asarray(dim.astype(np.uint32)),
                           jnp.uint32(seed))
        tu = trng.uniform4(_t(lane.astype(np.int64)),
                           _t(sample.astype(np.int64)),
                           _t(dim.astype(np.int64)), seed)
        for a, b in zip(ju, tu):
            np.testing.assert_array_equal(
                np.asarray(a).view(np.uint32), b.numpy().view(np.uint32))
        jh = jrng.pcg4d(lane.astype(np.uint32), sample.astype(np.uint32),
                        dim.astype(np.uint32), np.uint32(seed))
        th = trng.pcg4d(_t(lane.astype(np.int64)),
                        _t(sample.astype(np.int64)),
                        _t(dim.astype(np.int64)), seed)
        for a, b in zip(jh, th):
            np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                          b.numpy())


def test_uniform4_int32_counters_wrap_like_astype():
    """Negative int32 counters (the bit patterns of values >= 2^31) and a
    python-int dimension: bit-exact."""
    lane = np.arange(-600, 600, dtype=np.int32) * 3_000_001
    sample = np.full_like(lane, 7)
    ju = jrng.uniform4(jnp.asarray(lane), jnp.asarray(sample), 1 << 20, 5)
    tu = trng.uniform4(_t(lane), _t(sample), 1 << 20, 5)
    for a, b in zip(ju, tu):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _rand_v3(r, n, scale=1.0):
    a = (r.normal(size=(n, 3)) * scale).astype(np.float32)
    return a, jvm.V3(*[jnp.asarray(a[:, k]) for k in range(3)]), \
        tvm.V3(*[_t(a[:, k]) for k in range(3)])


def _close(j, t, rtol=1e-6, atol=1e-6):
    if isinstance(j, jvm.V3):
        for a, b in zip(j, t):
            np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=rtol,
                                       atol=atol)
    else:
        np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=rtol,
                                   atol=atol)


def test_vecmath_frames_and_offsets():
    """Tolerance: 1e-6 (f32 elementwise; transcendental-free)."""
    r = np.random.default_rng(1)
    n = 2000
    _, jv, tv = _rand_v3(r, n)
    _, jp, tp = _rand_v3(r, n, 10.0)
    _, je, te = _rand_v3(r, n, 1e-5)
    je, te = je.abs(), te.abs()
    _close(jvm.normalize(jv), tvm.normalize(tv))
    jn, tn = jvm.normalize(jv), tvm.normalize(tv)
    for a, b in zip(jvm.coordinate_system(jn), tvm.coordinate_system(tn)):
        _close(a, b)
    _close(jvm.cross(jv, jp), tvm.cross(tv, tp), atol=1e-5)
    # next_float_up/down and the error-bound offset are exact
    _close(jvm.offset_ray_origin(jp, je, jn, jv),
           tvm.offset_ray_origin(tp, te, tn, tv), rtol=0, atol=0)
    assert tvm.gamma(3) == jvm.gamma(3)
    assert tvm.SHADOW_EPSILON == jvm.SHADOW_EPSILON


def test_sampling_warps_and_power_heuristic():
    """Tolerance: 1e-6 rtol/atol (sin/cos differ by an ulp between
    backends)."""
    r = np.random.default_rng(2)
    u1, u2 = r.random(5000).astype(np.float32), \
        r.random(5000).astype(np.float32)
    u1[:3] = [0.5, 0.0, 0.999999]
    u2[:3] = [0.5, 0.0, 0.25]
    ju1, ju2, tu1, tu2 = jnp.asarray(u1), jnp.asarray(u2), _t(u1), _t(u2)
    for a, b in zip(jsam.concentric_sample_disk(ju1, ju2),
                    tsam.concentric_sample_disk(tu1, tu2)):
        _close(a, b)
    _close(jsam.cosine_sample_hemisphere(ju1, ju2),
           tsam.cosine_sample_hemisphere(tu1, tu2))
    _close(jsam.uniform_sample_sphere(ju1, ju2),
           tsam.uniform_sample_sphere(tu1, tu2))
    pa, pb = r.random(5000).astype(np.float32), \
        r.random(5000).astype(np.float32)
    pa[:2] = 0.0
    pb[:1] = 0.0
    _close(jsam.power_heuristic(1, jnp.asarray(pa), 1, jnp.asarray(pb)),
           tsam.power_heuristic(1, _t(pa), 1, _t(pb)))


def test_env_alias_tables_and_sampling():
    """Host tables equal; per-lane samples and pdfs within 1e-6 (f32
    elementwise)."""
    r = np.random.default_rng(3)
    funcs = [r.random((8, 16)) * (r.random((8, 16)) > 0.3),
             np.zeros((8, 16))]
    ja = jsam.make_env_alias_stack(funcs)
    ta = tsam.make_env_alias_stack(funcs, "cpu")
    for a, b in zip(ja, (ta.prob, ta.alias, ta.func, ta.func_mean)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    n = 4000
    slot = r.integers(0, 2, n).astype(np.int32)
    u1, u2 = r.random(n).astype(np.float32), r.random(n).astype(np.float32)
    js = jsam.sample_env_alias(ja, jnp.asarray(slot), jnp.asarray(u1),
                               jnp.asarray(u2))
    ts_ = tsam.sample_env_alias(ta, _t(slot), _t(u1), _t(u2))
    for a, b in zip(js, ts_):
        _close(a, b)
    _close(jsam.pdf_env_alias(ja, jnp.asarray(slot), js[0], js[1]),
           tsam.pdf_env_alias(ta, _t(slot), ts_[0], ts_[1]))


def test_device_rule_raises_without_card():
    """Entry points default to cuda and raise when there is no card."""
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)
        with pytest.raises(RuntimeError):
            resolve_device("cuda")


def test_jax_stays_on_cpu():
    assert jax.devices()[0].platform == "cpu"

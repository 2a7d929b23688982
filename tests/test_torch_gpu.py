"""Tests of the port that need an NVIDIA card (marker ``gpu``).

They skip without one. This file imports no JAX, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""
import numpy as np
import pytest
import torch

from fountain_tpu_torch.core.vecmath import V3
from fountain_tpu_torch.geometry import tri_sweep as ts

T_RTOL = 3e-5   # f32 dots summed in another order than the plain matmul


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _random_case(n_tris, n_rays, seed):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-10, 10, (n_tris, 3)).astype(np.float32)
    tv = np.stack([v0, v0 + rng.uniform(-1, 1, (n_tris, 3)),
                   v0 + rng.uniform(-1, 1, (n_tris, 3))], 1)
    o = rng.uniform(-12, 12, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    cuda = lambda a: V3(*[torch.as_tensor(a[:, k].copy(), device="cuda")
                          for k in range(3)])                  # noqa: E731
    return tv.astype(np.float32), cuda(o), cuda(d)


@pytest.mark.gpu
def test_kernels_match_plain_on_card(monkeypatch):
    """Both kernels equal their plain versions (hit masks and idx equal, t
    within rtol 3e-5, any-hit equal), count their launches, and a CUDA
    tensor never reaches the plain version."""
    _card()
    tv, o, d = _random_case(1024 + 3 * 128 + 17, 1024, 7)
    table = ts.pack_sweep_table(tv, "cuda")
    cap = torch.full((1024,), 3e38, device="cuda")
    tp, ip = ts.closest_hit_plain(table, o, d, cap)
    occ_p = ts.any_hit_plain(table, o, d, cap)

    def refuse(*a, **k):
        raise AssertionError("plain version called on CUDA tensors")
    monkeypatch.setattr(ts, "closest_hit_plain", refuse)
    monkeypatch.setattr(ts, "any_hit_plain", refuse)
    ts.reset_launch_counts()
    t, idx, ok = ts.mt_intersect_kernel(table, o, d, cap)
    _, _, occ = ts.mt_intersect_kernel(table, o, d, cap, any_hit=True)
    torch.cuda.synchronize()
    assert ts.launch_counts == {"tri_sweep_closest": 1, "tri_sweep_any": 1}
    m = (ip >= 0).cpu()
    assert m.sum() > 50
    np.testing.assert_array_equal(ok.cpu(), m)
    np.testing.assert_array_equal(idx.cpu()[m], ip.cpu()[m])
    np.testing.assert_allclose(t.cpu()[m], tp.cpu()[m], rtol=T_RTOL)
    np.testing.assert_array_equal(occ.cpu(), occ_p.cpu())


@pytest.mark.gpu
def test_wrapper_refuses_malformed_input():
    _card()
    tv, o, d = _random_case(200, 256, 3)
    table = ts.pack_sweep_table(tv, "cuda")
    cap = torch.full((256,), 3e38, device="cuda")
    with pytest.raises(ValueError):          # rays on two devices
        ts.closest_hit_kernel(table, V3(o.x.cpu(), o.y, o.z), d, cap)
    with pytest.raises(ValueError):          # table on another device
        ts.closest_hit_kernel(ts.pack_sweep_table(tv, "cpu"), o, d, cap)

"""The ``scatter_rows`` kernel (``csrc/scatter_rows.cu``, the backward of
``gather.gather_rows`` on a card) against float64 ``index_add_``, its
statistics, and the flagship step that runs it (marker ``gpu``; skips
without a card). This file imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gather_gpu.py -q
"""
import pytest
import torch

from fountain_tpu_torch import bench
from fountain_tpu_torch.core import gather
from fountain_tpu_torch.integrator import path, regen_graph
from test_torch_graph_gpu import _assert_step_close, _plain_wave

RTOL = 1e-5          # float atomics sum in another order than index_add_
FLAGSHIP_RES = 32


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


# the flagship step's scatters: lanes, table shape, share of non-zero rows,
# and the rows the lanes index (None: every row alike)
SHAPES = {
    "atlas": (262_144, (131_072, 3), 0.01, None),
    "values_one_row": (262_144, (13, 3), 1.0, 0),
    "values_sparse": (262_144, (13, 3), 0.005, None),
    "shading": (262_144, (4, 96), 0.022, None),
}


def _inputs(case, dtype, dyadic, seed=0):
    """(grad, idx, shape): a share of non-zero rows, the rest +-0; values
    k / 64 where ``dyadic`` (every sum exact in float32), else in
    [0.5, 1.5)."""
    n, shape, share, row = SHAPES[case]
    g = torch.Generator(device="cuda").manual_seed(seed)
    cols = shape[1:]
    if dyadic:
        grad = torch.randint(-64, 65, (n, *cols), generator=g,
                             device="cuda").float() / 64
    else:
        grad = torch.rand((n, *cols), generator=g, device="cuda") + 0.5
    keep = torch.rand(n, generator=g, device="cuda") < share
    grad = torch.where(keep[:, None], grad, torch.where(
        torch.rand(n, 1, generator=g, device="cuda") < 0.5, -0.0, 0.0))
    if row is None:
        idx = torch.randint(0, shape[0], (n,), generator=g, device="cuda")
    else:
        idx = torch.full((n,), row, device="cuda")
    return grad, idx.to(dtype), shape


def _reference(grad, idx, shape):
    return torch.zeros(shape, dtype=torch.float64, device="cuda").index_add_(
        0, idx, grad.double())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64],
                         ids=["int32", "int64"])
@pytest.mark.parametrize("case", list(SHAPES))
@pytest.mark.parametrize("dyadic", [False, True], ids=["uniform", "exact"])
def test_scatter_rows_equals_float64_index_add(case, dtype, dyadic):
    _card()
    grad, idx, shape = _inputs(case, dtype, dyadic)
    gather.reset_launch_counts()
    got = gather.scatter_rows(grad, idx, shape)
    torch.cuda.synchronize()
    want = _reference(grad, idx, shape)
    shared = shape[0] * shape[1] * 4 <= gather.SHARED_BYTES
    assert gather.launch_counts == {"scatter_rows_shared": int(shared),
                                    "scatter_rows_global": int(not shared)}
    if dyadic:
        assert torch.equal(got.double(), want)
    else:
        torch.testing.assert_close(got.double(), want, rtol=RTOL, atol=0.0)
    assert not (got.eq(0) & got.signbit()).any()    # no -0.0


def _merged_atomics(grad, idx, shape) -> int:
    """Atomic adds of the global path: for each warp's 32 lanes, each index
    its non-zero lanes share, each column whose sum is not zero (exact for
    dyadic values)."""
    n, c = grad.shape[0], shape[1]
    nz = grad.ne(0).any(1)
    key = (torch.arange(n, device="cuda") // 32) * shape[0] + idx.long()
    sums = torch.zeros((-(-n // 32) * shape[0], c), dtype=torch.float64,
                       device="cuda").index_add_(0, key[nz],
                                                 grad[nz].double())
    return int(sums.ne(0).sum())


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(SHAPES))
def test_statistics_count_the_lanes_and_atomics(case):
    _card()
    grad, idx, shape = _inputs(case, torch.int32, dyadic=True, seed=7)
    stats = torch.zeros(3, dtype=torch.int64, device="cuda")
    gather.scatter_rows(grad, idx, shape, stats=stats)
    lanes, nonzero, atomics = stats.tolist()
    assert lanes == grad.shape[0]
    assert nonzero == int(grad.ne(0).any(1).sum())
    merged = _merged_atomics(grad, idx, shape)
    if shape[0] * shape[1] * 4 <= gather.SHARED_BYTES:
        # shared adds, then each block's flush of its non-zero entries
        blocks = torch.cuda.get_device_properties(0).multi_processor_count * 2
        assert merged < atomics <= merged + blocks * shape[0] * shape[1]
    else:
        assert atomics == merged


@pytest.mark.gpu
def test_captured_flagship_backward_equals_the_eager_one(monkeypatch):
    """The flagship step through the graphed wave (the kernel captured in
    its backward graph; a recording step, then replays) against the plain
    loop whose gathers' backward is ``index_add_``: the loss to the bit,
    each gradient within the graph tests' GRAD_RTOL (1e-5)."""
    _card()
    scene, cam = bench.build_flagship("cuda", film_res=FLAGSHIP_RES)
    seeds = (2_000_000_021, 6, 2 ** 31 + 11)
    got = [bench.flagship_step(scene, cam, FLAGSHIP_RES, s) for s in seeds]
    monkeypatch.setattr(path, "_graphed_wave", _plain_wave)
    monkeypatch.setattr(gather, "scatter_rows", lambda g, i, shape: torch
                        .zeros(shape, device=g.device).index_add_(0, i, g))
    for g, s in zip(got, seeds):
        _assert_step_close(g, bench.flagship_step(scene, cam, FLAGSHIP_RES,
                                                  s))


@pytest.mark.gpu
def test_flagship_step_launches_the_kernel():
    """A fresh recording of the flagship step launches the kernel once for
    each differentiable gather (624 into the texel atlas, global; 198 into
    the texture values and 6 into the shading table, shared); its replays
    launch nothing from the host."""
    _card()
    torch.cuda.synchronize()
    regen_graph._HELD.clear()
    scene, cam = bench.build_flagship("cuda", film_res=FLAGSHIP_RES)
    gather.reset_launch_counts()
    path.reset_graph_counts()
    bench.flagship_step(scene, cam, FLAGSHIP_RES, 3)
    want = {"scatter_rows_shared": 204, "scatter_rows_global": 624}
    assert gather.launch_counts == want
    bench.flagship_step(scene, cam, FLAGSHIP_RES, 4)
    assert gather.launch_counts == want
    counts = path.graph_counts()
    assert (counts["wave_captures"], counts["wave_replays"]) == (1, 1)

"""``core/gather.py`` on the CPU: the row gather of tables that may require
grad, its dispatch, and the plain version of its scatter kernel (the
kernel itself: ``tests/test_torch_gather_gpu.py``). Imports no JAX."""
import pytest
import torch

from fountain_tpu_torch.core import gather


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _table(rows, *cols, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(rows, *cols, generator=g)


def _dyadic(n, *cols, seed=1):
    """Values k / 64 with |k| <= 64: every sum of a few thousand of them is
    exact in float32, so a sum's order cannot change its bits."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-64, 65, (n, *cols), generator=g).float() / 64


# table shape, index length, index dtype
GATHERS = {
    "texels_c3_int32": ((512, 3), 2048, torch.int32),
    "values_c3_int64": ((13, 3), 777, torch.int64),
    "shading_c96": ((4, 96), 300, torch.int32),
    "column_c1": ((40,), 129, torch.int64),
}


@pytest.mark.parametrize("case", list(GATHERS))
def test_cpu_gather_is_index_select_forward_and_backward(case):
    shape, n, dtype = GATHERS[case]
    g = torch.Generator().manual_seed(3)
    idx = torch.randint(0, shape[0], (n,), generator=g, dtype=dtype)
    upstream = torch.randn(n, *shape[1:], generator=g)
    a = _table(*shape).requires_grad_(True)
    b = a.detach().clone().requires_grad_(True)
    out = gather.gather_rows(a, idx)
    ref = torch.index_select(b, 0, idx)
    assert torch.equal(out, ref)
    assert type(out.grad_fn) is type(ref.grad_fn)    # index_select's own
    (out * upstream).sum().backward()
    (ref * upstream).sum().backward()
    assert torch.equal(a.grad, b.grad)


@pytest.mark.parametrize("mode", ["no_grad", "table_without_grad"])
def test_gather_without_autograd_builds_no_node(mode):
    table = _table(13, 3)
    idx = torch.tensor([0, 12, 5, 5], dtype=torch.int32)
    if mode == "no_grad":
        table.requires_grad_(True)
        with torch.no_grad():
            out = gather.gather_rows(table, idx)
    else:
        out = gather.gather_rows(table, idx)
    assert out.grad_fn is None and not out.requires_grad
    assert torch.equal(out, torch.index_select(table.detach(), 0, idx))


@pytest.mark.parametrize("case", list(GATHERS))
def test_autograd_function_saves_the_index_only(case):
    """``_GatherRows`` (the card's path) run on CPU tensors: its forward is
    ``index_select`` to the bit, it saves the index and not the table, and
    its backward (here the plain scatter) is ``index_add_``'s to the bit."""
    shape, n, dtype = GATHERS[case]
    g = torch.Generator().manual_seed(4)
    idx = torch.randint(0, shape[0], (n,), generator=g, dtype=dtype)
    upstream = torch.randn(n, *shape[1:], generator=g)
    upstream[::3] = 0.0
    a = _table(*shape).requires_grad_(True)
    b = a.detach().clone().requires_grad_(True)
    out = gather._GatherRows.apply(a, idx)
    ref = torch.index_select(b, 0, idx)
    assert torch.equal(out, ref)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 1 and saved[0] is idx
    (out * upstream).sum().backward()
    (ref * upstream).sum().backward()
    assert torch.equal(a.grad, b.grad)


def _edge(case, cols):
    """(grad [N, cols...], idx [N], table shape) of one edge case."""
    n, rows = 4096, 13
    grad = _dyadic(n, *cols)
    g = torch.Generator().manual_seed(5)
    idx = torch.randint(0, rows, (n,), generator=g)
    if case == "one_row":
        idx = torch.full((n,), rows - 1, dtype=torch.int64)
    elif case == "negative_zero":
        grad[::2] = -0.0
        grad[1::4] = 0.0
    elif case == "nan_inf":
        grad[::5] = 0.0
        grad[7] = float("nan")
        grad[100] = float("inf")
        grad[200] = -float("inf")
        idx[100], idx[200], idx[300] = 3, 4, 4
        grad[300] = float("inf")
    elif case == "empty":
        grad, idx = grad[:0], idx[:0]
    elif case == "sparse":
        keep = torch.rand(n, generator=g) < 0.01
        grad = grad * keep.reshape(n, *[1] * len(cols))
    return grad, idx, (rows, *cols)


@pytest.mark.parametrize("cols", [(), (1,), (3,), (96,)],
                         ids=["c1_flat", "c1", "c3", "c96"])
@pytest.mark.parametrize("case", ["one_row", "negative_zero", "nan_inf",
                                  "empty", "sparse"])
def test_plain_scatter_equals_float64_index_add(case, cols):
    grad, idx, shape = _edge(case, cols)
    got = gather.scatter_rows(grad, idx, shape)
    want = torch.zeros(shape, dtype=torch.float64).index_add_(
        0, idx, grad.double())
    assert got.dtype == torch.float32 and got.shape == shape
    assert torch.equal(got.double().nan_to_num(), want.nan_to_num())
    assert torch.equal(got.isnan(), want.isnan())
    # -0.0 rows are left out; index_add_ of -0.0 into +0.0 reads +0.0 too
    assert torch.equal(got.signbit(), want.signbit())


def test_scatter_counts_statistics_only_on_a_card():
    with pytest.raises(ValueError):
        gather.scatter_rows(torch.ones(2, 3), torch.zeros(2, dtype=torch.long),
                            (1, 3), stats=torch.zeros(3, dtype=torch.int64))

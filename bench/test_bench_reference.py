"""The plain references against small hand-worked answers: the NumPy
dataframe reference and its comparison, and the float32 Mamba-2's chunked
SSD against the recurrence it stands for."""
import sys
from collections import namedtuple
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness import frame_ref, mamba_ref  # noqa: E402

T = namedtuple("T", "columns dictionaries")


def _tables():
    li = {"l_orderkey": np.array([1, 1, 2, 3, 3, 3]),
          "l_quantity": np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0]),
          "l_flag": np.array([0, 1, 0, 1, 1, 0], dtype=np.int32)}
    od = {"o_orderkey": np.array([3, 1, 2]), "o_price": np.array([30.0, 10.0, 20.0]),
          "l_orderkey": np.array([3, 1, 2])}
    return {"lineitem": T(li, {"l_flag": np.array(["A", "B"], dtype=object)}),
            "orders": T(od, {})}


def test_frame_reference_by_hand():
    ref = frame_ref.FrameReference(_tables(), ("l_orderkey", "o_orderkey"))
    base = (("base", "lineitem"),)
    kind, names, counts, stats = ref.answer(base + (("filter", "l_quantity", 2.5),),
                                            ("describe",))
    assert names == ["l_orderkey", "l_quantity"] and list(counts) == [4, 4]
    assert stats[1][0] == pytest.approx(4.5)  # mean of 3, 4, 5, 6
    assert stats[1][1] == pytest.approx(np.std([3, 4, 5, 6], ddof=1))
    assert list(stats[1][2:]) == [3.0, 6.0]
    _, codes, cnt = ref.answer(base, ("value_counts", "l_flag"))
    assert list(codes) == [0, 1] and list(cnt) == [3, 3]  # a tie: by code
    _, codes, names, means = ref.answer(base, ("groupby_mean_head", "l_flag", 1))
    assert list(codes) == [0] and means[1][0] == pytest.approx((1 + 3 + 6) / 3)
    _, names, rows = ref.answer(base + (("assign", "z", "l_quantity", 2.0),), ("tail", 2))
    assert names[-1] == "z" and list(rows[-1]) == [10.0, 12.0]
    _, names, rows = ref.answer((("base", "join"),), ("head", 3))
    assert list(rows[names.index("o_price")]) == [10.0, 10.0, 20.0]


def test_compare_is_exact_on_rows_and_counts_and_relative_on_statistics():
    want = ("describe", ["x"], np.array([4.0]), np.array([[1.0, 2.0, -10.0, 10.0]]))
    got = ("describe", ["x"], np.array([4.0]), np.array([[1.001, 2.0, -10.0, 10.0]]))
    bad, gap = frame_ref.compare(got, want)
    assert not bad and gap == pytest.approx(1e-4)
    vc = ("value_counts", np.array([1, 0]), np.array([5, 3]))
    assert frame_ref.compare(vc, vc) == (False, 0.0)
    assert frame_ref.compare(("value_counts", np.array([1, 0]), np.array([5, 4])), vc)[0]
    rows = ("rows", ["a"], [np.array([1, 2])])
    assert frame_ref.compare(("rows", ["a"], [np.array([1, 3])]), rows)[0]
    assert frame_ref.compare(("columns", ["a", "b"]), ("columns", ["b", "a"]))[0]


def test_bfloat16_rounding_by_hand():
    x = np.array([1.0, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, 3.14159])
    assert list(frame_ref.to_bfloat16(x)) == [1.0, 1.0, 1.0 + 2 ** -6, 3.140625]


def _recurrence(xdt, log_a, b, c):
    S, H, P = xdt.shape
    h = torch.zeros(H, b.shape[1], P)
    ys = []
    for t in range(S):
        h = torch.exp(log_a[t])[:, None, None] * h + b[t][None, :, None] * xdt[t][:, None, :]
        ys.append(torch.einsum("n,hnp->hp", c[t], h))
    return torch.stack(ys)


@pytest.mark.parametrize("S,chunk", [(7, 4), (16, 4), (5, 16)])
def test_chunked_ssd_is_the_recurrence(S, chunk):
    g = torch.Generator().manual_seed(S)
    xdt = torch.randn(S, 3, 2, generator=g)
    log_a = -torch.rand(S, 3, generator=g)
    b, c = torch.randn(S, 5, generator=g), torch.randn(S, 5, generator=g)
    got = mamba_ref.ssd_chunked(xdt, log_a, b, c, chunk)
    torch.testing.assert_close(got, _recurrence(xdt, log_a, b, c), rtol=1e-5, atol=1e-5)


def test_fp8_control_rounds_operands_and_gradients():
    x = torch.tensor([1.0, 0.3, -448.0, 1e-3])
    q = mamba_ref._fp8(x)
    assert q[0].item() == 1.0 and q[2].item() == -448.0 and q[1].item() != 0.3
    a = torch.tensor([[1.0, 0.3]], requires_grad=True)
    b = torch.tensor([[2.0, 1.0], [1.0, 1.0]], requires_grad=True)
    y = mamba_ref.matmul(a, b, "fp8")
    assert y[0, 0].item() == pytest.approx(2.0 + 0.3, rel=2 ** -3)
    y.backward(torch.tensor([[0.3, 1.0]]))
    assert a.grad.shape == a.shape and b.grad.shape == b.shape
    # at the gradient's scale (its largest, 1.0, at e5m2's largest) 0.3
    # keeps two mantissa bits: 2^14 of 57,344ths, 0.2857
    assert b.grad[0, 0].item() == pytest.approx(16384 / 57344)

"""The short-row sort of the PyTorch port (``ops/kernels/order_stats.py``
and ``csrc/order_stats_sort.cu``), which ``models/gnk.py`` ``ss_order``
sorts with.

On the CPU ``sort_rows`` is ``torch.sort``; the tests marked ``cuda``
launch the kernel and skip without a card.  This file does not import
JAX, so on a machine with a card

    python -m pytest --noconftest -m cuda tests/unit/test_torch_order_stats.py

runs the kernel's tests alone.
"""

import math
import re

import numpy as np
import pytest
import torch

import elfi_tpu_torch as et
from elfi_tpu_torch.models import gnk
from elfi_tpu_torch.ops.kernels import _build
from elfi_tpu_torch.ops.kernels.order_stats import MAX_N, sort_rows, takes
from elfi_tpu_torch.utils import capture

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


def _rows(b, n, seed, device="cpu"):
    """(b, n) float32 rows holding ties, +-0, +-inf and NaN: each kind in
    some rows, several at once in others, none in the rest."""
    g = torch.Generator(device=device).manual_seed(seed)
    y = 3 * torch.randn((b, n), generator=g, device=device)
    y[1::5] = torch.round(y[1::5])                       # ties
    for k, v in enumerate((0.0, -0.0, math.inf, -math.inf, math.nan)):
        pick = torch.rand((b, n), generator=g, device=device) < 0.04
        pick[k::7] = False                               # rows without it
        y[pick] = v
    y[3::11] = math.nan                                  # rows all NaN
    y[4::13, : n // 2] = -math.inf
    return y


def _same(got, want):
    """Equal values (-0 == +0) with NaN in the same places."""
    nan = torch.isnan(want)
    return (got.shape == want.shape and got.dtype == want.dtype
            and torch.equal(torch.isnan(got), nan)
            and torch.equal(got.masked_fill(nan, 0),
                            want.masked_fill(nan, 0)))


def _counts():
    return sort_rows.launches, sort_rows.captured, sort_rows.graph_launches


# -- on the CPU --------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 50, 1), (7, 17), (5, 65, 1),
                                   (3, 1), (0, 50)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_ss_order_is_torch_sort(shape, dtype):
    y = torch.randn(shape, dtype=dtype, generator=torch.Generator()
                    .manual_seed(len(shape)))
    before = _counts()
    assert not takes(y)
    got = gnk.ss_order(y)
    assert torch.equal(got, torch.sort(y, dim=1).values)
    assert _counts() == before


def test_cpu_ss_order_keeps_special_values_and_its_gradient():
    y = _rows(40, 50, seed=1)[:, :, None]
    assert _same(gnk.ss_order(y), torch.sort(y, dim=1).values)
    x = torch.randn(6, 50, 1, requires_grad=True)
    gnk.ss_order(x).pow(2).sum().backward()
    torch.testing.assert_close(x.grad, 2 * x.detach())


def test_cuda_source_holds_its_entries_and_note():
    text = (_build.CSRC / "order_stats_sort.cu").read_text()
    for entry in ("elfi_order_stats_sort(", "elfi_cuda_error_string(",
                  "elfi_tpu/models/gnk.py:43", "jnp.sort",
                  "What bounds it on this card: bytes",
                  '#include "sort_network.cuh"'):
        assert entry in text, entry
    assert "torch/extension.h" not in text
    # the benchmark finds the kernel by the name of its __global__
    # function: a name no other kernel's name holds, nor it theirs
    assert re.findall(r"^(\w+)\(", text, re.M).count(
        "order_stats_sort_kernel") == 1
    name = "order_stats_sort_kernel"
    for other in ("ma2_distance_kernel", "gnk_distance_kernel",
                  "gnk_sort_rows_kernel", "cull_scan", "cull_merge_kernel",
                  "gather_rows_kernel", "radixSortKVInPlace"):
        assert other not in name and name not in other
    assert MAX_N == 64


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 17, 50, 63, 64])
@pytest.mark.parametrize("b", [1, 127, 129, 2**21])
def test_kernel_equals_torch_sort(cuda, n, b):
    y = _rows(b, n, seed=n * 1000 + b % 997, device=cuda)
    kept = y.clone()
    before = sort_rows.launches
    got = sort_rows(y)
    assert sort_rows.launches == before + 1
    assert _same(got, torch.sort(kept, dim=1).values)
    # the input is left as it was, bit for bit
    assert torch.equal(y.view(torch.int32), kept.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [17, 50, 64])
def test_kernel_takes_a_trailing_dimension_of_one_and_an_offset(cuda, n):
    y = _rows(300, n, seed=n, device=cuda)[:, :, None]
    before = sort_rows.launches
    got = gnk.ss_order(y)
    assert got.shape == (300, n, 1)
    assert _same(got, torch.sort(y, dim=1).values)
    # a contiguous view that starts 4 bytes into its storage: the kernel
    # moves it a value at a time
    flat = _rows(1, 301 * n + 1, seed=n + 1, device=cuda).reshape(-1)
    z = flat[1:].reshape(301, n)
    assert z.is_contiguous() and z.data_ptr() % 16 != 0
    assert _same(sort_rows(z), torch.sort(z, dim=1).values)
    assert sort_rows.launches == before + 2


@pytest.mark.cuda
def test_kernel_replayed_in_a_graph_equals_the_eager_call(cuda):
    y = _rows(4099, 50, seed=3, device=cuda)
    eager = sort_rows(y)                  # builds and loads the library
    before = _counts()
    with capture.on_side_stream(cuda):
        graph = capture.Graph(lambda: sort_rows(y), capture.Recorder(0), 0,
                              cuda)
    assert _counts() == (before[0], before[1] + 1, before[2])
    y.copy_(_rows(4099, 50, seed=4, device=cuda))
    with capture.on_side_stream(cuda):
        out = graph.replay({}, 0)
    torch.cuda.synchronize()
    assert _same(out, sort_rows(y))
    assert not _same(out, eager)
    assert sort_rows.graph_launches == before[2] + 1


@pytest.mark.cuda
def test_inputs_outside_the_rule_take_torch_sort(cuda):
    g = torch.Generator(device=cuda).manual_seed(5)
    wide = torch.randn((64, 50), generator=g, device=cuda)
    cases = {
        "n_65": torch.randn((64, 65), generator=g, device=cuda),
        "float64": torch.randn((64, 50), generator=g, device=cuda,
                               dtype=torch.float64),
        "trailing_2": torch.randn((64, 50, 2), generator=g, device=cuda),
        "strided": wide.t().contiguous().t(),
        "no_rows": torch.randn((0, 50), generator=g, device=cuda),
        "needs_grad": torch.randn((64, 50), generator=g, device=cuda,
                                  requires_grad=True),
    }
    before = _counts()
    for name, y in cases.items():
        assert not takes(y), name
        got = gnk.ss_order(y)
        assert torch.equal(got, torch.sort(y, dim=1).values), name
    assert _counts() == before
    # the gradient flows through torch.sort, as on the CPU
    x = cases["needs_grad"]
    gnk.ss_order(x).pow(2).sum().backward()
    torch.testing.assert_close(x.grad, 2 * x.detach())
    with torch.no_grad():
        assert takes(x)


@pytest.mark.cuda
def test_plain_gnk_rejection_sorts_with_the_kernel(cuda):
    m = gnk.get_model(n_obs=50, seed_obs=1)
    before = sort_rows.launches + sort_rows.graph_launches
    res = et.Rejection(m["d"], batch_size=2**14, seed=1, device=cuda).sample(
        100, n_sim=2**18, bar=False)
    assert sort_rows.launches + sort_rows.graph_launches > before
    d = res.outputs["d"]
    assert np.all(np.isfinite(d)) and np.all(np.diff(d) >= 0)
    assert not math.isnan(float(np.mean(res.samples["A"])))

"""The threshold-culled top-N merge on the card (``ops/kernels/topn.py`` and
``csrc/topn_cull.cu``): the kernel against its plain version and the flat
merge, bit for bit, on the merge sequence of ``chip_smoke.py``'s merge
phase and on columns of other dtypes and shapes; the fused rejection loop
with the cull and the merge unroll equal to the flat merge with no unroll,
queued with no host read in quantile mode, and over a device list.

Every test needs a CUDA device and skips without one.  The file does not
import JAX, so on a machine with a card

    python -m pytest --noconftest -m cuda tests/unit/test_torch_merge_cuda.py

runs it alone.
"""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import elfi_tpu_torch as et
from elfi_tpu_torch.methods import samplers
from elfi_tpu_torch.models import ma2, ma2_kernel
from elfi_tpu_torch.ops import topk
from elfi_tpu_torch.ops.kernels.topn import (kernel_width, topn_cull,
                                             topn_cull_reference)

torch.set_num_threads(1)

N = 5000


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend, and put their own work on the
    card."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def smoke():
    """``chip_smoke.py`` as a module: its merge sequence."""
    path = Path(__file__).resolve().parents[2] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bits(x):
    return x.contiguous().view(torch.uint8)


def _assert_same_merge(bufs, batch, thr, widths):
    got, idx, acc = topn_cull(bufs, batch, thr, "d", widths)
    want, widx, wacc = topn_cull_reference(bufs, batch, thr, "d", widths)
    flat, facc = topk.merge_core(bufs, batch, thr, "d")
    assert torch.equal(idx, widx)
    assert int(acc) == int(wacc) == int(facc)
    assert set(got) == set(want) == set(flat)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert torch.equal(_bits(got[k]), _bits(want[k])), k
        assert torch.equal(_bits(got[k]), _bits(flat[k])), k
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("small_k", [1024, 4096, (1024, 4096, 16384)])
def test_cull_kernel_equals_plain_version_on_the_merge_sequence(
        cuda, smoke, small_k):
    widths = small_k if isinstance(small_k, tuple) else (small_k,)
    width = kernel_width(widths)
    n_cases = 0
    for case, bufs, batch, thr, expect in smoke.merge_cases(
            cuda, 2**17, N, width, seed=5):
        if expect is not None:
            assert smoke.candidates(bufs, batch, thr) == expect, case
        topn_cull.launches = 0
        _assert_same_merge(bufs, batch, thr, widths)
        assert topn_cull.launches == 1
        n_cases += 1
    assert n_cases >= 32


@pytest.mark.cuda
def test_cull_kernel_carries_any_column(cuda):
    """Columns of other dtypes and trailing shapes, a strided column, a
    float64 distance (its keys made by the wrapper) and a batch column
    of another dtype than the buffer's."""
    g = torch.Generator(device=cuda).manual_seed(3)
    B, n = 2**16, 700

    def batch(d):
        wide = torch.randn((B, 3, 5), generator=g, device=cuda)
        return {"d": d,
                "x": torch.randn((B, 3, 2), generator=g, device=cuda,
                                 dtype=torch.float64),
                "lbl": torch.randint(0, 9, (B,), generator=g, device=cuda,
                                     dtype=torch.int32),
                "flag": torch.rand(B, generator=g, device=cuda) < 0.5,
                "half": torch.randn(B, generator=g, device=cuda).half(),
                "col": wide[:, 1, 2:4]}

    for dtype in (torch.float32, torch.float64):
        b = batch(torch.rand(B, generator=g, device=cuda, dtype=dtype))
        bufs = topk.init_buffers(n, b, "d")
        bufs = topk.merge_core(bufs, b, math.inf, "d")[0]
        for thr in (math.inf, 0.3):
            b = batch(torch.rand(B, generator=g, device=cuda, dtype=dtype))
            bufs = _assert_same_merge(bufs, b, thr, (1024,))
    b["lbl"] = b["lbl"].long()          # converted to the buffer's dtype
    _assert_same_merge(bufs, b, 0.3, (1024,))


def _sync_guarded(fn):
    """``fn`` with every host synchronisation raising an error."""
    def run(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return run


def _run(node, bs, device, n_sim=None, threshold=None, seed=2):
    return et.Rejection(node, batch_size=bs, seed=seed, device=device).sample(
        1000, n_sim=n_sim, threshold=threshold, bar=False)


def _equal(a, b):
    for k in a.outputs:
        np.testing.assert_array_equal(a.outputs[k], b.outputs[k], err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("graph", ["plain", "kernel"])
def test_fused_cull_and_unroll_equal_flat_and_read_nothing(cuda, graph,
                                                           monkeypatch):
    """The fused rejection with the cull and each unroll equals the flat
    merge with no unroll, in quantile and threshold mode; the quantile
    loop makes no host read."""
    mod = {"plain": ma2, "kernel": ma2_kernel}[graph]
    node = mod.get_model(seed_obs=271)["d"]
    bs = 2**16
    monkeypatch.setattr(topk, "CULL_MIN_BATCH", 1 << 16)
    monkeypatch.setattr(topk, "MERGE_VARIANT", "flat")
    monkeypatch.setattr(samplers, "FUSED_UNROLL", 1)
    base = _run(node, bs, cuda, n_sim=40 * bs)
    base_thr = _run(node, bs, cuda, threshold=0.1)
    monkeypatch.setattr(topk, "MERGE_VARIANT", "culled")
    for u in (1, 2, 3, 4):
        monkeypatch.setattr(samplers, "FUSED_UNROLL", u)
        rej = et.Rejection(node, batch_size=bs, seed=2, device=cuda)
        rej.sample(1000, n_sim=2 * bs, bar=False)      # the program, built
        rej._run_fused = _sync_guarded(rej._run_fused)
        topn_cull.launches = 0
        _equal(rej.sample(1000, n_sim=40 * bs, bar=False), base)
        assert topn_cull.launches > 0
        res_thr = _run(node, bs, cuda, threshold=0.1)
        _equal(res_thr, base_thr)
        assert res_thr.n_sim == base_thr.n_sim


@pytest.mark.cuda
def test_cull_over_a_device_list_equals_native(cuda, monkeypatch):
    node = ma2_kernel.get_model(seed_obs=271)["d"]
    bs = 2**16
    monkeypatch.setattr(topk, "CULL_MIN_BATCH", 1 << 16)
    monkeypatch.setattr(samplers, "FUSED_UNROLL", 2)
    native = _run(node, bs, cuda, n_sim=24 * bs)
    et.set_client("sharded", devices=[cuda, cuda])
    topn_cull.launches = 0
    listed = _run(node, bs, None, n_sim=24 * bs)
    assert topn_cull.launches > 0
    _equal(listed, native)

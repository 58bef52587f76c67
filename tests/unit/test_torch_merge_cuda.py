"""The threshold-culled top-N merge on the card (``ops/kernels/topn.py`` and
``csrc/topn_cull.cu``): the kernel against its plain version and the flat
merge, bit for bit, on the merge sequence of ``chip_smoke.py``'s merge
phase (the kernel's capacity edges included), on columns of other dtypes
and shapes and on a buffer too large for shared memory; the host's plans,
never reused across a layout, a batch size or a stream; two device
operations a merge; the fused rejection loop with the cull and the merge
unroll equal to the flat merge with no unroll, queued with no host read in
quantile mode, and over a device list.

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
from elfi_tpu_torch.ops.kernels import topn
from elfi_tpu_torch.ops.kernels.topn import (CAPACITY, COUNT_SORT,
                                             KEY_STAGE, LOCAL_TILES,
                                             topn_cull, topn_cull_reference)

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
    width = max(widths)
    n_cases = 0
    for case, bufs, batch, thr, expect in smoke.merge_cases(
            cuda, 2**17, N, width, seed=5):
        if expect is not None:
            assert smoke.candidates(bufs, batch, thr) == expect, case
        topn_cull.launches = 0
        _assert_same_merge(bufs, batch, thr, widths)
        assert topn_cull.launches == 1
        n_cases += 1
    assert n_cases >= 41


@pytest.mark.cuda
def test_cull_kernel_carries_any_column(cuda):
    """Columns of other dtypes and trailing shapes, a strided column, a
    float64 distance (its keys made by the wrapper), a batch column of
    another dtype than the buffer's, and more columns than the merge
    kernel writes itself (the rest gathered by a second kernel)."""
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
    bufs = _assert_same_merge(bufs, b, 0.3, (1024,))
    extra = {f"c{j}": torch.randn((B, j % 3 + 1), generator=g, device=cuda)
             for j in range(34)}
    b = dict(batch(torch.rand(B, generator=g, device=cuda)), **extra)
    bufs = dict(bufs, **{k: torch.zeros((n,) + v.shape[1:], device=cuda)
                         for k, v in extra.items()})
    _assert_same_merge(bufs, b, 0.3, (1024,))


@pytest.mark.cuda
def test_cull_kernel_with_a_large_buffer(cuda):
    """n = 2^16, above the keys the kernel stages and twice a pass's
    capacity, at candidate counts at the edges of the counting sort, of
    the tiles' copies and of one pass."""
    g = torch.Generator(device=cuda).manual_seed(7)
    B, n = 2**18, 2**16
    assert n > KEY_STAGE and n >= 2 * CAPACITY

    def batch(d):
        return {"d": d, "t": torch.randn((B, 2), generator=g, device=cuda)}

    b = batch(torch.rand(B, generator=g, device=cuda))
    bufs = topk.merge_core(topk.init_buffers(n, b, "d"), b, math.inf,
                           "d")[0]
    for count in (0, 1, 8 * COUNT_SORT + 1, LOCAL_TILES, LOCAL_TILES + 1,
                  CAPACITY - 1, CAPACITY + 1, 3 * CAPACITY):
        kth = float(bufs["__key"][-1])
        d = kth + (1 - kth) * torch.rand(B, generator=g, device=cuda)
        rows = torch.randperm(B, generator=g, device=cuda)[:count]
        d[rows] = kth * 0.999 * torch.rand(count, generator=g, device=cuda)
        bufs = _assert_same_merge(bufs, batch(d), math.inf, (4096,))


@pytest.mark.cuda
def test_cull_plans_follow_layout_batch_size_and_stream(cuda):
    """A plan is reused only for the same key: a column's dtype or layout,
    the batch size and the stream each make a new one, and every merge
    equals the plain version."""
    g = torch.Generator(device=cuda).manual_seed(8)
    n = 1000

    def batch(B, t_dtype=torch.float32, strided=False):
        wide = torch.randn((B, 3), generator=g, device=cuda)
        t = wide[:, 1] if strided else wide[:, 1].contiguous()
        return {"d": torch.rand(B, generator=g, device=cuda),
                "t": t.to(t_dtype)}

    def merged(b, bufs=None):
        if bufs is None:
            bufs = topk.merge_core(topk.init_buffers(n, b, "d"), b,
                                   math.inf, "d")[0]
        before = set(topn._plans)
        _assert_same_merge(bufs, b, math.inf, (1024,))
        return set(topn._plans) - before

    topn._plans.clear()
    assert len(merged(batch(2**16))) == 1          # a first plan
    assert merged(batch(2**16)) == set()           # reused
    for b in (batch(2**16, torch.float64),         # a column's dtype
              batch(2**16, strided=True),          # its layout
              batch(2**17)):                       # the batch size
        assert len(merged(b)) == 1
    side = torch.cuda.Stream(device=cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        assert len(merged(batch(2**16))) == 1      # the stream
        assert merged(batch(2**16)) == set()
    torch.cuda.current_stream(cuda).wait_stream(side)
    keys = list(topn._plans)
    assert len({k[2] for k in keys}) == 2          # two streams


@pytest.mark.cuda
def test_cull_merge_takes_two_device_operations(cuda):
    """A merge on the card is two kernel launches, with no memset or
    copy, from a ``torch.profiler`` table over ten merges (through
    ``utils.profiling.recorded``, whose primer kernels are left out)."""
    from torch.autograd import DeviceType
    from elfi_tpu_torch.utils.profiling import recorded
    g = torch.Generator(device=cuda).manual_seed(9)
    B = 2**21
    b = {k: torch.rand(B, generator=g, device=cuda) for k in ("d", "t1",
                                                               "t2")}
    bufs = topk.merge_core(topk.init_buffers(N, b, "d"), b, math.inf,
                           "d")[0]
    b = {k: torch.rand(B, generator=g, device=cuda) for k in b}
    for _ in range(3):
        topn_cull(bufs, b, math.inf, "d", (4096,))
    torch.cuda.synchronize()
    with recorded() as prof:
        for _ in range(10):
            topn_cull(bufs, b, math.inf, "d", (4096,))
    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and not e.is_user_annotation
           and "spin_kernel" not in e.key]
    names = {e.key: e.count for e in ops}
    assert sum(names.values()) == 20, names
    assert all(e.count == 10 for e in ops), names
    assert not any("emset" in k or "emcpy" in k for k in names), names


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

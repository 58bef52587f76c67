"""The cull kernel's algorithm (``csrc/topn_cull.cu``) on the CPU.

The kernel cannot run here, so its index arithmetic is modelled in numpy,
step for step: the scan's packed candidates in an arbitrary order (the
atomics'), passes of ``CAPACITY`` candidates, each block's share of a pass
sorted in a tile padded to a power of two, the binary lifting over every
tile and over the buffer, the places of candidates and buffer entries, the
scatter of the places below n and the rows gathered by the index map.  The
model is held bit for bit against the port's flat merge, the plain version
of the kernel and the JAX package's flat merge on the same seeded inputs.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from elfi_tpu.ops import topk as jtopk
import elfi_tpu_torch as et
from elfi_tpu_torch.interop import from_numpy_state
from elfi_tpu_torch.ops import topk
from elfi_tpu_torch.ops.kernels import topn

torch.set_num_threads(1)

C, T, CAP = topn.CLUSTER_BLOCKS, topn.TILE, topn.CAPACITY
PAD = np.uint64(2**64 - 1)
B, N = 40000, 5000


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


# -- the model ---------------------------------------------------------------

def order_bits(f):
    """float32 -> the kernel's order-preserving uint32 image."""
    u = np.ascontiguousarray(f, np.float32).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def from_order_bits(u):
    u = u.astype(np.uint32)
    return np.where(u & 0x80000000, u & 0x7FFFFFFF, ~u).astype(
        np.uint32).view(np.float32)


def pack(key_bits, idx):
    return (key_bits.astype(np.uint64) << np.uint64(32)) | idx.astype(
        np.uint64)


def lift(a, length, x):
    """Entries of the sorted ``a[:length]`` below each ``x``, by the
    kernel's binary lifting: from the highest power of two at or below
    ``length``, a step taken while it stays within ``length`` and the
    entry it reaches is below x."""
    x = np.asarray(x, np.uint64)
    k = np.zeros(x.shape, np.int64)
    step = 1 << (int(length).bit_length() - 1)
    while step > 0:
        inside = k + step <= length
        below = a[np.minimum(k + step - 1, length - 1)] < x
        k = np.where(inside & below, k + step, k)
        step >>= 1
    return k


def effective_keys(d, thr):
    """(acceptance, key): the last distance column, +inf where a column
    is above its threshold or NaN."""
    ok = d <= thr if d.ndim == 1 else np.all(d <= thr, axis=1)
    key = np.where(ok, d if d.ndim == 1 else d[:, -1], np.inf)
    return ok, key.astype(np.float32)


def model_scan(buf_key, d, thr, rng):
    """The scan: (acceptance count, packed candidates in an arbitrary
    order)."""
    n = buf_key.shape[0]
    ok, key = effective_keys(d, thr)
    u = order_bits(key)
    rows = np.nonzero(u < order_bits(buf_key[n - 1:])[0])[0]
    cand = pack(u[rows], n + rows)
    return int(ok.sum()), rng.permutation(cand)


def model_merge(buf_key, cand):
    """The merge kernel: the n merged entries (packed) after every pass,
    and the number of passes."""
    n = buf_key.shape[0]
    run = pack(order_bits(buf_key), np.arange(n))
    m = cand.shape[0]
    passes = 1 if m == 0 else -(-m // CAP)
    for p in range(passes):
        chunk = cand[p * CAP:p * CAP + CAP]
        mc = chunk.shape[0]
        t = -(-mc // C)
        width = 1
        while width < t:
            width <<= 1
        tiles, own = [], []
        for r in range(C):
            mine = max(0, min(t, mc - r * t))
            tile = np.full(width, PAD, np.uint64)
            tile[:mine] = chunk[r * t:r * t + mine]
            tiles.append(np.sort(tile))            # the bitonic network
            own.append(tiles[-1][:mine])

        def cluster_rank(x):
            return sum(lift(tile, width, x) for tile in tiles)

        out = np.full(n, PAD, np.uint64)
        placed = np.zeros(n, np.int64)
        for c in own:
            k = cluster_rank(c) + lift(run, n, c)
            np.add.at(placed, k[k < n], 1)
            out[k[k < n]] = c[k < n]
        k = np.arange(n) + cluster_rank(run)
        np.add.at(placed, k[k < n], 1)
        out[k[k < n]] = run[k < n]
        # the places are a bijection onto [0, n): no entry written twice,
        # none left out
        assert (placed == 1).all()
        run = out
    return run, passes


def model_cull(bufs, batch, thr, seed=0):
    """One merge as the kernel makes it, on numpy buffers and batch:
    (merged columns, index map, acceptance count, passes)."""
    rng = np.random.default_rng(seed)
    n = bufs["__key"].shape[0]
    acc, cand = model_scan(bufs["__key"], batch["d"], thr, rng)
    run, passes = model_merge(bufs["__key"], cand)
    idx = (run & np.uint64(0xFFFFFFFF)).astype(np.int64)
    out = {"__key": from_order_bits((run >> np.uint64(32)).astype(
        np.uint32))}
    for k, v in batch.items():
        rows = np.concatenate([bufs[k], v.astype(bufs[k].dtype)])
        out[k] = rows[idx]
    return out, idx, acc, passes


# -- inputs ------------------------------------------------------------------

def _columns(rng, d):
    b = d.shape[0]
    return {"d": d, "t1": rng.normal(size=b).astype(np.float32),
            "t2": rng.normal(size=(b, 2)).astype(np.float32),
            "k": rng.integers(0, 1 << 30, b).astype(np.int32)}


def _torch_threshold(thr):
    return torch.from_numpy(thr) if isinstance(thr, np.ndarray) \
        else float(thr)


def _flat(bufs, batch, thr):
    out, _ = topk.merge_core(from_numpy_state(bufs, "cpu"),
                             from_numpy_state(batch, "cpu"),
                             _torch_threshold(thr), "d")
    return {k: v.numpy() for k, v in out.items()}


def _full_buffer(rng, n):
    first = _columns(rng, rng.uniform(0, 1, B).astype(np.float32))
    bufs = {k: np.asarray(v) for k, v in jax.device_get(
        jtopk.init_buffers(n, first, "d")).items()}
    return _flat(bufs, first, np.inf)


def _beating(rng, kth, count, b=B):
    """Uniform distances in [kth, 1) with ``count`` rows below kth."""
    d = (kth + (1 - kth) * rng.uniform(0, 1, b)).astype(np.float32)
    rows = rng.choice(b, count, replace=False)
    d[rows] = (kth * 0.999 * rng.uniform(0, 1, count)).astype(np.float32)
    return d


def _bits(x):
    return np.ascontiguousarray(x).view(np.uint8)


def _check(bufs, batch, thr, expect_count=None):
    """The model against the port's flat merge, the plain version and the
    JAX package's flat merge, bit for bit; returns the merged buffers."""
    out, idx, acc, passes = model_cull(bufs, batch, thr)
    _, idx2, _, _ = model_cull(bufs, batch, thr, seed=1)
    assert np.array_equal(idx, idx2)          # the atomics' order is moot
    n = bufs["__key"].shape[0]
    _, key = effective_keys(batch["d"], thr)
    if expect_count is not None:
        kth = order_bits(bufs["__key"][n - 1:])[0]
        count = int((order_bits(key) < kth).sum())
        assert count == expect_count
        assert passes == max(1, -(-count // CAP))

    flat = _flat(bufs, batch, thr)
    ref, ridx, racc = topn.topn_cull_reference(
        from_numpy_state(bufs, "cpu"), from_numpy_state(batch, "cpu"),
        _torch_threshold(thr), "d", (1024, 4096))
    jout, jacc = jtopk.merge_core(bufs, batch, thr, "d")
    jout = jax.device_get(jout)
    assert acc == int(racc) == int(jacc)
    np.testing.assert_array_equal(idx, ridx.numpy())
    cat = np.concatenate([bufs["__key"], key])
    np.testing.assert_array_equal(idx, np.argsort(cat, kind="stable")[:n])
    assert set(out) == set(flat) == set(jout) == set(ref)
    for k in out:
        assert out[k].dtype == flat[k].dtype == np.asarray(jout[k]).dtype, k
        assert np.array_equal(_bits(out[k]), _bits(flat[k])), k
        assert np.array_equal(_bits(out[k]), _bits(np.asarray(jout[k]))), k
        assert np.array_equal(_bits(out[k]), _bits(ref[k].numpy())), k
    return out


# -- tests -------------------------------------------------------------------

def test_model_constants_are_the_kernels():
    src = (Path(topn.__file__).resolve().parents[2] / "csrc"
           / "topn_cull.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kClusterBlocks") == C
    assert const("kTile") == T
    assert const("kMergeThreads") == topn.COUNT_SORT
    assert "constexpr int kCountSort = kMergeThreads;" in src
    assert const("kLocalTiles") == topn.LOCAL_TILES
    assert const("kKeyStage") == topn.KEY_STAGE
    assert "constexpr int kCapacity = kClusterBlocks * kTile;" in src
    assert CAP == C * T


@pytest.mark.parametrize("length", [1, 2, 3, 7, 8, 64, 4096, 4999, 5000])
def test_lifting_counts_entries_below(length):
    """The binary lifting equals ``searchsorted(side="left")`` on a sorted
    array of unique packed entries, padded past ``length`` as a tile is,
    for queries below, between, equal to and above its entries."""
    rng = np.random.default_rng(length)
    a = np.sort(rng.choice(1 << 40, length, replace=False).astype(
        np.uint64))
    padded = np.concatenate([a, np.full(3, PAD, np.uint64)])
    x = np.concatenate([a, a + np.uint64(1), a - np.uint64(1),
                        np.array([0, 1 << 41], np.uint64)])
    want = np.searchsorted(a, x, side="left")
    np.testing.assert_array_equal(lift(a, length, x), want)
    np.testing.assert_array_equal(lift(padded, length, x), want)


@pytest.mark.parametrize("count", [0, 1, T - 1, T, T + 1, CAP - 1, CAP,
                                   CAP + 1, B])
def test_design_equals_flat_merge_at_capacity_edges(count):
    """Candidate counts at the tile's and the one pass's edges (and every
    row of the batch a candidate: two passes, the second partly full)."""
    rng = np.random.default_rng(count)
    bufs = _full_buffer(rng, N)
    batch = _columns(rng, _beating(rng, float(bufs["__key"][-1]), count))
    _check(bufs, batch, np.inf, expect_count=count)


@pytest.mark.parametrize("n,count", [(4999, 1000), (4097, 4097), (37, 300),
                                     (1, 5)])
def test_design_with_n_not_a_multiple_of_the_tile(n, count):
    """Buffers whose slices split unevenly over the cluster's blocks."""
    rng = np.random.default_rng(n)
    bufs = _full_buffer(rng, n)
    batch = _columns(rng, _beating(rng, float(bufs["__key"][-1]), count))
    _check(bufs, batch, np.inf, expect_count=count)


def test_design_ties_at_the_nth_key_and_at_buffer_keys():
    rng = np.random.default_rng(11)
    bufs = _full_buffer(rng, N)
    kth = bufs["__key"][-1]
    d = _beating(rng, float(kth), 700)
    d[rng.choice(B, B // 4, replace=False)] = kth
    d[rng.choice(B, 37, replace=False)] = bufs["__key"][
        rng.integers(0, N - 1, 37)]
    out = _check(bufs, _columns(rng, d), np.inf)
    # rows tied with kth never enter: the buffer's row keeps its place
    assert out["__key"][-1] <= kth


def test_design_nan_and_inf_distances():
    rng = np.random.default_rng(12)
    bufs = _full_buffer(rng, N)
    d = _beating(rng, float(bufs["__key"][-1]), 2000)
    d[rng.choice(B, B // 8, replace=False)] = np.nan
    d[rng.choice(B, B // 16, replace=False)] = np.inf
    _check(bufs, _columns(rng, d), np.inf)
    _check(bufs, _columns(rng, d), np.float32(0.05))


def test_design_threshold_rejecting_everything():
    rng = np.random.default_rng(13)
    bufs = _full_buffer(rng, N)
    batch = _columns(rng, rng.uniform(0, 1, B).astype(np.float32))
    out = _check(bufs, batch, -1.0, expect_count=0)
    assert np.array_equal(_bits(out["__key"]), _bits(bufs["__key"]))


def test_design_partly_inf_buffer():
    """A threshold that keeps the buffer partly +inf over several merges:
    kth is +inf, so every accepted row is a candidate."""
    rng = np.random.default_rng(14)
    thr = np.float32(N / 8 / B)
    first = _columns(rng, rng.uniform(0, 1, B).astype(np.float32))
    bufs = {k: np.asarray(v) for k, v in jax.device_get(
        jtopk.init_buffers(N, first, "d")).items()}
    for _ in range(4):
        batch = _columns(rng, rng.uniform(0, 1, B).astype(np.float32))
        bufs = _check(bufs, batch, thr)
    assert np.isinf(bufs["__key"]).any() and np.isfinite(
        bufs["__key"]).any()


def test_design_2d_distance_under_a_vector_threshold():
    rng = np.random.default_rng(15)
    thr = np.array([0.9, 0.6], np.float32)
    first = _columns(rng, rng.uniform(0, 1, (B, 2)).astype(np.float32))
    bufs = {k: np.asarray(v) for k, v in jax.device_get(
        jtopk.init_buffers(N, first, "d")).items()}
    for _ in range(3):
        batch = _columns(rng, rng.uniform(0, 1, (B, 2)).astype(np.float32))
        bufs = _check(bufs, batch, thr)


# -- the host's plan key -----------------------------------------------------

def _plan_inputs(b=64, dtype=torch.float32, strided=False):
    wide = torch.rand(b, 3)
    t = wide[:, 1] if strided else wide[:, 1].contiguous()
    batch = {"d": torch.rand(b), "t": t.to(dtype)}
    return topk.init_buffers(8, batch, "d"), batch


@pytest.mark.parametrize("change", [
    "new data", "column dtype", "column layout", "batch size", "stream",
    "threshold kind", "distance name"])
def test_plan_key_changes_with_what_fixes_the_arguments(change):
    """The wrapper's plan is cached by everything that fixes the kernel's
    arguments but the data: new tensors of the same layout share a key,
    and a column's dtype or layout, the batch size, the stream, the
    threshold's kind and the distance's name each make another."""
    bufs, batch = _plan_inputs()
    key = topn._plan_key(bufs, batch, 0.5, "d", 7)
    thr, name, stream = 0.5, "d", 7
    if change == "new data":
        bufs, batch = _plan_inputs()
    elif change == "column dtype":
        bufs, batch = _plan_inputs(dtype=torch.float64)
    elif change == "column layout":
        bufs, batch = _plan_inputs(strided=True)
    elif change == "batch size":
        bufs, batch = _plan_inputs(b=128)
    elif change == "stream":
        stream = 8
    elif change == "threshold kind":
        thr = torch.tensor([0.5])
    else:
        name = "t"
        bufs["t"] = bufs["t"].float()
    other = topn._plan_key(bufs, batch, thr, name, stream)
    assert (other == key) == (change == "new data")

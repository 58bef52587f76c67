"""The PyTorch port's top-N merge against the JAX package's: the same
buffers and batches give bit-identical keys and gathered rows, ties, +inf
and NaN included, merge after merge."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from elfi_tpu.ops import topk as jtopk
import elfi_tpu_torch as et
from elfi_tpu_torch.interop import from_numpy_state
from elfi_tpu_torch.ops import topk

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


def _batch(rng, b, special=True):
    d = rng.uniform(0, 1, b).astype(np.float32)
    if special:
        d[rng.integers(0, b, b // 8)] = 0.25          # ties
        d[rng.integers(0, b, b // 16)] = np.inf
        d[rng.integers(0, b, b // 16)] = np.nan
        d[rng.integers(0, b, 3)] = 0.0
    return {"d": d,
            "t1": rng.normal(size=b).astype(np.float32),
            "t2": rng.normal(size=(b, 2)).astype(np.float32),
            "k": rng.integers(0, 100, b).astype(np.int32)}


def _assert_same(bt, bj):
    bj = jax.device_get(bj)
    assert sorted(bt) == sorted(bj)
    for k in bj:
        np.testing.assert_array_equal(bt[k].numpy(), np.asarray(bj[k]),
                                      err_msg=k)
        assert bt[k].numpy().dtype == np.asarray(bj[k]).dtype, k


def test_stable_sort_matches_lax_top_k_on_specials():
    keys = np.array([1, np.nan, .5, np.inf, .5], np.float32)
    _, idx_j = jax.lax.top_k(-jnp.asarray(keys), 3)
    _, idx_t = torch.sort(torch.from_numpy(keys), stable=True)
    np.testing.assert_array_equal(idx_t[:3].numpy(), np.asarray(idx_j))


@pytest.mark.parametrize("threshold", [math.inf, 0.4, 0.25])
@pytest.mark.parametrize("n,b", [(16, 64), (100, 64), (37, 512)])
def test_merge_sequence_bit_identical_to_jax(threshold, n, b):
    rng = np.random.default_rng(n * b)
    batches = [_batch(rng, b) for _ in range(6)]
    bj = jtopk.init_buffers(n, batches[0], "d")
    bt = from_numpy_state(jax.device_get(bj), "cpu")
    _assert_same(bt, bj)
    for batch in batches:
        bj, acc_j = jtopk.merge_core(bj, batch, jnp.float32(threshold), "d")
        bt, acc_t = topk.merge_core(bt, from_numpy_state(batch, "cpu"),
                                    float(np.float32(threshold)), "d")
        assert int(acc_t) == int(acc_j)
        _assert_same(bt, bj)


def test_merge_from_midrun_jax_buffer():
    """A JAX buffer taken mid-run, carried into the port, merges on
    exactly as the JAX package merges it."""
    rng = np.random.default_rng(5)
    n = 24
    bj = jtopk.init_buffers(n, _batch(rng, 128), "d")
    for _ in range(3):
        bj, _ = jtopk.merge_core(bj, _batch(rng, 128), jnp.inf, "d")
    bt = from_numpy_state(jax.device_get(bj), "cpu")
    assert bt["__key"].dtype == torch.float32
    for _ in range(4):
        batch = _batch(rng, 128)
        bj, _ = jtopk.merge_core(bj, batch, jnp.inf, "d")
        bt, _ = topk.merge_scan(bt, from_numpy_state(batch, "cpu"),
                                math.inf, "d")
        _assert_same(bt, bj)


def test_make_merge_fn_equals_merge_core():
    rng = np.random.default_rng(2)
    batch = from_numpy_state(_batch(rng, 64), "cpu")
    bufs = topk.init_buffers(8, batch, "d")
    a, acc_a = topk.make_merge_fn("d")(bufs, batch, 0.5)
    b, acc_b = topk.merge_core(bufs, batch, 0.5, "d")
    assert int(acc_a) == int(acc_b)
    for k in a:
        assert torch.equal(a[k], b[k])


def test_nested_distance_sort_key_and_accept_mask_as_jax():
    d = np.array([[0.1, 0.3], [0.9, 0.2], [0.2, 0.25], [np.nan, 0.1]],
                 np.float32)
    np.testing.assert_array_equal(
        topk.sort_key(torch.from_numpy(d)).numpy(),
        np.asarray(jtopk.sort_key(d)))
    np.testing.assert_array_equal(
        topk.accept_mask(torch.from_numpy(d), 0.5).numpy(),
        np.asarray(jtopk.accept_mask(d, 0.5)))


def test_init_buffers_as_jax():
    batch = {"d": np.zeros((32, 2), np.float32),
             "theta": np.zeros((32, 3), np.float32),
             "lbl": np.zeros(32, np.int32)}
    _assert_same(topk.init_buffers(10, from_numpy_state(batch, "cpu"), "d"),
                 jtopk.init_buffers(10, batch, "d"))


def test_from_numpy_state_places_and_keeps_dtypes():
    state = {"a": np.arange(3, dtype=np.int32),
             "b": np.ones((2, 2), np.float32), "__key": np.full(2, np.inf)}
    out = from_numpy_state(state, torch.device("cpu"))
    for k, v in state.items():
        assert out[k].device.type == "cpu"
        assert out[k].numpy().dtype == v.dtype
        np.testing.assert_array_equal(out[k].numpy(), v)


# -- the threshold-culled merge (elfi_tpu/ops/topk.py:74-173) ---------------

def _stream(rng, n_batches, b):
    """tests/unit/test_topk.py's stream: uniform distances and a (b, 2)
    float column."""
    for _ in range(n_batches):
        yield {"d": rng.uniform(0, 1, b).astype(np.float32),
               "t": rng.normal(size=(b, 2)).astype(np.float32)}


def _culled_pair(buf_j, buf_t, batch, threshold, small_k):
    """One culled merge in each package on the same numpy inputs, held
    equal bit for bit (keys, every column, the acceptance count)."""
    bj, acc_j = jtopk.merge_core_culled(buf_j, batch, threshold, "d",
                                        small_k=small_k)
    bt, acc_t = topk.merge_core_culled(buf_t, from_numpy_state(batch, "cpu"),
                                       float(np.float32(threshold)), "d",
                                       small_k=small_k)
    assert int(acc_t) == int(acc_j)
    _assert_same(bt, bj)
    return bj, bt


@pytest.mark.parametrize("threshold", [np.inf, 0.4])
@pytest.mark.parametrize("small_k", [8, (4, 8), (2, 8, 16)])
def test_culled_merge_bit_identical_to_jax(threshold, small_k):
    """The JAX package's test_culled_merge_bit_identical_to_flat, both
    packages: early batches overflow the widths (the flat branch), later
    ones cull, and both equal the flat merge."""
    rng = np.random.RandomState(3)
    n, b = 16, 64
    max_k = small_k if isinstance(small_k, int) else max(small_k)
    batches = list(_stream(rng, 12, b))
    bj = jtopk.init_buffers(n, batches[0], "d")
    bt = from_numpy_state(jax.device_get(bj), "cpu")
    flat = from_numpy_state(jax.device_get(bj), "cpu")
    fast = False
    for batch in batches:
        kth = float(bt["__key"][n - 1])
        fast |= int(np.sum(batch["d"] < min(kth, threshold))) <= max_k
        bj, bt = _culled_pair(bj, bt, batch, threshold, small_k)
        flat, _ = topk.merge_core(flat, from_numpy_state(batch, "cpu"),
                                  float(np.float32(threshold)), "d")
        for k in flat:
            assert torch.equal(flat[k], bt[k]), k
    assert fast


def test_culled_merge_rejects_unsorted_cascade():
    batch = from_numpy_state({"d": np.zeros(64, np.float32)}, "cpu")
    bufs = topk.init_buffers(8, batch, "d")
    for small_k in ((8, 4), (4, 4)):
        with pytest.raises(ValueError, match="ascending"):
            topk.merge_core_culled(bufs, batch, math.inf, "d",
                                   small_k=small_k)


@pytest.mark.parametrize("case", ["boundary ties", "partial-buffer infs",
                                  "duplicate keys"])
def test_culled_merge_special_cases_as_jax(case):
    """tests/unit/test_topk.py's boundary ties (exact ties at the N-th key
    never enter), +inf keys kept from a partly filled buffer, and a batch
    of one repeated key, merged by both packages."""
    if case == "boundary ties":
        n, small_k, thr = 8, 4, np.inf
        first = {"d": np.linspace(0.1, 0.8, 32).astype(np.float32),
                 "t": np.arange(32, dtype=np.float32)}
        bj = jtopk.init_buffers(n, first, "d")
        bt = from_numpy_state(jax.device_get(bj), "cpu")
        bj, bt = _culled_pair(bj, bt, first, thr, small_k)
        kth = float(bt["__key"][n - 1])
        d2 = np.full(32, kth, np.float32)
        d2[5], d2[9] = kth / 2, kth / 3
        d2[16:] = 0.9
        bj, bt = _culled_pair(bj, bt, {"d": d2, "t": 100 + np.arange(
            32, dtype=np.float32)}, thr, small_k)
        assert kth not in bt["__key"].tolist()
    elif case == "partial-buffer infs":
        n, small_k = 12, 4
        d = np.full(32, 5.0, np.float32)
        d[3], d[20] = 0.1, 0.2
        batch = {"d": d, "t": np.arange(32, dtype=np.float32)}
        bj = jtopk.init_buffers(n, batch, "d")
        bt = from_numpy_state(jax.device_get(bj), "cpu")
        bj, bt = _culled_pair(bj, bt, batch, 1.0, small_k)
        assert int(torch.isinf(bt["__key"]).sum()) == n - 2
    else:
        n = 6
        batch = {"d": np.full(64, 0.5, np.float32),
                 "t": np.arange(64, dtype=np.float32)}
        bj = jtopk.init_buffers(n, batch, "d")
        bt = from_numpy_state(jax.device_get(bj), "cpu")
        for _ in range(3):
            bj, bt = _culled_pair(bj, bt, batch, np.inf, 8)
        np.testing.assert_array_equal(bt["t"].numpy(), np.arange(6))


@pytest.mark.parametrize("variant", ["flat", "culled"])
def test_merge_scan_variant_switch_as_jax(variant, monkeypatch):
    """merge_scan honours MERGE_VARIANT, CULL_SMALL_K and CULL_MIN_BATCH
    as the JAX merge_scan does (both packages' constants set alike), and
    ``fresh=True`` takes the flat merge."""
    rng = np.random.default_rng(0)
    batches = [{"d": rng.uniform(0, 1, 256).astype(np.float32),
                "t": rng.normal(size=256).astype(np.float32)}
               for _ in range(4)]
    for mod in (topk, jtopk):
        monkeypatch.setattr(mod, "MERGE_VARIANT", variant)
        monkeypatch.setattr(mod, "CULL_SMALL_K", 16)
        monkeypatch.setattr(mod, "CULL_MIN_BATCH", 128)
    calls = []
    culled = topk.merge_core_culled
    monkeypatch.setattr(topk, "merge_core_culled",
                        lambda *a, **k: calls.append(k) or culled(*a, **k))
    bj = jtopk.init_buffers(8, batches[0], "d")
    bt = from_numpy_state(jax.device_get(bj), "cpu")
    for i, batch in enumerate(batches):
        bj, acc_j = jtopk.merge_scan(bj, batch, jnp.float32(0.7), "d")
        bt, acc_t = topk.merge_scan(bt, from_numpy_state(batch, "cpu"),
                                    float(np.float32(0.7)), "d",
                                    fresh=i == 0)
        assert int(acc_t) == int(acc_j)
        _assert_same(bt, bj)
    assert calls == ([{"small_k": 16}] * 3 if variant == "culled" else [])


def test_cull_index_map_is_the_flat_concatenation_index():
    """topn_cull's index map: buffer row i < n or batch row i - n, the
    index into the flat merge's concatenation, for 2-D distances under a
    vector threshold and int64 / trailing-shape columns."""
    from elfi_tpu_torch.ops.kernels.topn import topn_cull
    rng = np.random.default_rng(4)
    n, b = 40, 512
    mk = lambda: {"d": rng.uniform(0, 1, (b, 2)).astype(np.float32),  # noqa
                  "__pos": rng.integers(0, 1 << 40, b),
                  "x": rng.normal(size=(b, 3, 2)).astype(np.float32)}
    thr = np.array([0.9, 0.5], np.float32)
    bj = jtopk.init_buffers(n, mk(), "d")
    bt = from_numpy_state(jax.device_get(bj), "cpu")
    for _ in range(5):
        batch = mk()
        cat = np.concatenate([np.asarray(bj["__key"]), np.where(
            np.all(batch["d"] <= thr, axis=1), batch["d"][:, -1], np.inf)])
        out, idx, acc = topn_cull(bt, from_numpy_state(batch, "cpu"),
                                  torch.from_numpy(thr), "d", (16,))
        np.testing.assert_array_equal(
            idx.numpy(), np.argsort(cat, kind="stable")[:n])
        bj, acc_j = jtopk.merge_core_culled(bj, batch, jnp.asarray(thr), "d",
                                            small_k=16)
        assert int(acc) == int(acc_j)
        _assert_same(out, bj)
        bt = out


def test_fused_unroll_as_jax(monkeypatch):
    """The port's _fused_unroll at batches 2^16-2^21 under the JAX
    package's constants (written here), against the JAX function."""
    from elfi_tpu.methods.samplers import _fused_unroll as jax_unroll
    from elfi_tpu_torch.methods import samplers

    for name, value in (("FUSED_UNROLL", None),
                        ("_UNROLL_CAND_CAP", 1 << 21), ("_UNROLL_MAX", 16),
                        ("_UNROLL_MAX_BATCH", 1 << 18),
                        ("_UNROLL_BYTES_CAP", 256)):
        monkeypatch.setattr(samplers, name, value)

    class _Shape:
        def __init__(self, shape, itemsize=4):
            self.shape = shape
            self.dtype = type("dt", (), {"itemsize": itemsize})()

    narrow = {"d": _Shape((1,)), "t1": _Shape((1,)), "t2": _Shape((1,))}
    wide = {"y": _Shape((1, 512))}
    tensors = {"d": torch.zeros(4), "t1": torch.zeros(4),
               "x": torch.zeros((4, 3), dtype=torch.float64)}
    for b in (1 << p for p in range(16, 22)):
        for shapes in (narrow, wide):
            assert samplers._fused_unroll(b, shapes) == jax_unroll(b, shapes)
        assert samplers._fused_unroll(b, tensors) == jax_unroll(
            b, {"d": _Shape((1,)), "t1": _Shape((1,)),
                "x": _Shape((1, 3), 8)})
    monkeypatch.setattr(samplers, "FUSED_UNROLL", 3)
    assert samplers._fused_unroll(1 << 21, narrow) == 3

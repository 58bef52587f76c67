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

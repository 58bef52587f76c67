"""The port's output pools and stores (``elfi_tpu_torch/store.py``): the
mirror of ``tests/unit/test_store.py``, plus a ``.npy`` file written by the
port's ``NpyArray`` read by the JAX package's, and ``add_batch`` of
tensors."""

import os
import pickle

import numpy as np
import pytest
import torch

import elfi_tpu_torch as et
from elfi_tpu.store import NpyArray as JaxNpyArray
from elfi_tpu_torch.models import ma2
from elfi_tpu_torch.store import ArrayStore, NpyArray, NpyStore

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


@pytest.fixture
def m():
    return ma2.get_model(seed_obs=4)


class TestNpyArray:
    def test_append_and_read(self, tmp_path):
        arr = NpyArray(str(tmp_path / "a.npy"))
        a = np.random.rand(10, 3).astype(np.float32)
        b = np.random.rand(5, 3).astype(np.float32)
        arr.append(a)
        arr.append(b)
        np.testing.assert_array_equal(arr[:], np.vstack([a, b]))
        assert len(arr) == 15

    def test_standard_npy_readable(self, tmp_path):
        f = str(tmp_path / "a.npy")
        arr = NpyArray(f)
        a = np.arange(12, dtype=np.int64).reshape(4, 3)
        arr.append(a)
        arr.close()
        np.testing.assert_array_equal(np.load(f), a)

    def test_jax_package_reads_the_port_file(self, tmp_path):
        """The file layout is the JAX package's: its NpyArray opens the
        port's file, appends to it, and the port reads that back."""
        f = str(tmp_path / "a.npy")
        arr = NpyArray(f)
        a = np.random.RandomState(0).rand(6, 2, 3).astype(np.float32)
        arr.append(torch.as_tensor(a))
        arr.close()
        jarr = JaxNpyArray(f)
        assert len(jarr) == 6 and jarr.dtype == np.float32
        np.testing.assert_array_equal(jarr[:], a)
        jarr.append(a[:2])
        jarr.close()
        np.testing.assert_array_equal(NpyArray(f)[:],
                                      np.concatenate([a, a[:2]]))

    def test_truncate(self, tmp_path):
        arr = NpyArray(str(tmp_path / "a.npy"))
        arr.append(np.arange(10.0))
        arr.truncate(4)
        np.testing.assert_array_equal(arr[:], np.arange(4.0))
        arr.append(np.array([99.0]))
        np.testing.assert_array_equal(arr[:], np.array([0, 1, 2, 3, 99.0]))

    def test_reopen(self, tmp_path):
        f = str(tmp_path / "a.npy")
        arr = NpyArray(f)
        arr.append(np.ones((3, 2)))
        arr.close()
        arr2 = NpyArray(f)
        assert len(arr2) == 3
        arr2.append(np.zeros((2, 2)))
        assert len(arr2) == 5

    def test_shape_mismatch(self, tmp_path):
        arr = NpyArray(str(tmp_path / "a.npy"))
        arr.append(np.ones((3, 2)))
        with pytest.raises(ValueError):
            arr.append(np.ones((3, 5)))

    def test_pickle_by_filename(self, tmp_path):
        arr = NpyArray(str(tmp_path / "a.npy"))
        arr.append(np.arange(6.0).reshape(2, 3))
        arr2 = pickle.loads(pickle.dumps(arr))
        np.testing.assert_array_equal(arr2[:], arr[:])


class TestArrayStore:
    def test_batch_semantics(self):
        store = ArrayStore(np.zeros((20, 2)), batch_size=5)
        data = np.random.rand(5, 2)
        store[0] = data
        assert 0 in store and 1 not in store
        np.testing.assert_array_equal(store[0], data)
        with pytest.raises(IndexError):
            store[3] = data  # can't skip ahead
        store[1] = data
        del store[1]
        assert len(store) == 1
        with pytest.raises(KeyError):
            store[1]

    def test_npy_store_of_tensors(self, tmp_path):
        store = NpyStore(str(tmp_path / "s.npy"), batch_size=4)
        data = torch.arange(8.0).reshape(4, 2)
        store[0] = data
        store[1] = data + 1
        assert len(store) == 2
        np.testing.assert_array_equal(store[1], data.numpy() + 1)


class TestPools:
    def test_add_batch_of_tensors(self):
        """Tensors are stored as numpy copies, the pooled names only, and a
        stored batch index is not overwritten."""
        pool = et.OutputPool(["a", "b"])
        t = torch.arange(4.0)
        pool.add_batch({"a": t, "b": t * 2, "c": t}, 0)
        batch = pool.get_batch(0)
        assert set(batch) == {"a", "b"}
        assert isinstance(batch["a"], np.ndarray)
        np.testing.assert_array_equal(batch["b"], [0, 2, 4, 6])
        t.add_(10)   # the pool holds a copy
        np.testing.assert_array_equal(pool.get_batch(0)["a"], [0, 1, 2, 3])
        pool.add_batch({"a": torch.zeros(4), "b": torch.zeros(4)}, 0)
        np.testing.assert_array_equal(pool.get_batch(0)["a"], [0, 1, 2, 3])
        assert 0 in pool and 1 not in pool and len(pool) == 1

    def test_output_pool_roundtrip(self, m):
        pool = et.OutputPool(["t1", "t2", "d"])
        rej = et.Rejection(m["d"], batch_size=10, seed=1, pool=pool)
        rej.sample(5, n_sim=30, fused=False, bar=False)
        assert len(pool) == 3
        batch = pool.get_batch(0)
        assert set(batch) == {"t1", "t2", "d"}
        assert len(batch["t1"]) == 10

    def test_pool_replay_matches(self, m):
        pool = et.OutputPool(["t1", "t2", "d"])
        rej = et.Rejection(m["d"], batch_size=10, seed=3, pool=pool)
        res1 = rej.sample(5, n_sim=30, fused=False, bar=False)
        # replay: same pool, same seed -> identical result, no re-simulation
        rej2 = et.Rejection(m["d"], batch_size=10, seed=3, pool=pool)
        res2 = rej2.sample(5, n_sim=30, fused=False, bar=False)
        np.testing.assert_array_equal(res1.samples["t1"], res2.samples["t1"])
        np.testing.assert_array_equal(res1.outputs["d"], res2.outputs["d"])

    def test_pool_context_mismatch(self, m):
        pool = et.OutputPool(["t1"])
        et.Rejection(m["d"], batch_size=10, seed=3, pool=pool)
        with pytest.raises(ValueError):
            et.Rejection(m["d"], batch_size=20, seed=3, pool=pool)

    def test_array_pool_save_open_delete(self, tmp_path, m):
        pool = et.ArrayPool(["t1", "d"], name="testpool",
                            prefix=str(tmp_path))
        rej = et.Rejection(m["d"], batch_size=10, seed=2, pool=pool)
        rej.sample(5, n_sim=20, fused=False, bar=False)
        pool.save()
        pool2 = et.ArrayPool.open("testpool", prefix=str(tmp_path))
        np.testing.assert_array_equal(pool2.get_batch(0)["t1"],
                                      pool.get_batch(0)["t1"])
        assert pool2.seed == pool.seed
        np.testing.assert_array_equal(
            np.load(str(tmp_path / "testpool" / "d.npy")),
            np.concatenate([pool.get_batch(i)["d"] for i in range(2)]))
        pool2.delete()
        assert not os.path.isdir(os.path.join(str(tmp_path), "testpool"))

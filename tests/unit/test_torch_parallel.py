"""Batch submission of the PyTorch port: in-order consumption, deterministic
replay of a failed batch, and cancellation."""

import numpy as np
import pytest
import torch

import elfi_tpu_torch as et
from elfi_tpu_torch.model.model import ComputationContext
from elfi_tpu_torch.models import ma2
from elfi_tpu_torch.parallel import BatchHandler, NativeBackend


def _handler(m, outputs=("t1", "d"), client=None, batch_size=16, seed=3):
    ctx = ComputationContext(batch_size=batch_size, seed=seed)
    return BatchHandler(m, ctx, outputs, client=client or NativeBackend())


def test_batches_are_consumed_in_submission_order():
    m = ma2.get_model(seed_obs=4)
    bh = _handler(m)
    for _ in range(3):
        bh.submit()
    assert bh.num_pending == 3 and bh.total == 3 and bh.has_ready()
    got = [bh.wait_next() for _ in range(3)]
    assert [i for _, i in got] == [0, 1, 2]
    ref = _handler(m)
    for batch, i in got:
        ref.next_index = i
        ref.submit()
        again, j = ref.wait_next()
        assert j == i
        for k in batch:
            assert torch.equal(batch[k], again[k]), k


def test_failed_batch_is_replayed_with_the_same_streams():
    m = et.Model()
    et.Prior("uniform", 0, 1, model=m, name="p")
    fails = {"left": 2}

    def flaky(p, batch_size, generator):
        if fails["left"]:
            fails["left"] -= 1
            raise RuntimeError("transient")
        return p[:, None] + torch.rand((batch_size, 2), generator=generator)

    et.Simulator(flaky, m["p"], observed=np.zeros(2), model=m, name="sim")
    bh = _handler(m, outputs=("sim",))
    bh.submit()
    batch, idx = bh.wait_next()
    assert idx == 0 and fails["left"] == 0
    clean = _handler(m, outputs=("sim",))
    clean.submit()
    assert torch.equal(batch["sim"], clean.wait_next()[0]["sim"])


def test_failure_surfaces_after_the_retries():
    m = et.Model()
    et.Prior("uniform", 0, 1, model=m, name="p")

    def broken(p, batch_size, generator):
        raise RuntimeError("always")

    et.Simulator(broken, m["p"], observed=np.zeros(1), model=m, name="sim")
    bh = _handler(m, outputs=("sim",))
    bh.submit()
    with pytest.raises(RuntimeError, match="Batch 0 failed after 2 retries"):
        bh.wait_next()


def test_cancel_pending_rewinds():
    m = ma2.get_model(seed_obs=4)
    bh = _handler(m)
    for _ in range(3):
        bh.submit()
    bh.wait_next()
    bh.cancel_pending()
    assert bh.num_pending == 0 and bh.next_index == 1
    with pytest.raises(ValueError, match="no batches are pending"):
        bh.wait_next()
    bh.submit({"t1": np.zeros(16, np.float32)})
    batch, idx = bh.wait_next()
    assert idx == 1 and torch.equal(batch["t1"], torch.zeros(16))
    bh.reset()
    assert bh.next_index == 0

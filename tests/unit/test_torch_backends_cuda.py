"""The backends beyond one device on the card: the device list naming
cuda:0 twice deals the MA2 kernel graph's batches and equals the native
run bit for bit with K1 launched once a batch, fused and batch at a time;
each card's share of a chunk captured as a graph on that card equals the
eager device list and one device bit for bit, over every visible card and
over one card named four times; a cluster master with no worker computes
on the card through K1; a pool's outputs come back onto the card.

Every test needs a CUDA device and skips without one.  The file does not
import JAX, so on a machine with a card

    python -m pytest --noconftest -m cuda tests/unit/test_torch_backends_cuda.py

runs it alone.
"""

import numpy as np
import pytest
import torch

import elfi_tpu_torch as et
from elfi_tpu_torch.compile.compiler import compile_program
from elfi_tpu_torch.models import ma2, ma2_kernel
from elfi_tpu_torch.ops.kernels.ma2 import ma2_distance
from elfi_tpu_torch.utils import capture

from chunk_keys import chunk_keys

torch.set_num_threads(1)

BATCH, N_BATCHES = 2**14, 4


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
        pytest.skip("needs a CUDA device: the check is of the card's run")
    return torch.device("cuda", 0)


def _kernel_run(client, fused):
    et.set_client(client)
    m = ma2_kernel.get_model(seed_obs=4)
    ma2_distance.launches = ma2_distance.graph_launches = 0
    res = et.Rejection(m["d"], batch_size=BATCH, seed=3).sample(
        200, n_sim=N_BATCHES * BATCH, fused=fused, bar=False)
    torch.cuda.synchronize()
    # K1's launches by the host and inside replayed CUDA graphs
    return res, ma2_distance.launches + ma2_distance.graph_launches


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False])
def test_device_list_on_the_card_equals_native(cuda, fused):
    want, n = _kernel_run(et.NativeBackend(cuda), fused)
    assert n == N_BATCHES
    for devices in ([cuda], [cuda, cuda]):
        got, n = _kernel_run(et.ShardedBackend(devices), fused)
        assert n == N_BATCHES
        for k in want.outputs:
            np.testing.assert_array_equal(got.outputs[k], want.outputs[k])


#: three chunks of 16 batches
CARD_BATCH, CARD_BATCHES = 2**16, 48


def _card_run(client, m, guarded=False):
    """A fused rejection call; ``guarded``: its loop and last merge with
    every host synchronisation raising an error."""
    et.set_client(client)
    ma2_distance.launches = ma2_distance.graph_launches = 0
    rej = et.Rejection(m["d"], batch_size=CARD_BATCH, seed=7)
    if guarded:
        run_fused = rej._run_fused

        def _run_fused(*args, **kwargs):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return run_fused(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        rej._run_fused = _run_fused
    res = rej.sample(300, n_sim=CARD_BATCHES * CARD_BATCH, bar=False)
    return rej, res


@pytest.mark.cuda
@pytest.mark.parametrize("cards", ["every_card", "one_card_four_times"])
def test_card_graphs_equal_the_eager_list_and_one_device(cuda, cards,
                                                         monkeypatch):
    """The first runs record and capture each card's graphs, the fourth
    replays every chunk's share of every card; each run's rows are the
    eager device list's and one device's."""
    if cards == "every_card":
        if torch.cuda.device_count() < 2:
            pytest.skip("needs two or more CUDA devices")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [cuda] * 4
    m = ma2_kernel.get_model(seed_obs=4)
    _, want = _card_run(et.NativeBackend(cuda), m)
    monkeypatch.setattr(capture, "_ENABLED", False)
    _, eager = _card_run(et.ShardedBackend(devices), m)
    monkeypatch.setattr(capture, "_ENABLED", True)
    for k in want.outputs:
        np.testing.assert_array_equal(eager.outputs[k], want.outputs[k])
    for run in range(4):
        # the replays are queued without a wait
        rej, got = _card_run(et.ShardedBackend(devices), m, guarded=run == 3)
        for k in want.outputs:
            np.testing.assert_array_equal(got.outputs[k], want.outputs[k],
                                          err_msg=f"run {run}, {k}")
    # the last run: every batch's K1 inside a replayed graph
    assert rej.state["card_replays"] == [3] * len(devices)
    assert sum(rej.state["card_batches"]) == CARD_BATCHES
    assert ma2_distance.launches == 0
    assert ma2_distance.graph_launches == CARD_BATCHES
    # each card's graphs are kept with its own program, a key a position
    for dev in dict.fromkeys(devices):
        prog = compile_program(m, tuple(rej.output_names), device=dev)
        at = {key.position for key in chunk_keys(prog.replays).values()}
        assert at == {k for k, d in enumerate(devices) if d == dev}


@pytest.mark.cuda
def test_cluster_master_computes_on_the_card(cuda):
    from elfi_tpu_torch.parallel.cluster import ClusterBackend
    backend = ClusterBackend(device=cuda)
    try:
        got, n = _kernel_run(backend, None)
    finally:
        backend.close()
    assert n == N_BATCHES
    want, _ = _kernel_run(et.NativeBackend(cuda), None)
    np.testing.assert_array_equal(got.samples_array, want.samples_array)


@pytest.mark.cuda
def test_pool_outputs_come_back_onto_the_card(cuda):
    pool = et.MultiprocessingBackend(1, device=cuda)
    try:
        prog = compile_program(ma2.get_model(seed_obs=4), ("d", "t1"),
                               device=cuda)
        out = pool.get_result(pool.submit(prog, 2, 0, {}, 64))
        cpu = compile_program(prog.model, ("d", "t1"), device="cpu").run(
            2, 0, {}, 64)
    finally:
        pool.close()
    for k, v in out.items():
        assert v.device == cuda
        torch.testing.assert_close(v.cpu(), cpu[k], rtol=0, atol=0)

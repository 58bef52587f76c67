"""The backends beyond one device on the card: the device list naming
cuda:0 twice deals the MA2 kernel graph's batches and equals the native
run bit for bit with K1 launched once a batch, fused and batch at a time;
a cluster master with no worker computes on the card through K1; a pool's
outputs come back onto the card.

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

"""The PyTorch port's ``torch.distributed`` farming on the CPU: a real
two-process gloo job (the port of ``test_two_process_multihost``) in which
both ranks run the same rejection and give the same samples, equal to a
one-process native run, with a host graph farmed (each rank simulates its
own batches and the first) and its raw outputs bit-equal; and the
one-process backend (the port of ``test_rejection.py``'s
``test_multihost_backend_single_process``)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import elfi_tpu_torch as et
from elfi_tpu_torch.models import ma2, ma2_kernel

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_WORKER = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
addr, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=addr, world_size=2, rank=rank)
import elfi_tpu_torch as et
from elfi_tpu_torch.models import ma2, ma2_kernel
from elfi_tpu_torch.parallel.multihost import MultihostBackend

et.set_client(MultihostBackend(device="cpu"))
assert et.get_client().num_processes == 2
for name, mod in (("plain", ma2), ("kernel", ma2_kernel)):
    m = mod.get_model(seed_obs=4)
    res = et.Rejection(m["d"], batch_size=200, seed=17).sample(
        20, n_sim=1000, bar=False)
    np.save(out + f"_{name}.npy", res.samples_array)

CALLS = {"n": 0}

def hostsim(t, batch_size=1, random_state=None, **kw):
    CALLS["n"] += 1
    return np.atleast_1d(t)[:, None] + random_state.normal(
        size=(batch_size, 3))

mh = et.Model(name="farm")
p = et.Prior("uniform", 0, 1, model=mh, name="p")
et.Simulator(hostsim, p, observed=0.5 * np.ones(3), host=True, model=mh,
             name="sim")
et.Distance("euclidean", mh["sim"], model=mh, name="d")
res2 = et.Rejection(mh["d"], batch_size=50, seed=23).sample(
    10, n_sim=400, bar=False)                      # 8 batches
# one shape batch on every rank, then 7 farmed round robin
assert 1 + 3 <= CALLS["n"] <= 1 + 4, CALLS["n"]
np.save(out + "_farm.npy", res2.samples_array)

rejb = et.Rejection(mh["d"], batch_size=50, seed=29, output_names=["sim"])
rejb.set_objective(10, n_sim=400)
for i in range(3):
    rejb.batches.submit(rejb.prepare_new_batch(i))
raw = [rejb.batches.wait_next()[0]["sim"].numpy() for _ in range(3)]
np.save(out + "_farm_sim.npy", np.stack(raw))
dist.destroy_process_group()
print("WORKER_OK")
"""


def _hostsim(t, batch_size=1, random_state=None, **kw):
    return np.atleast_1d(t)[:, None] + random_state.normal(
        size=(batch_size, 3))


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


def test_two_process_multihost(tmp_path):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    addr = f"tcp://localhost:{port}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    outs = [str(tmp_path / f"rank{i}") for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, addr, str(i), outs[i]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=ROOT)
        for i in range(2)]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a multihost rank timed out")
        logs.append(out.decode())
    for i, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and "WORKER_OK" in log, \
            f"rank {i} failed:\n{log[-3000:]}"

    for name, mod in (("plain", ma2), ("kernel", ma2_kernel)):
        a, b = (np.load(o + f"_{name}.npy") for o in outs)
        np.testing.assert_array_equal(a, b)
        m = mod.get_model(seed_obs=4)
        ref = et.Rejection(m["d"], batch_size=200, seed=17).sample(
            20, n_sim=1000, bar=False, fused=False)
        np.testing.assert_array_equal(ref.samples_array, a)

    fa, fb = (np.load(o + "_farm.npy") for o in outs)
    np.testing.assert_array_equal(fa, fb)
    mh = et.Model(name="farm_native")
    p = et.Prior("uniform", 0, 1, model=mh, name="p")
    et.Simulator(_hostsim, p, observed=0.5 * np.ones(3), host=True,
                 model=mh, name="sim")
    et.Distance("euclidean", mh["sim"], model=mh, name="d")
    nat = et.Rejection(mh["d"], batch_size=50, seed=23).sample(
        10, n_sim=400, bar=False)
    np.testing.assert_array_equal(nat.samples_array, fa)

    # raw batches: 0 is the shape batch, 1 and 2 are farmed one way each
    rejb = et.Rejection(mh["d"], batch_size=50, seed=29,
                        output_names=["sim"])
    rejb.set_objective(10, n_sim=400)
    for i in range(3):
        rejb.batches.submit(rejb.prepare_new_batch(i))
    nat_raw = np.stack([rejb.batches.wait_next()[0]["sim"].numpy()
                        for _ in range(3)])
    for o in outs:
        farm_raw = np.load(o + "_farm_sim.npy")
        assert farm_raw.dtype == nat_raw.dtype
        np.testing.assert_array_equal(nat_raw, farm_raw)


def test_multihost_backend_single_process():
    """Without a process group the backend runs the native path and gives
    the native samples."""
    from elfi_tpu_torch.parallel.multihost import MultihostBackend
    m = ma2.get_model(seed_obs=4)
    r_native = et.Rejection(m["d"], batch_size=300, seed=21).sample(
        30, n_sim=900, bar=False, fused=False)
    et.set_client(MultihostBackend(device="cpu"))
    assert et.get_client().num_processes == 1
    r_mh = et.Rejection(m["d"], batch_size=300, seed=21).sample(
        30, n_sim=900, bar=False)
    np.testing.assert_array_equal(r_native.samples_array, r_mh.samples_array)


def test_broadcast_header_and_dtypes():
    """The header names every output's shape and dtype; outputs that are
    not tensors are refused."""
    from elfi_tpu_torch.parallel.multihost import _header
    out = {"b": torch.zeros((4, 2), dtype=torch.bool),
           "a": torch.arange(3)}
    assert _header(out) == [("a", (3,), torch.int64),
                            ("b", (4, 2), torch.bool)]
    with pytest.raises(TypeError):
        _header({"x": np.zeros(3)})

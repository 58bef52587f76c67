"""Pools, persistence and the distributions on the card: a pool filled from
CUDA batches of the MA2 kernel graph and replayed onto the card without a
K1 launch, a model saved with CUDA tensors that loads with its tensors on
the CPU (in a process that sees no card), the eleven distributions'
``logpdf``, ``cdf`` and ``ppf`` on the card equal to the CPU, and
``utils.profiling.trace`` on the card keeping every device record.

Every test needs a CUDA device and skips without one.  The file does not
import JAX, so on a machine with a card

    python -m pytest --noconftest -m cuda tests/unit/test_torch_pool_cuda.py

runs it alone.
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import elfi_tpu_torch as et
from elfi_tpu_torch.models import ma2_kernel
from elfi_tpu_torch.ops import distributions as d
from elfi_tpu_torch.ops.kernels.ma2 import ma2_distance

torch.set_num_threads(1)


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


def _reset(fn):
    fn.launches = fn.captured = fn.graph_launches = 0


def _ran(fn):
    """Launches of ``fn``'s kernel on the card: by the host, and inside
    the CUDA graphs replayed (``utils.capture``)."""
    return fn.launches + fn.graph_launches


@pytest.mark.cuda
def test_pool_from_cuda_batches_replays_onto_the_card(cuda):
    m = ma2_kernel.get_model(seed_obs=4)
    kw = dict(batch_size=2**14, seed=3, device=cuda)
    plain = et.Rejection(m["d"], **kw).sample(100, n_sim=4 * 2**14,
                                               fused=False, bar=False)
    pool = et.OutputPool(["t1", "t2", "d"])
    _reset(ma2_distance)
    first = et.Rejection(m["d"], pool=pool, **kw).sample(
        100, n_sim=4 * 2**14, bar=False)
    assert _ran(ma2_distance) == 4 and len(pool) == 4
    assert isinstance(pool.get_batch(0)["d"], np.ndarray)
    for k in plain.outputs:
        np.testing.assert_array_equal(first.outputs[k], plain.outputs[k])

    _reset(ma2_distance)
    replay = et.Rejection(m["d"], pool=pool, **kw)
    again = replay.sample(100, n_sim=4 * 2**14, bar=False)
    torch.cuda.synchronize()
    assert _ran(ma2_distance) == 0
    assert all(v.device == cuda for v in replay.state["samples"].values())
    assert all(v.device == cuda
               for v in replay.batches._replayed(0).values())
    for k in first.outputs:
        np.testing.assert_array_equal(again.outputs[k], first.outputs[k])


LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync")


@pytest.mark.cuda
def test_trace_on_the_card_keeps_every_device_record(cuda, tmp_path):
    """Two traces of a pooled two-batch run: each holds the annotation,
    both K1 launches and a device record for every host launch after the
    primer that ``recorded`` opens its recording with (but those made
    while a CUDA graph was captured, which record and run nothing)."""
    from elfi_tpu_torch.utils.profiling import PRIMER_NAME, annotate, trace
    m = ma2_kernel.get_model(seed_obs=4)
    for i in range(2):
        logdir = str(tmp_path / f"trace{i}")
        rej = et.Rejection(m["d"], batch_size=2**14, seed=i, device=cuda,
                           pool=et.OutputPool(["t1", "t2", "d"]))
        with trace(logdir), annotate("pooled_run"):
            rej.sample(100, n_sim=2 * 2**14, bar=False)
        with open(os.path.join(logdir, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
        assert any(e.get("name") == "pooled_run" for e in events)
        kernels = [e for e in events if e.get("cat") == "kernel"]
        assert sum("ma2_distance_kernel" in e["name"] for e in kernels) == 2
        primer_end = max(e["ts"] + e.get("dur", 0) for e in events
                         if e.get("name") == PRIMER_NAME
                         and e.get("cat") == "user_annotation")
        spans = list(zip(
            sorted(e["ts"] for e in events
                   if e.get("name", "").startswith("cudaStreamBeginCapture")),
            sorted(e["ts"] for e in events
                   if e.get("name", "").startswith("cudaStreamEndCapture"))))
        launches = {e["args"]["correlation"] for e in events
                    if e.get("cat") in ("cuda_runtime", "cuda_driver")
                    and e.get("name") in LAUNCH_CALLS
                    and e["ts"] > primer_end
                    and not any(b <= e["ts"] <= f for b, f in spans)}
        on_card = {e["args"].get("correlation") for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")}
        assert launches and launches <= on_card


@pytest.mark.cuda
def test_model_saved_on_the_card_loads_on_the_cpu(cuda, tmp_path):
    m = ma2_kernel.get_model(seed_obs=4)
    et.Constant(torch.arange(3.0, device=cuda), model=m, name="c")
    m.observed["extra"] = torch.ones(2, device=cuda)
    before = m.generate(64, outputs=["d"], seed=5, device=cuda)["d"]
    assert m["d"].state["op"]._obs_on     # a per-device copy exists
    path = m.save(prefix=str(tmp_path))
    loaded = et.load_model(path)
    assert loaded["c"].state["value"].device.type == "cpu"
    assert loaded.observed["extra"].device.type == "cpu"
    assert loaded["d"].state["op"]._obs_on == {}
    np.testing.assert_array_equal(
        loaded.generate(64, outputs=["d"], seed=5, device=cuda)["d"],
        before)
    code = ("import pickle, torch; m = pickle.load(open(%r, 'rb')); "
            "print(torch.cuda.is_available(), "
            "m['c'].state['value'].device.type)" % path)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(
                   [os.path.dirname(os.path.dirname(os.path.dirname(
                       os.path.abspath(__file__))))]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=300)
    assert out.stdout.split() == ["False", "cpu"]


#: (name, params, x range or None for the counts 0..20, functions); the
#: betainc and bisection functions at rtol 1e-4 / atol 1e-5, the rest at
#: rtol 1e-5 / atol 1e-6
CASES = [
    ("lognorm", (0.5, 0.0, 2.0), (0.05, 8.0), ("logpdf", "cdf", "ppf")),
    ("gamma", (2.0, 0.0, 1.5), (0.01, 15.0), ("logpdf", "cdf", "ppf")),
    ("beta", (2.0, 5.0), (0.001, 0.999), ("logpdf", "cdf", "ppf")),
    ("binom", (20, 0.3), None, ("logpdf",)),
    ("poisson", (4.0,), None, ("logpdf",)),
    ("t", (10.0, 0.5, 2.0), (-8.0, 8.0), ("logpdf", "cdf", "ppf")),
    ("cauchy", (1.0, 2.0), (-20.0, 20.0), ("logpdf", "cdf", "ppf")),
    ("laplace", (0.5, 2.0), (-10.0, 10.0), ("logpdf", "cdf", "ppf")),
    ("chi2", (4.0,), (0.01, 20.0), ("logpdf", "cdf", "ppf")),
    ("skewnorm", (3.0, 0.2, 1.5), (-3.0, 6.0), ("logpdf", "cdf")),
    ("weibull_min", (1.5, 0.0, 2.0), (0.01, 8.0), ("logpdf", "cdf", "ppf")),
]
LOOSE = {("gamma", "ppf"), ("chi2", "ppf"), ("beta", "cdf"), ("beta", "ppf"),
         ("t", "cdf"), ("t", "ppf")}


@pytest.mark.cuda
@pytest.mark.parametrize("name,params,xr,fns", CASES,
                         ids=[c[0] for c in CASES])
def test_distribution_on_the_card_equals_the_cpu(cuda, name, params, xr,
                                                 fns):
    rng = np.random.default_rng(0)
    x = np.arange(21, dtype=np.float32) if xr is None else \
        rng.uniform(*xr, 4096).astype(np.float32)
    q = rng.uniform(0, 1, 4096).astype(np.float32)
    dist = getattr(d, name)
    for fn in fns:
        arg = torch.as_tensor(q if fn == "ppf" else x)
        on_card = getattr(dist, fn)(arg.to(cuda), *params)
        assert on_card.device == cuda
        on_cpu = getattr(dist, fn)(arg, *params)
        rtol, atol = (1e-4, 1e-5) if (name, fn) in LOOSE else (1e-5, 1e-6)
        np.testing.assert_allclose(on_card.cpu().numpy(), on_cpu.numpy(),
                                   rtol=rtol, atol=atol,
                                   err_msg=f"{name}.{fn}")
    g = torch.Generator(device=cuda).manual_seed(1)
    draw = dist.rvs(*params, size=1024, generator=g)
    assert draw.device == cuda and draw.shape == (1024,)

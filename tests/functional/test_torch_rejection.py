"""MA2 rejection-ABC end to end in the PyTorch port, on the CPU: the fused
and batch-at-a-time loops agree bit for bit, both MA2 graphs pass the JAX
package's accuracy gate on its own observed data, and the committed observed
data is the JAX package's draw."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import elfi_tpu_torch as et
from elfi_tpu.models import ma2 as jax_ma2
from elfi_tpu_torch.models import ma2, ma2_kernel
from elfi_tpu_torch.models._observed import load_observed

torch.set_num_threads(1)

TRUE = np.array([0.6, 0.2])
MODELS = {"plain": ma2, "kernel": ma2_kernel}


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


def _check(res, atol=0.05):
    means = np.array([np.mean(res.samples[k]) for k in ("t1", "t2")])
    err = np.abs(means - TRUE)
    assert np.all(err < atol), f"posterior means {means}, err {err}"


@pytest.mark.parametrize("graph", sorted(MODELS))
def test_ma2_gate(graph):
    """The gate of tests/functional/test_inference.py at seed_obs=271."""
    m = MODELS[graph].get_model(seed_obs=271)
    rej = et.Rejection(m["d"], batch_size=1 << 14, seed=1, device="cpu")
    res = rej.sample(1000, n_sim=1 << 19, bar=False)
    assert res.n_sim == 1 << 19 and res.n_batches == 32
    assert res.outputs["d"].shape == (1000,)
    assert np.all(np.diff(res.outputs["d"]) >= 0)
    assert res.threshold == res.outputs["d"][-1]
    _check(res)


@pytest.mark.parametrize("graph", sorted(MODELS))
@pytest.mark.parametrize("objective", [dict(n_sim=6 * 4096),
                                       dict(quantile=0.05)])
def test_fused_equals_batch_at_a_time(graph, objective):
    m = MODELS[graph].get_model(seed_obs=4)
    kw = dict(batch_size=4096, seed=7, device="cpu")
    a = et.Rejection(m["d"], **kw).sample(300, bar=False, **objective)
    b = et.Rejection(m["d"], **kw).sample(300, bar=False, fused=False,
                                          **objective)
    assert a.n_sim == b.n_sim and a.n_batches == b.n_batches
    assert sorted(a.outputs) == sorted(b.outputs)
    for k in a.outputs:
        np.testing.assert_array_equal(a.outputs[k], b.outputs[k], err_msg=k)


def test_seed_determinism_and_sensitivity():
    m = ma2.get_model(seed_obs=4)

    def run(seed):
        return et.Rejection(m["d"], batch_size=2048, seed=seed).sample(
            100, n_sim=4 * 2048, bar=False).outputs["t1"]

    np.testing.assert_array_equal(run(3), run(3))
    assert not np.array_equal(run(3), run(4))


@pytest.mark.parametrize("fused", [True, False])
def test_threshold_objective(fused):
    m = ma2.get_model(seed_obs=271)
    rej = et.Rejection(m["d"], batch_size=1 << 14, seed=2)
    res = rej.sample(200, threshold=0.1, fused=fused, bar=False)
    assert res.outputs["d"].shape == (200,)
    assert np.all(res.outputs["d"] <= 0.1)
    assert res.n_sim == res.n_batches * (1 << 14)
    _check(res, atol=0.1)


def test_extra_outputs_and_progress_bar(capsys):
    m = ma2.get_model(seed_obs=4)
    rej = et.Rejection(m["d"], batch_size=1024, seed=0,
                       output_names=["S1", "S2"])
    res = rej.sample(50, n_sim=4096)
    assert "Progress" in capsys.readouterr().out
    assert res.outputs["S1"].shape == (50,)
    assert set(res.samples) == {"t1", "t2"}
    assert res.samples_array.shape == (50, 2)
    assert res.discrepancies.shape == (50,)
    assert "Number of samples: 50" in str(res)


def test_requested_device_is_kept(monkeypatch):
    """A requested device is used as given, never replaced by the CPU; with
    none requested the global backend's is used, the card by default."""
    m = ma2.get_model(seed_obs=4)
    et.set_client(et.NativeBackend(device="cuda"))
    assert et.Rejection(m["d"], batch_size=8).device.type == "cuda"
    assert et.Rejection(m["d"], batch_size=8,
                        device="cpu").device.type == "cpu"
    et.set_client("native", device="cpu")
    assert et.get_client().device.type == "cpu"
    # a machine with a card: the default backend is on the current one
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    et.set_client("native")
    assert et.get_client().device == torch.device("cuda", 0)
    assert et.Rejection(m["d"], batch_size=8).device == \
        torch.device("cuda", 0)
    # the device list of every CUDA device: none on this machine
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        et.set_client("sharded")
    assert et.set_client("sharded", devices=["cpu"]).device.type == "cpu"


@pytest.mark.parametrize("seed_obs", [0, 4, 271])
def test_committed_observed_data_is_the_jax_draw(seed_obs):
    y = np.asarray(jax_ma2.MA2(jnp.asarray([.6]), jnp.asarray([.2]),
                               n_obs=100, batch_size=1,
                               key=jax.random.key(seed_obs)))[0]
    stored = load_observed(ma2._DATA, 100, 100, None, (.6, .2), seed_obs)
    np.testing.assert_array_equal(stored, y)
    assert stored.dtype == y.dtype
    m_t, m_j = ma2.get_model(seed_obs=seed_obs), \
        jax_ma2.get_model(seed_obs=seed_obs)
    np.testing.assert_array_equal(m_t.observed["MA2"], m_j.observed["MA2"])


def test_unstored_observed_data_raises():
    """The settings no file holds, once refused, give the JAX package's
    observed data (MA2's draw is bit for bit; the kernel graph's
    autocovariances within rtol 1e-6)."""
    from elfi_tpu.models import ma2_pallas
    for kw in (dict(seed_obs=5), dict(n_obs=50)):
        np.testing.assert_array_equal(ma2.get_model(**kw).observed["MA2"],
                                      jax_ma2.get_model(**kw).observed["MA2"])
    kw = dict(true_params=[0.5, 0.1])
    op_t = ma2_kernel.get_model(**kw).dag.get_state("d")["op"]
    op_j = ma2_pallas.get_model(**kw).dag.get_state("d")["op"]
    np.testing.assert_allclose(op_t.obs, op_j.obs, rtol=1e-6)


def test_kernel_graph_observed_autocovs_equal_jax():
    from elfi_tpu.models import ma2_pallas
    op_t = ma2_kernel.get_model(seed_obs=271).dag.get_state("d")["op"]
    op_j = ma2_pallas.get_model(seed_obs=271).dag.get_state("d")["op"]
    np.testing.assert_allclose(op_t.obs, op_j.obs, rtol=1e-6)
    assert op_t.obs.dtype == op_j.obs.dtype == np.float32


def test_kernel_graph_runs_through_the_wrapper(monkeypatch):
    """The kernel graph's discrepancy node calls the kernel's wrapper once
    per batch, with the node's own generator."""
    import elfi_tpu_torch.models.ma2_kernel as mk
    calls = []
    real = mk.ma2_distance

    def spy(t1, t2, obs, n_obs, batch_size, generator):
        calls.append((batch_size, generator.initial_seed()))
        return real(t1, t2, obs, n_obs=n_obs, batch_size=batch_size,
                    generator=generator)

    monkeypatch.setattr(mk, "ma2_distance", spy)
    m = mk.get_model(seed_obs=4)
    et.Rejection(m["d"], batch_size=1024, seed=0).sample(
        10, n_sim=3 * 1024, bar=False)
    assert [c[0] for c in calls] == [1024] * 3
    assert len({c[1] for c in calls}) == 3


def _outputs_equal(a, b, what):
    assert sorted(a.outputs) == sorted(b.outputs)
    for k in a.outputs:
        np.testing.assert_array_equal(a.outputs[k], b.outputs[k],
                                      err_msg=f"{what}: {k}")


@pytest.mark.parametrize("devices", [None, ["cpu", "cpu"]])
def test_fused_merge_unroll_and_cull_parity(devices, monkeypatch):
    """The counterpart of tests/functional/test_rejection.py's
    test_fused_merge_unroll_parity, with the culled merge on: u batches
    concatenated into one merge equal one merge a batch, bit for bit, for
    u = 1-4 (10 batches at u = 3 and 4 end each chunk with a remainder
    merge), in quantile and threshold mode, on one device and over a
    device list (each device concatenating its own batches)."""
    from elfi_tpu_torch.methods import samplers
    from elfi_tpu_torch.ops import topk
    m = ma2.get_model(seed_obs=4)
    monkeypatch.setattr(topk, "CULL_SMALL_K", 16)
    monkeypatch.setattr(topk, "CULL_MIN_BATCH", 128)

    def run(**kw):
        return et.Rejection(m["d"], batch_size=128, seed=13).sample(
            40, bar=False, **kw)

    monkeypatch.setattr(topk, "MERGE_VARIANT", "flat")
    monkeypatch.setattr(samplers, "FUSED_UNROLL", 1)
    base, base_thr = run(n_sim=1280), run(threshold=0.3)
    if devices:
        et.set_client("sharded", devices=devices)
    monkeypatch.setattr(topk, "MERGE_VARIANT", "culled")
    for u in (1, 2, 3, 4):
        monkeypatch.setattr(samplers, "FUSED_UNROLL", u)
        _outputs_equal(run(n_sim=1280), base, f"unroll {u}")
        res_thr = run(threshold=0.3)
        _outputs_equal(res_thr, base_thr, f"unroll {u}, threshold")
        assert res_thr.n_sim == base_thr.n_sim


def test_fused_loop_routes_a_fresh_buffer_to_the_flat_merge(monkeypatch):
    """The host's rule: a device's merges before its buffer has taken n
    rows go to the flat merge (fresh=True), every later one to the cull;
    u batches make one merge.  A device list queues a chunk card after
    card, so each device's merges come in turn."""
    from elfi_tpu_torch.methods import samplers
    from elfi_tpu_torch.ops import topk
    m = ma2.get_model(seed_obs=4)
    monkeypatch.setattr(topk, "CULL_SMALL_K", 16)
    monkeypatch.setattr(topk, "CULL_MIN_BATCH", 64)
    seen = []
    scan = topk.merge_scan
    monkeypatch.setattr(topk, "merge_scan", lambda b, batch, t, d, fresh: (
        seen.append((batch[d].shape[0], fresh)) or scan(b, batch, t, d,
                                                        fresh=fresh)))
    for u, expect in ((1, [(64, True)] * 3 + [(64, False)] * 5),
                      (2, [(128, True)] * 2 + [(128, False)] * 2)):
        monkeypatch.setattr(samplers, "FUSED_UNROLL", u)
        seen.clear()
        et.Rejection(m["d"], batch_size=64, seed=1).sample(
            150, n_sim=8 * 64, bar=False)
        assert seen == expect
    et.set_client("sharded", devices=["cpu", "cpu"])
    monkeypatch.setattr(samplers, "FUSED_UNROLL", 1)
    seen.clear()
    et.Rejection(m["d"], batch_size=64, seed=1).sample(100, n_sim=8 * 64,
                                                       bar=False)
    assert seen == ([(64, True)] * 2 + [(64, False)] * 2) * 2

"""Checkpoint and resume in the port: the mirror of
``tests/functional/test_resume.py`` (pool replay skips simulation, the
pool extends on a longer run, the model's save/load round trip, a failed
batch resubmitted deterministically), plus the MA2 kernel graph replayed
without running its distance op, a pool changing no result, a replayed
batch computed by ``BatchHandler.compute`` equal to the stored one, and
``fused=True`` with a pool refused by each of the five fused methods."""

import pickle

import numpy as np
import pytest
import torch

import elfi_tpu_torch as et
from elfi_tpu_torch.models import gnk, ma2, ma2_kernel

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


_SIM_CALLS = {"n": 0}


def _counting_sim(t1, batch_size=1, random_state=None):
    """Host simulator with a call counter (host ops run in-process on the
    native backend, so the counter sees real executions)."""
    _SIM_CALLS["n"] += 1
    t1 = np.atleast_1d(np.asarray(t1, dtype=np.float64))
    return t1[:, None] + random_state.normal(size=(batch_size, 5))


def _mean_summary(x):
    return x.mean(1, keepdim=True)


def _counting_model():
    m = et.Model(name="resume_counting")
    et.Prior("uniform", 0, 1, model=m, name="t1")
    sim = et.Simulator(et.tools.mark_host(_counting_sim), m["t1"],
                       observed=np.full((1, 5), 0.5), model=m, name="sim")
    s = et.Summary(_mean_summary, sim, model=m, name="S")
    et.Distance("euclidean", s, model=m, name="d")
    return m


def test_pool_replay_skips_simulation():
    m = _counting_model()
    pool = et.OutputPool(["sim"])
    _SIM_CALLS["n"] = 0
    res1 = et.Rejection(m["d"], batch_size=10, seed=7, pool=pool).sample(
        5, n_sim=40, bar=False)
    calls_first = _SIM_CALLS["n"]
    assert calls_first >= 4  # 40 sims / batch 10

    res2 = et.Rejection(m["d"], batch_size=10, seed=7, pool=pool).sample(
        5, n_sim=40, bar=False)
    assert _SIM_CALLS["n"] == calls_first  # all batches replayed
    np.testing.assert_array_equal(res1.samples_array, res2.samples_array)


def test_pool_extends_on_longer_run():
    m = _counting_model()
    pool = et.OutputPool(["sim"])
    _SIM_CALLS["n"] = 0
    et.Rejection(m["d"], batch_size=10, seed=7, pool=pool).sample(
        5, n_sim=20, bar=False)
    first = _SIM_CALLS["n"]
    et.Rejection(m["d"], batch_size=10, seed=7, pool=pool).sample(
        5, n_sim=40, bar=False)
    # only the 2 new batch indices simulate; the first 2 replay
    assert _SIM_CALLS["n"] == first + 2
    assert len(pool.stores["sim"]) == 4 and len(pool) == 4


def test_kernel_graph_replay_runs_no_distance_op(monkeypatch):
    """The MA2 kernel graph pooled on (t1, t2, d): a replay runs neither
    the priors nor the distance op (K1 on the card, its plain version
    here), and a longer run computes only the new batch indices."""
    calls = {"d": 0}
    kernel = ma2_kernel.ma2_distance

    def counting(*args, **kwargs):
        calls["d"] += 1
        return kernel(*args, **kwargs)

    monkeypatch.setattr(ma2_kernel, "ma2_distance", counting)
    m = ma2_kernel.get_model(seed_obs=4)
    pool = et.OutputPool(["t1", "t2", "d"])
    kw = dict(batch_size=256, seed=11)
    plain = et.Rejection(m["d"], **kw).sample(50, n_sim=4 * 256, bar=False,
                                               fused=False)
    calls["d"] = 0
    first = et.Rejection(m["d"], pool=pool, **kw).sample(
        50, n_sim=4 * 256, bar=False)
    assert calls["d"] == 4
    for k in plain.outputs:    # a pool changes no result
        np.testing.assert_array_equal(first.outputs[k], plain.outputs[k])

    calls["d"] = 0
    replay = et.Rejection(m["d"], pool=pool, **kw)
    prog_runs = []
    replay.batches.client._launch = (
        lambda prog, *a, _orig=replay.batches.client._launch:
        prog_runs.append(sorted(prog.order)) or _orig(prog, *a))
    again = replay.sample(50, n_sim=4 * 256, bar=False)
    assert calls["d"] == 0
    # every node of the replayed program is an override: nothing is drawn
    assert all(set(order) <= {"t1", "t2", "d"} for order in prog_runs)
    for k in first.outputs:
        np.testing.assert_array_equal(again.outputs[k], first.outputs[k])

    longer = et.Rejection(m["d"], pool=pool, **kw).sample(
        50, n_sim=6 * 256, bar=False)
    assert calls["d"] == 2 and len(pool) == 6
    assert longer.n_sim == 6 * 256


def test_compute_equals_the_pooled_batch():
    m = ma2.get_model(seed_obs=4)
    pool = et.OutputPool(["t1", "d"])
    rej = et.Rejection(m["d"], batch_size=64, seed=5, pool=pool)
    rej.sample(10, n_sim=2 * 64, bar=False)
    out = rej.batches.compute(1)
    np.testing.assert_array_equal(out["d"].numpy(), pool.get_batch(1)["d"])
    assert rej.batches.pending_indices == []
    assert not rej.batches.has_ready(any_batch=True)
    assert rej.batches.timers.report()["wait"]["calls"] == 2


def test_caller_overrides_win_over_the_pool():
    """A submitted override of a pooled name is used as given, and only
    the stored names the caller leaves are copied back."""
    m = ma2.get_model(seed_obs=4)
    pool = et.OutputPool(["t1", "t2", "d"])
    rej = et.Rejection(m["d"], batch_size=64, seed=5, pool=pool)
    rej.sample(10, n_sim=64, bar=False)
    assert sorted(rej.batches._replayed(0, skip={"t1": None})) == ["d", "t2"]

    handler = et.Rejection(m["d"], batch_size=64, seed=5, pool=pool).batches
    t1 = torch.full((64,), 0.25)
    handler.submit({"t1": t1})
    _, overrides = handler._submitted_args[0]
    assert overrides["t1"] is t1
    np.testing.assert_array_equal(overrides["t2"].numpy(),
                                  pool.get_batch(0)["t2"])
    out, _ = handler.wait_next()
    np.testing.assert_array_equal(out["t1"].numpy(), t1.numpy())


def _method(name, pool):
    m = ma2.get_model(seed_obs=4)
    if name == "rejection":
        return lambda: et.Rejection(m["d"], batch_size=100, seed=1,
                                    pool=pool).sample(10, n_sim=200,
                                                      fused=True, bar=False)
    if name == "smc":
        return lambda: et.SMC(m["d"], batch_size=100, seed=1,
                              pool=pool).sample(10, quantiles=[0.5],
                                                fused=True, bar=False)
    if name == "bsl":
        return lambda: et.BSL(m, n_sim_round=100, seed=1, pool=pool).sample(
            3, sigma_proposals=np.eye(2) * 0.1, fused=True, bar=False)
    if name == "bolfi":
        et.Operation(torch.log, m["d"], model=m, name="log_d")
        return lambda: et.BOLFI(m["log_d"], batch_size=1,
                                initial_evidence=4, update_interval=4,
                                bounds={"t1": (-2, 2), "t2": (-1, 1)},
                                seed=1, pool=pool).fit(8, fused=True,
                                                       bar=False)
    g = gnk.get_model(n_obs=50, seed_obs=1)
    et.Summary(gnk.ss_order, g["GNK"], model=g, name="ss_order")
    return lambda: et.BOLFIRE(
        g, n_training_data=100, feature_names=["ss_order"],
        bounds={p: (0, 10) for p in "ABgk"}, n_initial_evidence=4, seed=1,
        pool=pool).fit(8, fused=True, bar=False)


@pytest.mark.parametrize("name", ["rejection", "smc", "bsl", "bolfi",
                                  "bolfire"])
def test_fused_with_a_pool_raises(name):
    pool = et.OutputPool(["t1"])
    with pytest.raises(ValueError, match="pool"):
        _method(name, pool)()


def test_smc_and_bsl_with_a_pool_run_batch_at_a_time():
    """A pool turns the fused default off: the batches go through the
    handler and land in the pool."""
    m = ma2.get_model(seed_obs=4)
    pool = et.OutputPool(["d"])
    smc = et.SMC(m["d"], batch_size=100, seed=2, pool=pool)
    res = smc.sample(20, quantiles=[0.5, 0.5], bar=False)
    assert res.n_populations == 2 and len(pool) == smc.batches.total
    bpool = et.OutputPool(["S1"])
    bsl = et.BSL(m, n_sim_round=50, seed=3, pool=bpool)
    bres = bsl.sample(3, sigma_proposals=np.eye(2) * 0.1, bar=False)
    assert bres.n_samples == 3 and len(bpool) == bsl.batches.total > 0


def test_model_save_load_roundtrip(tmp_path):
    m = ma2.get_model(seed_obs=4)
    path = m.save(prefix=str(tmp_path))  # <prefix>/<model name>.pkl
    loaded = et.load_model(path)
    assert et.get_default_model() is loaded
    r1 = et.Rejection(m["d"], batch_size=100, seed=5).sample(
        10, n_sim=200, bar=False)
    r2 = et.Rejection(loaded["d"], batch_size=100, seed=5).sample(
        10, n_sim=200, bar=False)
    np.testing.assert_array_equal(r1.samples_array, r2.samples_array)


def test_saved_model_drops_programs_and_device_copies():
    """The program cache and the kernel op's per-device copy of the
    observed pair are not pickled; tensors in node states go to the CPU."""
    m = ma2_kernel.get_model(seed_obs=4)
    et.Constant(torch.ones(3), model=m, name="c")
    m.generate(4, seed=1)
    assert m._program_cache and m["d"].state["op"]._obs_on
    loaded = pickle.loads(pickle.dumps(m))
    assert "_program_cache" not in loaded.__dict__
    assert loaded["d"].state["op"]._obs_on == {}
    assert loaded["c"].state["value"].device.type == "cpu"
    np.testing.assert_array_equal(loaded.generate(4, seed=1)["d"],
                                  m.generate(4, seed=1)["d"])


_FLAKY = {"fail_next": 0, "calls": 0}


def _flaky_sim(t1, batch_size=1, random_state=None):
    """Host simulator that raises while the fail budget lasts."""
    _FLAKY["calls"] += 1
    if _FLAKY["fail_next"] > 0:
        _FLAKY["fail_next"] -= 1
        raise RuntimeError("transient simulator failure")
    t1 = np.atleast_1d(np.asarray(t1, dtype=np.float64))
    return t1[:, None] + random_state.normal(size=(batch_size, 4))


def _flaky_model():
    m = et.Model(name="flaky")
    et.Prior("uniform", 0, 1, model=m, name="t1")
    sim = et.Simulator(et.tools.mark_host(_flaky_sim), m["t1"],
                       observed=np.full((1, 4), 0.5), model=m, name="sim")
    s = et.Summary(_mean_summary, sim, model=m, name="S")
    et.Distance("euclidean", s, model=m, name="d")
    return m


def test_failed_batch_is_resubmitted_deterministically():
    m = _flaky_model()
    _FLAKY.update(fail_next=0, calls=0)
    clean = et.Rejection(m["d"], batch_size=20, seed=3).sample(
        5, n_sim=100, bar=False)

    _FLAKY.update(fail_next=2, calls=0)  # first two executions die
    recovered = et.Rejection(m["d"], batch_size=20, seed=3).sample(
        5, n_sim=100, bar=False)
    np.testing.assert_array_equal(clean.samples_array,
                                  recovered.samples_array)

    _FLAKY.update(fail_next=10**6)  # permanent failure -> hard error
    with pytest.raises(RuntimeError):
        et.Rejection(m["d"], batch_size=20, seed=4).sample(
            5, n_sim=100, bar=False)
    _FLAKY.update(fail_next=0)

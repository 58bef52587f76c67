"""The adaptive distance of the PyTorch port (``AdaptiveDistance``,
``AdaptiveDistanceOp`` and ``Rejection`` with an adaptive node) against the
JAX package's, from one state carried across by
``interop.adaptive_state_from_numpy``."""

from functools import partial

import numpy as np
import pytest
import torch

import jax

import elfi_tpu as elfi
import elfi_tpu_torch as et
from elfi_tpu.compile.compiler import compile_program as jax_compile_program
from elfi_tpu.models import ma2 as jax_ma2
from elfi_tpu_torch.compile.compiler import compile_program
from elfi_tpu_torch.interop import adaptive_state_from_numpy
from elfi_tpu_torch.models import gnk, ma2

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


def _adaptive(pkg, m, *sums):
    pkg.AdaptiveDistance(*(m[s] for s in sums), model=m, name="ad")
    return m["ad"]


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(1, 2, 64), rng.gamma(2.0, 3.0, (64, 1)))
            for _ in range(3)]


def test_welford_and_weights_equal_jax():
    """add_data / update_distance on the same numpy batches give the JAX
    node's accumulators and weights: both run in float64 numpy."""
    node_t = _adaptive(et, ma2.get_model(seed_obs=4), "S1", "S2")
    node_j = _adaptive(elfi, jax_ma2.get_model(seed_obs=4), "S1", "S2")
    for round_ in range(2):
        for s1, s2 in _batches(round_):
            node_t.add_data(s1, s2)
            node_j.add_data(s1, s2)
        st_t, st_j = node_t.adaptive_state, node_j.adaptive_state
        assert st_t["count"] == st_j["count"] == 192
        for k in ("mean", "m2", "scale"):
            np.testing.assert_array_equal(st_t[k], st_j[k])
        node_t.update_distance()
        node_j.update_distance()
    assert len(st_t["w"]) == len(st_j["w"]) == 3 and st_t["w"][0] is None
    for w_t, w_j in zip(st_t["w"][1:], st_j["w"][1:]):
        np.testing.assert_array_equal(w_t, w_j)
    assert st_t["count"] == 0 and st_t["version"] > 1


def test_adaptive_op_equals_jax_from_one_state():
    m_j = jax_ma2.get_model(seed_obs=4)
    node_j = _adaptive(elfi, m_j, "S1", "S2")
    for s1, s2 in _batches():
        node_j.add_data(s1, s2)
    node_j.update_distance()
    node_j.add_data(*_batches(1)[0])            # a round in progress
    m_t = ma2.get_model(seed_obs=4)
    node_t = _adaptive(et, m_t, "S1", "S2")
    st = adaptive_state_from_numpy(node_j.adaptive_state, node_t)
    for k in ("count", "mean", "m2", "scale"):
        np.testing.assert_array_equal(st[k], node_j.adaptive_state[k])

    rng = np.random.default_rng(3)
    s1 = rng.normal(size=256).astype(np.float32)
    s2 = rng.normal(size=256).astype(np.float32)
    obs = (np.float32([[0.4]]), np.float32([[0.1]]))
    want = np.asarray(m_j.dag.get_state("ad")["op"](s1, s2, observed=obs))
    got = m_t.dag.get_state("ad")["op"](
        torch.tensor(s1), torch.tensor(s2),
        observed=tuple(map(torch.tensor, obs))).numpy()
    assert got.shape == want.shape == (256, 2)
    # float32 weights and a 2-term float32 sum, as in the JAX package
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_program_cache_tracks_shared_adaptive_state():
    """The weights holder is shared across model copies; mutating it
    through a COPY must invalidate programs compiled against the ORIGINAL
    (whose revision does not change) -- the case of the JAX package's
    test_compiler.py."""
    for pkg, mod, comp, seed in (
            (et, ma2, partial(compile_program, device="cpu"), 0),
            (elfi, jax_ma2, jax_compile_program, jax.random.key(0))):
        m = mod.get_model(seed_obs=4)
        pkg.AdaptiveDistance(m["S1"], m["S2"], model=m, name="ad")
        prog1 = comp(m, ("ad",))
        node = m.copy()["ad"]
        node.init_adaptation_round()
        node.add_data(np.random.rand(16), np.random.rand(16))
        node.update_distance()            # bumps the COPY's revision only
        prog2 = comp(m, ("ad",))
        assert prog2 is not prog1
        out = prog2.run(seed, 0, {}, batch_size=8)
        assert np.asarray(out["ad"]).shape == (8, 2)


@pytest.mark.parametrize("model", ["ma2", "gnk_octile"])
def test_adaptive_rejection_structure(model):
    """The structural checks of the JAX package's test_smc.py on the
    adaptive node, on MA2 and on g-and-k octiles (Prangle 2017's worked
    example)."""
    if model == "ma2":
        m = ma2.get_model(seed_obs=4)
        et.AdaptiveDistance(m["S1"], m["S2"], model=m, name="ad")
        n_sums = 2
    else:
        m = gnk.get_model(seed_obs=1)
        et.Summary(gnk.ss_octile, m["GNK"], model=m, name="octiles")
        et.AdaptiveDistance(m["octiles"], model=m, name="ad")
        n_sums = 7
    rej = et.Rejection(m["ad"], batch_size=100, seed=3)
    assert rej.adaptive is True
    res = rej.sample(20, quantile=0.2, bar=False)
    st = rej.model["ad"].adaptive_state
    assert st is m["ad"].adaptive_state          # shared with the user's
    assert len(st["w"]) == 2                     # unweighted + 1 adapted
    assert st["w"][1].shape == (n_sums,) and np.all(st["w"][1] > 0)
    d = res.outputs["ad"]
    assert d.ndim == 1 and d.shape == (20,)      # re-computed distances
    assert np.all(np.diff(d) >= 0) and np.all(np.isfinite(d))
    assert res.threshold == d[-1]
    assert res.n_sim == 100 and res.samples_array.shape[0] == 20


def test_adaptive_distances_are_recomputed_under_the_new_weights():
    """The kept rows' distances are the adaptive op's last column on their
    summaries, under the weights frozen at the end of the run."""
    m = ma2.get_model(seed_obs=4)
    et.AdaptiveDistance(m["S1"], m["S2"], model=m, name="ad")
    res = et.Rejection(m["ad"], batch_size=256, seed=5).sample(
        50, n_sim=4 * 256, bar=False)
    w = m["ad"].adaptive_state["w"][-1].astype(np.float32)
    u = np.stack([res.outputs["S1"], res.outputs["S2"]], axis=1) * w
    prog = compile_program(m, ("S1", "S2"), device="cpu")
    v = np.array([float(prog.observed_value(s)[0]) for s in ("S1", "S2")],
                 np.float32) * w
    np.testing.assert_allclose(res.outputs["ad"],
                               np.sqrt(((u - v) ** 2).sum(axis=1)),
                               rtol=1e-6)


def test_adaptive_runs_batch_at_a_time_and_refuses_fused():
    m = ma2.get_model(seed_obs=4)
    et.AdaptiveDistance(m["S1"], m["S2"], model=m, name="ad")
    with pytest.raises(ValueError, match="adaptive"):
        et.Rejection(m["ad"], batch_size=64, seed=1).sample(
            10, n_sim=128, fused=True, bar=False)
    a = et.Rejection(m["ad"], batch_size=64, seed=1)
    res = a.sample(10, n_sim=128, bar=False)           # fused=None
    assert res.n_batches == 2

"""The method layer's host-side helpers and result container of the
PyTorch port against the JAX package's on the same numpy inputs."""

import json

import numpy as np
import pytest
import torch

from elfi_tpu.methods import results as jresults
from elfi_tpu.methods import utils as jutils
import elfi_tpu_torch as et
from elfi_tpu_torch.methods import results, utils

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


@pytest.mark.parametrize("weights", [None, "random"])
def test_weighted_statistics_equal_jax(weights):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(200, 3))
    w = None if weights is None else rng.uniform(0.1, 1, 200)
    np.testing.assert_array_equal(utils.weighted_var(x, w),
                                  jutils.weighted_var(x, w))
    for alpha in (0.0, 0.025, 0.5, 0.975, 1.0):
        assert utils.weighted_sample_quantile(x[:, 0], alpha, w) == \
            jutils.weighted_sample_quantile(x[:, 0], alpha, w)
    if w is not None:
        assert utils.compute_ess(w) == jutils.compute_ess(w)
        np.testing.assert_array_equal(utils.normalize_weights(w),
                                      jutils.normalize_weights(w))


def test_batch_helpers_equal_jax():
    x = np.arange(12.0).reshape(6, 2)
    names = ["a", "b"]
    bt, bj = utils.arr2d_to_batch(x, names), jutils.arr2d_to_batch(x, names)
    assert sorted(bt) == sorted(bj)
    for k in bj:
        np.testing.assert_array_equal(bt[k], bj[k])
    batch = {"a": np.arange(4.0), "b": np.ones((4, 2, 2))}
    np.testing.assert_array_equal(utils.batch_to_arr2d(batch, ["a", "b"]),
                                  jutils.batch_to_arr2d(batch, ["a", "b"]))
    assert utils.batch_to_arr2d(batch, []).shape == (0, 0)
    for n, b in ((1, 8), (8, 8), (9, 8), (100, 7)):
        assert utils.ceil_to_batch_size(n, b) == \
            jutils.ceil_to_batch_size(n, b)
    with pytest.raises(ValueError):
        utils.arr2d_to_batch(x, ["a"])
    with pytest.raises(ValueError, match="zero"):
        utils.normalize_weights(np.zeros(3))


def _samples(pkg, weights=None):
    rng = np.random.default_rng(4)
    outputs = {"t1": rng.normal(size=50), "t2": rng.normal(size=50),
               "d": np.sort(rng.uniform(size=50))}
    return pkg.Sample("Rejection", outputs, ["t1", "t2"],
                      discrepancy_name="d", weights=weights, n_sim=500,
                      threshold=outputs["d"][-1], seed=1)


@pytest.mark.parametrize("weighted", [False, True])
def test_sample_statistics_equal_jax(weighted):
    w = np.linspace(0.5, 1.5, 50) if weighted else None
    st, sj = _samples(results, w), _samples(jresults, w)
    assert st.n_samples == sj.n_samples == 50
    assert st.dim == sj.dim == 2
    np.testing.assert_array_equal(st.samples_array, sj.samples_array)
    np.testing.assert_array_equal(st.discrepancies, sj.discrepancies)
    np.testing.assert_allclose(st.sample_means_array, sj.sample_means_array)
    np.testing.assert_allclose(st.get_sample_covariance(),
                               sj.get_sample_covariance())
    assert st.effective_sample_size == pytest.approx(
        sj.effective_sample_size)
    assert st.sample_means_and_95CIs() == sj.sample_means_and_95CIs()
    assert st.n_sim == 500 and st.seed == 1
    assert st.summary_string() == sj.summary_string()


def test_sample_save_formats(tmp_path):
    s = _samples(results)
    s.save(str(tmp_path / "s.csv"))
    arr = np.loadtxt(tmp_path / "s.csv", delimiter=",", skiprows=1)
    np.testing.assert_allclose(arr, s.samples_array)
    s.save(str(tmp_path / "s.json"))
    payload = json.loads((tmp_path / "s.json").read_text())
    np.testing.assert_allclose(payload["t1"], s.samples["t1"])
    s.save(str(tmp_path / "s.pkl"))
    assert (tmp_path / "s.pkl").stat().st_size > 0
    with pytest.raises(ValueError):
        s.save(str(tmp_path / "s.txt"))
    with pytest.raises(AttributeError):
        s.no_such_meta

"""Every distance metric of the PyTorch port against
``scipy.spatial.distance.cdist`` and against the JAX package's
``DistanceOp`` on the same inputs: the cases of ``test_distances.py``,
merged as parametrised cases, plus the callable metric and the
``Distance`` node's keyword arguments."""

import numpy as np
import pytest
import torch
from scipy.spatial.distance import cdist

import elfi_tpu_torch as et
from elfi_tpu.ops.distances import distance_op as jax_distance_op
from elfi_tpu_torch.ops.distances import distance_op

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


RNG = np.random.default_rng(42)
U = RNG.normal(size=(7, 5)).astype(np.float32)
V_OBS = RNG.normal(size=(1, 5)).astype(np.float32)
W = RNG.uniform(0.5, 2.0, size=5).astype(np.float32)
VAR = RNG.uniform(0.5, 2.0, size=5).astype(np.float32)
VI = np.linalg.inv(np.cov(RNG.normal(size=(30, 5)).T)).astype(np.float32)
MASK = np.array([1.0, 0.0, 2.0, 0.0, 1.0], dtype=np.float32)
UB, VB = (U > 0).astype(np.float32), (V_OBS > 0).astype(np.float32)
UP, VP = np.abs(U) + 0.1, np.abs(V_OBS) + 0.1

SIMPLE = ["euclidean", "sqeuclidean", "cityblock", "chebyshev", "canberra",
          "braycurtis", "cosine", "correlation"]

# (id, metric, kwargs, u, v): every case of tests/unit/test_distances.py
CASES = (
    [(m, m, {}, U, V_OBS) for m in SIMPLE]
    + [(f"{m}-w", m, {"w": W}, U, V_OBS) for m in SIMPLE]
    + [("chebyshev-mask", "chebyshev", {"w": MASK}, U, V_OBS)]
    + [(f"minkowski-{p}", "minkowski", {"p": p}, U, V_OBS)
       for p in (1.0, 1.5, 3.0)]
    + [(f"minkowski-{p}-w", "minkowski", {"p": p, "w": W}, U, V_OBS)
       for p in (1.0, 1.5, 3.0)]
    + [("hamming", "hamming", {}, UB, VB),
       ("hamming-w", "hamming", {"w": W}, UB, VB),
       ("jensenshannon", "jensenshannon", {}, UP, VP),
       ("seuclidean", "seuclidean", {"V": VAR}, U, V_OBS),
       ("mahalanobis", "mahalanobis", {"VI": VI}, U, V_OBS)]
)


@pytest.mark.parametrize("metric,kwargs,u,v",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_metric_equals_cdist_and_jax(metric, kwargs, u, v):
    got = distance_op(metric, **kwargs)(torch.tensor(u),
                                        observed=(torch.tensor(v),)).numpy()
    want = cdist(u, v, metric, **kwargs).ravel()
    jax_got = np.asarray(jax_distance_op(metric, **kwargs)(u, observed=(v,)))
    assert got.shape == jax_got.shape == (len(u),)
    # float32 against scipy's float64, as the JAX package's test holds
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)
    # the same float32 formulas, reductions taken in another order
    np.testing.assert_allclose(got, jax_got, rtol=2e-6, atol=1e-6)


@pytest.mark.parametrize("kwargs,match", [
    (dict(metric="minkowski"), "requires p"),
    (dict(metric="seuclidean"), "requires V"),
    (dict(metric="mahalanobis"), "requires VI"),
    (dict(metric="nosuchmetric"), "Unknown metric"),
    (dict(metric="jensenshannon", w=W), "does not support a weight"),
    (dict(metric="seuclidean", V=np.ones(5), w=W),
     "does not support a weight")])
def test_bad_arguments_raise_as_in_jax(kwargs, match):
    with pytest.raises(ValueError, match=match):
        distance_op(**kwargs)
    with pytest.raises(ValueError, match=match):
        jax_distance_op(**kwargs)


def _sim(t, batch_size=1, **kw):
    return t[:, None] * torch.ones(5, device=t.device)


@pytest.mark.parametrize("metric,kwargs", [
    ("seuclidean", dict(V=np.linspace(0.5, 1.5, 5))),
    ("mahalanobis", dict(VI=VI)),
    ("minkowski", dict(p=3.0, w=W)),
    (lambda u, v: torch.abs(u - v).sum(dim=1), {})])
def test_distance_node_passes_its_arguments(metric, kwargs):
    """The ``Distance`` node takes p/w/V/VI or a callable, as the JAX
    package's does, and gives the JAX op's distances on its simulations."""
    m = et.Model(name="dist_kwargs_test")
    p = et.Prior("uniform", 0, 1, model=m, name="p")
    s = et.Simulator(_sim, p, observed=0.5 * np.ones(5), model=m, name="sim")
    et.Distance(metric, s, **kwargs, model=m, name="d")
    out = m.generate(batch_size=4, outputs=["sim", "d"], seed=3)
    obs = 0.5 * np.ones((1, 5), np.float32)
    if isinstance(metric, str):
        want = np.asarray(jax_distance_op(metric, **kwargs)(
            out["sim"], observed=(obs,)))
    else:
        want = np.abs(out["sim"] - obs).sum(axis=1)
    np.testing.assert_allclose(out["d"], want, rtol=2e-6, atol=1e-6)
    assert out["d"].shape == (4,) and out["d"].dtype == np.float32
    assert m.dag.get_state("d")["metric"] is metric

"""BOLFIRE's ratio classifiers in the PyTorch port against the JAX
package's on the same inputs: ``logreg_fit_core`` (one problem, a batch of
problems, and the ill-scaled features of g-and-k's squared octiles that the
damping exists for), the port's ``LogisticRegression`` against sklearn's
log-ratios where sklearn is installed, and ``GPClassifier``'s
probabilities.  Both packages solve in float32 in their own orders, so each
comparison states its tolerance."""

import numpy as np
import pytest
import torch

import elfi_tpu_torch as et
from elfi_tpu_torch.methods.classifier import (GPClassifier,
                                               LogisticRegression,
                                               logreg_fit_core)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


def _overlapping(seed=3, n=2000, f=3):
    """BOLFIRE's regime: weakly separable classes, thousands of rows."""
    rng = np.random.RandomState(seed)
    X = np.vstack([rng.normal(0.3, 1, (n, f)), rng.normal(-0.3, 1, (n, f))])
    y = np.concatenate([np.ones(n), -np.ones(n)])
    return X, y, rng.normal(0, 1.5, (20, f))


def _ill_scaled(seed=7):
    """Features spanning nine orders of magnitude."""
    rng = np.random.RandomState(seed)
    scales = np.array([1.0, 1e3, 1e6, 1e9])
    X = np.vstack([rng.lognormal(0.3, 2, (1500, 4)),
                   rng.lognormal(0.0, 2, (1500, 4))]) * scales
    y = np.concatenate([np.ones(1500), -np.ones(1500)])
    return X, y, rng.lognormal(0.15, 2, (10, 4)) * scales


def _log_ratio(fit, Xq):
    w, b, mu, sd = (np.asarray(v.numpy() if isinstance(v, torch.Tensor)
                               else v, np.float64) for v in fit)
    return ((Xq - mu) / sd) @ w + b


def _jax_fit(X, y):
    import jax
    import jax.numpy as jnp
    from elfi_tpu.methods.classifier import logreg_fit_core as jcore
    return jax.jit(jcore)(jnp.asarray(X), jnp.asarray(y))


def _port_fit(X, y):
    return logreg_fit_core(torch.as_tensor(X), torch.as_tensor(y))


@pytest.mark.parametrize("data,atol", [(_overlapping, 1e-3),
                                       (_ill_scaled, 2e-3)])
def test_logreg_core_equals_jax(data, atol):
    """Log-ratios at query points to atol 1e-3 on the overlapping classes
    (4.2e-4 measured), 2e-3 on the ill-scaled features (1.9e-6 measured,
    values up to 0.08)."""
    X, y, Xq = data()
    np.testing.assert_allclose(_log_ratio(_port_fit(X, y), Xq),
                               _log_ratio(_jax_fit(X, y), Xq), atol=atol)


def test_logreg_core_batched_equals_its_rows():
    """A batch of problems (BOLFIRE's initial rounds) against each problem
    alone: the batched matmuls sum in their own blocks, so to 1e-5."""
    problems = [_overlapping(seed=s)[:2] for s in (3, 4, 5)]
    X = torch.as_tensor(np.stack([p[0] for p in problems]),
                        dtype=torch.float32)
    y = torch.as_tensor(np.stack([p[1] for p in problems]))
    batched = logreg_fit_core(X, y)
    assert batched[0].shape == (3, 3) and batched[1].shape == (3,)
    for i in range(3):
        alone = logreg_fit_core(X[i], y[i])
        for a, b in zip(batched, alone):
            np.testing.assert_allclose(a[i].numpy(), b.numpy(), atol=1e-5)


def test_logreg_core_survives_ill_scaled_features():
    """The undamped Newton step diverges on these features (log-ratios of
    thousands against sklearn's 1.6); the damped one stays at the optimum:
    sane log-ratios, and an objective no worse than sklearn's solution's
    under this objective where sklearn is installed."""
    X, y, Xq = _ill_scaled()
    w, b, mu, sd = (v.numpy().astype(np.float64) for v in _port_fit(X, y))
    z = _log_ratio((w, b, mu, sd), Xq)
    assert np.all(np.abs(z) < 50), z

    def objective(v):
        m = y * (((X - mu) / sd) @ v[:-1] + v[-1])
        return 0.5 * np.sum(v * v) + np.sum(np.logaddexp(0.0, -m))

    v_port = np.concatenate([w, [float(b)]])
    skl = pytest.importorskip("sklearn.linear_model")
    model = skl.LogisticRegression(C=1.0)
    model.fit((X - mu) / sd, y)
    v_skl = np.concatenate([model.coef_[0], model.intercept_])
    assert objective(v_port) <= objective(v_skl) + 1.0


def test_logistic_regression_against_sklearn():
    """The port's classifier (the L2 primal) against the JAX package's
    host classifier (sklearn, whose default configuration is an L1
    penalty in recent versions): log-ratios within 0.05 in BOLFIRE's
    regime."""
    pytest.importorskip("sklearn")
    from elfi_tpu.methods.classifier import LogisticRegression as JLogReg
    X, y, Xq = _overlapping()
    ref = JLogReg()
    ref.fit(X, y)
    clf = LogisticRegression()
    clf.fit(X, y)
    np.testing.assert_allclose(clf.predict_log_likelihood_ratio(Xq),
                               ref.predict_log_likelihood_ratio(Xq),
                               atol=0.05)


def test_logistic_regression_attributes_give_the_log_ratio():
    X, y, Xq = _overlapping()
    clf = LogisticRegression()
    clf.fit(X, y)
    p = clf.attributes["parameters"]
    assert set(p) == {"coef_", "intercept_", "n_iter", "mean_", "scale_"}
    z = (((Xq - np.asarray(p["mean_"])) / np.asarray(p["scale_"]))
         @ np.asarray(p["coef_"][0]) + p["intercept_"][0])
    np.testing.assert_allclose(clf.predict_log_likelihood_ratio(Xq), z,
                               rtol=1e-12)
    np.testing.assert_allclose(np.log(clf.predict_likelihood_ratio(Xq)), z,
                               rtol=1e-9)
    # class_min floors the class-1 probability
    floored = LogisticRegression(class_min=0.4)
    floored.fit(X, y)
    assert np.all(floored.predict_log_likelihood_ratio(Xq)
                  >= np.log(0.4 / 0.6) - 1e-12)


def test_logistic_regression_takes_only_the_default_config():
    LogisticRegression(config={"solver": "liblinear", "l1_ratio": 1.0})
    with pytest.raises(ValueError, match="default configuration"):
        LogisticRegression(config={"solver": "lbfgs"})
    with pytest.raises(TypeError):
        LogisticRegression(class_min="0")


def _two_blobs(seed=0):
    rng = np.random.RandomState(seed)
    X = np.vstack([rng.normal(1, 0.5, (80, 2)), rng.normal(-1, 0.5, (80, 2))])
    y = np.concatenate([np.ones(80), -np.ones(80)])
    return X, y, rng.normal(0, 1.2, (25, 2))


def test_gp_classifier_equals_jax():
    """Class-1 probabilities on the same data: both run 20 float32 Newton
    steps on the same float64 kernel, to atol 1e-4."""
    from elfi_tpu.methods.classifier import GPClassifier as JGPC
    X, y, Xq = _two_blobs()
    ref = JGPC()
    ref.fit(X, y)
    clf = GPClassifier()
    clf.fit(X, y)
    np.testing.assert_array_equal(clf._ls, ref._ls)
    np.testing.assert_allclose(clf.predict_proba(Xq), ref.predict_proba(Xq),
                               atol=1e-4)
    lr = clf.predict_log_likelihood_ratio(np.array([[1.5, 1.5],
                                                    [-1.5, -1.5]]))
    assert lr[0] > 0 > lr[1]
    assert clf.attributes["parameters"]["lengthscales"] == \
        ref.attributes["parameters"]["lengthscales"]

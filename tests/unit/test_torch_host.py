"""The port's host executor and host distributions against the JAX
package's: ``run_host`` on a graph without randomness, the scalar-override
broadcast, ``ScipyHostDistribution`` draws for the same ``RandomState``,
``wrap_if_foreign`` and ``from_name``'s scipy fallback, ``vectorize``,
``vectorize_traced`` and ``external_operation``, host priors in
``ModelPrior``, and the mirror of ``tests/unit/test_scipy_fallback.py``."""

import numpy as np
import pytest
import scipy.stats as ss
import torch

import elfi_tpu_torch as et
from elfi_tpu_torch.compile.compiler import compile_program
from elfi_tpu_torch.model import tools
from elfi_tpu_torch.model.model import node_uid
from elfi_tpu_torch.ops import distributions as d
from elfi_tpu_torch.utils.rng import generator, stream_seed

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


def _host_sim(a, b, batch_size=1, random_state=None, **kw):
    """A deterministic host simulator: numpy in, numpy (float64) out."""
    a, b = np.asarray(a), np.asarray(b)
    assert isinstance(a, np.ndarray) and a.shape == (batch_size,)
    t = np.arange(1, 6)
    return a[:, None] * t + np.sin(b[:, None] * t)


def _host_summary(x):
    assert not isinstance(x, torch.Tensor)
    x = np.asarray(x)
    return np.stack([x.mean(1), x.max(1) - x.min(1)], 1)


def _build(pkg, lib):
    """The same deterministic graph in either package: two priors (fed as
    overrides), a host simulator, a device summary, a host summary, a
    device operation after it and a distance."""
    m = pkg.Model(name="host_graph")
    pkg.Prior("uniform", 0, 1, model=m, name="a")
    pkg.Prior("uniform", 0, 1, model=m, name="b")
    pkg.Simulator(_host_sim, m["a"], m["b"], host=True, model=m, name="sim",
                  observed=_host_sim(np.array([0.3]), np.array([0.7]))[0])
    pkg.Summary(lambda x: lib.mean(x ** 2, 1), m["sim"], model=m, name="S1")
    pkg.Summary(_host_summary, m["sim"], host=True, model=m, name="S2")
    pkg.Operation(lambda s: s * 2.0 + 1.0, m["S2"], model=m, name="op")
    pkg.Distance("euclidean", m["S1"], m["op"], model=m, name="d")
    return m


def test_run_host_equals_jax_on_a_graph_without_randomness():
    import jax
    import jax.numpy as jnp
    import elfi_tpu as elfi
    from elfi_tpu.compile.compiler import compile_program as jcompile
    rng = np.random.default_rng(0)
    ov = {"a": rng.uniform(size=16).astype(np.float32),
          "b": rng.uniform(size=16).astype(np.float32)}
    outs = ("sim", "S1", "S2", "op", "d")
    tm = _build(et, torch)
    tp = compile_program(tm, outs, ("a", "b"), device="cpu")
    assert tp.host
    got = tp.run(3, 0, ov, batch_size=16)
    jm = _build(elfi, jnp)
    want = jcompile(jm, outs, ("a", "b")).run(jax.random.key(3), 0, ov,
                                                batch_size=16)
    for o in outs:
        # every numeric output reaches the caller as a tensor on the device
        assert isinstance(got[o], torch.Tensor), o
        np.testing.assert_allclose(got[o].numpy(), np.asarray(want[o]),
                                   rtol=1e-5, atol=1e-6, err_msg=o)


def test_host_flag_detection_and_determinism():
    m = et.Model()
    et.Prior("uniform", 0, 1, model=m, name="p")

    def host_sim(p, batch_size, random_state):
        return random_state.rand(batch_size, 3) + np.asarray(p)[:, None]

    et.Simulator(host_sim, m["p"], host=True, observed=np.zeros(3), model=m,
                 name="sim")
    assert compile_program(m, ("sim",), device="cpu").host
    out = m.generate(batch_size=4, outputs=["sim"], seed=1)
    assert out["sim"].shape == (4, 3)
    np.testing.assert_array_equal(
        out["sim"], m.generate(batch_size=4, outputs=["sim"], seed=1)["sim"])
    assert not np.array_equal(
        out["sim"], m.generate(batch_size=4, outputs=["sim"], seed=2)["sim"])


def test_host_scalar_override_broadcasts_like_traced():
    """run_host materialises a scalar override as (batch_size,), as the
    per-batch function broadcasts it."""
    m = et.Model(name="host_scalar_override")
    et.Prior("uniform", 0, 1, model=m, name="mu")

    def sim(mu, batch_size=1, random_state=None, **kw):
        mu = np.asarray(mu)
        assert mu.shape == (batch_size,), mu.shape
        return mu[:, None] + random_state.rand(batch_size, 3)

    et.Simulator(sim, m["mu"], host=True, observed=np.array([.5, .5, .5]),
                 model=m, name="sim")
    prog = compile_program(m, ("sim", "mu"), override_names=("mu",),
                           device="cpu")
    out = prog.run(0, 0, {"mu": 0.25}, batch_size=6)
    assert tuple(out["mu"].shape) == (6,)
    assert tuple(out["sim"].shape) == (6, 3)


def test_host_node_gets_the_random_state_of_its_stream():
    """The executor seeds a host node's RandomState with
    ``host_seed(stream_seed(seed, batch, uid))``; a direct ``rvs`` with a
    generator seeded by the same stream draws the same."""
    m = et.Model(name="host_seed")
    et.Prior("gumbel_r", 0.0, 1.0, model=m, name="p")
    got = compile_program(m, ("p",), device="cpu").run(7, 3, {},
                                                       batch_size=32)["p"]
    stream = stream_seed(7, 3, node_uid("p"))
    want = ss.gumbel_r.rvs(0.0, 1.0, size=32, random_state=np.random
                           .RandomState(d.host_seed(stream)))
    np.testing.assert_allclose(got.numpy(), want.astype(np.float32))
    direct = d.from_name("gumbel_r").rvs(0.0, 1.0, size=32,
                                         generator=generator(stream, "cpu"))
    np.testing.assert_array_equal(direct, want)
    assert d.host_seed(stream) == stream & 0x7FFFFFFF


@pytest.mark.parametrize("name,params", [
    ("gumbel_r", (0.5, 2.0)), ("powerlaw", (1.8,)), ("skellam", (2.0, 1.0))])
def test_scipy_host_draws_equal_jax_for_the_same_random_state(name, params):
    from elfi_tpu.ops import distributions as jd
    tdist, jdist = d.from_name(name), jd.from_name(name)
    assert isinstance(tdist, d.ScipyHostDistribution) and tdist.host
    got = tdist.rvs(*params, size=200, random_state=np.random.RandomState(9))
    want = jdist.rvs(*params, size=200,
                     random_state=np.random.RandomState(9))
    np.testing.assert_array_equal(got, want)
    for method in ("logpdf", "pdf", "cdf"):
        np.testing.assert_allclose(getattr(tdist, method)(got, *params),
                                   getattr(jdist, method)(want, *params))
    np.testing.assert_allclose(tdist.ppf([0.1, 0.5, 0.9], *params),
                               jdist.ppf([0.1, 0.5, 0.9], *params))
    if name != "skellam":
        x = np.array([0.3, 0.6, 0.9])
        np.testing.assert_allclose(tdist.gradient_logpdf(x, *params),
                                   jdist.gradient_logpdf(x, *params))


def test_host_adapter_matches_scipy():
    dist = d.from_name("gumbel_r")
    g = generator(123, "cpu")
    x = dist.rvs(0.5, 2.0, size=200, generator=g)
    assert np.asarray(x).shape == (200,)
    np.testing.assert_array_equal(
        dist.rvs(0.5, 2.0, size=200, generator=generator(123, "cpu")), x)
    np.testing.assert_allclose(dist.logpdf(x, 0.5, 2.0),
                               ss.gumbel_r.logpdf(x, 0.5, 2.0))
    # a tensor argument is copied to the host
    np.testing.assert_allclose(dist.pdf(torch.as_tensor(x), 0.5, 2.0),
                               ss.gumbel_r.pdf(x, 0.5, 2.0))


def test_from_name_falls_back_to_scipy_and_unknown_raises():
    assert d.from_name("norm") is d.norm
    assert d.from_name("levy_stable") is d.levy_stable
    assert isinstance(d.from_name("gumbel_r"), d.ScipyHostDistribution)
    with pytest.raises(ValueError, match="Unknown distribution"):
        d.from_name("definitely_not_a_distribution")


def test_wrap_if_foreign():
    assert d.wrap_if_foreign(d.norm) is d.norm

    class MyDist(d.Distribution):
        @classmethod
        def rvs(cls, size=1, generator=None):
            return torch.randn(size, generator=generator)

    assert d.wrap_if_foreign(MyDist) is MyDist

    class Ducked:
        def rvs(self, size=1, generator=None):
            return torch.randn(size, generator=generator)

    duck = Ducked()
    assert d.wrap_if_foreign(duck) is duck

    class KeyStyle:              # the JAX package's duck type is foreign
        def rvs(self, size=1, key=None):
            return np.zeros(size)

    assert isinstance(d.wrap_if_foreign(KeyStyle()),
                      d.ScipyHostDistribution)
    for obj in (ss.skewnorm(4), ss.gumbel_r):
        assert isinstance(d.wrap_if_foreign(obj), d.ScipyHostDistribution)
    m = et.Model()
    et.Prior(ss.skewnorm(4), model=m, name="p")
    assert m.dag.get_state("p")["host"]


def test_unseedable_rvs_still_deterministic():
    class NoSeed:
        def rvs(self, size=1):
            return np.random.normal(size=size)

    dist = d.ScipyHostDistribution(NoSeed())
    saved = np.random.get_state()
    a = dist.rvs(size=32, generator=generator(3, "cpu"))
    np.testing.assert_array_equal(
        a, dist.rvs(size=32, generator=generator(3, "cpu")))
    assert not np.array_equal(
        a, dist.rvs(size=32, generator=generator(4, "cpu")))
    after = np.random.get_state()
    assert saved[0] == after[0]
    np.testing.assert_array_equal(saved[1], after[1])


def test_seedable_rvs_param_error_surfaces():
    dist = d.ScipyHostDistribution("gumbel_r")
    dist.rvs(0.0, 1.0, size=3, generator=generator(1, "cpu"))
    assert dist._rvs_seedable is True
    with pytest.raises(TypeError):
        dist.rvs(0.0, 1.0, 2.0, 3.0, size=3, generator=generator(1, "cpu"))


def _scipy_model(name, prior):
    m = et.Model(name=name)
    p = et.Prior(*prior, model=m, name="p")

    def sim(t, batch_size=1, random_state=None, **kw):
        return np.atleast_1d(t)[:, None] + 0.1 * random_state.normal(
            size=(batch_size, 2))

    return m, p, sim


@pytest.mark.parametrize("prior,obs", [(("gumbel_r", 0.0, 1.0), 1.0),
                                       ((ss.skewnorm(4),), 0.7)])
def test_scipy_prior_rejection_end_to_end(prior, obs):
    m, p, sim = _scipy_model("scipy_prior", prior)
    assert m.dag.get_state("p")["host"]
    et.Simulator(sim, p, observed=np.array([obs, obs]), host=True, model=m,
                 name="sim")
    et.Distance("euclidean", m["sim"], model=m, name="dist")
    res = et.Rejection(m["dist"], batch_size=100, seed=7).sample(
        20, n_sim=1000, bar=False)
    assert res.n_samples == 20
    assert np.all(np.isfinite(res.samples_array))
    assert abs(np.mean(res.samples["p"]) - obs) < 1.0
    res2 = et.Rejection(m["dist"], batch_size=100, seed=7).sample(
        20, n_sim=1000, bar=False)
    np.testing.assert_array_equal(res.samples_array, res2.samples_array)
    # as in the JAX package, fused=True on a host graph runs batch at a
    # time (Rejection) or raises (SMC)
    res3 = et.Rejection(m["dist"], batch_size=100, seed=7).sample(
        20, n_sim=1000, bar=False, fused=True)
    np.testing.assert_array_equal(res.samples_array, res3.samples_array)
    with pytest.raises(ValueError, match="no host nodes"):
        et.SMC(m["dist"], batch_size=100, seed=7).sample(
            20, thresholds=[1.0], bar=False, fused=True)


def test_device_simulator_with_scipy_prior_and_host_summary():
    """A scipy prior, a torch simulator on the program's device, a host
    summary after it and a device distance: the device nodes get tensors,
    the host node numpy."""
    m = et.Model(name="mixed")
    et.Prior(ss.norm(1.0, 0.5), model=m, name="mu")

    def sim(mu, batch_size=1, generator=None):
        assert isinstance(mu, torch.Tensor)
        return mu[:, None] + torch.randn((batch_size, 8),
                                         generator=generator)

    def host_mean(x):
        assert isinstance(x, np.ndarray)
        return x.mean(1)

    et.Simulator(sim, m["mu"], observed=np.full(8, 1.2, np.float32),
                 model=m, name="sim")
    et.Summary(host_mean, m["sim"], host=True, model=m, name="S")
    et.Distance("euclidean", m["S"], model=m, name="d")
    out = m.generate(64, outputs=["mu", "sim", "S", "d"], seed=3)
    np.testing.assert_allclose(out["S"], out["sim"].mean(1), rtol=1e-5)
    res = et.Rejection(m["d"], batch_size=256, seed=1).sample(
        64, n_sim=4096, bar=False)
    assert abs(float(np.mean(res.samples["mu"])) - 1.2) < 0.2


def test_smc_with_scipy_host_prior():
    m, p, sim = _scipy_model("scipy_smc", ("gumbel_r", 0.5, 0.3))
    et.Simulator(sim, p, observed=np.array([0.8, 0.8]), host=True, model=m,
                 name="sim")
    et.Distance("euclidean", m["sim"], model=m, name="dist")
    res = et.SMC(m["dist"], batch_size=200, seed=3).sample(
        100, thresholds=[0.5, 0.3, 0.2], bar=False)
    assert res.n_samples == 100
    assert abs(float(np.mean(res.samples["p"])) - 0.8) < 0.3


def test_model_prior_with_host_distribution():
    m = et.Model(name="host_prior_model")
    et.Prior(ss.gumbel_r(0.0, 1.0), model=m, name="a")
    et.Prior("uniform", 0, 2, model=m, name="b")
    prior = et.ModelPrior(m)
    assert prior.host
    x = prior.rvs(size=50, seed=4)
    assert x.shape == (50, 2)
    want = ss.gumbel_r(0.0, 1.0).logpdf(x[:, 0]) \
        + ss.uniform(0, 2).logpdf(x[:, 1])
    np.testing.assert_allclose(prior.logpdf(x), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(prior.pdf(x[:1]), np.exp(want[0]), rtol=1e-5)
    g = prior.gradient_logpdf(x[:3])
    assert g.shape == (3, 2)
    # d/da log gumbel_r(a) = -1 + exp(-a); b's uniform density is flat
    np.testing.assert_allclose(g[:, 0], -1 + np.exp(-x[:3, 0]), rtol=1e-4)
    np.testing.assert_allclose(g[:, 1], 0.0, atol=1e-6)
    with pytest.raises(ValueError, match="host-path"):
        prior.traceable_logpdf()
    lp = prior.tensor_logpdf()(torch.as_tensor(x, dtype=torch.float32))
    np.testing.assert_allclose(lp.numpy(), want, rtol=1e-4, atol=1e-4)


def test_host_prior_logpdf_equals_jax():
    import elfi_tpu as elfi
    x = np.random.default_rng(1).uniform(0.1, 1.9, (20, 2))
    pm = [None, None]
    for i, pkg in enumerate((et, elfi)):
        m = pkg.Model(name="host_prior_parity")
        pkg.Prior(ss.gumbel_r(0.3, 1.5), model=m, name="a")
        pkg.Prior("uniform", 0, 2, model=m, name="b")
        pm[i] = pkg.ModelPrior(m)
    np.testing.assert_allclose(pm[0].logpdf(x), pm[1].logpdf(x), rtol=1e-5)
    # the JAX package's central differences of its float32 sum are 4e-3
    # off here; the port's float64 ones are held to the closed form
    z = (x[:4, 0] - 0.3) / 1.5
    np.testing.assert_allclose(pm[0].gradient_logpdf(x[:4])[:, 0],
                               (np.exp(-z) - 1) / 1.5, rtol=1e-5)


def test_vectorize_equals_jax_and_is_host():
    from elfi_tpu.model import tools as jtools

    def single(a, b, c=0.0, **kw):
        return np.array([a + b + c, a * b])

    op = tools.vectorize(single, constants=[1])
    assert tools.is_host_op(op)
    a = np.arange(4.0)
    got = op(a, 2.0, c=1.0)
    want = jtools.vectorize(single, constants=[1])(a, 2.0, c=1.0)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="does not match"):
        tools.run_vectorized(single, np.arange(3.0), np.arange(4.0))
    m = et.Model()
    et.Prior("uniform", 0, 1, model=m, name="p")
    node = et.Simulator(tools.vectorize(
        lambda p, random_state=None, **kw: np.array([p, random_state.rand()])),
        m["p"], model=m, name="sim", observed=np.zeros(2))
    assert node.state["host"]
    assert m.generate(5, outputs=["sim"], seed=2)["sim"].shape == (5, 2)


def test_external_operation_with_echo():
    from elfi_tpu.model import tools as jtools
    op = tools.external_operation("echo {0} {1} {seed}")
    assert tools.is_host_op(op)
    rs = np.random.RandomState(2)
    got = op(1.5, 3, random_state=rs)
    want = jtools.external_operation("echo {0} {1} {seed}")(
        1.5, 3, random_state=np.random.RandomState(2))
    np.testing.assert_array_equal(got, want)
    assert got[:2].tolist() == [1.5, 3.0]
    m = et.Model()
    et.Prior("uniform", 0, 1, model=m, name="p")
    et.Simulator(tools.vectorize(tools.external_operation(
        "echo {0} {batch_index}")), m["p"], model=m, name="sim",
        observed=np.zeros(2))
    m["sim"].uses_meta = True
    out = m.generate(3, outputs=["p", "sim"], seed=4)
    np.testing.assert_allclose(out["sim"][:, 0], out["p"], rtol=1e-5)
    np.testing.assert_array_equal(out["sim"][:, 1], 0)
    with pytest.raises(KeyError, match="not passed"):
        tools.external_operation("echo {nope}")(1.0)
    np.testing.assert_array_equal(tools.stdout_to_array(b"1 2  3\n"),
                                  [1.0, 2.0, 3.0])


def test_vectorize_traced_draws_per_member_and_per_stream():
    op = tools.vectorize_traced(lambda mu, s: mu + s * torch.randn(4),
                                constants=[1])
    mu = torch.arange(6.0)
    a = op(mu, 0.1, batch_size=6, generator=generator(5, "cpu"))
    assert a.shape == (6, 4)
    np.testing.assert_allclose(a.mean(1).numpy(), mu.numpy(), atol=0.3)
    assert not torch.equal(a[0] - mu[0], a[1] - mu[1])
    state = torch.get_rng_state()
    b = op(mu, 0.1, batch_size=6, generator=generator(5, "cpu"))
    assert torch.equal(a, b)
    assert torch.equal(state, torch.get_rng_state())
    assert not torch.equal(a, op(mu, 0.1, batch_size=6,
                                 generator=generator(6, "cpu")))
    # no batched input: the map runs over the batch index
    z = tools.vectorize_traced(lambda: torch.randn(3))(
        batch_size=4, generator=generator(5, "cpu"))
    assert z.shape == (4, 3) and not torch.equal(z[0], z[1])
    m = et.Model()
    et.Prior("norm", 0, 1, model=m, name="mu")
    et.Simulator(op, m["mu"], 0.1, model=m, name="sim",
                 observed=np.zeros(4))
    assert not m.dag.get_state("sim")["host"]
    out = m.generate(8, outputs=["mu", "sim"], seed=1)
    np.testing.assert_array_equal(
        out["sim"], m.generate(8, outputs=["mu", "sim"], seed=1)["sim"])
    assert out["sim"].shape == (8, 4)


def test_mark_host_routes_the_node():
    fn = tools.mark_host(lambda x: np.asarray(x) * 2)
    m = et.Model()
    et.Prior("uniform", 0, 1, model=m, name="p")
    et.Operation(fn, m["p"], model=m, name="op")
    assert m.dag.get_state("op")["host"]
    out = m.generate(4, outputs=["p", "op"], seed=0)
    np.testing.assert_allclose(out["op"], 2 * out["p"])
    assert et.ElfiModel is et.Model and et.tools is tools

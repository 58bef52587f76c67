"""ROMC in the PyTorch port on the CPU, held against the JAX package on the
same inputs: the helpers (``_quad_features``, ``_find_rotation``,
``NDimBoundingBox``, ``line_search``), the whole pipeline on a
deterministic model (a simulator that ignores its noise, so both packages
optimise the same objectives), regions from the JAX package's own
solutions, the batched region and local-fit paths against the per-problem
ones, the frozen-noise objective rows, the refusal of a graph without a
gradient, and the minimum-norm local fit where the features outnumber the
samples."""

import numpy as np
import pytest
import torch

import elfi_tpu_torch as et
from elfi_tpu_torch.interop import romc_solutions_from_numpy
from elfi_tpu_torch.methods import romc as tromc
from elfi_tpu_torch.models import gnk_kernel, ma2_kernel

torch.set_num_threads(1)

CPU = torch.device("cpu")
#: the deterministic model's observed summary: its objective
#: ``(a + b/2 - 0.4)^2 + (b - 0.3 a - 0.1)^2`` is an exact quadratic with
#: minimum 0, so Adam converges to the same float32 point in both packages
#: and a quadratic local fit recovers it from any box points
DET_OBS = np.array([0.4, 0.1, 0.0], np.float32)
DET_BOUNDS = [(-2.0, 2.0), (-2.0, 2.0)]
DET_N1 = 6
DET_EPS = 0.2


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                      else x, np.float64)


def jax_det_model():
    import jax.numpy as jnp
    import elfi_tpu as elfi
    m = elfi.Model(name="romc_det")
    elfi.Prior("uniform", -2, 4, model=m, name="a")
    elfi.Prior("uniform", -2, 4, model=m, name="b")

    def sim(a, b, batch_size, key):
        return jnp.stack([a + 0.5 * b, b - 0.3 * a, jnp.zeros_like(a)],
                         axis=1)

    elfi.Simulator(sim, m["a"], m["b"], observed=DET_OBS[None], model=m,
                   name="sim")
    elfi.Distance("euclidean", m["sim"], model=m, name="d")
    return m


def det_model():
    m = et.Model(name="romc_det")
    et.Prior("uniform", -2, 4, model=m, name="a")
    et.Prior("uniform", -2, 4, model=m, name="b")

    def sim(a, b, batch_size, generator):
        return torch.stack([a + 0.5 * b, b - 0.3 * a, torch.zeros_like(a)],
                           dim=1)

    et.Simulator(sim, m["a"], m["b"], observed=DET_OBS[None], model=m,
                 name="sim")
    et.Distance("euclidean", m["sim"], model=m, name="d")
    return m


def gauss_1d(y=(1.2, 0.3, 1.9, 0.8, 1.1)):
    """theta ~ U(-2.5, 2.5); data ~ N(theta, 1) x 5; summary the mean."""
    m = et.Model(name="romc_gauss")
    et.Prior("uniform", -2.5, 5.0, model=m, name="theta")

    def sim(theta, batch_size, generator):
        return theta[:, None] + torch.randn((batch_size, 5),
                                            generator=generator,
                                            device=theta.device)

    et.Simulator(sim, m["theta"], observed=np.asarray(y, np.float32),
                 model=m, name="sim")
    et.Summary(lambda x: torch.mean(x, dim=1), m["sim"], model=m, name="S")
    et.Distance("euclidean", m["S"], model=m, name="d")
    return m


# -- the helpers against the JAX package --------------------------------------

@pytest.mark.parametrize("d", [1, 2, 4])
def test_quad_features_equal_jax(d):
    import jax.numpy as jnp
    from elfi_tpu.methods.romc import _quad_features as jfeats
    x = np.random.RandomState(d).uniform(-3, 3, (7, d)).astype(np.float32)
    got = _np(tromc._quad_features(torch.as_tensor(x)))
    assert got.shape == (7, 1 + d + d * (d + 1) // 2)
    np.testing.assert_allclose(got, np.asarray(jfeats(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_find_rotation_equals_jax():
    from elfi_tpu.methods.romc import RegionConstructor as JRC
    rng = np.random.RandomState(0)
    a = rng.randn(3, 3)
    mats = [a @ a.T + np.eye(3), np.diag([2.0, 1e-3, 5.0]),
            np.array([[1.0, 2.0], [2.0, 4.0]]),          # singular
            np.array([[1.0, np.nan], [0.0, 1.0]]),       # not finite
            np.array([[2.18, 0.4], [0.4, 2.5]])]
    for h in mats:
        np.testing.assert_allclose(tromc.RegionConstructor._find_rotation(h),
                                   JRC._find_rotation(h), rtol=1e-6,
                                   atol=1e-6)


def test_bounding_box_equals_jax():
    from elfi_tpu.methods.romc import NDimBoundingBox as JBox
    rot = np.array([[0.6, -0.8], [0.8, 0.6]])
    center = np.array([0.3, -0.2])
    # the second direction's width is secured to 1e-3
    limits = np.array([[-0.5, 0.25], [0.0, 0.0002]])
    box, jbox = tromc.NDimBoundingBox(rot, center, limits), JBox(rot, center,
                                                                 limits)
    np.testing.assert_allclose(box.limits, jbox.limits, rtol=1e-6)
    assert box.limits[1, 1] - box.limits[1, 0] >= 1e-3
    np.testing.assert_allclose(box.volume, jbox.volume, rtol=1e-6)
    pts = np.random.RandomState(1).uniform(-0.5, 0.8, (200, 2))
    for p in pts:
        assert box.contains(p) == jbox.contains(p)
        assert box.pdf(p) == pytest.approx(jbox.pdf(p), rel=1e-6)
    drawn = box.sample(500, seed=3)
    assert drawn.shape == (500, 2) and drawn.dtype == np.float32
    assert all(box.contains(p) for p in drawn.astype(np.float64)[:50])
    np.testing.assert_array_equal(drawn, box.sample(500, seed=3))


@pytest.mark.parametrize("K, eta, rep_lim, eps, th", [
    (10, 1.0, 300, 1.0, (0.1, -0.2)),      # the defaults
    (6, 0.01, 3, 1.0, (0.1, -0.2)),        # the step limit ends the search
    (10, 1.0, 300, 0.01, (0.5, 0.5)),      # f >= eps at the start
])
def test_line_search_equals_jax(K, eta, rep_lim, eps, th):
    """Every (start, direction) pair of one masked loop against the JAX
    package's search of that pair alone."""
    import jax
    import jax.numpy as jnp
    from elfi_tpu.methods.romc import line_search as jls

    def jf(t):
        return t[0] ** 2 + 2 * t[1] ** 2 + 0.5 * t[0] * t[1]

    def tf(t):
        return (t[..., 0] ** 2 + 2 * t[..., 1] ** 2
                + 0.5 * t[..., 0] * t[..., 1])

    ang = np.linspace(0, 2 * np.pi, 9)[:-1]
    dirs = np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)
    th0 = np.broadcast_to(np.asarray(th, np.float32), dirs.shape).copy()
    got = _np(tromc.line_search(tf, torch.as_tensor(th0),
                                torch.as_tensor(dirs), eps, K, eta, rep_lim))
    search = jax.jit(jax.vmap(lambda vd: jls(jf, jnp.asarray(th, jnp.float32),
                                             vd, eps, K, eta, rep_lim)))
    np.testing.assert_allclose(got, np.asarray(search(jnp.asarray(dirs))),
                               rtol=1e-6, atol=1e-6)
    # and one pair alone gives a 0-d offset
    one = tromc.line_search(tf, torch.as_tensor(th0[0]),
                            torch.as_tensor(dirs[0]), eps, K, eta, rep_lim)
    assert one.shape == () and float(one) == pytest.approx(got[0], rel=1e-6)


# -- the whole pipeline on a deterministic model ------------------------------

@pytest.fixture(scope="module")
def det_pair():
    """Both packages' ROMC on the deterministic model, solved from the same
    starts (one restart each), their regions built at DET_EPS."""
    import elfi_tpu as elfi
    x0 = np.random.RandomState(0).uniform(-1.5, 1.5, (DET_N1, 2)).astype(
        np.float32)
    args = {"x0": x0, "restarts": 1}
    jr = elfi.ROMC(jax_det_model()["d"], bounds=DET_BOUNDS, seed=1)
    jr.solve_problems(n1=DET_N1, seed=2, optimizer_args=args)
    jr.estimate_regions(eps_filter=DET_EPS)
    # module-scoped, so built before the autouse client: the CPU by name
    tr = et.ROMC(det_model()["d"], bounds=DET_BOUNDS, seed=1, device=CPU)
    tr.solve_problems(n1=DET_N1, seed=2, optimizer_args=args)
    tr.estimate_regions(eps_filter=DET_EPS)
    return jr, tr


def test_det_solutions_equal_jax(det_pair):
    jr, tr = det_pair
    assert all(tr.inference_state["solved"])
    for pj, pt in zip(jr.optim_problems, tr.optim_problems):
        np.testing.assert_allclose(pt.result.x_min, pj.result.x_min,
                                   rtol=1e-4)
        # the minimum is 0: the values agree to float32 rounding of it
        np.testing.assert_allclose(pt.result.f_min, pj.result.f_min,
                                   rtol=1e-4, atol=1e-12)
        np.testing.assert_allclose(pt.result.hess_appr, pj.result.hess_appr,
                                   rtol=1e-4)
        np.testing.assert_array_equal(pt.initial_point, pj.initial_point)
    assert tr.compute_eps(0.5) == pytest.approx(jr.compute_eps(0.5),
                                                rel=1e-4, abs=1e-12)


def test_det_regions_equal_jax(det_pair):
    jr, tr = det_pair
    assert tr.inference_state["accepted"] == jr.inference_state["accepted"]
    assert len(tr.posterior.regions) == len(jr.posterior.regions) == DET_N1
    for rj, rt in zip(jr.posterior.regions, tr.posterior.regions):
        np.testing.assert_allclose(rt.center, rj.center, rtol=1e-4)
        np.testing.assert_allclose(rt.rotation, rj.rotation, rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(rt.limits, rj.limits, rtol=1e-4)
        assert rt.volume == pytest.approx(rj.volume, rel=1e-4)


def test_det_local_fits_equal_jax(det_pair):
    """The batched quadratic fits: each package draws its own box points,
    and the objective is an exact quadratic, so both recover it."""
    jr, tr = det_pair
    accepted = tr.inference_state["accepted"]
    jr._fit_local_surrogates_batched(accepted)
    tr._fit_local_surrogates_batched(accepted)
    for pj, pt in zip(jr.optim_problems, tr.optim_problems):
        for cj, ct in zip(pj._local_coeffs, pt._local_coeffs):
            np.testing.assert_allclose(ct, cj, rtol=1e-4, atol=2e-5)
        th = pt.result.x_min
        assert pt.local_surrogates[0](th) == pytest.approx(
            pj.local_surrogates[0](th), rel=1e-4, abs=2e-5)


def test_det_pdf_and_partition_equal_jax(det_pair):
    jr, tr = det_pair
    g = np.linspace(-0.4, 0.9, 14)
    pts = np.stack(np.meshgrid(g, g), -1).reshape(-1, 2).astype(np.float32)
    want = jr.posterior.pdf_unnorm_batched(pts)
    assert np.sum(want > 0) > 20
    np.testing.assert_allclose(tr.posterior.pdf_unnorm_batched(pts), want,
                               rtol=1e-4)
    np.testing.assert_allclose(tr.eval_unnorm_posterior(pts),
                               jr.eval_unnorm_posterior(pts), rtol=1e-4)
    np.testing.assert_allclose(tr.posterior._approximate_partition(),
                               jr.posterior._approximate_partition(),
                               rtol=1e-4)
    np.testing.assert_allclose(tr.eval_posterior(pts),
                               jr.eval_posterior(pts), rtol=1e-4)
    np.testing.assert_allclose(tr.posterior._all_distances(pts),
                               jr.posterior._all_distances(pts), rtol=1e-4,
                               atol=1e-6)


def test_det_weights_expectation_ess_equal_jax(det_pair):
    """At the JAX package's box points: the weights and distances, the
    expectation and the ESS."""
    jr, tr = det_pair
    jres = jr.sample(n2=40, seed=5)
    w, dists = tr.posterior._weights(jr.samples)
    np.testing.assert_allclose(w, jr.weights, rtol=1e-4)
    np.testing.assert_allclose(dists.ravel(), jr.distances, rtol=1e-4,
                               atol=1e-6)
    tr.samples, tr.weights, tr.distances = jr.samples, w, dists.ravel()
    tr.inference_state["_has_drawn_samples"] = True
    tr.result = tr.extract_result()
    assert tr.result.n_samples == jres.n_samples == DET_N1 * 40
    for h in (lambda t: t[..., 0], lambda t: t[..., 1] ** 2):
        np.testing.assert_allclose(tr.compute_expectation(h),
                                   jr.compute_expectation(h), rtol=1e-4)
    np.testing.assert_allclose(tr.compute_ess(), jr.compute_ess(),
                               rtol=1e-4)
    np.testing.assert_allclose(tr.result.sample_means_array,
                               jres.sample_means_array, rtol=1e-4)


def test_det_divergence_equals_jax(det_pair):
    jr, tr = det_pair

    def gt(theta):
        t = np.atleast_2d(theta)
        return np.exp(-20 * ((t[:, 0] - 0.3) ** 2 + (t[:, 1] - 0.2) ** 2))

    for distance in ("Jensen-Shannon", "KL-Divergence"):
        got = tr.compute_divergence(gt, step=0.2, distance=distance)
        want = jr.compute_divergence(gt, step=0.2, distance=distance)
        assert np.isfinite(want)
        np.testing.assert_allclose(got, want, rtol=1e-4)


def test_regions_from_jax_solutions_equal_jax():
    """Solutions set in the JAX package (points around the optimum, so some
    fall above the filter) carried into the port: the same problems
    accepted, the same boxes, the same local fits, the same density."""
    import elfi_tpu as elfi
    rng = np.random.RandomState(4)
    n1 = 8
    xs = (np.array([0.3043478, 0.1913043])
          + rng.uniform(-0.3, 0.3, (n1, 2))).astype(np.float32)
    jr = elfi.ROMC(jax_det_model()["d"], bounds=DET_BOUNDS, seed=1)
    jr._define_objectives(n1=n1, seed=3)
    hs = []
    for p, x in zip(jr.optim_problems, xs):
        h = np.array([[2.18, 0.4], [0.4, 2.5]]) + rng.uniform(0, 0.2, (2, 2))
        hs.append(h + h.T)
        p.set_solution(x, p.objective(x), hs[-1])
    jr.inference_state.update(solved=[True] * n1, attempted=[True] * n1,
                              _has_solved_problems=True)
    fs = np.array([p.result.f_min for p in jr.optim_problems])
    eps = float(np.quantile(fs, 0.6))
    jr.estimate_regions(eps_filter=eps, fit_models=True)

    tr = et.ROMC(det_model()["d"], bounds=DET_BOUNDS, seed=1)
    tr._define_objectives(n1=n1, seed=3)
    romc_solutions_from_numpy(tr, xs, fs, np.stack(hs))
    assert [p.nuisance for p in tr.optim_problems] == \
        [p.nuisance for p in jr.optim_problems]
    tr.estimate_regions(eps_filter=eps, fit_models=True)
    acc = tr.inference_state["accepted"]
    assert acc == jr.inference_state["accepted"] and 0 < sum(acc) < n1
    for rj, rt in zip(jr.posterior.regions, tr.posterior.regions):
        np.testing.assert_allclose(rt.center, rj.center, rtol=1e-6)
        np.testing.assert_allclose(rt.limits, rj.limits, rtol=1e-4)
    for pj, pt in zip(jr.optim_problems, tr.optim_problems):
        for cj, ct in zip(getattr(pj, "_local_coeffs", None) or [],
                          getattr(pt, "_local_coeffs", None) or []):
            np.testing.assert_allclose(ct, cj, rtol=1e-4, atol=2e-5)
    g = np.linspace(-0.4, 0.9, 11)
    pts = np.stack(np.meshgrid(g, g), -1).reshape(-1, 2)
    np.testing.assert_allclose(tr.eval_posterior(pts),
                               jr.eval_posterior(pts), rtol=1e-4)


# -- the port's own paths -----------------------------------------------------

def test_objective_rows_hold_their_noise():
    """Row i of the program at (seed, 0) is problem i's objective: the
    same on every call, independent of the other rows, and the host
    objective and the single-problem function give the same value."""
    romc = et.ROMC(gauss_1d()["d"], bounds=[(-2.5, 2.5)], seed=3)
    romc._define_objectives(n1=8, seed=7)
    obj = romc._objective
    theta = torch.linspace(-1, 1, 8)[:, None]
    first = obj(theta)
    assert torch.equal(first, obj(theta))
    same = obj(torch.full((8, 1), 0.25))
    assert len(set(same.tolist())) == 8        # each row its own noise
    moved = theta.clone()
    moved[3] = 2.0
    changed = obj(moved)
    keep = torch.arange(8) != 3
    assert torch.equal(changed[keep], first[keep])
    for i in (0, 5):
        p = romc.optim_problems[i]
        assert p.objective(np.array([0.25])) == float(same[i])
        assert float(p._objective_fn()(torch.tensor([0.25]))) == \
            float(same[i])
    got = obj.at([5, 2], torch.tensor([[[0.25], [-1.0]], [[0.25], [0.5]]]))
    assert float(got[0, 0]) == float(same[5])
    assert float(got[1, 0]) == float(same[2])
    # a repeated row takes one more program call per point index
    rep = obj.at([5, 5], torch.tensor([[[0.25]], [[-1.0]]]))
    assert float(rep[0, 0]) == float(same[5])
    assert float(rep[1, 0]) == float(obj(torch.full((8, 1), -1.0))[5])
    # another seed draws other noise
    romc._define_objectives(n1=8, seed=8)
    assert not torch.equal(romc._objective(theta), first)


def test_single_problem_solve_equals_the_batched_solve():
    romc = et.ROMC(gauss_1d()["d"], bounds=[(-2.5, 2.5)], seed=3)
    x0 = np.linspace(-2, 2, 6, dtype=np.float32)[:, None]
    romc.solve_problems(n1=6, seed=7, optimizer_args={"x0": x0,
                                                      "restarts": 1})
    for i in (1, 4):
        p = romc.optim_problems[i]
        batched = (p.result.x_min.copy(), p.result.f_min,
                   p.result.hess_appr.copy())
        assert p.solve_gradients(x0=x0[i])
        np.testing.assert_allclose(p.result.x_min, batched[0], rtol=1e-6)
        np.testing.assert_allclose(p.result.f_min, batched[1], rtol=1e-5,
                                   atol=1e-12)
        np.testing.assert_allclose(p.result.hess_appr, batched[2],
                                   rtol=1e-5)


def _gauss_regions(batched):
    romc = et.ROMC(gauss_1d()["d"], bounds=[(-2.5, 2.5)], seed=3)
    romc.solve_problems(n1=10, seed=7)
    if not batched:
        romc._can_batch_regions = lambda *a, **k: False
    romc.estimate_regions(eps_filter=0.2)
    return romc


def test_batched_regions_equal_per_problem_path():
    batched = {p.ind: p.regions[0]
               for p in _gauss_regions(True).optim_problems
               if p.state["region"]}
    sequential = {p.ind: p.regions[0]
                  for p in _gauss_regions(False).optim_problems
                  if p.state["region"]}
    assert batched and set(batched) == set(sequential)
    for ind, reg in batched.items():
        np.testing.assert_allclose(reg.center, sequential[ind].center,
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(reg.limits, sequential[ind].limits,
                                   rtol=1e-4, atol=1e-5)


def test_batched_local_fits_equal_per_problem_path():
    romc = _gauss_regions(True)
    accepted = romc.inference_state["accepted"]
    probs = [p for p, a in zip(romc.optim_problems, accepted) if a]
    assert probs
    sequential = {}
    for p in probs:
        p.fit_local_surrogate()
        sequential[p.ind] = [np.asarray(c) for c in p._local_coeffs]
        p._local_coeffs = None
        p.local_surrogates = None
    romc._fit_local_surrogates_batched(accepted)
    for p in probs:
        assert p.state["has_fit_local_surrogates"]
        assert len(p._local_coeffs) == len(sequential[p.ind])
        for got, want in zip(p._local_coeffs, sequential[p.ind]):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                       err_msg=f"problem {p.ind}")
        assert np.isfinite(p.local_surrogates[0](p.result.x_min))


@pytest.mark.parametrize("kernel_model", ["ma2_kernel", "gnk_kernel"])
def test_graph_without_a_gradient_is_refused(kernel_model):
    """The fused distance kernels have no backward: ROMC refuses their
    graphs instead of returning the starts as solutions.  (The JAX
    package refuses them too, at its kernels' batch-size check.)"""
    if kernel_model == "ma2_kernel":
        m, bounds = ma2_kernel.get_model(seed_obs=4), [(-2, 2), (-1, 1)]
    else:
        m, bounds = gnk_kernel.get_model(), [(0, 10)] * 4
    romc = et.ROMC(m["d"], bounds=bounds, seed=1)
    with pytest.raises(ValueError, match="gradient"):
        romc.solve_problems(n1=4, seed=2)
    with pytest.raises(ValueError, match="gradient"):
        romc.optim_problems[0].solve_gradients(seed=2)


def test_local_fit_with_more_features_than_samples_is_min_norm():
    """D = 5 at the default 20 samples: 21 quadratic features, so the least
    squares has many solutions; the fit is the minimum-norm one, as numpy's
    and the JAX package's ``lstsq`` give it."""
    import jax.numpy as jnp
    rng = np.random.RandomState(2)
    x = rng.uniform(-1, 1, (20, 5)).astype(np.float32)
    y = (x ** 2).sum(1) + x[:, 0] * x[:, 3]
    feats = tromc._quad_features(torch.as_tensor(x))
    assert feats.shape == (20, 21)
    got = _np(tromc._lstsq_min_norm(feats, torch.as_tensor(y)))
    want = np.linalg.lstsq(_np(feats), y.astype(np.float64), rcond=None)[0]
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    jwant = np.asarray(jnp.linalg.lstsq(jnp.asarray(_np(feats), jnp.float32),
                                        jnp.asarray(y))[0])
    np.testing.assert_allclose(got, jwant, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(_np(feats) @ got, y, atol=1e-4)

    # and through ROMC: a 5-D deterministic model's batched local fit
    m = et.Model(name="romc_5d")
    names = [f"p{i}" for i in range(5)]
    for n in names:
        et.Prior("uniform", -1, 2, model=m, name=n)
    et.Simulator(lambda *ps, batch_size, generator: torch.stack(ps, dim=1),
                 *[m[n] for n in names], observed=np.full((1, 5), 0.1,
                                                          np.float32),
                 model=m, name="sim")
    et.Distance("euclidean", m["sim"], model=m, name="d")
    romc = et.ROMC(m["d"], bounds=[(-1, 1)] * 5, seed=1)
    romc.solve_problems(n1=2, seed=1, optimizer_args={"restarts": 1})
    romc.estimate_regions(eps_filter=0.5, fit_models=True)
    p = romc.optim_problems[0]
    xs = torch.as_tensor(p.regions[0].sample(20,
                                             generator=p._box_generator(0)))
    ys = _np(p._objective_fn()(xs))
    want = np.linalg.lstsq(_np(tromc._quad_features(xs)), ys, rcond=None)[0]
    np.testing.assert_allclose(p._local_coeffs[0], want, rtol=1e-3,
                               atol=1e-4)

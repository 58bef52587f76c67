"""Stochastic Lotka-Volterra model by the Gillespie direct method in
PyTorch (counterpart of :mod:`elfi_tpu.models.lotka_volterra`; reference
``elfi/examples/lotka_volterra.py``).

The JAX package ``vmap``s a ``lax.while_loop`` per member.  Here all
members run as rows of one masked loop: a step is a few ops on (batch,)
tensors, a member that is done (its clock past ``time_end``, its grid
filled, or its 30,000 events taken) keeps its state, and the host reads
"are all members done?" once every ``check_every`` steps, not every step.
A member's step s uses the s-th draw of its row, so the members' streams
are independent of each other's progress.  The observation slots in
``(t, t_new]`` are filled by one vectorised update per step (the JAX
package's nested fill loops): each gets ``stock + (stock_new - stock) *
frac``; on predator extinction the rest of the grid gets ``stock_new``.

The draws come from ``step_noise``, so a test can feed
:func:`lotka_volterra_from_noise` the JAX package's own.  The observed data
are the JAX package's draws for any setting: :func:`observed_data` drives the
loop with the key stream of the JAX simulator at batch 1;
``data/lotka_volterra_observed.npz`` holds the JAX package's counts the
generator is held to."""

from __future__ import annotations

from functools import partial
from pathlib import Path

import numpy as np
import torch

from ..model.model import Distance, Model, Prior, Simulator, Summary
from ..ops.distributions import Distribution, draw_device
from ..parallel.backends import resolve_device
from ..utils import threefry, xla_math
from ._observed import first_row, memoised, true_values
from ._stats import batch_param

__all__ = ["lotka_volterra", "lotka_volterra_from_noise", "get_model",
           "observed_data", "ExpUniform", "stock_mean", "stock_log_variance",
           "stock_autocorr", "stock_crosscorr", "last_run"]

#: the JAX package's counts, which the generator is held to
_DATA = Path(__file__).resolve().parent / "data" / \
    "lotka_volterra_observed.npz"

_MAX_EVENTS = 30000
#: steps between the host's reads of "are all members done?"
CHECK_EVERY = 64

#: the last simulation's loop steps and host reads (for the smoke's
#: launches-per-step figure)
last_run = {"steps": 0, "checks": 0}


def _grid(n_obs, time_end):
    """``jnp.linspace(0, time_end, n_obs)`` in float32, bit for bit."""
    t = np.arange(n_obs, dtype=np.float32) * np.float32(
        time_end / (n_obs - 1))
    t[-1] = time_end
    return t


def lotka_volterra_from_noise(r1, r2, r3, prey_init, predator_init, sigma,
                              step_noise, final_noise, n_obs=16,
                              time_end=30., check_every=CHECK_EVERY,
                              xla_sum=False):
    """(batch, n_obs, 2) prey / predator counts on the even grid of
    ``[0, time_end]``, plus ``sigma * final_noise``.  ``step_noise(s, k)``
    gives steps ``s .. s + k - 1``'s standard exponentials and uniforms,
    each (k, batch); ``final_noise`` is (batch, n_obs, 2), or a function
    of each member's count of steps taken (batch,) that gives it (the JAX
    package draws it from the key the member's loop ended on).  With
    ``xla_sum`` the total hazard is summed as XLA's CPU code sums it (each
    product fused into the add), so that the JAX package's observed data
    take the same events bit for bit; the simulator keeps the plain sum,
    since the fused one (in float64) takes 0.2002 against 0.1784 device ms
    and 60.3 against 55.3 launches a step at 2**15 members on an H100
    (``scripts/torch_xla_order_ab.py --phases zoo``)."""
    E, U = step_noise(0, min(check_every, _MAX_EVENTS))
    device = E.device
    b = E.shape[1]
    taken = torch.zeros(b, dtype=torch.long, device=device) \
        if callable(final_noise) else None
    r1, r2, r3 = (batch_param(v, b, device) for v in (r1, r2, r3))
    times = torch.as_tensor(_grid(n_obs, time_end), device=device)
    slots = torch.arange(n_obs, device=device)
    stock = torch.stack([torch.floor(batch_param(prey_init, b, device)),
                         torch.floor(batch_param(predator_init, b, device))],
                        dim=1)
    obs = torch.zeros((b, n_obs, 2), device=device)
    obs[:, 0] = stock
    t = torch.zeros(b, device=device)
    next_idx = torch.ones(b, dtype=torch.long, device=device)
    stoich = torch.tensor([[1., 0.], [-1., 1.], [0., -1.], [0., 0.]],
                          device=device)
    active = torch.ones(b, dtype=torch.bool, device=device)
    steps = checks = 0
    while True:
        for j in range(E.shape[0]):
            if taken is not None:
                taken += active
            h1 = r1 * stock[:, 0]
            h2 = r2 * stock[:, 0] * stock[:, 1]
            if xla_sum:
                total = xla_math.fma(r3, stock[:, 1], xla_math.fma(
                    r1, stock[:, 0], h2))
            else:
                total = h1 + h2 + r3 * stock[:, 1]
            alive = total > 0
            tot = torch.clamp(total, min=1e-30)
            dt = torch.where(alive, E[j] / tot, time_end + 1.0)
            t_new = t + dt
            c0 = h1 / tot
            c1 = c0 + h2 / tot
            reaction = torch.where(
                alive, (U[j] >= c0).long() + (U[j] >= c1).long(), 3)
            stock_new = stock + stoich[reaction]
            # the slots in (t, t_new] that are not filled yet
            fill = ((slots >= next_idx[:, None]) & (times <= t_new[:, None])
                    & active[:, None])
            frac = torch.where(dt[:, None] > 0,
                               (times - t[:, None]) / dt[:, None], 0.0)
            val = stock[:, None] + (stock_new - stock)[:, None] * \
                frac[:, :, None]
            obs = torch.where(fill[:, :, None], val, obs)
            next_idx = next_idx + fill.sum(dim=1)
            # predators extinct: the trajectory is constant from here
            dead = (stock_new[:, 1] == 0) & active
            rest = (slots >= next_idx[:, None]) & dead[:, None]
            obs = torch.where(rest[:, :, None], stock_new[:, None], obs)
            next_idx = torch.where(dead, n_obs, next_idx)
            t = torch.where(active, torch.where(dead, time_end, t_new), t)
            stock = torch.where(active[:, None], stock_new, stock)
            active = active & (t < time_end) & (next_idx < n_obs)
        steps += E.shape[0]
        checks += 1
        if steps >= _MAX_EVENTS or not bool(active.any()):
            break
        E, U = step_noise(steps, min(check_every, _MAX_EVENTS - steps))
    last_run.update(steps=steps, checks=checks)
    if taken is not None:
        final_noise = final_noise(taken)
    return obs + batch_param(sigma, b, device)[:, None, None] * final_noise


def lotka_volterra(r1, r2, r3, prey_init=50, predator_init=100, sigma=0.,
                   n_obs=16, time_end=30., batch_size=1, generator=None):
    """(batch, n_obs, 2) prey / predator observations at an even time grid,
    on ``generator``'s device."""
    device = generator.device

    def step_noise(_, k):
        E = torch.empty((k, batch_size), device=device).exponential_(
            generator=generator)
        U = torch.rand((k, batch_size), generator=generator, device=device)
        return E, U

    noise = torch.randn((batch_size, n_obs, 2), generator=generator,
                        device=device)
    return lotka_volterra_from_noise(
        r1, r2, r3, prey_init, predator_init, sigma, step_noise, noise,
        n_obs, time_end)


class ExpUniform(Distribution):
    """log x ~ Uniform(a, b)."""

    @classmethod
    def rvs(cls, a, b, size=1, generator=None):
        u = torch.rand((size,), generator=generator,
                       device=draw_device(generator))
        return torch.exp(a + (b - a) * u)

    @classmethod
    def pdf(cls, x, a, b):
        x = torch.as_tensor(x)
        p = torch.where((x < np.exp(a)) | (x > np.exp(b)), 0.0, 1.0 / x)
        return p / (b - a)


def stock_mean(stock, species=0, mu=0, std=1):
    return (torch.mean(stock[:, :, species], dim=1) - mu) / std


def stock_log_variance(stock, species=0, mu=0, std=1):
    v = torch.var(stock[:, :, species], dim=1, correction=1)
    return (torch.log(v + 1) - mu) / std


def stock_autocorr(stock, species=0, lag=1, mu=0, std=1):
    x = stock[:, :, species]
    n_obs = x.shape[1]
    mx = torch.mean(x, dim=1, keepdim=True)
    sx = torch.std(x, dim=1, correction=1, keepdim=True)
    z = (x - mx) / sx
    C = torch.sum(z[:, lag:] * z[:, :-lag], dim=1) / (n_obs - 1)
    return (C - mu) / std


def stock_crosscorr(stock, mu=0, std=1):
    n_obs = stock.shape[1]

    def z(x):
        return (x - torch.mean(x, dim=1, keepdim=True)) / torch.std(
            x, dim=1, correction=0, keepdim=True)

    C = torch.sum(z(stock[:, :, 0]) * z(stock[:, :, 1]), dim=1) / (n_obs - 1)
    return (C - mu) / std


@memoised
def observed_data(n_obs=50, true_params=None, observation_noise=False,
                  seed_obs=None, time_end=30., device=None):
    """The observed counts (n_obs, 2), the JAX package's draw on ``device``
    (None: the global backend's).  The member's key is ``split(key(seed_obs
    or 0), 1)[0]``; event step j splits the chain's key into (next key,
    k1, k2) and draws ``exponential(k1)`` and ``uniform(k2)``; the
    observation noise is ``normal(fold_in(k, 99), (n_obs, 2))`` on the key
    ``k`` the loop ended on.  The chain of keys runs on the host (one short
    integer hash a step), the draws on the device."""
    if true_params is None:
        true_params = [1.0, 0.005, 0.6, 50, 100,
                       10. if observation_noise else 0.]
    device = resolve_device(device)
    chain = [threefry.host_split(threefry.seed_words(seed_obs or 0), 1)[0]]
    draws = []

    def keys(words):
        return torch.tensor(words, dtype=torch.int64, device=device)

    def step_noise(s, k):
        while len(draws) < s + k:
            nxt, k1, k2 = threefry.host_split(chain[-1], 3)
            chain.append(nxt)
            draws.append((k1, k2))
        k12 = keys(draws[s:s + k])                      # (k, 2, 2)
        return (threefry.exponential(k12[:, 0])[:, None],
                threefry.uniform(k12[:, 1])[:, None])

    def final_noise(taken):
        k = threefry.fold_in(keys(chain[int(taken[0])]), 99)
        return threefry.normal(k, (1, n_obs, 2))

    params = true_values(true_params, device)
    return first_row(lotka_volterra_from_noise(
        *params, step_noise, final_noise, n_obs, time_end, xla_sum=True))


def get_model(n_obs=50, true_params=None, observation_noise=False,
              seed_obs=None, time_end=30.):
    """Lotka-Volterra inference model."""
    y_obs = observed_data(n_obs, true_params, observation_noise, seed_obs,
                          time_end)
    sim_fn = partial(lotka_volterra, n_obs=n_obs, time_end=time_end)
    m = Model(name="lotka_volterra")
    priors = [Prior(ExpUniform, -6., 2., model=m, name="r1"),
              Prior(ExpUniform, -6., 2., model=m, name="r2"),
              Prior(ExpUniform, -6., 2., model=m, name="r3"),
              Prior("norm", 50, np.sqrt(50), model=m, name="prey0"),
              Prior("norm", 100, np.sqrt(100), model=m, name="predator0")]
    if observation_noise:
        priors.append(Prior(ExpUniform, np.log(0.5), np.log(50), model=m,
                            name="sigma"))
    Simulator(sim_fn, *priors, observed=y_obs, model=m, name="LV")
    ss = [Summary(partial(stock_mean, species=0), m["LV"], model=m,
                  name="prey_mean"),
          Summary(partial(stock_mean, species=1), m["LV"], model=m,
                  name="pred_mean"),
          Summary(partial(stock_log_variance, species=0), m["LV"], model=m,
                  name="prey_log_var"),
          Summary(partial(stock_log_variance, species=1), m["LV"], model=m,
                  name="pred_log_var"),
          Summary(partial(stock_autocorr, species=0, lag=1), m["LV"],
                  model=m, name="prey_autocorr_1"),
          Summary(partial(stock_autocorr, species=1, lag=1), m["LV"],
                  model=m, name="pred_autocorr_1"),
          Summary(partial(stock_autocorr, species=0, lag=2), m["LV"],
                  model=m, name="prey_autocorr_2"),
          Summary(partial(stock_autocorr, species=1, lag=2), m["LV"],
                  model=m, name="pred_autocorr_2"),
          Summary(stock_crosscorr, m["LV"], model=m, name="crosscorr")]
    Distance("euclidean", *ss, model=m, name="d")
    return m

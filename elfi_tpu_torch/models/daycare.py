"""Daycare-centre bacterial transmission model in PyTorch (Numminen et al.
2013; counterpart of :mod:`elfi_tpu.models.daycare`).

A continuous-time Markov SIS process over (day-care centre x individual x
strain), solved with the Gillespie direct method.  The state is a (batch,
n_dcc, n_ind, n_strains) bool tensor on the device; an event step computes
every centre's hazards, its total and its exponential waiting time at
once, finds the reaction by ``searchsorted`` on the centre's cumulative
hazards (the count ``sum(u >= cum[:-1])`` of the JAX package, which the
observed data's loop takes itself), and flips
that one state entry by a scatter (the JAX package builds a (batch, n_dcc,
n_ind * n_strains) one-hot instead).  A centre whose clock has passed
``time_end`` stops: its steps are masked no-ops.  The loop ends when every
centre is past ``time_end`` or after 20,000 steps overall, as in the JAX
package; the host reads the stop condition once every ``check_every``
steps, so up to ``check_every - 1`` masked steps run past the end (the
draws of a step are the same either way).

Hazards, as in the JAX package: an individual without strain s catches it
at ``(1 or t3) * (t1 * P_s / (n_ind - 1) + 1e-9 + t2 f_s)`` -- ``t3`` when
it carries any strain, ``P_s`` the centre's carriage of s with each
carrier's strains weighted ``1 / (its count)`` -- and a carrier clears a
strain at rate 1.  The draws come from ``step_noise``, so a test can feed
:func:`daycare_from_noise` the JAX package's own.  The observed data are
the JAX package's draws for any setting: :func:`observed_data` drives the
loop with the key stream of the JAX simulator at batch 1 and sums in the
order XLA's CPU code sums (``xla_order``), so the states are the JAX
package's bit for bit; ``data/daycare_observed.npz`` holds the JAX
package's states the generator is held to."""

from __future__ import annotations

from functools import partial
from pathlib import Path

import torch

from ..model.model import Discrepancy, Model, Operation, Prior, Simulator, \
    Summary
from ..parallel.backends import resolve_device
from ..utils import threefry, xla_math
from ._observed import first_row, memoised, true_values

__all__ = ["daycare", "daycare_from_noise", "get_model", "observed_data",
           "ss_shannon", "ss_strains", "ss_prevalence",
           "ss_prevalence_multi", "distance", "last_run"]

#: the JAX package's states, which the generator is held to
_DATA = Path(__file__).resolve().parent / "data" / "daycare_observed.npz"

_MAX_EVENTS = 20000
#: steps between the host's reads of the stop condition
CHECK_EVERY = 64

#: the last simulation's loop steps and host reads (for the smoke's
#: launches-per-step figure)
last_run = {"steps": 0, "checks": 0}


def daycare_from_noise(t1, t2, t3, step_noise, n_dcc=29, n_ind=53,
                       n_strains=33, freq_strains_commun=None, n_obs=36,
                       time_end=10., check_every=CHECK_EVERY,
                       xla_order=False):
    """Cross-sectional carriage states, (batch, n_dcc, n_obs, n_strains)
    float32.  ``step_noise(s, k)`` gives steps ``s .. s + k - 1``'s
    standard exponentials and uniforms, each (k, batch, n_dcc).  With
    ``xla_order`` every sum (a strain's weight, a centre's total, the
    running sums the reaction is read from) is taken in the order XLA's
    CPU code takes it, and the weight's multiply-add is fused, so that the
    states are the JAX package's bit for bit on the card and the CPU;
    without, torch sums as it likes (a rounding apart, which moves an
    event now and then).  The simulator sums as torch likes: XLA's order
    takes 17.88 against 2.93 ms a step at 2048 members on an H100
    (``scripts/torch_xla_order_ab.py``)."""
    E, U = step_noise(0, min(check_every, _MAX_EVENTS))
    device = E.device
    b = E.shape[1]

    def param(v):
        return torch.as_tensor(v, dtype=torch.float32,
                               device=device).reshape(-1, 1, 1, 1)

    t1, t2, t3 = param(t1), param(t2), param(t3)
    freq = torch.full((n_strains,), 0.1, device=device) \
        if freq_strains_commun is None else torch.as_tensor(
            freq_strains_commun, dtype=torch.float32, device=device)
    prob_commun = t2 * freq                                # (b, 1, 1, S)
    n_factor = 1.0 / (n_ind - 1)
    gamma = 1.0
    n_cells = n_ind * n_strains

    state = torch.zeros((b, n_dcc, n_ind, n_strains), dtype=torch.bool,
                        device=device)
    flat = state.view(b * n_dcc, n_cells)
    time = torch.zeros((b, n_dcc), device=device)
    steps = checks = 0
    while True:
        for j in range(E.shape[0]):
            sf = state.to(torch.float32)
            per_ind = sf.sum(dim=3, keepdim=True)          # (b, D, I, 1)
            carrier = per_ind > 0
            inv = torch.where(carrier, 1.0 / per_ind, 0.0)
            share = sf * inv             # the JAX package's sf / per_ind
            cells = (b, n_dcc, n_cells)
            if xla_order:
                P = xla_math.reduce_sum(share.transpose(2, 3),
                                        (3,))[:, :, None]  # (b, D, 1, S)
                base = xla_math.fma(t1 * P, n_factor, 1e-9) + prob_commun
            else:
                P = share.sum(dim=2, keepdim=True)
                base = t1 * P * n_factor + 1e-9 + prob_commun
            hazards = torch.where(carrier, t3 * base, base)
            hazards.masked_fill_(state, gamma)
            if xla_order:
                total = xla_math.reduce_sum(hazards, (2, 3))   # (b, D)
                cum = xla_math.cumsum(hazards.view(cells))
                u = (U[j] * total)[..., None]
                # the JAX package's count: a running sum in XLA's order
                # may step back an ulp where two blocks meet, so no
                # binary search
                idx = (u >= cum[..., :-1]).sum(dim=2).view(-1, 1)
            else:
                total = hazards.sum(dim=(2, 3))
                cum = torch.cumsum(hazards.view(cells), dim=2)
                u = (U[j] * total)[..., None]
                idx = torch.searchsorted(cum, u, right=True).clamp_(
                    max=n_cells - 1).view(-1, 1)
            dt = E[j] / total
            active = time < time_end
            cur = flat.gather(1, idx)
            flat.scatter_(1, idx, cur ^ active.view(-1, 1))
            time = torch.where(active, time + dt, time)
        steps += E.shape[0]
        checks += 1
        if steps >= _MAX_EVENTS or not bool((time < time_end).any()):
            break
        E, U = step_noise(steps, min(check_every, _MAX_EVENTS - steps))
    last_run.update(steps=steps, checks=checks)
    return state[:, :, :n_obs, :].to(torch.float32)


def daycare(t1, t2, t3, n_dcc=29, n_ind=53, n_strains=33,
            freq_strains_commun=None, n_obs=36, time_end=10., batch_size=1,
            generator=None):
    """(batch, n_dcc, n_obs, n_strains) carriage states on ``generator``'s
    device."""
    device = generator.device

    def step_noise(_, k):
        E = torch.empty((k, batch_size, n_dcc), device=device).exponential_(
            generator=generator)
        U = torch.rand((k, batch_size, n_dcc), generator=generator,
                       device=device)
        return E, U

    return daycare_from_noise(t1, t2, t3, step_noise, n_dcc, n_ind,
                              n_strains, freq_strains_commun, n_obs,
                              time_end)


def ss_shannon(data):
    """Shannon diversity per day-care centre; (batch, n_dcc)."""
    total_obs = torch.sum(data, dim=2, keepdim=True)
    denom = torch.sum(total_obs, dim=3, keepdim=True)
    p = torch.where(denom > 0, total_obs / denom, 0.0)
    p = torch.where(p == 0, 1.0, p)
    return -torch.sum(p * torch.log(p), dim=3)[:, :, 0]


def ss_strains(data):
    return torch.sum(torch.any(data > 0, dim=2), dim=2)


def ss_prevalence(data):
    return torch.sum(torch.any(data > 0, dim=3), dim=2) / data.shape[2]


def ss_prevalence_multi(data):
    return torch.sum(torch.sum(data, dim=3) > 1, dim=2) / data.shape[2]


def distance(*summaries, observed):
    """Gutmann & Corander (2016) single distance: L1 over the summaries
    normalised by the observed maxima and sorted over the centres."""
    def stack(xs):
        return torch.stack([torch.as_tensor(x).to(torch.float32)
                            for x in xs])

    sim, obs = stack(summaries), stack(observed)
    obs_max = torch.amax(obs, dim=2, keepdim=True)
    obs_max = torch.where(obs_max == 0, 1.0, obs_max)
    y = torch.sort(obs / obs_max, dim=2).values
    x = torch.sort(sim / obs_max, dim=2).values
    n_ss, _, n_dcc = x.shape
    return torch.sum(torch.abs(x - y), dim=(0, 2)) / (n_ss * n_dcc)


@memoised
def observed_data(true_params=None, seed_obs=None, device=None, **kwargs):
    """The observed states (n_dcc, n_obs, n_strains), the JAX package's
    draw on ``device`` (None: the global backend's); ``kwargs`` are the
    size arguments of :func:`daycare`.  Event step j splits the chain's key
    (from ``key(seed_obs or 0)``) into (next key, k1, k2) and draws
    ``exponential(k1, (1, n_dcc))`` and ``uniform(k2, (1, n_dcc, 1))``.
    The chain of keys runs on the host (one short integer hash a step),
    the draws on the device."""
    device = resolve_device(device)
    n_dcc = kwargs.get("n_dcc", 29)
    chain = [threefry.seed_words(seed_obs or 0)]

    def step_noise(s, k):
        draws = []
        for _ in range(k):
            nxt, k1, k2 = threefry.host_split(chain[-1], 3)
            chain.append(nxt)
            draws.append((k1, k2))
        k12 = torch.tensor(draws, dtype=torch.int64, device=device)
        return (threefry.exponential(k12[:, 0], (1, n_dcc)),
                threefry.uniform(k12[:, 1], (1, n_dcc)))

    params = true_values(true_params or [3.6, 0.6, 0.1], device)
    return first_row(daycare_from_noise(*params, step_noise, **kwargs,
                                        xla_order=True))


def get_model(true_params=None, seed_obs=None, **kwargs):
    """Daycare transmission inference model; ``kwargs`` are the size
    arguments of :func:`daycare`."""
    y_obs = observed_data(true_params, seed_obs, **kwargs)
    m = Model(name="daycare")
    Prior("uniform", 0, 11, model=m, name="t1")
    Prior("uniform", 0, 2, model=m, name="t2")
    Prior("uniform", 0, 1, model=m, name="t3")
    Simulator(partial(daycare, **kwargs), m["t1"], m["t2"], m["t3"],
              observed=y_obs, model=m, name="DCC")
    ss = [Summary(ss_shannon, m["DCC"], model=m, name="Shannon"),
          Summary(ss_strains, m["DCC"], model=m, name="n_strains"),
          Summary(ss_prevalence, m["DCC"], model=m, name="prevalence"),
          Summary(ss_prevalence_multi, m["DCC"], model=m, name="multi")]
    Discrepancy(distance, *ss, model=m, name="d")
    Operation(torch.log, m["d"], model=m, name="logd")
    return m

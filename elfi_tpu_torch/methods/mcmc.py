"""MCMC samplers and chain diagnostics (counterpart of
:mod:`elfi_tpu.methods.mcmc`): NUTS, random-walk Metropolis, split-chain
effective sample size and split-R-hat.

NUTS is the JAX package's iterative formulation (Hoffman & Gelman, Alg. 6,
with the recursion flattened: a fixed-size checkpoint stack holds the left
ends for the sub-U-turn tests, stored at slot popcount(i) on even leaves
and tested at slots [popcount - trailing_ones, popcount) on odd ones).  The
JAX package ``vmap``s one chain of nested ``lax.while_loop``s, whose
finished lanes are masked while the others go on.  Here all chains are rows
of one ``(n_chains, d)`` tensor and the loops become one step,
:func:`_nuts_step`, that takes one leaf of every chain: a chain whose
subtree ends in that leaf merges it into its tree, and a chain whose tree
ends records its draw, adapts its step size and starts its next iteration
in the same step.  So each chain has its own iteration, depth and leaf
counter, runs exactly the leaves the JAX chain would, and never waits for
another.  A leaf's first gradient is the previous leaf's last one, carried
instead of recomputed.

On a CUDA device the step is captured once per run as a CUDA graph and
replayed; the host reads one "all chains done" flag per
:data:`_STEPS_PER_CHECK` steps.  The eager run (the CPU) takes the same
steps and gives the same draws bit for bit.  The random numbers of a run
are drawn up front from one ``torch.Generator`` and each step reads its own
by (chain, iteration, depth or leaf), so the chains agree with the JAX
package's statistically, not bitwise.

The target is a function of rows: ``target(x (n, d), *target_args) ->
(n,)``; its gradient comes from autograd.

ESS and R-hat are in float32 on a device, over a trailing parameter axis
at once, as the JAX package computes them on its default device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.backends import resolve_device
from ..utils.rng import fold_in, generator
from .bo.gp import full_float32_matmul, value_and_grad
from .bo.utils import _args_device

__all__ = ["nuts", "nuts_chains", "metropolis", "metropolis_chains",
           "eff_sample_size", "gelman_rubin_statistic"]

_DIVERGENCE = 1000.0  # reference's diverging-error slack (mcmc.py:330)
#: folded into the seed to key the samplers' streams
_NUTS_SALT = 0x4E555453
_MH_SALT = 0x4D48
#: NUTS steps between two reads of the "all chains done" flag; the steps
#: after a chain's last iteration change nothing
_STEPS_PER_CHECK = 16

#: the last NUTS run's counts: host steps (graph replays on CUDA), chains,
#: iterations, leapfrogs of all chains, tree depths summed over all chains'
#: iterations, and whether the step was captured
stats = {}


def _popcount(n):
    """Branch-free SWAR popcount of non-negative integers below 2**32."""
    n = torch.as_tensor(n).to(torch.int64)
    n = n - ((n >> 1) & 0x55555555)
    n = (n & 0x33333333) + ((n >> 2) & 0x33333333)
    n = (n + (n >> 4)) & 0x0F0F0F0F
    return ((n * 0x01010101) & 0xFFFFFFFF) >> 24


def _trailing_ones(n):
    """Number of trailing 1-bits: popcount(n ^ (n + 1)) - 1."""
    n = torch.as_tensor(n).to(torch.int64)
    return _popcount(n ^ (n + 1)) - 1


def _sg(v):
    """Non-finite gradient entries set to 0: outside the prior support the
    log-density is -inf and its gradient nan, and one boundary touch would
    otherwise poison the whole trajectory (the reference's sanitized
    ``gradient_logpdf``)."""
    return torch.where(torch.isfinite(v), v, 0.0)


def _value_and_grad(target):
    """``x -> (target(x), sanitized gradient)`` for rows ``x``."""
    def vg(x):
        f, g = value_and_grad(target, x)
        return f, _sg(g)
    return vg


def _leapfrog(grad_x, vg, x, m, step):
    """One leapfrog step from ``(x, m)`` with the gradient ``grad_x`` at
    ``x``; returns ``(x1, m1, target(x1), gradient at x1)``."""
    m1 = m + 0.5 * step * _sg(grad_x)
    x1 = x + step * m1
    logp1, g1 = vg(x1)
    m1 = m1 + 0.5 * step * g1
    return x1, m1, logp1, g1


def _uturn(x_l, x_r, m_l, m_r):
    dx = x_r - x_l
    return (torch.sum(dx * m_l, dim=-1) < 0) | (torch.sum(dx * m_r, dim=-1)
                                                < 0)


def _where(c, a, b):
    """``torch.where`` with a per-chain condition ``c`` (n,) broadcast over
    the trailing axes of ``a`` and ``b``."""
    return torch.where(c.reshape(c.shape + (1,) * (a.ndim - 1)), a, b)


def _find_stepsize(vg, x0, m0):
    """Trial-leapfrog initial step size of each chain (reference
    ``mcmc.py:175-220``) from rows ``x0`` with momenta ``m0``: first the
    largest of 1, e^-1, e^-2, ... (at most 20) whose trial joint density
    is finite, then doubled or halved (at most 50 times) until the
    acceptance ratio crosses 0.5."""
    logp0, g0 = vg(x0)
    joint0 = logp0 - 0.5 * torch.sum(m0 * m0, dim=-1)

    def joint_at(step):
        _, m1, logp1, _ = _leapfrog(g0, vg, x0, m0, step[:, None])
        return logp1 - 0.5 * torch.sum(m1 * m1, dim=-1)

    i = torch.zeros_like(joint0)
    step = torch.ones_like(joint0)
    j1 = joint_at(step)
    while True:
        live = ~torch.isfinite(j1) & (i < 20)
        if not bool(live.any()):
            break
        trial = torch.exp(-(i + 1.0))
        j_trial = joint_at(trial)
        step = torch.where(live, trial, step)
        j1 = torch.where(live, j_trial, j1)
        i = torch.where(live, i + 1.0, i)
    plus = torch.exp(j1 - joint0) > 0.5
    factor = torch.where(plus, 2.0, 0.5)
    sign = torch.where(plus, 1.0, -1.0)
    it = torch.zeros_like(i)
    while True:
        live = (factor * torch.exp(sign * (j1 - joint0)) > 1.0) & (it < 50)
        if not bool(live.any()):
            break
        trial = step * factor
        j_trial = joint_at(trial)
        step = torch.where(live, trial, step)
        j1 = torch.where(live, j_trial, j1)
        it = torch.where(live, it + 1.0, it)
    return step


def _nuts_draws(gen, n_chains, n_iter, d, max_depth, device):
    """Every random number of a run, by chain and iteration: the momentum,
    the slice's exponential, one uniform per doubling for its direction and
    one for its acceptance, and one per leaf for the progressive proposal
    (at most 2**(max_depth + 1) - 1 leaves an iteration)."""
    shape = (n_chains, n_iter)
    return dict(
        m0=torch.randn(shape + (d,), generator=gen, device=device),
        e=torch.empty(shape, device=device).exponential_(generator=gen),
        u_dir=torch.rand(shape + (max_depth + 1,), generator=gen,
                         device=device),
        u_acc=torch.rand(shape + (max_depth + 1,), generator=gen,
                         device=device),
        u_leaf=torch.rand(shape + (2 ** (max_depth + 1),), generator=gen,
                          device=device))


def _start_iteration(S, R, rows, start, n_iter):
    """The state of a fresh iteration (``nuts_iteration``'s initial loop
    state) for the chains in ``start``: a momentum, the slice, and a tree
    that is the current point alone."""
    itn = torch.clamp(S["it"], max=n_iter - 1)
    m0 = R["m0"][rows, itn]
    lj0 = S["logp"] - 0.5 * torch.sum(m0 * m0, dim=-1)
    new = dict(
        lj0=lj0, ls=lj0 - R["e"][rows, itn],
        depth=torch.zeros_like(S["depth"]), nleaf=torch.zeros_like(S["nleaf"]),
        xl=S["x"], ml=m0, gl=S["g"], xr=S["x"], mr=m0, gr=S["g"],
        xp=S["x"], lpp=S["logp"], gp=S["g"],
        nok=torch.ones_like(S["nok"]), ok=torch.ones_like(S["ok"]),
        mh=torch.zeros_like(S["mh"]), ns=torch.ones_like(S["ns"]))
    for k, v in new.items():
        S[k] = _where(start, v, S[k])


def _start_subtree(S, R, rows, start, n_iter, max_depth):
    """A new subtree of ``2**depth`` leaves for the chains in ``start``
    (``_build_subtree``'s initial state): its direction, and the tree's
    edge on that side as its first leapfrog's start."""
    itn = torch.clamp(S["it"], max=n_iter - 1)
    u = R["u_dir"][rows, itn, torch.clamp(S["depth"], max=max_depth)]
    right = u < 0.5
    xe = _where(right, S["xr"], S["xl"])
    ge = _where(right, S["gr"], S["gl"])
    new = dict(
        dirn=torch.where(right, 1.0, -1.0), i=torch.zeros_like(S["i"]),
        xe=xe, me=_where(right, S["mr"], S["ml"]), ge=ge,
        xsp=xe, lpsp=torch.zeros_like(S["lpsp"]), gsp=ge,
        nsub=torch.zeros_like(S["nsub"]), sok=torch.ones_like(S["sok"]),
        mhs=torch.zeros_like(S["mhs"]), nst=torch.zeros_like(S["nst"]))
    for k, v in new.items():
        S[k] = _where(start, v, S[k])


def _nuts_step(vg, S, R, xs, rows, slots, n_iter, n_adapt, target_prob,
               max_depth):
    """One leaf of every chain, then the ends of subtrees, trees and
    iterations that leaf brings, all masked per chain; the new state
    replaces ``S`` in place and finished iterations write their draw into
    ``xs``."""
    S0, S = S, dict(S)
    live = S["it"] < n_iter
    itc = torch.clamp(S["it"], max=n_iter - 1)

    # -- the leaf (_build_subtree's loop body) --
    x1, m1, lp1, g1 = _leapfrog(S["ge"], vg, S["xe"], S["me"],
                                (S["dirn"] * S["step"])[:, None])
    lj = lp1 - 0.5 * torch.sum(m1 * m1, dim=-1)
    leaf_ok = S["ls"] < (_DIVERGENCE + lj)
    nok_leaf = (S["ls"] <= lj).to(torch.float32)
    mh = torch.where(leaf_ok, torch.clamp(torch.exp(lj - S["lj0"]), max=1.0),
                     0.0)
    # progressive (reservoir) proposal over the slice-accepted leaves
    u = R["u_leaf"][rows, itc, S["nleaf"]]
    take = leaf_ok & (u < nok_leaf / torch.clamp(S["nsub"] + nok_leaf,
                                                  min=1.0))
    S["xsp"] = _where(take, x1, S["xsp"])
    S["lpsp"] = torch.where(take, lp1, S["lpsp"])
    S["gsp"] = _where(take, g1, S["gsp"])
    S["nsub"] = S["nsub"] + nok_leaf
    # checkpoints for the sub-U-turn tests; for a leftward subtree the
    # checkpoint is the later point, so the displacement is time-aligned
    i = S["i"]
    pc = _popcount(i)
    even = (i % 2) == 0
    at = (slots[None, :] == pc[:, None]) & even[:, None]
    S["xc"] = torch.where(at[..., None], x1[:, None, :], S["xc"])
    S["mc"] = torch.where(at[..., None], m1[:, None, :], S["mc"])
    to = _trailing_ones(i)
    valid = (slots[None, :] >= (pc - to)[:, None]) \
        & (slots[None, :] <= (pc - 1)[:, None])
    dxs = S["dirn"][:, None, None] * (x1[:, None, :] - S["xc"])
    turn = (torch.sum(dxs * S["mc"], dim=-1) < 0) \
        | (torch.sum(dxs * m1[:, None, :], dim=-1) < 0)
    turning = ~even & torch.any(valid & turn, dim=-1)
    S["sok"] = leaf_ok & ~turning
    S["i"] = i + 1
    S["nleaf"] = torch.clamp(S["nleaf"] + 1, max=R["u_leaf"].shape[-1] - 1)
    S["mhs"] = S["mhs"] + mh
    S["nst"] = S["nst"] + 1.0
    S["xe"], S["me"], S["ge"] = x1, m1, g1
    S["nleap"] = S["nleap"] + live.to(S["nleap"].dtype)

    # -- the subtree's end (nuts_iteration's loop body after it) --
    sub_end = ~S["sok"] | (S["i"] >= (torch.ones_like(i) << S["depth"]))
    right = S["dirn"] > 0
    left_end, right_end = sub_end & ~right, sub_end & right
    for side, cond in (("l", left_end), ("r", right_end)):
        S["x" + side] = _where(cond, S["xe"], S["x" + side])
        S["m" + side] = _where(cond, S["me"], S["m" + side])
        S["g" + side] = _where(cond, S["ge"], S["g" + side])
    u_acc = R["u_acc"][rows, itc, torch.clamp(S["depth"], max=max_depth)]
    accept = sub_end & S["sok"] & (u_acc < S["nsub"] / torch.clamp(
        S["nok"], min=1.0))
    S["xp"] = _where(accept, S["xsp"], S["xp"])
    S["lpp"] = torch.where(accept, S["lpsp"], S["lpp"])
    S["gp"] = _where(accept, S["gsp"], S["gp"])
    S["nok"] = torch.where(sub_end, S["nok"] + S["nsub"], S["nok"])
    S["ok"] = torch.where(
        sub_end, S["sok"] & ~_uturn(S["xl"], S["xr"], S["ml"], S["mr"]),
        S["ok"])
    # the acceptance statistic is the last subtree's
    S["mh"] = torch.where(sub_end, S["mhs"], S["mh"])
    S["ns"] = torch.where(sub_end, torch.clamp(S["nst"], min=1.0), S["ns"])
    S["depth"] = torch.where(sub_end, S["depth"] + 1, S["depth"])

    # -- the iteration's end: the draw and the dual-averaging step size
    # (reference mcmc.py:281-296) --
    it_end = live & sub_end & (~S["ok"] | (S["depth"] > max_depth))
    S["x"] = _where(it_end, S["xp"], S["x"])
    S["logp"] = torch.where(it_end, S["lpp"], S["logp"])
    S["g"] = _where(it_end, S["gp"], S["g"])
    xs[rows, itc] = _where(it_end, S["xp"], xs[rows, itc])
    S["depth_sum"] = S["depth_sum"] + torch.where(it_end, S["depth"], 0)
    ii = (S["it"] + 1).to(torch.float32)
    in_adapt = ii <= n_adapt
    ar = (1.0 - 1.0 / (ii + 10.0)) * S["ar"] \
        + (target_prob - S["mh"] / S["ns"]) / (ii + 10.0)
    log_step = S["mu"] - torch.sqrt(ii) / 0.05 * ar
    w = ii ** -0.75
    las = w * log_step + (1.0 - w) * S["las"]
    step = torch.where(in_adapt, torch.exp(log_step),
                       torch.where(ii == n_adapt + 1, torch.exp(S["las"]),
                                   S["step"]))
    S["step"] = torch.where(it_end, step, S["step"])
    S["ar"] = torch.where(it_end & in_adapt, ar, S["ar"])
    S["las"] = torch.where(it_end & in_adapt, las, S["las"])
    S["it"] = torch.where(it_end, S["it"] + 1, S["it"])
    _start_iteration(S, R, rows, it_end, n_iter)
    _start_subtree(S, R, rows, sub_end, n_iter, max_depth)
    for k, v in S.items():
        S0[k].copy_(v)


def _run_nuts(x0s, target, n_iter, n_adapt, target_prob, max_depth, seed,
              stepsize0, scales, device, capture=None):
    """All chains from rows ``x0s`` (numpy); returns the draws (n_chains,
    n_iter, d) as float32 numpy.  ``scales`` (d,) runs the chains in
    z = x / scales with unit-mass momentum, a diagonal mass matrix
    diag(1 / scales^2).  ``capture`` (default: on a CUDA device) replays
    the step as a CUDA graph."""
    x = torch.atleast_2d(torch.as_tensor(np.asarray(x0s), dtype=torch.float32,
                                         device=device))
    if scales is not None:
        scales = torch.as_tensor(np.asarray(scales), dtype=torch.float32,
                                 device=device)
        unscaled = target
        target = lambda z: unscaled(z * scales)   # noqa: E731
        x = x / scales
    if capture is None:
        capture = x.device.type == "cuda"
    gen = generator(fold_in(seed, _NUTS_SALT), device)
    vg = _value_and_grad(target)
    C, d = x.shape
    rows = torch.arange(C, device=device)
    slots = torch.arange(max_depth + 1, device=device)
    xs = torch.zeros((C, n_iter, d), device=device)
    with full_float32_matmul():
        logp, g = vg(x)
        if stepsize0:
            step = torch.full((C,), float(stepsize0), device=device)
        else:
            step = _find_stepsize(
                vg, x, torch.randn((C, d), generator=gen, device=device))
        R = _nuts_draws(gen, C, n_iter, d, max_depth, device)
        zc = torch.zeros((C,), device=device)
        zi = torch.zeros((C,), dtype=torch.int64, device=device)
        S = dict(it=zi, x=x, logp=logp, g=g, step=step,
                 mu=torch.log(10.0 * step), ar=zc, las=zc, ok=zi.bool(),
                 nleap=zi, depth_sum=zi, xc=torch.zeros((C, max_depth + 1, d),
                                                        device=device))
        for k in ("lj0", "ls", "nok", "mh", "ns", "dirn", "lpp", "lpsp",
                  "nsub", "mhs", "nst"):
            S[k] = zc
        for k in ("depth", "nleaf", "i"):
            S[k] = zi
        S["sok"] = zi.bool()
        for k in ("xl", "ml", "gl", "xr", "mr", "gr", "xp", "gp", "xe", "me",
                  "ge", "xsp", "gsp"):
            S[k] = x
        S["mc"] = S["xc"]
        every = torch.ones((C,), dtype=torch.bool, device=device)
        _start_iteration(S, R, rows, every, n_iter)
        _start_subtree(S, R, rows, every, n_iter, max_depth)
        S = {k: v.clone() for k, v in S.items()}

        def step_fn():
            _nuts_step(vg, S, R, xs, rows, slots, n_iter, n_adapt,
                       target_prob, max_depth)

        run = _capture_step(step_fn, S, xs, device) if capture else step_fn
        n_steps = 0
        while True:
            for _ in range(_STEPS_PER_CHECK):
                run()
            n_steps += _STEPS_PER_CHECK
            if not bool((S["it"] < n_iter).any()):
                break
    counts = torch.stack([S["nleap"].sum(), S["depth_sum"].sum()]).cpu()
    stats.clear()
    stats.update(steps=n_steps, chains=C, iterations=n_iter,
                 leapfrogs=int(counts[0]), depth_sum=int(counts[1]),
                 captured=bool(capture))
    if scales is not None:
        xs = xs * scales
    return xs.cpu().numpy()


def _capture_step(step_fn, S, xs, device):
    """``step_fn`` captured as a CUDA graph; returns its replay.  The
    warm-up step that capture asks for (on a side stream, so the libraries
    set up their handles outside the graph) runs on a copy of the state,
    which is then put back."""
    saved = {k: v.clone() for k, v in S.items()}
    xs_saved = xs.clone()
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        step_fn()
    torch.cuda.current_stream(device).wait_stream(side)
    for k, v in saved.items():
        S[k].copy_(v)
    xs.copy_(xs_saved)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step_fn()
    return graph.replay


def _bind(target, target_args):
    if not target_args:
        return target
    return lambda x: target(x, *target_args)


def _device_of(target_args, device):
    return _args_device(target_args) or resolve_device(device)


def nuts(n_iter, params0, target, grad_target=None, n_adapt=None,
         target_prob=0.6, max_depth=5, seed=0, stepsize=None,
         target_args=(), scales=None, device=None, **kwargs):
    """Sample the log-density ``target`` (rows -> values) with NUTS
    (reference API, ``mcmc.py:114-162``); returns (n_iter, d) including the
    adaptation.  ``grad_target`` is accepted for the reference's API and
    not used: the gradient comes from autograd.  ``scales``: per-parameter
    widths used as a diagonal mass matrix."""
    device = _device_of(target_args, device)
    params0 = np.atleast_1d(np.asarray(params0, np.float32))
    tgt = _bind(target, target_args)
    with torch.no_grad():
        t0 = float(tgt(torch.as_tensor(params0[None], device=device))[0])
    if not np.isfinite(t0):
        raise ValueError(f"NUTS: bad initialization point {params0}, "
                         "logpdf -> -inf")
    n_adapt = n_adapt if n_adapt is not None else n_iter // 2
    return _run_nuts(params0[None], tgt, int(n_iter), int(n_adapt),
                     float(target_prob), int(max_depth), seed, stepsize,
                     scales, device)[0]


def nuts_chains(n_iter, x0s, target, n_adapt=None, target_prob=0.6,
                max_depth=5, seed=0, stepsize=None, mesh=None,
                target_args=(), scales=None, device=None, capture=None):
    """Run several NUTS chains as one batch on the device; returns
    (n_chains, n_iter, d).  ``target_args`` are passed to
    ``target(x, *target_args)``.  ``mesh`` is accepted for the JAX
    package's API and ignored: the chains' step is bound by the host's
    launches, which a split over devices would only multiply.  ``capture``
    (default: on a CUDA device) replays the step as a CUDA graph; the
    draws are the same either way."""
    device = _device_of(target_args, device)
    n_adapt = n_adapt if n_adapt is not None else n_iter // 2
    return _run_nuts(x0s, _bind(target, target_args), int(n_iter),
                     int(n_adapt), float(target_prob), int(max_depth), seed,
                     stepsize, scales, device, capture)


def _run_metropolis(x0s, target, n_total, sigma, seed, device):
    x = torch.atleast_2d(torch.as_tensor(np.asarray(x0s), dtype=torch.float32,
                                         device=device))
    sigma = torch.as_tensor(np.asarray(sigma), dtype=torch.float32,
                            device=device)
    gen = generator(fold_in(seed, _MH_SALT), device)
    xs = torch.empty((x.shape[0], n_total, x.shape[1]), device=device)
    with torch.no_grad(), full_float32_matmul():
        logp = target(x)
        for i in range(n_total):
            prop = x + sigma * torch.randn(x.shape, generator=gen,
                                           device=device)
            logp_prop = target(prop)
            u = torch.rand((x.shape[0],), generator=gen, device=device)
            accept = torch.isfinite(logp_prop) & (torch.exp(logp_prop - logp)
                                                  >= u)
            x = _where(accept, prop, x)
            logp = torch.where(accept, logp_prop, logp)
            xs[:, i] = x
    return xs.cpu().numpy()


def metropolis(n_samples, params0, target, sigma_proposals, warmup=0, seed=0,
               target_args=(), device=None):
    """Random-walk Metropolis with Gaussian proposals (reference
    ``mcmc.py:379-429``); returns (n_samples, d) past the warm-up."""
    device = _device_of(target_args, device)
    params0 = np.atleast_1d(np.asarray(params0, np.float32))
    tgt = _bind(target, target_args)
    with torch.no_grad():
        t0 = float(tgt(torch.as_tensor(params0[None], device=device))[0])
    if not np.isfinite(t0):
        raise ValueError(f"Metropolis: bad initialization point {params0}")
    return _run_metropolis(params0[None], tgt, int(n_samples + warmup),
                           sigma_proposals, seed, device)[0, warmup:]


def metropolis_chains(n_samples, x0s, target, sigma_proposals, warmup=0,
                      seed=0, target_args=(), device=None):
    device = _device_of(target_args, device)
    return _run_metropolis(x0s, _bind(target, target_args),
                           int(n_samples + warmup), sigma_proposals, seed,
                           device)[:, warmup:]


# ---------------------------------------------------------------------------
# Chain diagnostics
# ---------------------------------------------------------------------------

def _split_halves(chains):
    """(m, n[, p]) chains -> (2m, n//2[, p]): first and last halves stacked
    (the middle draw is dropped when n is odd).  Splitting makes within-chain
    drift show up as between-chain variance in both diagnostics."""
    chains = np.atleast_2d(np.asarray(chains, np.float64))
    half = chains.shape[1] // 2
    return np.concatenate([chains[:, :half], chains[:, -half:]], axis=0)


def _tau_and_rhat(split, device):
    """Integrated autocorrelation time tau and split-R-hat of (m, n, p)
    split chains, one pair per trailing column, as float64 numpy arrays
    (p,).  The arithmetic is float32 on ``device``."""
    split = torch.as_tensor(split, dtype=torch.float32, device=device)
    m, n, _ = split.shape
    # circular-embedding FFT autocovariance, biased (1/n) normalisation
    centered = split - split.mean(dim=1, keepdim=True)
    spectrum = torch.fft.rfft(centered, 2 * n, dim=1)
    acov = torch.fft.irfft(spectrum.abs() ** 2, 2 * n, dim=1)[:, :n] / n
    within = acov[:, 0].mean(dim=0) * n / (n - 1.0)
    between = torch.var(split.mean(dim=1), dim=0, correction=1)   # = B/n
    total = within * (n - 1.0) / n + between       # marginal variance var+
    rhat = torch.sqrt(total / within)
    # combined autocorrelation at each lag, all chains pooled: (n, p)
    rho = 1.0 - (within - acov.mean(dim=0)) / total
    # Geyer 1992: Gamma_k = rho_2k + rho_2k+1 is positive and non-increasing
    # for a reversible chain; truncate at the first non-positive pair and
    # clamp to the running minimum
    pairs = rho[0:n - n % 2:2] + rho[1::2]
    alive = torch.cumprod((pairs > 0.0).to(torch.int32), dim=0).bool()
    capped = torch.cummin(pairs, dim=0).values
    tau = -1.0 + 2.0 * torch.sum(
        torch.where(alive, torch.clamp(capped, min=0.0), 0.0), dim=0)
    # (near-)constant chains: the variance is rounding, tau and R-hat mean
    # nothing -- define both as 1; also tau = 1 when no Geyer pair survives
    degenerate = total <= 1e-10 * ((split ** 2).mean(dim=(0, 1)) + 1e-30)
    tau = torch.where(degenerate | ~torch.isfinite(tau) | (tau <= 0.0),
                      1.0, tau)
    rhat = torch.where(degenerate | ~torch.isfinite(rhat), 1.0, rhat)
    return (tau.cpu().numpy().astype(np.float64),
            rhat.cpu().numpy().astype(np.float64))


def eff_sample_size(chains, device=None):
    """Effective sample size of MCMC draws.

    ``chains`` is (n_samples,), (n_chains, n_samples), or
    (n_chains, n_samples, n_params) -- the latter returns one ESS per
    parameter as an array.  ``device``: where the float32 arithmetic runs
    (None: the global backend's).
    """
    device = resolve_device(device)
    arr = np.asarray(chains, np.float64)
    if arr.ndim == 3:
        taus, _ = _tau_and_rhat(_split_halves(arr), device)
        size = arr.shape[0] * arr.shape[1]
        return np.minimum(size / np.maximum(taus, 1e-12),
                          size * np.log10(max(size, 10.0)))
    split = _split_halves(arr)
    tau, _ = _tau_and_rhat(split[:, :, None], device)
    size = split.shape[0] * split.shape[1]
    return float(min(size / max(float(tau[0]), 1e-12),
                     size * np.log10(max(size, 10.0))))


def gelman_rubin_statistic(chains, device=None):
    """Split-chain potential-scale-reduction factor R-hat (the same
    split-halves convention as :func:`eff_sample_size`)."""
    device = resolve_device(device)
    arr = np.asarray(chains, np.float64)
    if arr.ndim == 3:
        return _tau_and_rhat(_split_halves(arr), device)[1]
    return float(_tau_and_rhat(_split_halves(arr)[:, :, None], device)[1][0])

"""SMC calls: ``elfi_tpu_torch.SMC(node, batch_size, seed,
device).sample(n_samples, thresholds=...)``, one sampler a run, each run a
posterior: a rejection round under the prior, then a round a threshold
from the Gaussian-mixture proposal over the last population.

Traffic keys: ``graph``, ``batch_size``, ``n_samples``, ``thresholds``,
``check_calls``.

The check follows each chosen run round by round.  Round 0 is recomputed
from the seed alone.  A later round's proposals depend on the previous
population, so the reference builds the round's mixture (its own code:
the components, their spread, the choice among them) from the program's
previous population, which the check of the round before has held to the
reference, and recomputes the round from there: the proposals from the
round's stream, the simulations, a chunk of :data:`CHUNK` batches at a
time until ``n_samples`` rows are within the threshold (the reference's
own stopping point, not the program's count), their best rows, and the
weights of the returned rows.  So each population is checked on its own:
its rows (:mod:`..reference.select`; a round that stops early or late
returns other rows), ``weight_gap`` (the largest difference of a
normalised weight from the reference's, times ``n_samples``, the
reference's weights worked out from the returned parameters and the
previous population).

Besides, the reference runs the whole chain alone, each round's mixture
from its own previous population, and ``chain_rows_missed`` counts its
last population's best rows that the program's last population lacks
(:func:`..reference.select.compare`).  The chain is not held row for row:
a weight that rounding moves by a part in a million moves a few of the
next round's component choices, so sound runs miss a few rows there.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..reference import select, smc, streams

#: batches a round runs between its reads of the acceptance count (the
#: port's fused rounds, ``Rejection._run_fused``): a round stops at the
#: first read that finds ``n_samples`` rows within its threshold
CHUNK = 16
#: the most batches the reference runs in one round
MAX_BATCHES = 1 << 12


class Driver:
    def __init__(self, cell, device):
        import elfi_tpu_torch as et
        from elfi_tpu_torch.methods import samplers
        self.et = et
        # the batches of a chunk run again for a proposal's redraw
        self.chunk = samplers._FUSED_CHUNK
        self.device = device
        t = cell.traffic
        self.batch_size, self.n, self.thresholds = (
            t["batch_size"], t["n_samples"], list(t["thresholds"]))
        self.params = cell.config["parameters"]
        model, node = cell.system().build(cell.config, t["graph"])
        self.node = model[node]
        self.dname = node

    def call(self, seed):
        s = self.et.SMC(self.node, batch_size=self.batch_size, seed=seed,
                        device=self.device)
        res = s.sample(self.n, thresholds=self.thresholds, bar=False)
        pops = [{"theta": np.stack([p.outputs[k] for k in self.params], 1),
                 "d": np.asarray(p.outputs[self.dname]),
                 "w": np.asarray(p.weights, np.float64),
                 "n_batches": int(p.meta["n_batches"])}
                for p in res.populations]
        redone = int(s.state.get("redone_chunks", 0))
        return {"sims": int(s.state["n_sim"]),
                "batches": sum(p["n_batches"] for p in pops)
                + self.chunk * redone,
                "pops": pops}

    def release(self):
        self.node = None


def _round_rows(cell, seed, r, start, n_batches, mixture, device, dtype,
                keep):
    """(the best ``keep`` rows within the threshold of round ``r``'s
    batches, how many rows are within it)."""
    t, ref = cell.traffic, cell.reference()
    thr = float(np.float32(t["thresholds"][r]))
    rseed = streams.sub_seed(seed, r) if r else None
    top, accepted = select.TopRows(keep), 0
    for b in range(start, start + n_batches):
        theta = None if mixture is None else mixture.propose(
            streams.proposal_seed(rseed, b), t["batch_size"], ref.inside)
        th, d = ref.simulate(cell.config, t["graph"], seed, b,
                             t["batch_size"], device, dtype, theta=theta)
        ok = d <= thr
        accepted += int(ok.sum())
        top.add(th, torch.where(ok, d, math.inf))
    return top, accepted


def _round(cell, seed, r, start, mixture, device, dtype, keep):
    """Round ``r`` from batch ``start``, :data:`CHUNK` batches at a time
    until ``n_samples`` rows are within its threshold: (its best ``keep``
    rows within the threshold, the batches it ran)."""
    n = cell.traffic["n_samples"]
    top, accepted, nb = select.TopRows(keep), 0, 0
    while accepted < n and nb < MAX_BATCHES:
        part, acc = _round_rows(cell, seed, r, start + nb, CHUNK, mixture,
                                device, dtype, keep)
        top.add(part.theta, part.d)
        accepted += acc
        nb += CHUNK
    return top, nb


def check_run(cell, seed, pops, device):
    """The worst of each number over the rounds of one run whose
    populations are ``pops``."""
    t, ref = cell.traffic, cell.reference()
    n = t["n_samples"]
    if len(pops) != len(t["thresholds"]):
        return {"theta_gap": math.inf}
    worst, start = {}, 0
    with torch.no_grad():
        for r, pop in enumerate(pops):
            mix = smc.Mixture(pops[r - 1]["theta"], pops[r - 1]["w"],
                              device) if r else None
            top, nb = _round(cell, seed, r, start, mix, device,
                             torch.float32, n + select.MARGIN)
            nums = select.compare(pop["theta"], pop["d"], top, n, ref.SCALES)
            wp = np.asarray(pop["w"], np.float64)
            wp = wp / wp.sum()
            wr = smc.weights(pop["theta"], mix, ref.log_prior)
            nums["weight_gap"] = float(np.max(np.abs(wp - wr)) * n)
            for k, v in nums.items():
                v = v if math.isfinite(v) else math.inf
                worst[k] = max(worst.get(k, -math.inf), v)
            start += nb
        # the reference's own chain, each round's mixture from its own
        # population: its last population against the program's
        chain = reference_run(cell, seed, device, torch.float32)[-1]
        last = select.TopRows(n)
        last.add(torch.as_tensor(chain["theta"], device=device),
                 torch.as_tensor(chain["d"], device=device))
        worst["chain_rows_missed"] = select.compare(
            pops[-1]["theta"], pops[-1]["d"], last, n,
            ref.SCALES)["rows_missed"]
    return worst


def check(cell, records, seed, device):
    from .rejection import checked
    return [check_run(cell, records[i].seed, records[i].out["pops"], device)
            for i in checked(records, seed, cell.traffic["check_calls"])]


def reference_run(cell, seed, device, dtype):
    """A whole run of the reference in ``dtype``, each round's mixture from
    its own previous population; its populations as the program returns
    them."""
    t, ref = cell.traffic, cell.reference()
    n, pops, start = t["n_samples"], [], 0
    with torch.no_grad():
        for r in range(len(t["thresholds"])):
            mix = smc.Mixture(pops[-1]["theta"], pops[-1]["w"], device) \
                if r else None
            top, nb = _round(cell, seed, r, start, mix, device, dtype, n)
            theta = top.theta.cpu().numpy()
            pops.append({"theta": theta, "d": top.d.cpu().numpy(),
                         "w": smc.weights(theta, mix, ref.log_prior, dtype),
                         "n_batches": nb})
            start += nb
    return pops


def control(cell, seed, device, dtype=torch.bfloat16):
    """The numbers of the control: the reference in ``dtype`` put in the
    program's place for the run with ``seed``."""
    return check_run(cell, seed, reference_run(cell, seed, device, dtype),
                     device)

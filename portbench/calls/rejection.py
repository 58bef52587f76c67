"""Rejection calls: ``elfi_tpu_torch.Rejection(node, batch_size, seed,
device).sample(n_samples, n_sim=n_sim)`` on the fused path, one sampler a
call, as an ELFI user drives it.

Traffic keys: ``graph`` (the configuration's graph: ``kernel`` or
``plain``), ``batch_size``, ``n_sim``, ``n_samples``, ``check_calls``
(how many of the window's calls the check recomputes, drawn from the
run's seed).

The check recomputes each chosen call with the plain reference, every
simulation of it, batch by batch from the call's seed, keeps its best rows
and compares the returned sample with them (:mod:`..reference.select`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import select


class Driver:
    def __init__(self, cell, device):
        import elfi_tpu_torch as et
        self.et = et
        self.device = device
        t = cell.traffic
        self.batch_size, self.n_sim, self.n = (
            t["batch_size"], t["n_sim"], t["n_samples"])
        self.params = cell.config["parameters"]
        model, node = cell.system().build(cell.config, t["graph"])
        self.node = model[node]
        self.dname = node

    def call(self, seed):
        rej = self.et.Rejection(self.node, batch_size=self.batch_size,
                                seed=seed, device=self.device)
        res = rej.sample(self.n, n_sim=self.n_sim, bar=False)
        theta = np.stack([res.outputs[p] for p in self.params], axis=1)
        return {"sims": int(res.meta["n_sim"]),
                "batches": int(rej.state["n_batches"]),
                "theta": theta, "d": np.asarray(res.outputs[self.dname])}

    def release(self):
        self.node = None


def checked(records, seed, k):
    """The indices of the ``k`` records the check recomputes, drawn from
    the run's seed."""
    rng = np.random.default_rng([int(seed), 0xC4EC])
    k = min(k, len(records))
    return sorted(int(i) for i in rng.choice(len(records), size=k,
                                            replace=False))


def reference_rows(cell, seed, device, dtype=torch.float32, keep=None):
    """The reference's best rows of the call with ``seed``: every batch of
    the call simulated by the configuration's reference."""
    t = cell.traffic
    ref = cell.reference()
    n_batches = -(-t["n_sim"] // t["batch_size"])
    top = select.TopRows(keep or t["n_samples"] + select.MARGIN)
    with torch.no_grad():
        for b in range(n_batches):
            theta, d = ref.simulate(cell.config, t["graph"], seed, b,
                                    t["batch_size"], device, dtype)
            top.add(theta, d)
    return top


def compare_call(cell, seed, theta, d, device):
    ref = reference_rows(cell, seed, device)
    return select.compare(theta, d, ref, cell.traffic["n_samples"],
                          cell.reference().SCALES)


def check(cell, records, seed, device):
    """The numbers of each checked call (a list of dicts)."""
    return [compare_call(cell, records[i].seed, records[i].out["theta"],
                         records[i].out["d"], device)
            for i in checked(records, seed, cell.traffic["check_calls"])]


def control(cell, seed, device, dtype=torch.bfloat16):
    """The numbers of the control: the reference computed in ``dtype``
    put in the program's place for the call with ``seed``."""
    t = cell.traffic
    low = reference_rows(cell, seed, device, dtype, keep=t["n_samples"])
    return compare_call(cell, seed, low.theta, low.d, device)

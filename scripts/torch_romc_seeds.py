#!/usr/bin/env python3
"""ROMC at the JAX bench's g-and-k point over seed triples, in the PyTorch
port (on the card, or the CPU with ``--device cpu``) or in the JAX package
(``--jax``, on the CPU).

    python3 scripts/torch_romc_seeds.py [--triples 12] [--device cpu]
                                        [--jax] [--out FILE]

Runs from the root of a checkout (it puts the checkout on ``sys.path``).
Triple k is the seeds ``(5 + 3k, 6 + 3k, 7 + 3k)``: ``ROMC(seed)``,
``solve_problems(n1=50, seed)``, ``sample(n2=20, seed)``, with
``estimate_regions(eps_filter=compute_eps(0.5))`` between, as
``bench.py:_bench_romc_gnk`` runs triple 0, on ``gnk.get_model(n_obs=50,
seed_obs=1)`` with bounds (0, 10)^4.  For each triple it prints the
weighted posterior means, their errors as shares of the bench's tolerance
(0.3, 0.3, 1.5, 0.15) from the JAX package's rejection ground truth
(3.43, 1.498, 5.205, 0.525; ``BENCH_r05.json``), the threshold and the
wall time on the host clock.  No triple is chosen: every triple is run and
reported.  The last line is a JSON object of the results and their mean
over the triples, also written to ``--out`` if given.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

NAMES = ("A", "B", "g", "k")
GT = np.array([3.43, 1.498, 5.205, 0.525])
TOL = np.array([0.3, 0.3, 1.5, 0.15])


def triple(k):
    return (5 + 3 * k, 6 + 3 * k, 7 + 3 * k)


def run_port(seeds, device):
    import torch
    import elfi_tpu_torch as et
    from elfi_tpu_torch.models import gnk
    if device is not None:
        # the model draws its observed data on the global backend's device
        et.set_client("native", device=device)
    m = gnk.get_model(n_obs=50, seed_obs=1)
    romc = et.ROMC(m["d"], bounds=[(0, 10)] * 4, seed=seeds[0],
                   device=device)
    romc.solve_problems(n1=50, seed=seeds[1])
    eps = romc.compute_eps(0.5)
    romc.estimate_regions(eps_filter=eps)
    res = romc.sample(n2=20, seed=seeds[2])
    if romc.device.type == "cuda":
        torch.cuda.synchronize()
    return res, eps


def run_jax(seeds):
    import jax
    jax.config.update("jax_platforms", "cpu")
    import elfi_tpu as elfi
    from elfi_tpu.models import gnk
    m = gnk.get_model(n_obs=50, seed_obs=1)
    romc = elfi.ROMC(m["d"], bounds=[(0, 10)] * 4, seed=seeds[0])
    romc.solve_problems(n1=50, seed=seeds[1])
    eps = romc.compute_eps(0.5)
    romc.estimate_regions(eps_filter=eps)
    return romc.sample(n2=20, seed=seeds[2]), eps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--triples", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="the port's device (default: the card)")
    ap.add_argument("--jax", action="store_true",
                    help="run the JAX package on the CPU instead")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.jax:
        where = "JAX package, CPU"
    else:
        import torch
        torch.set_num_threads(1)
        if args.device is None and not torch.cuda.is_available():
            raise SystemExit("torch_romc_seeds: no CUDA device (pass "
                             "--device cpu for the CPU)")
        if args.device is None or args.device.startswith("cuda"):
            card = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True,
                text=True).stdout.strip()
            where = f"port, {card}"
        else:
            where = f"port, {args.device}"
    print(f"where: {where}", flush=True)
    rows = []
    for k in range(args.triples):
        seeds = triple(k)
        t0 = time.perf_counter()
        res, eps = run_jax(seeds) if args.jax else run_port(seeds,
                                                            args.device)
        wall = time.perf_counter() - t0
        w = np.asarray(res.weights, np.float64)
        w = w / w.sum()
        means = np.array([float(np.sum(np.asarray(res.samples[n]) * w))
                          for n in NAMES])
        share = np.abs(means - GT) / TOL
        row = dict(seeds=seeds, means=means.tolist(),
                   err_share=share.tolist(), ok=bool(np.all(share < 1)),
                   eps=float(eps), s=wall)
        rows.append(row)
        print(json.dumps(row), flush=True)
    means = np.array([r["means"] for r in rows])
    out = dict(where=where, rows=rows, mean=means.mean(0).tolist(),
               sd=means.std(0, ddof=1).tolist(),
               passed=sum(r["ok"] for r in rows), triples=len(rows))
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(f"mean over {len(rows)} triples {out['mean']}, sd {out['sd']}, "
          f"{out['passed']} pass the bench's gate")
    print(line)


if __name__ == "__main__":
    main()

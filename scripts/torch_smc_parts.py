#!/usr/bin/env python3
"""Time the parts of an SMC run of the PyTorch port on one GPU.

    python3 scripts/torch_smc_parts.py [--reps 10] [--out FILE]

Runs from the root of a checkout (it puts the checkout on ``sys.path``) and
uses only ``elfi_tpu_torch``.  At the JAX bench's gauss2d SMC operating
point (batch 16384, 2000 samples, thresholds 2.0, 1.0, 0.5, 0.3) it runs
the whole SMC once to warm up, then times on the host clock, each call
ended by a device synchronise, the median of ``--reps`` calls of:

- one round-0 rejection run (threshold 2.0), and one round-1 run;
- one proposal batch of round 1 with its prior-support check
  (``SMC.prepare_new_batch``), the mixture draw alone, and the component
  choice and the normals alone;
- the per-batch program of one round-1 batch, proposals given;
- the prior log-density of a batch;
- ``SMC._weigh_population`` of a round-1 population (2000 rows against the
  2000 components of round 0's population);
- the 2000 x 2000 mixture log-density as ``GMDistribution.logpdf`` takes it
  (``solve_lower_rows``: ``L^-1`` once, then a matmul), and the same
  ``L^-1 r`` for its 4M rows by ``torch.linalg.solve_triangular`` with one
  right-hand side per row, the form ``solve_lower_rows`` replaced (timed
  once: it takes seconds), with the largest difference of the two.

It prints the card's name and power limit, one line per part, and a JSON
object of every time in milliseconds as its last line (also written to
``--out`` if given).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

GAUSS_KW = dict(n_obs=50, true_params=[4.0, 2.0], nd_mean=True,
                cov_matrix=np.eye(2))
BATCH = 16384
N_SAMPLES = 2000
THRESHOLDS = [2.0, 1.0, 0.5, 0.3]


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def host_ms(fn, reps):
    """Median host-clock ms of ``fn()``, each call ended by a synchronise,
    after one untimed call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_smc_parts: no CUDA device is available")

    import elfi_tpu_torch as et
    from elfi_tpu_torch.compile.compiler import compile_program
    from elfi_tpu_torch.methods.utils import GMDistribution
    from elfi_tpu_torch.models import gauss
    from elfi_tpu_torch.ops.distributions import solve_lower_rows
    from elfi_tpu_torch.utils.rng import generator

    device = torch.device("cuda", 0)
    print(f"card: {card_line()}", flush=True)
    m = gauss.get_model(**GAUSS_KW)
    node = m["d"]
    ms = {}

    def smc(seed=4):
        return et.SMC(node, batch_size=BATCH, seed=seed, device=device)

    smc().sample(N_SAMPLES, thresholds=THRESHOLDS, bar=False)   # warm-up
    ms["round 0 (threshold 2.0)"] = host_ms(
        lambda: smc().sample(N_SAMPLES, thresholds=THRESHOLDS[:1],
                             bar=False), args.reps)

    # a sampler standing at the start of round 1
    s = smc()
    s.sample(N_SAMPLES, thresholds=THRESHOLDS[:1], bar=False)
    r0 = s._populations[-1]
    ms["round 1 (threshold 1.0)"] = host_ms(
        lambda: smc_round1(smc, r0), args.reps)
    s.sample(N_SAMPLES, thresholds=THRESHOLDS[1:2], bar=False)
    proposal = s._proposal
    ms["proposal batch with support check"] = host_ms(
        lambda: s.prepare_new_batch(7), args.reps)
    ms["mixture draw alone"] = host_ms(
        lambda: GMDistribution._draw(proposal, BATCH,
                                     generator(7, device)), args.reps)

    def choice_and_normals():
        g = generator(7, device)
        torch.multinomial(proposal.weights, BATCH, replacement=True,
                          generator=g)
        torch.randn((BATCH, 2), generator=g, device=device)

    ms["component choice and normals"] = host_ms(choice_and_normals,
                                                 args.reps)
    prog = compile_program(s.model, tuple(s.output_names),
                           override_names=tuple(sorted(s.parameter_names)),
                           device=device)
    fn = prog.traceable(BATCH)
    over = s.prepare_new_batch(7)
    ms["per-batch program"] = host_ms(lambda: fn(s.seed, 7, over), args.reps)
    x = torch.stack([over[p] for p in s.parameter_names], dim=1)
    ms["prior logpdf of a batch"] = host_ms(lambda: s._prior_logpdf(x),
                                            args.reps)

    pop1 = s._populations[-1]
    s.state["round"] = 1
    s._populations = [r0]
    s._spawn_round_rejection(1)
    ms["weigh a population"] = host_ms(
        lambda: s._weigh_population(pop1), args.reps)

    theta = torch.as_tensor(pop1.means, dtype=torch.float32, device=device)
    gm = s._proposal
    ms["mixture logpdf 2000 x 2000"] = host_ms(
        lambda: GMDistribution.logpdf(theta, gm), args.reps)
    r = theta[:, None, :] - gm.means[None, :, :]
    new = solve_lower_rows(gm.L, r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    old = torch.linalg.solve_triangular(
        gm.L, r.reshape(-1, 2).T, upper=False).T.reshape(r.shape)
    torch.cuda.synchronize()
    ms["L^-1 r by solve_triangular (once)"] = (time.perf_counter() - t0) * 1e3
    ms["L^-1 r by solve_lower_rows"] = host_ms(
        lambda: solve_lower_rows(gm.L, r), args.reps)
    diff = float((old - new).abs().max())
    scale = float(old.abs().max())

    for k, v in ms.items():
        print(f"{k}: {v!r} ms", flush=True)
    print(f"solve_triangular against solve_lower_rows on {r.shape[0]} x "
          f"{r.shape[1]} rows: max abs difference {diff!r} (largest value "
          f"{scale!r})", flush=True)
    result = {"card": card_line(), "reps": args.reps, "ms": ms,
              "solve_max_abs_diff": diff, "solve_max_abs": scale}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)


def smc_round1(make, r0):
    """Round 1 (threshold 1.0) of a fresh sampler that starts from the
    round-0 population ``r0``."""
    s = make()
    s._populations = [r0]
    s.schedule.extend(1, thresholds=THRESHOLDS[:1])     # round 0, done
    s.sample(N_SAMPLES, thresholds=THRESHOLDS[1:2], bar=False)


if __name__ == "__main__":
    main()

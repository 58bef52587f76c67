#!/usr/bin/env python3
"""BOLFI of the PyTorch port at the JAX accuracy gate's MA2 point, over
several seeds, on one GPU.

    python3 scripts/torch_bolfi_seeds.py [--seeds 3 4 5 6 7 8] [--out FILE]

Runs from the root of a checkout (it puts the checkout on ``sys.path``) and
uses only ``elfi_tpu_torch``.  For each seed it fits ``BOLFI`` on
``ma2.get_model(seed_obs=271)``'s log-distance with the settings of the
JAX package's ``tests/functional/test_inference.py::test_bolfi_accuracy``
(24 initial points, 120 evidence, ``update_interval=12``, bounds (-2, 2)
and (-1, 1), ``acq_noise_var=0.1``), samples 4 NUTS chains of 1200, and
prints the posterior means, their errors from (0.6, 0.2) and the wall
times on the host clock.  No seed is chosen: every seed given is run and
reported.  The last line is a JSON object of the results, also written to
``--out`` if given.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

TRUE = np.array([0.6, 0.2])
FIT = dict(batch_size=1, initial_evidence=24, update_interval=12,
           bounds={"t1": (-2, 2), "t2": (-1, 1)}, acq_noise_var=0.1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[3, 4, 5, 6, 7, 8])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_bolfi_seeds: no CUDA device")
    import elfi_tpu_torch as et
    from elfi_tpu_torch.models import ma2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    m = ma2.get_model(seed_obs=271)
    et.Operation(torch.log, m["d"], model=m, name="log_d")
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        bolfi = et.BOLFI(m["log_d"], seed=seed, **FIT)
        bolfi.fit(n_evidence=120, bar=False)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = bolfi.sample(1200, n_chains=4, bar=False)
        t2 = time.perf_counter()
        means = res.sample_means_array
        err = np.abs(means - TRUE)
        rows.append(dict(seed=seed, means=means.tolist(), err=err.tolist(),
                         fit_s=t1 - t0, sample_s=t2 - t1,
                         rhat=[float(v) for v in bolfi.rhat.values()]))
        print(f"seed {seed}: means {means.tolist()!r} |err| {err.tolist()!r}"
              f" fit {t1 - t0:.2f} s sample {t2 - t1:.2f} s", flush=True)
    worst = np.array([r["err"] for r in rows]).max(axis=0)
    out = dict(card=card, seeds=rows, worst_err=worst.tolist())
    print(f"worst |err| over seeds {args.seeds}: {worst.tolist()!r}")
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""A/B of the cull kernel (``csrc/topn_cull.cu``) between two trees of the
port on one card: this tree and another (an earlier commit, unpacked with
``git archive`` into a directory that ``.gitignore`` lists).

    git archive <ref> | tar -x -C build/parent
    python3 scripts/torch_cull_ab.py --other build/parent
                                     [--out build/cull_ab.json]

Each arm runs in its own process, in turns (other, this, this, other),
and imports the package of its tree, with its own kernel built into that
tree's ``build/``.  Per arm, at 2**21 rows and n 5000 (``chip_smoke.py``'s
``cull_input``: a full buffer and a batch with a given number of rows
beating its N-th key), at n/16, 4096, 16384 and 32768 candidates:

- the cull's device time with its launches queued ahead
  (``chip_smoke.queued_ms``) and with the host's queueing
  (``chip_smoke.time_ms``), median of 25 CUDA-event timings;
- at n/16, the host's microseconds to queue one merge
  (``chip_smoke.host_us``) and the device time by kernel and the device
  operations a merge from one profile of 20 merges
  (``utils.profiling.recorded``);
- the fused MA2 rejection on the kernel graph at the main path's point
  (2**28 simulations at 2**21, 5000 samples): the best of three walls,
  and the device ms a batch of one profiled run of 32 batches.

Prints each arm's line, then the card's name and power limit; writes all
of it to ``--out``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COUNTS = (("n/16", 5000 // 16), ("4096", 4096), ("16384", 16384),
          ("32768", 32768))
PROFILED = 20
GRAPH_BATCHES = 32


def _smoke():
    """This tree's ``chip_smoke.py`` as a module: its timing helpers (their
    lazy imports take the arm's package, first on ``sys.path``)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def arm(tree):
    """One arm's numbers, in the process of its tree."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch
    import elfi_tpu_torch as et
    from elfi_tpu_torch.models import ma2_kernel
    from elfi_tpu_torch.ops.kernels import ma2, topn
    cs = _smoke()
    assert Path(topn.__file__).resolve().is_relative_to(
        Path(tree).resolve()), topn.__file__
    ma2._lib()
    topn._lib()
    device = torch.device("cuda", 0)
    out = {"tree": str(tree), "queued_ms": {}, "event_ms": {}}
    for label, count in COUNTS:
        bufs, b = cs.cull_input(device, cs.KERNEL_BATCH, count, seed=count)
        assert cs.candidates(bufs, b, math.inf) == count

        def merge():
            return topn.topn_cull(bufs, b, math.inf, "d", 4096)

        out["queued_ms"][label] = cs.queued_ms(merge)
        out["event_ms"][label] = cs.time_ms(merge)
        if label == "n/16":
            out["host_us"] = statistics.median(
                cs.host_us(merge) for _ in range(3))
            _, prof = cs.profiled(lambda: [merge()
                                           for _ in range(PROFILED)])
            events, _ = cs.device_table(prof)
            ops = cs.card_events(events)
            out["by_kernel_ms"] = {
                e.key[:60]: e.self_device_time_total / 1e3 / PROFILED
                for e in ops}
            out["device_ops_per_merge"] = sum(e.count for e in ops) \
                / PROFILED

    node = ma2_kernel.get_model(seed_obs=cs.SEED_OBS)["d"]
    rej = et.Rejection(node, batch_size=cs.KERNEL_BATCH, seed=1,
                       device=device)
    rej.sample(cs.N_SAMPLES, n_sim=2 * cs.KERNEL_BATCH, bar=False)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rej.sample(cs.N_SAMPLES, n_sim=cs.N_SIM, bar=False)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    _, prof = cs.profiled(lambda: rej.sample(
        cs.N_SAMPLES, n_sim=GRAPH_BATCHES * cs.KERNEL_BATCH, bar=False))
    _, device_us = cs.device_table(prof)
    batches = cs.N_SIM // cs.KERNEL_BATCH
    out["graph"] = {
        "wall_ms_per_batch": min(walls) * 1e3 / batches,
        "sims_per_s": cs.N_SIM / min(walls),
        "device_ms_per_batch": device_us / 1e3 / GRAPH_BATCHES}
    out["graph"]["busy_share"] = (out["graph"]["device_ms_per_batch"]
                                  / out["graph"]["wall_ms_per_batch"])
    out["card"] = cs.card_line()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="the other tree's root")
    ap.add_argument("--out", default="build/cull_ab.json")
    ap.add_argument("--arm", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.arm:
        print(json.dumps(arm(args.arm)), flush=True)
        return 0
    if not args.other:
        ap.error("--other is required")
    runs = []
    for tree in (args.other, ROOT, ROOT, args.other):
        proc = subprocess.run([sys.executable, __file__, "--arm", str(tree)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(runs, indent=1))
    print(f"card: {runs[0]['card']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

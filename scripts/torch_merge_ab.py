#!/usr/bin/env python3
"""A/B of the fused rejection loop's merge schedule on the card: the flat
merge against the threshold-culled merge (``ops/topk.py``, the kernel
``csrc/topn_cull.cu``) at each candidate width, each with every merge
unroll (``methods/samplers.py``) that the candidate cap admits.

    python3 scripts/torch_merge_ab.py [--out build/merge_ab.json]
                                      [--reps 3] [--quick] [--device cpu]
    python3 scripts/torch_merge_ab.py --profile [--out build/merge_profiles]

It runs MA2 rejection at the main path's point (2**28 simulations, 5000
samples, ``seed_obs=271``) on the plain graph at batches 2**16, 2**17 and
2**18 and on the kernel graph at 2**20 and 2**21.  Arms: ``flat``, and
``culled`` at ``CULL_SMALL_K`` 1024, 4096, 16384 and the cascade (1024,
4096, 16384), with ``CULL_MIN_BATCH`` 0; each at u in {1, 2, 4, 8, 16}
where u x batch <= 2**21.  Every arm's samples must equal the flat merge's
with no unroll bit for bit, and pass the 0.05 gate.

Walls: the host clock around ``sample``, ended by a synchronise, the best
of ``--reps`` runs taken in turns (all arms, then all arms in reverse
order, ...).  Device ms a batch: one profiled run of the first 64 batches
(32 on the kernel graph) per arm, the kernels' device time summed
(``utils.profiling.recorded``).  Prints a table and the card's name and
power limit; writes everything to ``--out``.

``--profile`` instead profiles the main path's batches, the plain graph at
2**17 (256 batches) and the kernel graph at 2**21 (32 batches), under the
flat merge with no unroll and under the package's settings: device ms a
batch by kernel (the top ten printed, the tables written to ``--out``, a
directory).
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

N_SIM = 2**28
N_SAMPLES = 5000
SEED_OBS = 271
TRUE = np.array([0.6, 0.2])
GATE = 0.05
CAND_CAP = 1 << 21
POINTS = (("plain", 2**16), ("plain", 2**17), ("plain", 2**18),
          ("kernel", 2**20), ("kernel", 2**21))
WIDTHS = (1024, 4096, 16384, (1024, 4096, 16384))
UNROLLS = (1, 2, 4, 8, 16)
PROFILE_BATCHES = {"plain": 64, "kernel": 32}
MAIN_PATH = (("plain", 2**17, 256), ("kernel", 2**21, 32))


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def arms(batch):
    out = []
    for u in UNROLLS:
        if u * batch > CAND_CAP:
            continue
        out.append(("flat", None, u))
        out += [("culled", w, u) for w in WIDTHS]
    return out


def configure(variant, width, u):
    from elfi_tpu_torch.methods import samplers
    from elfi_tpu_torch.ops import topk
    topk.MERGE_VARIANT = variant
    if width is not None:
        topk.CULL_SMALL_K = width
    topk.CULL_MIN_BATCH = 0
    samplers.FUSED_UNROLL = u


def card_events(events):
    """A profile's kernels, copies and memsets, without the profiler's own
    primer kernels."""
    from torch.autograd import DeviceType

    from elfi_tpu_torch.utils.profiling import PRIMER_NAME
    return [e for e in events
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation
            and "spin_kernel" not in e.key and PRIMER_NAME not in e.key]


def device_ms(events):
    """Device ms of a profile's kernels, copies and memsets."""
    return sum(e.self_device_time_total for e in card_events(events)) / 1e3


def profile_main_path(run, out_dir):
    """The main path's batches profiled under the flat merge with no
    unroll and under the package's settings."""
    from elfi_tpu_torch.methods import samplers
    from elfi_tpu_torch.ops import topk
    from elfi_tpu_torch.utils.profiling import recorded
    chosen = (topk.MERGE_VARIANT, topk.CULL_SMALL_K, topk.CULL_MIN_BATCH,
              samplers.FUSED_UNROLL)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rows = []
    for graph, batch, nb in MAIN_PATH:
        for label in ("flat, u = 1", "package settings"):
            if label == "flat, u = 1":
                configure("flat", None, 1)
            else:
                (topk.MERGE_VARIANT, topk.CULL_SMALL_K, topk.CULL_MIN_BATCH,
                 samplers.FUSED_UNROLL) = chosen
            run(graph, batch, 2 * batch)
            with recorded() as prof:
                run(graph, batch, nb * batch)
            events = prof.key_averages()
            top = sorted(card_events(events),
                         key=lambda e: -e.self_device_time_total)[:10]
            row = dict(graph=graph, batch=batch, batches=nb, settings=label,
                       device_ms_per_batch=device_ms(events) / nb,
                       top=[(e.key[:100], e.count / nb,
                             e.self_device_time_total / 1e3 / nb)
                            for e in top])
            rows.append(row)
            name = f"profile_{graph}_{batch}_{label.split(',')[0]}.txt"
            (out_dir / name.replace(" ", "_")).write_text(events.table(
                sort_by="self_device_time_total", row_limit=40))
            print(f"{graph} B={batch} {label}: device "
                  f"{row['device_ms_per_batch']:.4f} ms/batch over {nb} "
                  f"batches; by kernel (launches a batch, ms a batch):",
                  flush=True)
            for key, count, ms in row["top"]:
                print(f"  {ms:.4f} ms  {count:6.2f}x  {key}", flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="the JSON file (default build/merge_ab.json), or "
                    "with --profile the directory (build/merge_profiles)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--quick", action="store_true",
                    help="2**22 simulations and batches up to 2**18, for a "
                    "rehearsal")
    ap.add_argument("--device", default="cuda",
                    help="'cpu' rehearses the arms and checks on the CPU")
    ap.add_argument("--profile", action="store_true",
                    help="profile the main path's batches, flat and under "
                    "the package's settings, and stop")
    args = ap.parse_args(argv)
    if args.out is None:
        args.out = ("build/merge_profiles" if args.profile
                    else "build/merge_ab.json")
    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("torch_merge_ab: needs a CUDA device")
    import elfi_tpu_torch as et
    from elfi_tpu_torch.models import ma2, ma2_kernel
    from elfi_tpu_torch.ops.kernels.topn import topn_cull
    from elfi_tpu_torch.utils.profiling import recorded

    device = torch.device("cuda", 0) if cuda else torch.device("cpu")
    # the models draw their observed data on the global backend's device
    et.set_client("native", device=device)
    n_sim = 2**22 if args.quick else N_SIM
    points = [p for p in POINTS if p[1] <= 2**18] if args.quick else POINTS
    card = card_line() if cuda else "cpu (no device numbers)"

    def sync():
        if cuda:
            torch.cuda.synchronize()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    nodes = {"plain": ma2.get_model(seed_obs=SEED_OBS)["d"],
             "kernel": ma2_kernel.get_model(seed_obs=SEED_OBS)["d"]}

    def run(graph, batch, nsim=n_sim):
        rej = et.Rejection(nodes[graph], batch_size=batch, seed=1,
                           device=device)
        sync()
        t0 = time.perf_counter()
        res = rej.sample(N_SAMPLES, n_sim=nsim, bar=False)
        sync()
        return res, time.perf_counter() - t0

    if args.profile:
        rows = profile_main_path(run, args.out)
        (Path(args.out) / "merge_profiles.json").write_text(json.dumps(
            {"card": card, "rows": rows}, indent=1))
        print(f"card: {card}; tables in {args.out}", flush=True)
        return 0

    results = []
    for graph, batch in points:
        todo = arms(batch)
        configure("flat", None, 1)
        run(graph, batch, 2 * batch)                      # warm-up
        base, _ = run(graph, batch)
        rows = {a: dict(graph=graph, batch=batch, variant=a[0],
                        small_k=a[1], unroll=a[2], walls=[])
                for a in todo}
        for rep in range(args.reps):
            for a in (todo if rep % 2 == 0 else todo[::-1]):
                configure(*a)
                topn_cull.launches = 0
                res, wall = run(graph, batch)
                rows[a]["walls"].append(wall)
                rows[a]["launches"] = topn_cull.launches
                if rep == 0:
                    for k in base.outputs:
                        if not np.array_equal(res.outputs[k],
                                              base.outputs[k]):
                            raise AssertionError(
                                f"{graph} {batch} {a}: {k} differs from "
                                "the flat merge with no unroll")
                    err = np.abs(res.sample_means_array - TRUE)
                    if not np.all(err < GATE):
                        raise AssertionError(f"{graph} {batch} {a}: gate "
                                             f"failed, |err| {err}")
        for a in todo:
            configure(*a)
            nb = PROFILE_BATCHES[graph]
            run(graph, batch, 2 * batch)
            sync()
            with recorded() as prof:
                run(graph, batch, nb * batch)
            row = rows[a]
            row["device_ms_per_batch"] = device_ms(prof.key_averages()) / nb
            row["best_wall_s"] = min(row["walls"])
            row["sims_per_s"] = n_sim / row["best_wall_s"]
            row["wall_ms_per_batch"] = row["best_wall_s"] * 1e3 / (
                n_sim // batch)
            results.append(row)
            print(f"{graph} B={batch} {a[0]:6s} small_k={a[1]!s:20s} "
                  f"u={a[2]:2d}: best {row['best_wall_s']:.4f} s "
                  f"({row['sims_per_s']:.4g} sims/s, "
                  f"{row['wall_ms_per_batch']:.4f} wall ms/batch), device "
                  f"{row['device_ms_per_batch']:.4f} ms/batch, walls "
                  f"{[round(w, 4) for w in row['walls']]}, topn_cull "
                  f"{row['launches']}", flush=True)
    configure("flat", None, None)
    out = {"card": card, "torch": torch.__version__, "n_sim": n_sim,
           "n_samples": N_SAMPLES, "reps": args.reps, "rows": results}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(f"card: {card}; rows written to {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

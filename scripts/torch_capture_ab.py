#!/usr/bin/env python3
"""The captured loops' constants on the card: the chunk of the fused
rejection loop (``methods/samplers.py`` ``_FUSED_CHUNK``: batches a CUDA
graph holds, and batches between two reads of the acceptance count) and
the headroom of the masked redraw rounds that an SMC proposal graph
learns (``_REDRAW_HEADROOM``); the MH steps a BSL graph holds
(``methods/bsl/method.py`` ``_CHAIN_BLOCK``); and the device memory that
kept graphs hold, against the graphs a program keeps (``Replays(cap=8)``
in ``utils/capture.py``).

    python3 scripts/torch_capture_ab.py [--out build/capture_ab.json]
                                        [--reps 3]
                                        [--phases chunk,redraw,bsl,memory]

Chunk: MA2 rejection at the main path's point (5000 samples, 2**28
simulations, ``seed_obs=271``) on the plain graph at 2**17 and the kernel
graph at 2**21, and gauss2d SMC at the JAX bench's point (batch 16384,
2000 samples, thresholds 2, 1, 0.5, 0.3), captured at chunks 16, 32 and
64, and eagerly at 16; each arm a fresh sampler (the program keeps its
graphs, so after the first turn an arm replays), the best of ``--reps``
walls taken in turns; the rejection arms' samples equal to the eager
arm's bit for bit, and SMC's at chunk 16 (a threshold round stops at a
chunk's end, so other chunks give other samples).

Redraw rounds: the eager redraw loop's rounds per proposal batch (a
histogram, and the most a run's batches took) in gauss2d SMC, MA2 SMC
at batch 2000 (quantiles 0.5, 0.2, 0.2) and MA2 SMC at the benchmark's
``ma2-smc`` shapes (batch 10,000, 1,000 samples, thresholds 0.7, 0.2,
0.05, ``seed_obs=271``), over ``--seeds`` seeds each.  Then, at the
``ma2-smc`` shapes, captured runs learning the rounds under headrooms 0
.. 4, each arm on its own model (its own graphs and count), every arm the
same fresh seed a run: the walls of ``--seeds`` runs after a warm-up
run (``--reps`` turns), the count each learned and the chunks run again;
then headrooms 0, 1 and 2 as the benchmark runs the cell, a fresh model a
turn: four warm-up runs, then ``25 * --seeds`` timed runs.
Last, MA2 SMC at batch 2000, whose rounds take several chunks: after a
redone chunk, the round's later chunks running eagerly (the port's
choice) against taking the graph of the raised count, each turn four runs
on a fresh model (so they learn and redo), ``2 * --reps`` turns.

BSL block: the chain at the JAX bench's point (MA2, 500 simulations a
step, 1000 steps, Warton shrinkage 0.3) eagerly and captured in blocks of
16, 32 and 64 steps: ms a step (the best of ``--reps`` walls, in turns,
each a fresh sampler), the chains equal to the eager one bit for bit.

Memory: for MA2 rejection on both graphs, gauss2d SMC and BSL, each on a
fresh model, the device memory the caching allocator holds after the path
ran eagerly, against after it ran captured until a run captured nothing
(both after ``empty_cache``; a graph's private pool stays while the graph
is kept), divided by the graphs kept; the graphs each program keeps
against the cap, and the recordings and captures each run made (a last
[0, 0]: the cap holds every graph the path uses).

Prints the card's name and power limit and writes everything to ``--out``.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import elfi_tpu_torch as et  # noqa: E402
from elfi_tpu_torch.compile.compiler import compile_program  # noqa: E402
from elfi_tpu_torch.methods import samplers  # noqa: E402
from elfi_tpu_torch.methods.bsl import method as bsl_method  # noqa: E402
from elfi_tpu_torch.methods.bsl import standard_likelihood  # noqa: E402
from elfi_tpu_torch.methods.utils import GMDistribution  # noqa: E402
from elfi_tpu_torch.models import gauss, ma2, ma2_kernel  # noqa: E402

N_SAMPLES, N_SIM, SEED_OBS = 5000, 2**28, 271
GAUSS_KW = dict(n_obs=50, true_params=[4.0, 2.0], nd_mean=True,
                cov_matrix=np.eye(2))
GAUSS_THRESHOLDS = [2.0, 1.0, 0.5, 0.3]
BSL_N, BSL_N_SIM_ROUND = 1000, 500
BSL_SAMPLE_KW = dict(sigma_proposals=np.diag([.05, .05]),
                     params0=np.array([[.6, .2]]), burn_in=200, bar=False)


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def arms_in_turns(arms, reps):
    """{arm: (first result, best wall)}: every arm once, then in reverse
    order, ... ``reps`` times."""
    best, first = {}, {}
    order = list(arms)
    for r in range(reps):
        for name in (order if r % 2 == 0 else order[::-1]):
            out, wall = timed(arms[name])
            first.setdefault(name, out)
            best[name] = min(best.get(name, wall), wall)
    return {k: (first[k], best[k]) for k in arms}


def samples_of(res):
    if hasattr(res, "populations"):
        return [p.outputs for p in res.populations]
    return [res.outputs]


def equal(a, b):
    return all(np.array_equal(x[k], y[k]) for x, y in
               zip(samples_of(a), samples_of(b)) for k in x)


def with_settings(fn, chunk=None, headroom=None, captured=True,
                  block=None):
    from elfi_tpu_torch.utils import capture

    def run():
        saved = (samplers._FUSED_CHUNK, samplers._REDRAW_HEADROOM,
                 capture._ENABLED, bsl_method._CHAIN_BLOCK)
        samplers._FUSED_CHUNK = chunk or saved[0]
        samplers._REDRAW_HEADROOM = saved[1] if headroom is None \
            else headroom
        capture._ENABLED = captured
        bsl_method._CHAIN_BLOCK = block or saved[3]
        try:
            return fn()
        finally:
            (samplers._FUSED_CHUNK, samplers._REDRAW_HEADROOM,
             capture._ENABLED, bsl_method._CHAIN_BLOCK) = saved
    return run


def bsl_sampler(m, dev):
    return et.BSL(m, n_sim_round=BSL_N_SIM_ROUND, feature_names=["S1", "S2"],
                  likelihood=standard_likelihood(shrinkage="warton",
                                                 penalty=0.3),
                  seed=4, device=dev)


def bsl_block_phase(dev, reps):
    """ms a BSL step, eagerly and at blocks of 16, 32 and 64 steps."""
    m = ma2.get_model(seed_obs=4)

    def chain():
        return bsl_sampler(m, dev).sample(BSL_N, **BSL_SAMPLE_KW)
    chain()                                            # warm-up
    arms = {"eager": with_settings(chain, captured=False)}
    for b in (16, 32, 64):
        arms[f"captured {b}"] = with_settings(chain, block=b)
    res = arms_in_turns(arms, reps)
    ref = res["eager"][0]
    for arm, (out, _) in res.items():
        assert equal(out, ref), f"bsl {arm}: differs"
    return {arm: wall / BSL_N * 1e3 for arm, (_, wall) in res.items()}


def reserved(dev):
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved(dev)


def memory_phase(dev):
    """Device memory a kept graph holds, and the graphs each path keeps."""
    def replays_of(s, overrides=((),)):
        return [compile_program(s.model, tuple(s.output_names),
                                override_names=ov, device=dev).replays
                for ov in overrides]

    def rejection(mod, batch):
        m = mod.get_model(seed_obs=SEED_OBS)
        keep = []

        def run():
            r = et.Rejection(m["d"], batch_size=batch, seed=1, device=dev)
            keep.append(r)
            return r.sample(N_SAMPLES, n_sim=N_SIM, bar=False)
        return run, lambda: replays_of(keep[-1])

    def smc():
        m = gauss.get_model(**GAUSS_KW)
        keep = []

        def run():
            s = et.SMC(m["d"], batch_size=16384, seed=4, device=dev)
            keep.append(s)
            return s.sample(2000, thresholds=GAUSS_THRESHOLDS, bar=False)

        return run, lambda: replays_of(keep[-1], (
            (), tuple(sorted(keep[-1].parameter_names))))

    def bsl():
        m = ma2.get_model(seed_obs=4)
        keep = []

        def run():
            b = bsl_sampler(m, dev)
            keep.append(b)
            return b.sample(BSL_N, **BSL_SAMPLE_KW)

        # each chain keeps its own graphs
        return run, lambda: [keep[-1]._chain_replays]

    paths = {"ma2 kernel 2**21": rejection(ma2_kernel, 2**21),
             "ma2 plain 2**17": rejection(ma2, 2**17),
             "gauss2d smc": smc(), "bsl": bsl()}
    out = {}
    for name, (run, graphs) in paths.items():
        with_settings(run, captured=False)()
        r0 = reserved(dev)
        # captured runs until one records and captures nothing (a BSL chain
        # keeps its own graphs, so one run); at most 6
        def made():
            return [sum(r.eager for r in graphs()),
                    sum(r.captures for r in graphs())]
        runs, made_by_run = 0, []
        while runs < (1 if name == "bsl" else 6):
            before = made() if runs else [0, 0]
            run()
            runs += 1
            made_by_run.append([a - b for a, b in zip(made(), before)])
            if made_by_run[-1] == [0, 0]:
                break
        r1 = reserved(dev)
        kept = sum(sum(isinstance(e, tuple) for e in r.entries.values())
                   for r in graphs())
        out[name] = dict(
            graphs_kept=kept, cap=max(r.cap for r in graphs()),
            recorded_and_captured_by_run=made_by_run,
            reserved_mib=(r1 - r0) / 2**20,
            mib_per_graph=(r1 - r0) / 2**20 / max(kept, 1))
        print("memory", name, out[name], flush=True)
    return out


def smc_points(dev, plain, g2):
    """{name: (a fresh model's distance node or None for ``plain`` and
    ``g2``, ``run(node, seed)``)} of the redraw phase."""
    def smc(node, batch, n, **kw):
        def run(nd, seed):
            s = et.SMC(nd, batch_size=batch, seed=seed, device=dev)
            return s, s.sample(n, bar=False, **kw)
        return node, run

    return {
        "gauss2d smc": smc(g2, 16384, 2000, thresholds=GAUSS_THRESHOLDS),
        "ma2 smc 2000": smc(plain, 2000, 1000, quantiles=[0.5, 0.2, 0.2]),
        "ma2-smc": smc(None, 10000, 1000, thresholds=[0.7, 0.2, 0.05]),
    }


def learned_rounds(s):
    graphs = compile_program(s.model, tuple(s.output_names),
                             override_names=tuple(sorted(s.parameter_names)),
                             device=s.device).replays
    return max([v for k, v in graphs.memo.items()
                if k[0] == "redraw_rounds"], default=0)


def smc_arms(arms, seeds, reps, cold=False, warm=1):
    """{arm: the walls of ``seeds`` runs, one a turn of ``reps`` in
    turns, with the chunks run again in them and the count learned after
    each}.  ``arms`` maps a name to ``make() -> run(seed) -> sampler``,
    ``make`` building a fresh model (its own graphs and count): made once,
    or with ``cold`` afresh every turn; each made model first runs
    ``warm`` untimed runs.  Every arm runs the same seeds."""
    out = {k: dict(walls_s=[], redone_chunks=[], learned_rounds=[])
           for k in arms}
    made = {}
    order = list(arms)
    for r in range(reps):
        for name in (order if r % 2 == 0 else order[::-1]):
            if cold or name not in made:
                made[name] = arms[name]()
                for i in range(warm):
                    made[name](10**6 + r * warm + i)
            fn = made[name]

            def runs(fn=fn):
                return [fn(r * seeds + i) for i in range(seeds)]
            smcs, wall = timed(runs)
            o = out[name]
            o["walls_s"].append(wall)
            o["redone_chunks"].append(
                sum(s.state.get("redone_chunks", 0) for s in smcs))
            o["learned_rounds"].append(learned_rounds(smcs[-1]))
    return out


def redo_then_graphs(chunk):
    """``_ChunkLoop.chunk`` after which a redone chunk's later chunks take
    the graph of the raised count, where the port runs them eagerly."""
    def run(self, *args, **kwargs):
        redone = self.redone
        out = chunk(self, *args, **kwargs)
        if self.redone > redone:
            self.eager_proposals = False
        return out
    return run


def redraw_phase(dev, plain, g2, reps, seeds):
    """The eager redraw loop's rounds per batch, and warm captured walls
    under each headroom and after-redo choice (module docstring)."""
    points = smc_points(dev, plain, g2)
    real = GMDistribution.rvs_counted.__func__
    taken = []

    def counting(cls, *args):
        out, rounds = real(cls, *args)
        taken.append(rounds)
        return out, rounds

    report = {"redraw_rounds_per_batch": {}, "most_rounds_per_run": {}}
    for name, (node, run) in points.items():
        nd = node or ma2.get_model(seed_obs=SEED_OBS)["d"]
        hist, most = collections.Counter(), []
        GMDistribution.rvs_counted = classmethod(counting)
        try:
            for seed in range(seeds):
                taken.clear()
                with_settings(lambda: run(nd, 1000 + seed),
                              captured=False)()
                hist.update(taken)
                most.append(max(taken, default=0))
        finally:
            GMDistribution.rvs_counted = classmethod(real)
        report["redraw_rounds_per_batch"][name] = dict(sorted(hist.items()))
        report["most_rounds_per_run"][name] = most
        print(name, "redraw rounds per batch:", dict(sorted(hist.items())),
              "most a run:", most, flush=True)

    _, run = points["ma2-smc"]

    def headroom_arm(h):
        def make():
            nd = ma2.get_model(seed_obs=SEED_OBS)["d"]
            return lambda seed: with_settings(lambda: run(nd, seed),
                                              headroom=h)()[0]
        return make
    # a wide range, so the walls resolve what a round costs a run
    arms = {f"headroom {h}": headroom_arm(h) for h in (0, 2, 8, 16)}
    report["headroom_ma2-smc"] = smc_arms(arms, seeds, reps)
    print("ma2-smc headroom", report["headroom_ma2-smc"], flush=True)
    # as the benchmark runs the cell: a fresh process's four warm-up runs,
    # then a window's worth of runs, rises of the count included
    arms = {f"headroom {h}": headroom_arm(h) for h in (0, 1, 2)}
    report["headroom_ma2-smc_window"] = smc_arms(arms, 25 * seeds, reps,
                                                 cold=True, warm=4)
    print("ma2-smc headroom, a window a turn",
          report["headroom_ma2-smc_window"], flush=True)

    _, run = points["ma2 smc 2000"]

    def after_redo_arm(graphed):
        def make():
            nd = ma2.get_model(seed_obs=SEED_OBS)["d"]

            def go(seed):
                chunk = samplers._ChunkLoop.chunk
                if graphed:
                    samplers._ChunkLoop.chunk = redo_then_graphs(chunk)
                try:
                    return run(nd, seed)[0]
                finally:
                    samplers._ChunkLoop.chunk = chunk
            return go
        return make
    # cold: a fresh model a turn, so its first runs learn and redo
    arms = {"later chunks graphed": after_redo_arm(True),
            "later chunks eager": after_redo_arm(False)}
    report["after_redo_ma2_smc_2000"] = smc_arms(arms, 4, 2 * reps,
                                                 cold=True, warm=0)
    print("ma2 smc 2000 after a redo", report["after_redo_ma2_smc_2000"],
          flush=True)
    return report


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/capture_ab.json")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--phases", default="chunk,redraw,bsl,memory")
    ap.add_argument("--seeds", type=int, default=8,
                    help="SMC runs of each redraw measurement")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    report = dict(card=card(), device=torch.cuda.get_device_name(0))
    print(report, flush=True)

    plain = ma2.get_model(seed_obs=SEED_OBS)["d"]
    kern = ma2_kernel.get_model(seed_obs=SEED_OBS)["d"]
    g2 = gauss.get_model(**GAUSS_KW)["d"]
    paths = {
        "ma2 plain 2**17": lambda: et.Rejection(
            plain, batch_size=2**17, seed=1, device=dev).sample(
                N_SAMPLES, n_sim=N_SIM, bar=False),
        "ma2 kernel 2**21": lambda: et.Rejection(
            kern, batch_size=2**21, seed=1, device=dev).sample(
                N_SAMPLES, n_sim=N_SIM, bar=False),
        "gauss2d smc": lambda: et.SMC(
            g2, batch_size=16384, seed=4, device=dev).sample(
                2000, thresholds=GAUSS_THRESHOLDS, bar=False),
    }
    if "bsl" in phases:
        report["bsl_ms_a_step"] = bsl_block_phase(dev, args.reps)
        print("bsl ms a step", report["bsl_ms_a_step"], flush=True)
    if "memory" in phases:
        report["graph_memory"] = memory_phase(dev)
    chunk = {}
    for name, fn in (paths.items() if "chunk" in phases else ()):
        fn()                                           # warm-up
        arms = {"eager 16": with_settings(fn, 16, captured=False)}
        for c in (16, 32, 64):
            arms[f"captured {c}"] = with_settings(fn, c)
        res = arms_in_turns(arms, args.reps)
        ref = res["eager 16"][0]
        # a threshold round stops at a chunk's end, so only rejection with
        # a fixed simulation count gives one sample at every chunk
        same = [a for a in res if a == "captured 16"
                or not name.startswith("gauss2d")]
        for arm in same:
            assert equal(res[arm][0], ref), f"{name} {arm}: differs"
        chunk[name] = {arm: wall for arm, (_, wall) in res.items()}
        print(name, chunk[name], flush=True)
    report["chunk_walls_s"] = chunk

    if "redraw" in phases:
        report.update(redraw_phase(dev, plain, g2, args.reps, args.seeds))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""The captured loops' two constants on the card: the chunk of the fused
rejection loop (``methods/samplers.py`` ``_FUSED_CHUNK``: batches a CUDA
graph holds, and batches between two reads of the acceptance count) and
the masked redraw rounds of an SMC proposal inside a graph
(``_REDRAW_ROUNDS``); the MH steps a BSL graph holds
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

Redraw rounds: the eager redraw loop's rounds per proposal batch in the
gauss2d and MA2 SMC runs (a histogram), then gauss2d and MA2 SMC captured
at 0 .. 4 rounds: walls (best of ``--reps``, in turns) and the chunks run
again eagerly because a batch needed more rounds.

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


def with_settings(fn, chunk=None, rounds=None, captured=True, block=None):
    from elfi_tpu_torch.utils import capture

    def run():
        saved = (samplers._FUSED_CHUNK, samplers._REDRAW_ROUNDS,
                 capture._ENABLED, bsl_method._CHAIN_BLOCK)
        samplers._FUSED_CHUNK = chunk or saved[0]
        samplers._REDRAW_ROUNDS = saved[1] if rounds is None else rounds
        capture._ENABLED = captured
        bsl_method._CHAIN_BLOCK = block or saved[3]
        try:
            return fn()
        finally:
            (samplers._FUSED_CHUNK, samplers._REDRAW_ROUNDS,
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/capture_ab.json")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--phases", default="chunk,redraw,bsl,memory")
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

    # the eager redraw loop's rounds per batch
    rounds_hist = {}
    real = GMDistribution.rvs.__func__

    def counting(cls, means, cov=1, weights=None, size=1, prior_logpdf=None,
                 generator=None):
        calls = []

        def logpdf(x):
            calls.append(1)
            return prior_logpdf(x)
        out = real(cls, means, cov, weights, size,
                   None if prior_logpdf is None else logpdf, generator)
        hist[max(len(calls) - 1, 0)] += 1
        return out

    smc_paths = {
        "gauss2d smc": paths["gauss2d smc"],
        "ma2 smc plain": lambda: et.SMC(
            plain, batch_size=2000, seed=4, device=dev).sample(
                1000, quantiles=[0.5, 0.2, 0.2], bar=False),
    }
    for name, fn in (smc_paths.items() if "redraw" in phases else ()):
        hist = collections.Counter()
        GMDistribution.rvs = classmethod(counting)
        try:
            with_settings(fn, captured=False)()
        finally:
            GMDistribution.rvs = classmethod(real)
        rounds_hist[name] = dict(sorted(hist.items()))
        print(name, "redraw rounds per batch:", rounds_hist[name],
              flush=True)
    report["redraw_rounds_per_batch"] = rounds_hist

    redraw = {}
    for name, fn in (smc_paths.items() if "redraw" in phases else ()):
        redone = {}

        def arm(k, fn=fn):
            def run():
                smc_fn = with_settings(fn, rounds=k)
                res = smc_fn()
                return res
            return run
        arms = {f"rounds {k}": arm(k) for k in range(5)}
        res = arms_in_turns(arms, args.reps)
        ref = res["rounds 0"][0]
        for a, (out, wall) in res.items():
            assert equal(out, ref), f"{name} {a}: differs"
        redraw[name] = {a: wall for a, (_, wall) in res.items()}
        for k in range(5):
            smc = et.SMC(g2 if name == "gauss2d smc" else plain,
                         batch_size=16384 if name == "gauss2d smc" else 2000,
                         seed=4, device=dev)
            with_settings(lambda: smc.sample(
                2000, thresholds=GAUSS_THRESHOLDS, bar=False)
                if name == "gauss2d smc" else smc.sample(
                    1000, quantiles=[0.5, 0.2, 0.2], bar=False),
                rounds=k)()
            redone[k] = smc.state.get("redone_chunks", 0)
        redraw[name]["redone_chunks"] = redone
        print(name, redraw[name], flush=True)
    report["redraw_walls_s"] = redraw
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()

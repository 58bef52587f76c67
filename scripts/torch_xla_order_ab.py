#!/usr/bin/env python3
"""XLA's CPU arithmetic in the port on the card: is it exact there, and
what does it cost where the observed data do not need it?

    python3 scripts/torch_xla_order_ab.py [--out build/xla_order_ab.json]
        [--phases sums,daycare_observed,daycare_step,ricker_step,zoo]
        [--roots PARENT,CHANGE] [--reps 3]

sums: ``utils/xla_math.running_sum`` (torch's ``cumsum`` along a dimension
that is not the innermost one) on CUDA against numpy's float32 accumulate
on the same data, and ``reduce_sum`` and ``cumsum`` on CUDA against the
CPU, at daycare's shapes and a single column: the count of values that
differ (0 is bit for bit).

daycare_observed: ``daycare.observed_data`` at 29 x 53 x 33 for seeds 0
and 7 on the card and the CPU, equal to each other and, at seed 0, to the
JAX package's array in ``models/data/daycare_observed.npz``; the walls.

daycare_step: the simulator's event step at the zoo phase's batch (2048
members, 29 x 53 x 33) with torch's sums and with XLA's order
(``daycare_from_noise(xla_order=...)``): device ms a step over 64 steps
(CUDA events), in turns off, on, on, off, ``--reps`` times.

ricker_step: the stochastic Ricker recursion at 2**16 members, 50 steps,
with ``torch.exp`` and a fused-free update (the simulator) and with XLA's
``exp`` and fused multiply-add (``xla_math``, the observed series' code):
device ms a call, in turns.

zoo: ``chip_smoke.phase_zoo`` run in a fresh process from each of
``--roots`` (two checkouts, the parent's and the change's), in turns
parent, change, change, parent: the per-model seconds (``get_model``
included), rejection walls and device ms a batch, read from each run's
log lines.

Prints the card's name and power limit and writes everything to ``--out``.
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

from elfi_tpu_torch.utils import xla_math  # noqa: E402


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def phase_sums():
    g = torch.Generator().manual_seed(5)
    out = {}
    for shape, dim in [((459, 116), 0), ((29, 4, 459), 2),
                       ((2, 29, 33, 27), 3), ((29, 110, 16), 2),
                       ((1749,), 0), ((1, 1749), 1)]:
        x = torch.rand(shape, generator=g) * 0.37
        want = np.add.accumulate(x.numpy(), axis=dim)
        got = xla_math.running_sum(x.cuda(), dim).cpu().numpy()
        out[f"running_sum {shape} dim {dim}"] = int(np.sum(got != want))
    h = torch.rand((3, 29, 53, 33), generator=g)
    for name, fn in [("reduce_sum (2, 3)",
                      lambda t: xla_math.reduce_sum(t, (2, 3))),
                     ("reduce_sum (3,) of the transpose",
                      lambda t: xla_math.reduce_sum(t.transpose(2, 3),
                                                    (3,))),
                     ("cumsum", lambda t: xla_math.cumsum(
                         t.reshape(3, 29, -1)))]:
        got = fn(h.cuda()).cpu().numpy()
        out[f"{name} card vs CPU"] = int(np.sum(got != fn(h).numpy()))
    return out


def phase_daycare_observed():
    from elfi_tpu_torch.models import daycare
    from elfi_tpu_torch.models._observed import load_observed_setting
    out = {}
    for seed in (0, 7):
        walls = {}
        arrays = {}
        for dev in ("cuda", "cpu"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            arrays[dev] = daycare.observed_data.__wrapped__(
                seed_obs=seed, device=torch.device(dev))
            torch.cuda.synchronize()
            walls[dev] = time.perf_counter() - t0
        r = dict(walls_s=walls, steps=daycare.last_run["steps"],
                 card_vs_cpu_differ=int(np.sum(arrays["cuda"]
                                               != arrays["cpu"])))
        if seed == 0:
            want = load_observed_setting(
                daycare._DATA, true_params=[3.6, 0.6, 0.1], n_dcc=29,
                n_ind=53, n_strains=33, n_obs=36, time_end=10.,
                seed_obs=None)
            r["card_vs_jax_differ"] = int(np.sum(arrays["cuda"] != want))
        out[f"seed {seed}"] = r
    return out


def _events(fn, reps):
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return times


def phase_daycare_step(reps):
    from elfi_tpu_torch.models import daycare
    batch, steps = 2048, 64
    g = torch.Generator(device="cuda").manual_seed(3)
    t = [torch.rand(batch, device="cuda", generator=g) * hi
         for hi in (11., 2., 1.)]
    E = torch.empty((steps, batch, 29), device="cuda").exponential_(
        generator=g)
    U = torch.rand((steps, batch, 29), device="cuda", generator=g)

    def run(xla_order):
        keep = daycare._MAX_EVENTS
        daycare._MAX_EVENTS = steps
        try:
            return daycare.daycare_from_noise(
                *t, lambda s, k: (E[s:s + k], U[s:s + k]),
                time_end=1e9, check_every=steps, xla_order=xla_order)
        finally:
            daycare._MAX_EVENTS = keep

    run(False), run(True)
    torch.cuda.synchronize()
    out = {"off": [], "on": []}
    for _ in range(reps):
        for arm in ("off", "on", "on", "off"):
            out[arm] += [ms / steps for ms in
                         _events(lambda: run(arm == "on"), 1)]
    out = {k: {"ms_per_step": v, "best": min(v)} for k, v in out.items()}
    out["batch"], out["steps"] = batch, steps
    return out


def phase_ricker_step(reps):
    batch, n_obs = 2**16, 50
    g = torch.Generator(device="cuda").manual_seed(4)
    log_rate = torch.full((batch,), 3.8, device="cuda")
    std = torch.full((batch,), 0.3, device="cuda")
    Z = torch.randn((n_obs, batch), device="cuda", generator=g)

    def torch_arith():
        stock = torch.ones(batch, device="cuda")
        for i in range(n_obs):
            stock = stock * torch.exp(log_rate - stock + std * Z[i])
        return stock

    def xla_arith():
        stock = torch.ones(batch, device="cuda")
        for i in range(n_obs):
            stock = stock * xla_math.exp(xla_math.fma(std, Z[i],
                                                      log_rate - stock))
        return stock

    torch_arith(), xla_arith()
    out = {"torch": [], "xla": []}
    for _ in range(reps):
        for arm in ("torch", "xla", "xla", "torch"):
            out[arm] += _events(torch_arith if arm == "torch"
                                else xla_arith, 1)
    out = {k: {"ms_per_call": v, "best": min(v)} for k, v in out.items()}
    out["batch"], out["n_obs"] = batch, n_obs
    return out


_ZOO_CODE = ("import torch, chip_smoke; "
             "chip_smoke.phase_zoo(torch.device('cuda', 0))")


def phase_zoo(roots):
    runs = []
    for label, root in [("parent", roots[0]), ("change", roots[1]),
                        ("change", roots[1]), ("parent", roots[0])]:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", _ZOO_CODE], cwd=root,
                              capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        models = {}
        for line in (proc.stdout + proc.stderr).splitlines():
            if line.startswith("zoo ") and ": {" in line:
                name, _, rest = line[4:].partition(": ")
                d = json.loads(rest)
                models[name] = {k: d.get(k) for k in (
                    "seconds", "wall_s", "batch_wall_ms", "batch_device_ms",
                    "steps", "batch", "step_profile")}
        runs.append(dict(arm=label, rc=proc.returncode, wall_s=wall,
                         models=models,
                         tail=(proc.stdout + proc.stderr)[-2000:]
                         if proc.returncode else ""))
        print(f"zoo {label}: rc {proc.returncode}, {wall:.1f} s, "
              + ", ".join(f"{n} {m['seconds']:.2f} s"
                          for n, m in models.items()), flush=True)
    return runs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/xla_order_ab.json")
    ap.add_argument("--phases",
                    default="sums,daycare_observed,daycare_step,ricker_step")
    ap.add_argument("--roots", default="")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_xla_order_ab: needs a CUDA device")
    out = {"card": card()}
    print(f"card: {out['card']}", flush=True)
    for phase in args.phases.split(","):
        t0 = time.perf_counter()
        if phase == "sums":
            out[phase] = phase_sums()
        elif phase == "daycare_observed":
            out[phase] = phase_daycare_observed()
        elif phase == "daycare_step":
            out[phase] = phase_daycare_step(args.reps)
        elif phase == "ricker_step":
            out[phase] = phase_ricker_step(args.reps)
        elif phase == "zoo":
            out[phase] = phase_zoo(args.roots.split(","))
        else:
            raise SystemExit(f"unknown phase {phase}")
        if phase != "zoo":
            print(f"{phase}: {json.dumps(out[phase])}", flush=True)
        print(f"{phase}: {time.perf_counter() - t0:.1f} s", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()

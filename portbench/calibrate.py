"""Readings behind a cell's limits, in one process on the card: the
numbers that decide ``correct`` for the program on ``--seeds`` seeds (one
call each, at the cell's own size, through the timed path), and for the
control, the reference computed in bfloat16 put in the program's place,
on ``--controls`` seeds.

    python3 portbench/calibrate.py --workload <cell> --seeds 12 \
        --controls 3 --out build/calibrate-<cell>.json

A limit lies above the program's largest reading and below the control's
smallest (``PERF.md`` gives both and the limit).  The benchmark's own runs
do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=2**31 + 101)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    here = Path(__file__).resolve().parent
    sys.path[:] = [str(ROOT)] + [q for q in sys.path
                                 if q and Path(q).resolve() != here]
    import torch
    from portbench.harness.cells import Benchmark
    from portbench.harness.runner import call_seed
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    cell = Benchmark(ROOT).cell(args.workload)
    kind = cell.driver()
    seeds = [call_seed(args.first_seed, i) for i in range(args.seeds)]
    program, control = [], []
    driver = kind.Driver(cell, "cuda")
    driver.call(call_seed(args.first_seed, 1 << 30))   # warm-up
    outs = {}
    for s in seeds:
        out = driver.call(s)
        outs[s] = out
    driver.release()
    for s in seeds:
        from portbench.harness.runner import Record
        out = dict(outs[s])
        rec = Record(s, 0.0, 0.0, out.pop("sims"), out.pop("batches"), out)
        t0 = time.perf_counter()
        nums = kind.check(cell, [rec], 0, "cuda")[0]
        program.append({"seed": s, "check_s": time.perf_counter() - t0,
                        **nums})
        print("program", json.dumps(program[-1]), flush=True)
    for s in seeds[:args.controls]:
        t0 = time.perf_counter()
        nums = kind.control(cell, s, "cuda")
        control.append({"seed": s, "seconds": time.perf_counter() - t0,
                        **nums})
        print("control", json.dumps(control[-1]), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(
        {"workload": args.workload, "program": program, "control": control,
         "card": torch.cuda.get_device_name()}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

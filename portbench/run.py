"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks
for.  The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the check compared, with
its limit, which also end standard error.  Without the cards, or with
JAX or the JAX package loaded once the window has closed, it prints no
result and exits with another code than 0.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: the compiled bytecode of every module a run imports, at a fixed path
#: inside the checkout: a machine whose environment forbids writing it
#: (``PYTHONDONTWRITEBYTECODE``) would otherwise compile torch's sources
#: again in every run's set-up
PYCACHE = ROOT / "build" / "portbench" / "pycache"
#: top-level modules that nothing the benchmark runs may load
BANNED = ("jax", "jaxlib", "flax", "elfi_tpu")
#: the build and kernel caches, at fixed paths inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda"}
#: one thread in each of the host's thread pools: the host's share of a
#: run then does not contend with pools of idle threads for the cores
THREADS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def banned_modules():
    """The banned top-level names among ``sys.modules``, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    sys.dont_write_bytecode = False
    sys.pycache_prefix = str(PYCACHE)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "portbench" / sub)
    for var in THREADS:
        os.environ[var] = "1"
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [str(ROOT)] + [p for p in sys.path
                                 if p and Path(p).resolve() != Path(here)]
    from portbench.harness.cells import Benchmark
    cell = Benchmark(ROOT).cell(args.workload)

    import torch
    print(f"set-up: import torch {time.perf_counter() - T0!r} s",
          file=sys.stderr)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    from portbench.harness.card import describe
    from portbench.harness.runner import run_cell
    line, checks = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            "cuda", T0)
    print(f"card: {describe()}", file=sys.stderr)
    found = banned_modules()
    if found:
        print(f"portbench: loaded {found}, which the port must not use",
              file=sys.stderr)
        return 3
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Cluster worker entry point: ``python -m elfi_tpu_torch.worker
HOST:PORT/AUTHKEY`` (counterpart of :mod:`elfi_tpu.worker`).

Attach this process, from any machine that reaches the master, to a
running :class:`~elfi_tpu_torch.parallel.cluster.ClusterBackend`; start
and stop workers at any time, and the master reassigns work.  A worker
computes on its CPU, by the cluster's design: CUDA is hidden from it
before torch could initialise it, since a card is not shared between
processes.  ``ELFI_TPU_WORKER_PROGRAM_CACHE`` (the JAX package's name, so
one deployment drives either package) bounds the programs it keeps.
"""

import os
import sys


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1 or ":" not in argv[0]:
        print("usage: python -m elfi_tpu_torch.worker HOST:PORT/AUTHKEY",
              file=sys.stderr)
        return 2
    from elfi_tpu_torch.parallel.backends import _cpu_worker_init
    from elfi_tpu_torch.parallel.cluster import worker_main
    _cpu_worker_init()
    cache = int(os.environ.get("ELFI_TPU_WORKER_PROGRAM_CACHE", "32"))
    worker_main(argv[0], program_cache_size=cache)
    return 0


if __name__ == "__main__":
    sys.exit(main())

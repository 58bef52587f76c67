"""Times four ways of copying a pooled batch (t1, t2, d: 3 x 2**21
float32, 24 MiB) off the card into numpy arrays a pool can own, 20 batches
each, all four twice in turn:

- ``pageable``: ``tensor.to("cpu", copy=True).numpy()``, what
  ``store.OutputPool.add_batch`` does;
- ``staged``: one reused pinned buffer per tensor, then ``.copy()`` into a
  fresh numpy array;
- ``staged_empty``: the same into ``np.empty`` arrays;
- ``fresh_pinned``: a new pinned tensor per batch, kept (its numpy view).

    python3 scripts/torch_pool_copy_ab.py      # on a machine with a card
"""
import statistics
import subprocess
import time

import numpy as np
import torch

dev = torch.device("cuda", 0)
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip())
xs = [torch.randn(2**21, device=dev) for _ in range(3)]
stage = [torch.empty(2**21, pin_memory=True) for _ in range(3)]


def pageable():
    return [x.detach().to("cpu", copy=True).numpy() for x in xs]


def staged():
    for s, x in zip(stage, xs):
        s.copy_(x, non_blocking=True)
    torch.cuda.current_stream().synchronize()
    return [s.numpy().copy() for s in stage]


def staged_empty():
    for s, x in zip(stage, xs):
        s.copy_(x, non_blocking=True)
    torch.cuda.current_stream().synchronize()
    outs = [np.empty(2**21, np.float32) for _ in xs]
    for o, s in zip(outs, stage):
        np.copyto(o, s.numpy())
    return outs


def fresh_pinned():
    outs = [torch.empty(2**21, pin_memory=True) for _ in xs]
    for o, x in zip(outs, xs):
        o.copy_(x, non_blocking=True)
    torch.cuda.current_stream().synchronize()
    return [o.numpy() for o in outs]


for name, fn in (("pageable", pageable), ("staged", staged),
                 ("staged_empty", staged_empty),
                 ("fresh_pinned", fresh_pinned)) * 2:
    keep = []
    ts = []
    for i in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        keep.append(fn())
        ts.append(time.perf_counter() - t0)
    assert all(np.array_equal(a, x.cpu().numpy()) for a, x in zip(keep[-1], xs))
    print(f"{name}: median {statistics.median(ts) * 1e3:.3f} ms, min "
          f"{min(ts) * 1e3:.3f} ms a batch of 25165824 bytes", flush=True)

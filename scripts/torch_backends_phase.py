"""Run ``chip_smoke.py``'s backends phase alone on the card: build K1 and K2,
call ``phase_backends`` on cuda:0 (gates (a)-(d), the same checks as in the
whole smoke) and print what it measured as one JSON line.
About a minute; the quickest check of the device list, the pool, the
cluster and the multihost job after a change to one of them.

    python3 scripts/torch_backends_phase.py
"""

import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_backends_phase: no CUDA device is available")
    from elfi_tpu_torch.ops.kernels import gnk as k2
    from elfi_tpu_torch.ops.kernels import ma2 as k1
    cs.log(f"card: {cs.card_line()}; torch {torch.__version__}")
    with ThreadPoolExecutor(max_workers=2) as pool:
        for built in [pool.submit(k._lib) for k in (k1, k2)]:
            built.result()
    t0 = time.perf_counter()
    out = cs.phase_backends(torch.device("cuda", 0))
    print(json.dumps(out))
    print(f"backends phase ok in {time.perf_counter() - t0!r} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())

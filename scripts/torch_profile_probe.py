"""Probes ``torch.profiler`` through the whole of ``chip_smoke.py``: after
every phase (and before the first) it profiles 50 elementwise kernels, once
with the kernels at the start of the window and once after a 0.5 s sleep
inside it, and prints one ``PROBE`` line each: the process's age, the
kernels the profile holds (``key_averages`` and the exported Chrome trace),
the host launches, and the least and greatest offset of a kept kernel's
start from its launch (matched by correlation id).  A kernel stamped
before its launch shows the card's and the host's clocks disagreeing.

    python3 scripts/torch_profile_probe.py     # on a machine with a card

The smoke's own output follows as it runs; each probe writes
``build/profiles/probe_trace.json``.
"""
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

T0 = time.perf_counter()


def probe(tag):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(1 << 16, device="cuda")
    torch.cuda.synchronize()
    for pad in (0.0, 0.5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            if pad:
                time.sleep(pad)
            y = x
            for _ in range(50):
                y = y + 1
            torch.cuda.synchronize()
        ka = sum(e.count for e in p.key_averages()
                 if e.device_type == DeviceType.CUDA)
        path = cs.OUT_DIR / "probe_trace.json"
        p.export_chrome_trace(str(path))
        with open(path) as f:
            ev = json.load(f)["traceEvents"]
        kernels = [e for e in ev if e.get("cat") == "kernel"]
        launches = [e for e in ev if e.get("cat") == "cuda_runtime"
                    and "LaunchKernel" in e.get("name", "")]
        corr = {e["args"].get("correlation"): e["ts"] for e in launches
                if "args" in e}
        d = [k["ts"] - corr[k["args"]["correlation"]] for k in kernels
             if k.get("args", {}).get("correlation") in corr]
        ts_all = [e["ts"] for e in ev if "ts" in e and e.get("ph") == "X"]
        print(f"PROBE {tag} pad={pad} age={time.perf_counter() - T0:.1f}s "
              f"key_avg_kernels={ka} trace_kernels={len(kernels)} "
              f"launches={len(launches)} "
              f"kernel-launch us min={min(d) if d else None} "
              f"max={max(d) if d else None} "
              f"span={max(ts_all) - min(ts_all) if ts_all else None}",
              flush=True)


def main():
    for name in list(vars(cs)):
        if name.startswith("phase_"):
            def wrapped(*a, _fn=getattr(cs, name), _name=name, **k):
                out = _fn(*a, **k)
                probe(_name)
                return out
            setattr(cs, name, wrapped)
    cs.OUT_DIR.mkdir(parents=True, exist_ok=True)
    probe("start")
    rc = cs.main()
    probe("end")
    print("main rc", rc, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())

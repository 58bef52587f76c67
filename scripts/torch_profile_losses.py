"""Runs the whole of ``chip_smoke.py`` with each profile's completeness
check reporting instead of failing, and every other check printing
``CHECKFAIL`` instead of raising, so that one run shows every profile.
For each profile it prints a ``LOSTCHECK`` line (the process's age, the
host launches, the device records, the launches whose device record is
missing, the window's length) and, for up to ten lost launches, a
``LOST`` line: the call, its correlation id, its start in the window, its
host duration and the host events around it.  A launch made while a
stream was captured into a CUDA graph counts as captured, not lost.

    python3 scripts/torch_profile_losses.py    # on a machine with a card
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

T0 = time.perf_counter()


def report(events, what):
    from torch.autograd import DeviceType
    executed = set(cs.executed_launches(events))
    launches = [e for e in events if e.name() in cs.LAUNCH_CALLS]
    dev = [e for e in events if e.device_type() == DeviceType.CUDA]
    on_device = {e.correlation_id() for e in dev}
    lost = [e for e in launches if e.correlation_id() not in on_device
            and e.correlation_id() in executed]
    starts = [e.start_ns() for e in events]
    t0, t1 = min(starts), max(e.start_ns() + e.duration_ns() for e in events)
    print(f"LOSTCHECK age={time.perf_counter() - T0:.1f}s launches="
          f"{len(launches)} captured={len(launches) - len(executed)} "
          f"device={len(dev)} lost={len(lost)} "
          f"window_ms={(t1 - t0) / 1e6:.1f}", flush=True)
    hosts = sorted((e for e in events if e.device_type() != DeviceType.CUDA),
                   key=lambda e: e.start_ns())
    for e in lost[:10]:
        i = next(k for k, h in enumerate(hosts) if h is e or (
            h.correlation_id() == e.correlation_id() and h.name() == e.name()))
        ctx = [h.name()[:60] for h in hosts[max(0, i - 6):i + 3]]
        print(f"  LOST {e.name()} corr={e.correlation_id()} "
              f"at={(e.start_ns() - t0) / 1e6:.3f}ms dur_us="
              f"{e.duration_ns() / 1e3:.1f} ctx={ctx}", flush=True)
    if not lost:
        return
    # the kinds of device record the profile kept
    names = {}
    for d in dev:
        names[d.name()[:50]] = names.get(d.name()[:50], 0) + 1
    print("  DEVICE kinds:", sorted(names.items(), key=lambda x: -x[1])[:12],
          flush=True)


def soft_check(cond, msg):
    if not cond:
        print("CHECKFAIL", msg, flush=True)


def main():
    cs.check_complete = report
    cs.check = soft_check
    rc = cs.main()
    print("main rc", rc, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())

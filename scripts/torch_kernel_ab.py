"""K1 and K2 of the PyTorch port against an earlier version of their
sources, on one card and in turns.

    git show <ref>:elfi_tpu_torch/csrc/ma2_distance.cu > build/parent_csrc/...
    (the same for gnk_distance.cu, philox.cuh and sort_network.cuh), then
    on the card:
    python scripts/torch_kernel_ab.py [--quick] [--out build/kernel_ab/ab.json]

It builds both versions with the package's nvcc flags (one nvcc each, in
parallel), prints ptxas -v for every instance, counts each kernel's SASS
instructions by class (cuobjdump -sass; the loops found from backward
branches), holds the current kernels against their plain versions on
injected noise, compares the kernels' own streams, and times old, new, new,
old at 2^21 simulations (CUDA events, median), with the SM clock sampled
by nvidia-smi.  A variant of K2 with __expf and __fdividef in its
transform is timed and checked beside it.  The earlier sources must keep
the C entry points of the current ones.
"""

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
from collections import Counter
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]   # the repository
sys.path.insert(0, str(ROOT))

from elfi_tpu_torch.ops.kernels import _build  # noqa: E402
from elfi_tpu_torch.ops.kernels.gnk import gnk_distance_reference  # noqa
from elfi_tpu_torch.ops.kernels.ma2 import ma2_distance_reference  # noqa

AB = ROOT / "build" / "ab"
OLD = ROOT / "build" / "parent_csrc"
NEW = ROOT / "elfi_tpu_torch" / "csrc"
OUT = ROOT / "build" / "kernel_ab"
P = ctypes.c_void_p
B = 2**21


def card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def nvcc():
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def stage(tag, src_dir, files, edit=None):
    d = AB / tag
    d.mkdir(parents=True, exist_ok=True)
    for f in files:
        text = (src_dir / f).read_text()
        if edit and f == files[0]:
            text = edit(text)
        (d / f).write_text(text)
    return d


def build_all(specs):
    procs = {}
    for tag, (d, cu) in specs.items():
        so = AB / f"lib{tag}.so"
        cmd = [nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(d / cu)]
        procs[tag] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      so)
    libs, logs = {}, {}
    for tag, (p, so) in procs.items():
        out, _ = p.communicate()
        logs[tag] = out
        if p.returncode != 0:
            print(f"BUILD FAILED {tag}:\n{out}", flush=True)
            continue
        libs[tag] = so
    return libs, logs


def bind(so):
    lib = ctypes.CDLL(str(so))
    if hasattr(lib, "elfi_ma2_distance"):
        lib.elfi_ma2_distance.argtypes = [P, P, P, P, ctypes.c_longlong,
                                          ctypes.c_int, ctypes.c_ulonglong,
                                          ctypes.c_int, P]
        lib.elfi_ma2_distance_noise.argtypes = [P, P, P, P, P,
                                                ctypes.c_longlong,
                                                ctypes.c_int, ctypes.c_int, P]
    if hasattr(lib, "elfi_gnk_distance"):
        lib.elfi_gnk_distance.argtypes = [P, P, P, P, P, P, ctypes.c_longlong,
                                          ctypes.c_int, ctypes.c_float,
                                          ctypes.c_ulonglong, ctypes.c_int, P]
        lib.elfi_gnk_distance_noise.argtypes = [P, P, P, P, P, P, P,
                                                ctypes.c_longlong,
                                                ctypes.c_int, ctypes.c_float,
                                                ctypes.c_int, P]
    return lib


def stream():
    return torch.cuda.current_stream().cuda_stream


def time_ms(fn, warmup=3, reps=25):
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


CLASSES = [
    ("xu", re.compile(r"^(MUFU|F2F|I2F|F2I|FRND)")),
    ("fp64", re.compile(r"^D(ADD|MUL|FMA|SETP|MNMX)")),
    ("mem", re.compile(r"^(LDG|STG|LDS|STS|LDC|LD|ST|LDL|STL|ATOM|RED)")),
    ("uniform", re.compile(r"^U")),
    ("control", re.compile(r"^(BRA|EXIT|BSSY|BSYNC|CALL|RET|NOP|BAR|WARPSYNC"
                           r"|BREAK|BPT|YIELD|JMP|S2R|S2UR|CS2R|VOTE|PLOP3)")),
    ("minmax", re.compile(r"^(FMNMX|IMNMX)")),
    ("int", re.compile(r"^(IMAD|IADD|LOP|SHF|LEA|ISETP|SEL|PRMT|IABS|MOV"
                       r"|POPC|FLO|BMSK|SGXT)")),
    ("fp32", re.compile(r"^(FADD|FMUL|FFMA|FSETP|FSEL|FCHK|FSWZ|FSET)")),
]


def klass(op):
    for name, rx in CLASSES:
        if rx.match(op):
            return name
    return "other"


def sass(so):
    """{function: {"total", "classes", "ops", "loops": [...]}} from
    cuobjdump -sass."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            funcs[cur] = []
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m and cur:
            addr = int(m.group(1), 16)
            ins = m.group(2).strip()
            ins = re.sub(r"^@!?U?P[T0-9]\s+", "", ins)
            op = ins.split()[0]
            funcs[cur].append((addr, op, ins))
    out = {}
    for f, ins in funcs.items():
        ins = [i for i in ins if i[1] != "NOP"]
        ops = Counter(op.split(".")[0] for _, op, _ in ins)
        cls = Counter(klass(op) for _, op, _ in ins)
        loops = []
        for addr, op, full in ins:
            if op.startswith("BRA"):
                m = re.search(r"0x([0-9a-f]+)", full)
                if m and int(m.group(1), 16) < addr:
                    lo = int(m.group(1), 16)
                    body = [i for i in ins if lo <= i[0] <= addr]
                    loops.append({
                        "from": lo, "to": addr, "count": len(body),
                        "classes": dict(Counter(klass(o) for _, o, _ in body)),
                        "ops": dict(Counter(o.split(".")[0]
                                            for _, o, _ in body))})
        out[f] = {"total": len(ins), "classes": dict(cls), "ops": dict(ops),
                  "loops": loops}
    return out, text


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default=str(OUT / "ab.json"))
    args = ap.parse_args()
    OUT.mkdir(parents=True, exist_ok=True)
    reps = 10 if args.quick else 25
    res = {"card": card(), "torch": torch.__version__,
           "cuda": torch.version.cuda}
    print("card:", res["card"], flush=True)

    ma2_files = ["ma2_distance.cu", "philox.cuh"]
    gnk_files = ["gnk_distance.cu", "philox.cuh"]
    specs = {
        "k1_old": (stage("k1_old", OLD, ma2_files), "ma2_distance.cu"),
        "k1_new": (stage("k1_new", NEW, ma2_files), "ma2_distance.cu"),
        "k2_old": (stage("k2_old", OLD, gnk_files + ["sort_network.cuh"]),
                   "gnk_distance.cu"),
        "k2_new": (stage("k2_new", NEW, gnk_files + ["sort_network.cuh"]),
                   "gnk_distance.cu"),
    }
    # the transform with __expf and __fdividef in place of expf and the
    # IEEE divide (log1pf kept)
    specs["k2_fast"] = (stage("k2_fast", NEW, gnk_files + ["sort_network.cuh"],
                              edit=lambda t: t.replace(
                                  "expf(", "__expf(").replace(
                                  "__fdiv_rn(", "__fdividef(")),
                        "gnk_distance.cu")
    libs, logs = build_all(specs)
    res["ptxas"] = {t: [ln for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln
                        or "entry function" in ln]
                    for t, log in logs.items()}
    for t, lines in res["ptxas"].items():
        print(f"== ptxas {t}", *lines, sep="\n  ", flush=True)
    res["sass"] = {}
    for t in ("k1_old", "k1_new", "k2_old", "k2_new", "k2_fast"):
        if t in libs:
            res["sass"][t], text = sass(libs[t])
            if t.endswith("new"):
                (OUT / f"sass_{t}.txt").write_text(text)
            for f, v in res["sass"][t].items():
                print(f"== sass {t} {f[:70]}: total {v['total']} "
                      f"{v['classes']}; loops "
                      f"{[(l['count'], l['classes']) for l in v['loops']]}",
                      flush=True)
    L = {t: bind(so) for t, so in libs.items()}
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)

    # K1 inputs: prior draws as chip_smoke makes them
    t1 = (torch.rand(B, generator=g.manual_seed(1), device=dev) * 4 - 2)
    t2 = (torch.rand(B, generator=g.manual_seed(2), device=dev) * 2 - 1)
    obs = torch.tensor([0.9, 0.35], device=dev)
    out = torch.empty(B, device=dev)

    def k1(tag, seed=21):
        rc = L[tag].elfi_ma2_distance(t1.data_ptr(), t2.data_ptr(),
                                      obs.data_ptr(), out.data_ptr(), B, 100,
                                      seed, 0, stream())
        assert rc == 0, rc
        return out

    # correctness of the new K1 on injected noise against the plain version
    for n_obs, bb in ((100, B), (100, 2000), (3, 4096), (17, 257)):
        noise = torch.randn((bb, n_obs + 2), generator=g.manual_seed(3),
                            device=dev)
        o = torch.empty(bb, device=dev)
        rc = L["k1_new"].elfi_ma2_distance_noise(
            t1[:bb].data_ptr(), t2[:bb].data_ptr(), obs.data_ptr(),
            noise.data_ptr(), o.data_ptr(), bb, n_obs, 0, stream())
        assert rc == 0
        p = ma2_distance_reference(t1[:bb].contiguous(), t2[:bb].contiguous(),
                                   obs, n_obs, bb, noise=noise)
        err = (o - p).abs()
        res[f"k1_noise_{n_obs}_{bb}"] = [float(err.max()),
                                         float((err / p.abs()).max())]
        print(f"K1 new vs plain n_obs {n_obs} batch {bb}: max abs "
              f"{float(err.max())!r} max rel {float((err / p.abs()).max())!r}",
              flush=True)
        del noise
    # own stream: new against old, statistics
    a = k1("k1_old").clone()
    b = k1("k1_new").clone()
    res["k1_stats"] = [float(a.mean()), float(b.mean()), float(a.std()),
                       float(b.std())]
    print("K1 own stream mean/std old, new:", res["k1_stats"], flush=True)

    # K2 inputs
    P4 = [torch.rand(B, generator=g.manual_seed(10 + j), device=dev) * 10
          for j in range(4)]
    obs_by_n = {n: torch.sort(torch.randn(n, generator=g.manual_seed(n),
                                          device=dev) + 3).values
                for n in (17, 50, 64)}

    def k2(tag, n_obs=50, seed=21):
        rc = L[tag].elfi_gnk_distance(*(p.data_ptr() for p in P4),
                                      obs_by_n[n_obs].data_ptr(),
                                      out.data_ptr(), B, n_obs, 0.8, seed, 0,
                                      stream())
        assert rc == 0, rc
        return out

    for tag in ("k2_new", "k2_fast"):
        for n_obs in (17, 50, 64):
            for bb in (2**16, B):
                z = torch.randn((bb, n_obs), generator=g.manual_seed(4),
                                device=dev)
                o = torch.empty(bb, device=dev)
                rc = L[tag].elfi_gnk_distance_noise(
                    *(p[:bb].data_ptr() for p in P4),
                    obs_by_n[n_obs].data_ptr(), z.data_ptr(), o.data_ptr(),
                    bb, n_obs, 0.8, 0, stream())
                assert rc == 0
                p = gnk_distance_reference(*(q[:bb].contiguous() for q in P4),
                                           obs_by_n[n_obs], n_obs,
                                           batch_size=bb, z=z)
                err = (o - p).abs()
                res[f"{tag}_noise_{n_obs}_{bb}"] = [
                    float(err.max()), float((err / p.abs()).max())]
                print(f"K2 {tag} vs plain n_obs {n_obs} batch {bb}: max abs "
                      f"{float(err.max())!r} max rel "
                      f"{float((err / p.abs()).max())!r}", flush=True)
                del z
    a = k2("k2_old").clone()
    b = k2("k2_new").clone()
    res["k2_stats"] = [float(a.mean()), float(b.mean()), float(a.median()),
                       float(b.median())]
    print("K2 own stream mean/median old, new:", res["k2_stats"], flush=True)

    # timing in turns: old, new, new, old, with the SM clock sampled
    clocks = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader", "-lms", "100"], stdout=subprocess.PIPE,
        text=True)
    for name, fn in (("k1", k1), ("k2", k2)):
        seq = []
        for tag in (f"{name}_old", f"{name}_new", f"{name}_new",
                    f"{name}_old"):
            seq.append((tag, time_ms(lambda: fn(tag), reps=reps)))
            print(f"{tag}: {seq[-1][1]!r} ms", flush=True)
        res[f"{name}_turns"] = seq
    res["k1_plain_ms"] = time_ms(lambda: ma2_distance_reference(
        t1, t2, obs, 100, B, generator=g.manual_seed(5)), reps=reps)
    res["k2_plain_ms"] = time_ms(lambda: gnk_distance_reference(
        *P4, obs_by_n[50], 50, batch_size=B, generator=g.manual_seed(5)),
        reps=reps)
    print("plain K1, K2:", res["k1_plain_ms"], res["k2_plain_ms"],
          flush=True)
    # K2 at n_obs 17 and 64 (the 64-row instance), old and new
    for n_obs in (17, 64):
        for tag in ("k2_old", "k2_new"):
            res[f"{tag}_n{n_obs}_ms"] = time_ms(lambda: k2(tag, n_obs),
                                                reps=reps)
            print(f"{tag} n_obs {n_obs}: {res[f'{tag}_n{n_obs}_ms']!r} ms",
                  flush=True)
    # the fast-transform variant, between two of the new kernel
    for tag in ("k2_new", "k2_fast", "k2_fast", "k2_new"):
        res.setdefault("k2_fast_turns", []).append(
            (tag, time_ms(lambda: k2(tag), reps=reps)))
        print(f"{tag}: {res['k2_fast_turns'][-1][1]!r} ms", flush=True)
    clocks.terminate()
    res["clocks"] = clocks.communicate()[0].splitlines()
    print("SM clock, power while timing:", sorted(set(res["clocks"]))[:3],
          "...", sorted(set(res["clocks"]))[-3:], flush=True)
    res["card_after"] = card()
    Path(args.out).write_text(json.dumps(res, indent=1))
    print("wrote", args.out, flush=True)


if __name__ == "__main__":
    main()

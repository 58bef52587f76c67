"""The counts and peaks: from a configuration's shapes alone, and with no
import of the program, the JAX package or JAX."""

import json
import math
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.counts import gnk, ma2, peaks

ROOT = Path(__file__).resolve().parents[2]
CONFIGS = ROOT / "portbench" / "configs"


def config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


@pytest.mark.parametrize("mod,name", [(ma2, "ma2"), (gnk, "gnk")])
def test_counts_read_the_shapes_alone(mod, name):
    full = config(name)
    shapes = {"n_obs": full["n_obs"]}
    for fn in (mod.prior_ops, mod.distance_ops, mod.sim_ops):
        assert fn(full) == fn(shapes)
    assert mod.distance_bytes(full, 1 << 21) == \
        mod.distance_bytes(shapes, 1 << 21)
    other = dict(full, observed=[0.0] * full["n_obs"], seed_obs=5)
    assert mod.sim_ops(other) == mod.sim_ops(full)


def test_ma2_counts():
    c = {"n_obs": 100}
    # 102 normals, the series, two autocovariances and the distance
    assert ma2.distance_ops(c) == 102 * 6 + 400 + 198 + 196 + 2 + 6
    assert ma2.sim_ops(c) == ma2.distance_ops(c) + 14
    assert ma2.distance_bytes(c, 10) == 10 * 12 + 8


def test_gnk_counts():
    c = {"n_obs": 50}
    assert peaks.sort_compares(50) == math.ceil(math.log2(math.factorial(50)))
    assert gnk.distance_ops(c) == 50 * 6 + 50 * 16 + 215 + 150
    assert gnk.sim_ops(c) == gnk.distance_ops(c) + 12
    assert gnk.distance_bytes(c, 10) == 10 * 20 + 200


def test_bound_is_the_larger_time():
    assert peaks.bound_s(67e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.bound_s(67e12, 2 * 3.35e12) == pytest.approx(2.0)
    ops, nbytes = peaks.selection(1 << 21, 5000, 2)
    assert ops == 1 << 21
    assert nbytes == 4 * (1 << 21) + 2 * 5000 * 12


@pytest.mark.parametrize("module", ["portbench.counts.ma2",
                                    "portbench.counts.gnk",
                                    "portbench.counts.peaks"])
def test_counts_import_nothing_of_the_program(module):
    code = (f"import sys; import {module}; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    loaded = set(out.stdout.split())
    assert not loaded & {"jax", "jaxlib", "flax", "elfi_tpu",
                         "elfi_tpu_torch", "torch"}

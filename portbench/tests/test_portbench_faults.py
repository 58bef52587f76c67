"""A run of each kind of cell on the CPU, past the harness's look for a
card, with the timed path broken underneath: ``correct`` has to come out
false.  The faults a rejection or SMC cell can have: half of each batch
left out of the merge, a merge that returns the buffer unchanged, and an
answer altered where it is produced.  (One card: no exchange between
chips to leave out.)"""

import time
from pathlib import Path

import pytest
import torch

from portbench.harness.cells import Benchmark
from portbench.harness.runner import run_cell

ROOT = Path(__file__).resolve().parents[2]
SMALL = {"rejection": dict(batch_size=1024, n_sim=1 << 14, n_samples=100,
                           check_calls=1),
         "smc": dict(batch_size=500, n_samples=100, check_calls=1)}


def half_batch(merge):
    def run(buffers, batch, threshold, name, fresh=False):
        n = batch[name].shape[0] // 2
        return merge(buffers, {k: v[:n] for k, v in batch.items()},
                     threshold, name, fresh=fresh)
    return run


def unchanged(merge):
    seen = []

    def run(buffers, batch, threshold, name, fresh=False):
        seen.append(1)
        if len(seen) % 2 == 0 and buffers is not None:
            acc = torch.zeros((), dtype=torch.int64)
            return buffers, acc
        return merge(buffers, batch, threshold, name, fresh=fresh)
    return run


def altered(merge):
    def run(buffers, batch, threshold, name, fresh=False):
        d = batch[name].clone()
        d[7] = 0.0
        return merge(buffers, dict(batch, **{name: d}), threshold, name,
                     fresh=fresh)
    return run


@pytest.fixture
def cpu_client():
    import elfi_tpu_torch as et
    et.set_client("native", device="cpu")
    yield et
    et.reset_client()


def small_run(name, seed=17):
    cell = Benchmark(ROOT).cell(name)
    cell.traffic.update(SMALL[cell.traffic["kind"]])
    line, checks = run_cell(cell, seed, 0.01, False, "cpu",
                            time.perf_counter(), log=lambda *a: None)
    return line, checks


@pytest.mark.parametrize("name", ("ma2-rej-k1", "gnk-rej-plain", "ma2-smc"))
def test_a_sound_run_is_correct(name, cpu_client):
    line, _ = small_run(name)
    assert line["correct"] and line["failed"] == 0


@pytest.mark.parametrize("fault", (half_batch, unchanged, altered))
@pytest.mark.parametrize("name", ("ma2-rej-k1", "gnk-rej-plain", "ma2-smc"))
def test_a_broken_run_is_not_correct(name, fault, cpu_client, monkeypatch):
    from elfi_tpu_torch.ops import topk
    monkeypatch.setattr(topk, "merge_scan", fault(topk.merge_scan))
    line, checks = small_run(name)
    assert not line["correct"], checks
    assert line["failed"] >= 1


def wide(weighted_var):
    def run(*args, **kwargs):
        return 4.0 * weighted_var(*args, **kwargs)
    return run


@pytest.mark.parametrize("fault", ("proposal_spread", "late_stop"))
def test_a_consistent_smc_fault_is_not_correct(fault, cpu_client,
                                               monkeypatch):
    """Faults that every round of a run repeats alike: a proposal twice as
    wide as the previous population's (and weighed by it), and rounds
    that read their acceptance count a chunk of 32 batches at a time.  The
    reference builds each round's mixture and stopping point itself."""
    from elfi_tpu_torch.methods import samplers
    if fault == "proposal_spread":
        monkeypatch.setattr(samplers, "weighted_var",
                            wide(samplers.weighted_var))
    else:
        monkeypatch.setattr(samplers, "_FUSED_CHUNK", 32)
    line, checks = small_run("ma2-smc")
    assert not line["correct"], checks

"""The device list (``ShardedBackend``) on the fused rejection path, on the
CPU: each card's share of a chunk run through the capture machinery (the
CPU stand-in for a CUDA graph of ``test_torch_capture.py``) equals the
eager device list and the one-device run bit for bit, after warm-up and
in replay; the spans and counters of a device-list call; and the
benchmark's four-card cell ``ma2-rej-k1-x4`` at a small size: its rows
against its plain reference, its blocked noise, its files and its
readers.  The per-card CUDA graphs themselves run in
``test_torch_backends_cuda.py``."""

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import elfi_tpu_torch as et
from elfi_tpu_torch.compile.compiler import compile_program
from elfi_tpu_torch.methods import samplers
from elfi_tpu_torch.models import ma2, ma2_kernel
from elfi_tpu_torch.utils import capture, profiling

from chunk_keys import chunk_keys
from test_torch_capture import (_equal, cpu_capture,  # noqa: F401
                                small_chunks)
from test_torch_spans import inside, named, spans_of

from portbench.harness.cells import Benchmark
from portbench.harness.runner import judge, run_cell
from portbench.reference import streams

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[2]
CELL = "ma2-rej-k1-x4"
READERS = ("card_busy_share.x4", "card_host_us.x4", "replayed_card_share.x4",
           "merge_parts_ms.x4", "sim_mfu.x4")


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


def _rejection(model, devices, threshold=None, seed=5):
    """A fused rejection call at batch 64 over ``devices`` (None: one
    device): (the sampler, its outputs)."""
    et.set_client("native", device="cpu") if devices is None else \
        et.set_client("sharded", devices=devices)
    kw = dict(n_sim=64 * 22) if threshold is None else dict(
        threshold=threshold)
    rej = et.Rejection(model["d"], batch_size=64, seed=seed)
    return rej, rej.sample(40, bar=False, **kw)


# -- each card's share of a chunk through the capture machinery --------------

@pytest.mark.parametrize("n_cards", [1, 2, 3, 4])
@pytest.mark.parametrize("threshold", [None, 0.2])
@pytest.mark.parametrize("model", [ma2, ma2_kernel])
def test_card_graphs_equal_the_eager_list_and_one_device(
        cpu_capture, small_chunks, model, threshold, n_cards):
    """One device named ``n_cards`` times (a card named several times):
    every run equals the eager device list and the one-device run; by the
    fourth run every full chunk's share of every position replays its
    graph, and the positions keep a graph each under a raised cap.  The
    one-device run is the list of one: its graphs are position 0's of
    that list, kept beside a longer list's."""
    m = model.get_model(seed_obs=4)
    devices = ["cpu"] * n_cards
    cpu_capture["on"] = False
    _, want = _rejection(m, None, threshold)
    _, eager = _rejection(m, devices, threshold)
    cpu_capture["on"] = True
    for run in range(4):
        rej, got = _rejection(m, devices, threshold)
        for k in ("d", "t1", "t2"):
            assert _equal(got.outputs[k], want.outputs[k]), (run, k)
            assert _equal(eager.outputs[k], want.outputs[k]), k
        assert got.n_sim == want.n_sim
    full = rej.state["n_batches"] // samplers._FUSED_CHUNK
    assert rej.state["card_replays"] == [full] * n_cards
    assert sum(rej.state["card_batches"]) == rej.state["n_batches"]
    prog = compile_program(m, tuple(rej.output_names), device="cpu")
    assert prog.replays.cap == capture.CAP * n_cards
    keys = chunk_keys(prog.replays)
    assert {k.position for k in keys.values()} == set(range(n_cards))
    captures = prog.replays.captures
    _, again = _rejection(m, None, threshold)
    for k in ("d", "t1", "t2"):
        assert _equal(again.outputs[k], want.outputs[k]), k
    added = chunk_keys(prog.replays).keys() - keys.keys()
    # a list of one replays the one device's graphs; a longer list's are
    # kept beside them
    assert bool(added) == (n_cards > 1)
    assert (prog.replays.captures == captures) == (n_cards == 1)
    assert all(chunk_keys(prog.replays)[k].position == 0 for k in added)


@pytest.mark.parametrize("n_cards", [2, 3])
def test_a_run_shorter_than_a_chunk_runs_eagerly_on_each_card(
        cpu_capture, small_chunks, n_cards):
    """A run of 3 batches, fewer than a chunk's 4, over 2 or 3 cards: each
    card runs its share eagerly, run after run, no card records or
    replays a graph, and every run's rows are the one device's."""
    m = ma2_kernel.get_model(seed_obs=4)

    def run(devices):
        et.set_client("native", device="cpu") if devices is None else \
            et.set_client("sharded", devices=devices)
        rej = et.Rejection(m["d"], batch_size=64, seed=5)
        return rej, rej.sample(40, n_sim=64 * 3, bar=False)

    cpu_capture["on"] = False
    _, want = run(None)
    cpu_capture["on"] = True
    for _ in range(4):
        rej, got = run(["cpu"] * n_cards)
        for k in ("d", "t1", "t2"):
            assert _equal(got.outputs[k], want.outputs[k]), k
    assert rej.state["card_replays"] == [0] * n_cards
    assert rej.state["graph_nodes"] == 0
    assert rej.state["card_batches"] == [len(range(k, 3, n_cards))
                                         for k in range(n_cards)]
    prog = compile_program(m, tuple(rej.output_names), device="cpu")
    assert not prog.replays.entries


def test_card_graphs_carry_the_global_simulation_index(
        cpu_capture, small_chunks, monkeypatch):
    """A replayed share's rows carry the global simulation index of the
    chunk it replays (the graph reads the chunk's first batch from a
    device scalar): each card's buffer, ``__pos`` included, is the eager
    device list's."""
    m = ma2_kernel.get_model(seed_obs=4)
    kept = []
    real = samplers._ChunkLoop.final_parts

    def keep(loop):
        kept.append(real(loop))
        return kept[-1]

    monkeypatch.setattr(samplers._ChunkLoop, "final_parts", keep)
    cpu_capture["on"] = False
    _rejection(m, ["cpu"] * 4)
    cpu_capture["on"] = True
    for _ in range(4):
        rej, _ = _rejection(m, ["cpu"] * 4)
    assert rej.state["card_replays"] == [5] * 4
    eager, replayed = kept[0], kept[-1]
    assert len(eager) == len(replayed) == 4
    for k, (pe, pr) in enumerate(zip(eager, replayed)):
        for name in pe:
            assert _equal(pr[name], pe[name]), (k, name)
        pos = pr["__pos"][pr["__pos"] >= 0]
        # a row of card k is a simulation of a batch i with i % 4 == k
        assert pos.numel() > 0 and ((pos // 64) % 4 == k).all()


# -- spans and counters -------------------------------------------------------

@pytest.mark.parametrize("n_cards", [3, 4])
def test_a_device_list_call_gives_a_card_span_per_card_and_chunk(n_cards):
    m = ma2.get_model(seed_obs=4)
    et.set_client("sharded", devices=["cpu"] * n_cards)
    rej = et.Rejection(m["d"], batch_size=64, seed=1)
    with profiling.recorded() as prof:
        rej.sample(20, n_sim=64 * 40, bar=False)
    spans = spans_of(prof)
    chunks = named(spans, "elfi.chunk")
    cards = named(spans, "elfi.card")
    assert len(chunks) == 3                 # 16, 16 and 8 batches
    assert len(cards) == n_cards * len(chunks)
    for c in chunks:
        assert len([s for s in cards if inside(s, c)]) == n_cards
    (merge,) = named(spans, "elfi.merge_parts")
    (sample,) = named(spans, "elfi.sample")
    assert inside(merge, sample)
    assert not any(inside(merge, c) for c in chunks)
    s = rej.state
    assert sum(s["card_batches"]) == s["n_batches"] == 40
    assert s["card_batches"] == [len(range(k, 40, n_cards))
                                 for k in range(n_cards)]
    assert s["card_replays"] == [0] * n_cards


def test_one_device_gives_no_card_or_merge_span():
    m = ma2.get_model(seed_obs=4)
    rej = et.Rejection(m["d"], batch_size=64, seed=1)
    with profiling.recorded() as prof:
        rej.sample(20, n_sim=64 * 40, bar=False)
    names = {s[0] for s in spans_of(prof)}
    assert "elfi.card" not in names and "elfi.merge_parts" not in names
    assert rej.state["card_batches"] == [40]


# -- the benchmark's four-card cell -------------------------------------------

def _cell(**traffic):
    cell = Benchmark(ROOT).cell(CELL)
    cell.traffic.update(traffic)
    return cell


def test_the_cell_finds_its_files():
    cell = _cell()
    one = Benchmark(ROOT).cell("ma2-rej-k1")
    assert cell.chips == 4
    assert cell.config["name"] == "ma2-x4"
    assert cell.config["observed"] == one.config["observed"]
    assert cell.config["reduced"] == []
    assert cell.traffic["kind"] == "rejection_x4"
    assert cell.traffic["batch_size"] == 1 << 24
    assert cell.traffic["n_sim"] == 1 << 31
    assert cell.limits == one.limits
    assert cell.system().build and cell.reference().simulate
    assert cell.driver().check and cell.driver().control
    assert cell.counts().sim_ops(cell.config) == \
        one.counts().sim_ops(one.config)


def test_the_cell_runs_its_rows_against_the_reference_on_the_cpu():
    """The cell's call and check at batch 2**12 and 2**16 simulations, the
    list naming the CPU four times: correct within ``ma2-rej-k1``'s
    limits, and the rows of the one-device run bit for bit."""
    cell = _cell(batch_size=1 << 12, n_sim=1 << 16, n_samples=200,
                 check_calls=1)
    line, checks = run_cell(cell, 2**31 + 77, 0.2, False, "cpu", 0.0,
                            log=lambda *a: None)
    assert line["correct"] is True and line["failed"] == 0
    assert set(checks) == set(Benchmark(ROOT).cell("ma2-rej-k1").limits)

    driver = cell.driver().Driver(cell, "cpu")
    try:
        got = driver.call(9)
    finally:
        driver.release()
    per_call = cell.driver().check(
        cell, [SimpleNamespace(seed=9, out=got)], 0, "cpu")
    _, failed = judge(per_call, Benchmark(ROOT).cell("ma2-rej-k1").limits)
    assert failed == 0
    et.set_client("native", device="cpu")
    m, node = cell.system().build(cell.config, "kernel")
    one = et.Rejection(m[node], batch_size=1 << 12, seed=9).sample(
        200, n_sim=1 << 16, bar=False)
    want = np.stack([one.outputs[p] for p in cell.config["parameters"]],
                    axis=1)
    np.testing.assert_array_equal(got["theta"], want)
    np.testing.assert_array_equal(got["d"], one.outputs[node])
    assert got["sims"] == 1 << 16 and got["batches"] == 16


@pytest.mark.parametrize("block", [64, 1000])
def test_the_blocked_philox_normals_are_the_whole_draw(block):
    ref = _cell().reference()
    seed = streams.stream_seed(2**31 + 3, 7, "d")
    batch = 3 * 64 + 5
    got = ref.philox_normals(seed, batch, 102, "cpu", block=block)
    want = streams.philox_normals(seed, batch, 102, "cpu")
    assert torch.equal(got, want)
    assert torch.equal(ref.block_normals(seed, 64, 128, 102, "cpu"),
                       want[64:128])


def _view(host, ops=(), calls=((0, 1000),)):
    return SimpleNamespace(host=list(host), ops=list(ops), calls=list(calls),
                           t0=calls[0][0], t1=calls[-1][1],
                           window_s=(calls[-1][1] - calls[0][0]) * 1e-9)


#: a traced window of two calls over four cards: the first call's shares
#: record, capture and replay; the second's replay, one waiting for its
#: keys' copy
WINDOW = [("elfi.card", 0, 100), ("elfi.graph.record", 10, 90),
          ("elfi.card", 100, 200), ("elfi.graph.capture", 110, 190),
          ("elfi.card", 200, 250), ("elfi.graph.replay", 210, 240),
          ("elfi.card", 250, 300), ("elfi.graph.replay", 260, 290),
          ("elfi.merge_parts", 300, 340),
          ("elfi.card", 500, 540), ("elfi.graph.replay", 505, 535),
          ("elfi.host_read", 510, 530),
          ("elfi.card", 540, 560), ("elfi.graph.replay", 545, 555),
          ("elfi.card", 560, 580), ("elfi.graph.replay", 565, 575),
          ("elfi.card", 580, 600), ("elfi.graph.replay", 585, 595),
          ("elfi.merge_parts", 600, 660)]


@pytest.mark.parametrize("name, want", [
    ("card_host_us.x4", (100 + 100 + 50 + 50 + 20 + 20 + 20 + 20) / 8e3),
    ("replayed_card_share.x4", 100.0 * 6 / 8),
    ("merge_parts_ms.x4", (40 + 60) / 2e6),
    ("card_busy_share.x4", 100.0 * (400 + 300 + 200 + 100) / (4 * 1000)),
    ("sim_mfu.x4", None)])
def test_the_readers_arithmetic(name, want):
    cell = _cell()
    ops = [("k", 0, 400), ("k", 100, 400), ("k", 600, 800), ("k", 900, 1200)]
    run = SimpleNamespace(cell=cell, config=cell.config,
                          counts=cell.counts(), sims=8 << 20,
                          window_s=1e-6, trace=_view(WINDOW, ops))
    got = cell.reader(name).read(run)
    if want is None:        # the model's operations at 8 Mi sims a us
        want = 100.0 * 1428 * (8 << 20) / 1e-6 / (4 * 67e12)
    assert got == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_a_reader_finds_nothing_without_a_trace(name):
    read = _cell().reader(name).read
    assert read(SimpleNamespace(trace=None, sims=1, window_s=1.0)) is None
    if name in ("card_host_us.x4", "replayed_card_share.x4",
                "merge_parts_ms.x4"):
        # a program without the spans: the parent's
        older = _view([("elfi.chunk", 0, 100), ("cudaGraphLaunch", 30, 40)])
        assert read(SimpleNamespace(trace=older)) is None

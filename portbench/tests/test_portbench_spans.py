"""The readers of the program's spans on hand-made traced windows with
known answers, and without a trace or without the spans (an older
program)."""

from types import SimpleNamespace

import pytest

from portbench.harness import spans
from portbench.harness.cells import Cell
from portbench.tests.test_portbench_harness import SPEC

READERS = ("loop_host_ms.rej", "replay_host_us.rej",
           "replayed_chunk_share.smc", "smc_transition_ms",
           "host_reads_per_batch.smc")


def reader(name):
    return Cell.reader(name).read


def window(host, calls, batches=10, ops=()):
    return SimpleNamespace(
        trace=SimpleNamespace(host=list(host), calls=list(calls),
                              ops=list(ops)),
        batches=batches)


#: two rejection calls, ns.  Call 1 (0-1000): the sampler built 0-100,
#: the call 100-1000 with chunks 200-400 and 400-700 (each replaying a
#: graph, 250-300 and 450-520, the second waiting 460-490 for its keys'
#: copy), a host read 650-750 that overlaps the second chunk's end, and
#: the result's read 900-950.  Call 2 (1000-2000): built 1000-1050, the
#: call 1050-2000, one chunk 1100-1900 that captured (1200-1500) and read
#: 1850-1900 inside it.
REJ = [("elfi.sampler.init", 0, 100), ("elfi.sample", 100, 1000),
       ("elfi.chunk", 200, 400), ("elfi.graph.replay", 250, 300),
       ("elfi.chunk", 400, 700), ("elfi.graph.replay", 450, 520),
       ("elfi.host_read", 460, 490), ("elfi.host_read", 650, 750),
       ("elfi.host_read", 900, 950), ("aten::empty", 960, 970),
       ("elfi.sampler.init", 1000, 1050), ("elfi.sample", 1050, 2000),
       ("elfi.chunk", 1100, 1900), ("elfi.graph.capture", 1200, 1500),
       ("elfi.host_read", 1850, 1900)]
REJ_CALLS = [(0, 1000), (1000, 2000)]

#: one SMC run (0-3000): round 0's chunk replays (100-300); the
#: population 300-400 (its read 350-380 inside) and the next round
#: 400-500; round 1's first chunk replays and runs again (500-900: replay
#: 520-560, redo 600-880 with two proposals and their reads); an eager
#: chunk 900-1200 (a proposal with three reads); a chunk that records
#: 1200-1400; the last population 2800-2950, whose span overlaps nothing
#: else.
SMC = [("elfi.sample", 0, 3000),
       ("elfi.chunk", 100, 300), ("elfi.graph.replay", 120, 200),
       ("elfi.smc.population", 300, 400), ("elfi.host_read", 350, 380),
       ("elfi.smc.next_round", 400, 500),
       ("elfi.sampler.init", 410, 450),
       ("elfi.chunk", 500, 900), ("elfi.graph.replay", 520, 560),
       ("elfi.host_read", 570, 580),
       ("elfi.chunk.redo", 600, 880),
       ("elfi.proposal", 610, 700), ("elfi.host_read", 650, 660),
       ("elfi.proposal", 710, 800), ("elfi.host_read", 750, 760),
       ("elfi.chunk", 900, 1200),
       ("elfi.proposal", 910, 1000), ("elfi.host_read", 920, 930),
       ("elfi.host_read", 940, 950), ("elfi.host_read", 960, 970),
       ("elfi.chunk", 1200, 1400), ("elfi.graph.record", 1210, 1390),
       ("elfi.smc.population", 2800, 2950)]


def test_loop_host_ms_is_the_loop_outside_its_chunks_and_reads():
    # call 1: the loop 0-1000 less chunks and reads 200-750, 900-950:
    # 1000 - 550 - 50 = 400; call 2: 1000 - 800 = 200; 300 ns a call
    got = reader("loop_host_ms.rej")(window(REJ, REJ_CALLS))
    assert got == pytest.approx(300e-6)


def test_replay_host_us_is_the_mean_replay_span():
    """The replays' spans less the reads inside them: the second replay's
    wait for the card is not the host's work."""
    got = reader("replay_host_us.rej")(window(REJ, REJ_CALLS))
    assert got == pytest.approx((50 + 70 - 30) / 2 * 1e-3)


def test_replayed_chunk_share_counts_chunks_a_replay_ran_alone():
    # 4 chunks: replayed alone (100-300); replayed then redone; eager;
    # recorded
    got = reader("replayed_chunk_share.smc")(window(SMC, [(0, 3000)]))
    assert got == pytest.approx(25.0)
    # the capture's chunk is not a replayed one either
    rej = reader("replayed_chunk_share.smc")(window(REJ, REJ_CALLS))
    assert rej == pytest.approx(100 * 2 / 3)


def test_smc_transition_ms_is_the_population_and_round_set_up():
    got = reader("smc_transition_ms")(window(SMC, [(0, 3000)]))
    assert got == pytest.approx((100 + 100 + 150) * 1e-6)
    two_runs = reader("smc_transition_ms")(
        window(SMC, [(0, 1500), (1500, 3000)]))
    assert two_runs == pytest.approx(got / 2)


def test_host_reads_per_batch_counts_the_read_spans():
    got = reader("host_reads_per_batch.smc")(window(SMC, [(0, 3000)], 14))
    assert got == pytest.approx(7 / 14)
    assert reader("host_reads_per_batch.smc")(
        window(SMC, [(0, 3000)], 0)) is None


@pytest.mark.parametrize("name", READERS)
def test_a_reader_finds_nothing_without_a_trace_or_its_spans(name):
    read = reader(name)
    assert read(SimpleNamespace(trace=None, batches=10)) is None
    # an older program: the window holds the profiler's records alone
    older = [("aten::add", 10, 20), ("cudaGraphLaunch", 30, 40)]
    assert read(window(older, [(0, 100)])) is None


def test_the_readers_are_entries_of_the_benchmark():
    entries = {m["name"]: m for m in SPEC["per_layer"]}
    for name in READERS:
        assert entries[name]["source"] == "program_span"
        cells = entries[name]["workloads"]
        assert cells == (["ma2-smc"] if name.endswith("smc")
                         or name.startswith("smc") else
                         ["ma2-rej-k1", "gnk-rej-k2", "gnk-rej-plain"])


def test_interval_arithmetic():
    assert spans.merged([(5, 6), (0, 2), (1, 3), (3, 4)]) == [(0, 4),
                                                              (5, 6)]
    assert spans.length([(0, 2), (1, 3), (10, 11)]) == 4
    assert spans.within((5, 10), [(0, 6), (5, 7), (6, 10), (9, 11)]) == [
        (5, 7), (6, 10)]
    assert spans.subtract([(0, 10), (20, 30)], [(2, 4), (3, 5), (8, 22)]) \
        == [(0, 2), (5, 8), (22, 30)]
    assert spans.subtract([(0, 10)], []) == [(0, 10)]


def test_the_idle_split_names_the_innermost_span_at_each_idle_instant():
    """Two calls; the card busy 0-100 and 250-300 and 1100-1900.  Idle
    inside the calls: 100-250 (the chunk 100-200 holds a host read
    150-180; then the sample span alone), 300-1000 (a profiler buffer
    400-500; the result's read 600-700; plain Python 900-1000, outside
    the sample span), and in call 2 1000-1100 and 1900-2000 outside any
    span."""
    host = [("elfi.sample", 0, 900), ("elfi.chunk", 100, 200),
            ("elfi.host_read", 150, 180), ("aten::item", 160, 180),
            ("Activity_Buffer_Request", 400, 500),
            ("elfi.host_read", 600, 700)]
    ops = [("k", 0, 100), ("k", 250, 300), ("k", 1100, 1900)]
    view = SimpleNamespace(calls=[(0, 1000), (1000, 2000)], ops=ops,
                           host=host)
    split = spans.idle_split(view)
    got = spans.by_span(split)
    assert got == {"elfi.chunk": 70, "elfi.host_read": 130,
                   "elfi.sample": 50 + 100 + 100 + 200,
                   spans.IN_PROFILER: 100,
                   spans.OUTSIDE: 100 + 100 + 100}
    assert split[("elfi.host_read", "aten::item")] == 20
    assert split[("elfi.host_read", None)] == 110


def test_the_idle_report_gives_a_call_its_share():
    from portbench.idle_by_span import report
    host = [("elfi.sample", 0, 900), ("elfi.host_read", 600, 700),
            ("Buffer_Flush", 400, 500)]
    view = SimpleNamespace(calls=[(0, 1000), (1000, 2000)],
                           ops=[("k", 0, 100), ("k", 1100, 2000)], host=host)
    got = report(view)
    assert got["calls"] == 2
    assert got["idle_ms_per_call"] == pytest.approx(
        {"elfi.sample": 300e-6, spans.IN_PROFILER: 50e-6,
         spans.OUTSIDE: 100e-6, "elfi.host_read": 50e-6})
    assert got["in_spans"] == pytest.approx(700 / 900)
    assert got["idle_top"][0] == ["elfi.sample", None, pytest.approx(300e-6)]
    # call 1 idles 900-1000 after its spans; call 2 has none
    assert got["outside_ms_per_call"] == pytest.approx(
        {"after": 50e-6, "before": 50e-6})
    assert got["spans_per_call"] == {"elfi.host_read": 0.5,
                                     "elfi.sample": 0.5}
    assert got["span_ms_per_call"] == pytest.approx(
        {"elfi.host_read": 50e-6, "elfi.sample": 450e-6})

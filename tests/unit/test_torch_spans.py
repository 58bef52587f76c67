"""The port's spans (``utils.profiling.annotate``) on the CPU: the names a
fused rejection call and a fused SMC run give under the profiler, and
how they nest; the host reads of the eager SMC proposals against their
redraw rounds; and no span at all while no profiler records.  The graph
spans under the capture machinery: ``test_torch_capture.py``."""

import pytest
import torch

import elfi_tpu_torch as et
from elfi_tpu_torch.methods.utils import GMDistribution
from elfi_tpu_torch.models import ma2
from elfi_tpu_torch.utils import profiling

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


def spans_of(prof):
    """(name, start, end) of every ``elfi.*`` record of the profile, in
    the order they start."""
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("elfi.")), key=lambda s: s[1])


def inside(span, outer):
    return outer[1] <= span[1] and span[2] <= outer[2]


def named(spans, name):
    return [s for s in spans if s[0] == name]


def _rejection(m):
    et.Rejection(m["d"], batch_size=64, seed=1).sample(
        20, n_sim=64 * 40, bar=False)


def _smc(m):
    smc = et.SMC(m["d"], batch_size=64, seed=3)
    return smc.sample(50, quantiles=[0.5, 0.2, 0.2], bar=False)


#: per call kind: its spans, and (span, the span every one lies in)
CALLS = {
    "rejection": (_rejection,
                  {"elfi.sampler.init": 1, "elfi.sample": 1,
                   "elfi.chunk": 3, "elfi.host_read": 1},
                  [("elfi.chunk", "elfi.sample"),
                   ("elfi.host_read", "elfi.sample")]),
    "smc": (_smc,
            {"elfi.sampler.init": 4, "elfi.sample": 1, "elfi.smc.round": 3,
             "elfi.smc.population": 3, "elfi.smc.next_round": 3},
            [("elfi.smc.round", "elfi.sample"),
             ("elfi.chunk", "elfi.sample"),
             ("elfi.smc.population", "elfi.sample"),
             ("elfi.chunk", "elfi.smc.round"),
             ("elfi.proposal", "elfi.chunk")]),
}


@pytest.mark.parametrize("kind", sorted(CALLS))
def test_a_fused_call_gives_its_spans_nested(kind):
    run, counts, nesting = CALLS[kind]
    m = ma2.get_model(seed_obs=4)
    with profiling.recorded() as prof:
        run(m)
    spans = spans_of(prof)
    for name, n in counts.items():
        assert len(named(spans, name)) == n, name
    # the sampler is built before its call; an SMC round's rejection
    # sampler as the call sets the round up
    inits = named(spans, "elfi.sampler.init")
    assert not inside(inits[0], named(spans, "elfi.sample")[0])
    for s in inits[1:]:
        assert any(inside(s, o)
                   for o in named(spans, "elfi.smc.next_round"))
    for inner, outer in nesting:
        assert named(spans, inner), inner
        for s in named(spans, inner):
            assert any(inside(s, o) for o in named(spans, outer)), \
                (inner, outer)
    # no batch, graph or kernel spans on the eager CPU path
    assert not [s for s in spans if s[0].startswith("elfi.graph.")]


def test_the_proposals_read_the_host_once_a_redraw_round_and_once_more(
        monkeypatch):
    """Each eager proposal's redraw loop reads a flag after its first draw
    and after each redraw: as many host reads inside the ``elfi.proposal``
    spans as draws, one ``elfi.proposal`` a batch of the rounds >= 1."""
    draws = []
    draw = GMDistribution._draw

    def counted(*args, **kwargs):
        draws.append(1)
        return draw(*args, **kwargs)

    monkeypatch.setattr(GMDistribution, "_draw", staticmethod(counted))
    m = ma2.get_model(seed_obs=4)
    with profiling.recorded() as prof:
        res = _smc(m)
    spans = spans_of(prof)
    proposals = named(spans, "elfi.proposal")
    assert len(proposals) == sum(p.meta["n_batches"]
                                 for p in res.populations[1:])
    reads = [s for s in named(spans, "elfi.host_read")
             if any(inside(s, p) for p in proposals)]
    # MA2's triangle prior sends the mixture's rows out: rounds > 0
    assert len(draws) > len(proposals)
    assert len(reads) == len(draws)


@pytest.mark.parametrize("kind", sorted(CALLS))
def test_no_span_is_entered_without_a_profiler(monkeypatch, kind):
    assert not torch._C._autograd._profiler_enabled()
    assert profiling.annotate("elfi.a") is profiling.annotate("elfi.b")

    class Refused:
        def __init__(self, name):
            raise AssertionError(f"span {name!r} entered")

    monkeypatch.setattr(profiling, "record_function", Refused)
    CALLS[kind][0](ma2.get_model(seed_obs=4))

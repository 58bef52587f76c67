"""smc_transition_ms (ms, program spans): the host's time between an SMC
run's rounds, a run: the union of the window's ``elfi.smc.population``
(a population copied off the card and weighed) and
``elfi.smc.next_round`` (the next round's sampler, mixture and
threshold) spans, over the window's runs."""

from portbench.harness import spans


def read(run):
    if run.trace is None:
        return None
    phases = spans.named(run.trace.host, "elfi.smc.population",
                         "elfi.smc.next_round")
    if not phases:
        return None
    return 1e-6 * spans.length(phases) / len(run.trace.calls)

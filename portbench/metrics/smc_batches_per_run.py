"""smc_batches_per_run (batches/run, program counters): the batches an
SMC run simulated, over its rounds (each population's ``n_batches``) and
the chunks it ran again (``state["redone_chunks"]``)."""


def read(run):
    return run.batches / len(run.records)

"""setup_s (s, host clock): process start to the first timed call:
imports, the card, the kernels built or loaded, the model, the warm-up
calls that record and capture what the window replays."""


def read(run):
    return run.setup_s

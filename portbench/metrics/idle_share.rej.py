"""idle_share.rej (%, device trace): the share of the traced window in
which no operation ran on the card."""

from portbench.harness.readers import idle_share


def read(run):
    return idle_share(run)

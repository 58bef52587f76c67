"""CPU tests of the benchmark (and, marked ``cuda``, a few for the card)."""

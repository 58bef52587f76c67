"""The keys of the fused loop's chunk graphs
(``elfi_tpu_torch.methods.samplers._ChunkLoop``) with their fields named,
for tests that pick a program's graphs by position or by proposals.  It
imports neither JAX nor a test module, so the CUDA test files, run alone
on a machine with a card, import it too."""

import collections

#: a chunk graph's key, field by field: a position's share of a chunk
ChunkKey = collections.namedtuple("ChunkKey", [
    "kind",         # "chunk"
    "position",     # the share's position in the device list
    "first_mod",    # the chunk's first batch modulo the list's length
    "fn", "batch_size", "n", "disc",
    "merges",       # the share's merges of the chunk's merge schedule
    "threshold",    # the threshold's shape
    "proposals",    # (the proposals' graph key, redraw rounds) or None
    "state",        # the buffers' names, shapes and dtypes
])


def chunk_keys(graphs):
    """{key: its :class:`ChunkKey`} of the chunk graphs that ``graphs`` (a
    ``capture.Replays``) keeps, recorded or captured."""
    return {k: ChunkKey(*k) for k in graphs.entries if k[0] == "chunk"}

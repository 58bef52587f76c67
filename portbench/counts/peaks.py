"""The data-sheet peaks of one NVIDIA H100 (SXM, 700 W; NVIDIA's H100
data sheet, dense rates) and the fixed operation costs of the steps that
every count below is built from.  A count depends on a configuration's
shapes alone: whatever implements a step, it costs what is written here.
"""

import math

#: float32 operations a second outside the tensor cores
FP32_FLOPS = 67e12
#: HBM3 bytes a second
HBM_BYTES_PER_S = 3.35e12

#: one uniform draw: bits to a float in (0, 1)
UNIFORM = 2
#: one standard normal draw: Box-Muller's share of a pair (a logarithm, a
#: square root, a sine or cosine, the scalings) and its uniform
NORMAL = 6
#: one comparison (of a sort, or of a candidate against a threshold)
COMPARE = 1


def sort_compares(n):
    """The comparisons a sort of ``n`` values needs: ceil(log2 n!)."""
    return math.ceil(math.lgamma(n + 1) / math.log(2)) if n > 1 else 0


def bound_s(ops, nbytes):
    """The least time the card could take: the larger of the operations
    over the float32 peak and the bytes over the HBM bandwidth."""
    return max(ops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S)


def selection(batch, n_samples, n_params):
    """(operations, bytes) of one top-N merge of a batch of ``batch`` rows
    into a buffer of ``n_samples`` rows of a distance and ``n_params``
    parameters: each candidate compared once; its distance read, and the
    buffer's rows read and written once."""
    row = 4 * (1 + n_params)
    return batch * COMPARE, 4 * batch + 2 * n_samples * row

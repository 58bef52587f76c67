"""The sorting networks of the g-and-k kernel (``csrc/gnk_distance.cu``),
generated into ``csrc/sort_network.cuh``:

    python -m elfi_tpu_torch.ops.kernels.sort_network

Batcher's odd-even merge sort on 64 rows (543 comparators), and the same
network pruned to the first 50 rows (403), the rows of the main path's
n_obs.  Every comparator puts the minimum on the lower row, so rows that
hold +inf stay +inf, and a comparator that touches one is a no-op: pruning
every comparator that reaches a row >= n leaves a network that sorts n
rows.  The 64-row network sorts any n_obs <= 64 with +inf pads.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

__all__ = ["ROWS", "batcher_pairs", "network", "apply", "header", "HEADER"]

#: the instances the kernel has: n_obs 50 and the general 64-row one
ROWS = (50, 64)
HEADER = Path(__file__).resolve().parents[2] / "csrc" / "sort_network.cuh"


def batcher_pairs(n):
    """Comparators ``(lo, hi)`` of Batcher's odd-even merge sort on ``n``
    rows (a power of two), in an order that respects their dependencies."""
    pairs = []
    p = 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return pairs


def network(rows):
    """The comparators that sort ``rows`` rows: the network of the next
    power of two with every comparator that reaches a row >= ``rows``
    pruned."""
    n = 1 << (rows - 1).bit_length()
    return [(a, b) for a, b in batcher_pairs(n) if b < rows]


def apply(pairs, y):
    """Apply the comparators to every row of ``y`` (batch, rows) in place,
    as the kernel does (minimum to the lower row); returns ``y``."""
    for a, b in pairs:
        lo = np.minimum(y[:, a], y[:, b])
        y[:, b] = np.maximum(y[:, a], y[:, b])
        y[:, a] = lo
    return y


def header():
    """The text of ``csrc/sort_network.cuh``."""
    lines = [
        "// Generated by elfi_tpu_torch/ops/kernels/sort_network.py; do not",
        "// edit.  Regenerate with",
        "//     python -m elfi_tpu_torch.ops.kernels.sort_network",
        "//",
        "// Batcher's odd-even merge sort networks of the g-and-k kernel,",
        "// one per instance, as straight-line compare-exchanges on",
        "// constant indices, so that the rows stay in registers.  Each",
        "// comparator puts the minimum on the lower row.",
        "",
        "#pragma once",
        "",
        "namespace elfi {",
        "",
        "// compare-exchange",
        "__device__ __forceinline__ void cx(float& a, float& b) {",
        "  const float lo = fminf(a, b);",
        "  b = fmaxf(a, b);",
        "  a = lo;",
        "}",
        "",
        "template <int kRows>",
        "__device__ __forceinline__ void sort_network(float (&y)[kRows]);",
    ]
    for rows in ROWS:
        pairs = network(rows)
        lines += [
            "",
            f"// {rows} rows, {len(pairs)} comparators.",
            "template <>",
            f"__device__ __forceinline__ void sort_network<{rows}>("
            f"float (&y)[{rows}]) {{",
        ]
        for i in range(0, len(pairs), 4):
            lines.append("  " + " ".join(
                f"cx(y[{a}], y[{b}]);"
                for a, b in pairs[i:i + 4]))
        lines.append("}")
    lines += ["", "}  // namespace elfi", ""]
    return "\n".join(lines)


if __name__ == "__main__":
    HEADER.write_text(header())
    print(f"wrote {HEADER}")

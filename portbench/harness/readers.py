"""Arithmetic that several metric readers share: a kernel's share of its
roofline from the trace, and the kernel names of the port that the
metrics read (the names its CUDA sources give their ``__global__``
functions)."""

from __future__ import annotations

import functools
import re
from pathlib import Path

from ..counts import peaks

K1 = ("ma2_distance_kernel",)
K2 = ("gnk_distance_kernel",)
#: the cull's scan, merge and gather (``csrc/topn_cull.cu``)
CULL = ("cull_scan", "cull_merge_kernel", "gather_rows_kernel")
CULL_MERGE = ("cull_merge_kernel",)

#: an attribute with arguments between ``__global__`` and a kernel's name
_ATTRIBUTE = re.compile(r"__\w+__\s*\(")
_NAME = re.compile(r"([A-Za-z_]\w*)\s*\(")


def _strip_attributes(head):
    """``head`` without its ``__launch_bounds__(...)``-like groups."""
    while True:
        m = _ATTRIBUTE.search(head)
        if m is None:
            return head
        depth, i = 1, m.end()
        while depth and i < len(head):
            depth += {"(": 1, ")": -1}.get(head[i], 0)
            i += 1
        head = head[:m.start()] + head[i:]


def kernels_in(folder):
    """The names of the ``__global__`` functions defined in the CUDA
    sources (``*.cu``, ``*.cuh``) of ``folder``."""
    names = set()
    for f in sorted(Path(folder).glob("*.cu*")):
        text = f.read_text()
        for m in re.finditer(r"__global__", text):
            end = text.find("{", m.end())
            found = _NAME.search(_strip_attributes(text[m.end():end]))
            if found:
                names.add(found.group(1))
    return tuple(sorted(names))


@functools.lru_cache(maxsize=None)
def port_kernels():
    """Every kernel the port writes by hand: the ``__global__`` functions
    of its ``csrc/`` folder."""
    import elfi_tpu_torch
    return kernels_in(Path(elfi_tpu_torch.__file__).resolve().parent
                      / "csrc")


def roofline(run, names, ops, nbytes, per=None):
    """100 x the least time of ``ops`` operations and ``nbytes`` bytes over
    the card's time per launch of the kernels named ``names`` (per launch
    of ``per``, where one piece of work launches several kernels); None
    where the trace has none of them."""
    if run.trace is None:
        return None
    seconds, count = run.trace.op_seconds(names)
    if per is not None:
        _, count = run.trace.op_seconds(per)
    if count == 0 or seconds <= 0:
        return None
    return 100.0 * peaks.bound_s(ops, nbytes) / (seconds / count)


def idle_share(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)

"""Order statistics on the card: each row of a short-row float32 tensor
sorted ascending by the CUDA kernel ``csrc/order_stats_sort.cu``, values
only; ``torch.sort`` for every other input.

Counterpart of ``jnp.sort(y, axis=1)`` in the JAX package's ``ss_order``
(``elfi_tpu/models/gnk.py``; XLA, not a Pallas kernel).  :func:`takes`
decides from the input alone: the kernel sorts a contiguous float32 CUDA
tensor of shape (batch, n) or (batch, n, 1), batch >= 1, 1 <= n <=
``MAX_N``, that autograd does not track.  The rest (the CPU, other
dtypes, longer rows, a trailing dimension above 1, a strided view, no
rows, an input that needs a gradient: the kernel has no backward) goes
to ``torch.sort(y, dim=1).values``, the plain version.  The kernel
returns the same values as ``torch.sort``, ties, +-inf and NaN (last)
included.

``sort_rows.launches`` counts the kernel's launches (``captured`` and
``graph_launches`` those recorded into CUDA graphs and launched by their
replays: :mod:`elfi_tpu_torch.utils.capture`); a call that takes
``torch.sort`` counts nothing.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...utils import capture
from . import _build

__all__ = ["sort_rows", "takes", "MAX_N"]

_LIB = "order_stats_sort"
_SOURCES = ("order_stats_sort.cu",)
_P = ctypes.c_void_p
#: the longest row the kernel sorts: its network's 64-row instance
MAX_N = 64


@functools.cache
def _lib():
    """Build (at first use) and bind the kernel library."""
    lib = _build.load(_LIB, _SOURCES)
    lib.elfi_order_stats_sort.argtypes = [_P, _P, ctypes.c_longlong,
                                          ctypes.c_int, ctypes.c_int, _P]
    lib.elfi_order_stats_sort.restype = ctypes.c_int
    lib.elfi_cuda_error_string.argtypes = [ctypes.c_int]
    lib.elfi_cuda_error_string.restype = ctypes.c_char_p
    return lib


def takes(y):
    """Whether the kernel sorts ``y`` (module docstring)."""
    return (isinstance(y, torch.Tensor) and y.device.type == "cuda"
            and y.dtype == torch.float32 and y.is_contiguous()
            and (y.ndim == 2 or (y.ndim == 3 and y.shape[2] == 1))
            and y.shape[0] >= 1 and 1 <= y.shape[1] <= MAX_N
            and not (y.requires_grad and torch.is_grad_enabled()))


def sort_rows(y):
    """``torch.sort(y, dim=1).values``: by the kernel where :func:`takes`
    holds, else by ``torch.sort`` itself."""
    if not takes(y):
        return torch.sort(y, dim=1).values
    batch, n = int(y.shape[0]), int(y.shape[1])
    device = y.device
    lib = _lib()
    out = torch.empty(y.shape, dtype=y.dtype, device=device)
    rc = lib.elfi_order_stats_sort(
        y.data_ptr(), out.data_ptr(), batch, n, device.index,
        torch.cuda.current_stream(device).cuda_stream)
    _build.raise_on(rc, lib, "elfi_order_stats_sort")
    capture.count(sort_rows)
    return out


capture.counted(sort_rows)

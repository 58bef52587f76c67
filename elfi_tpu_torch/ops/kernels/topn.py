"""Threshold-culled top-N merge: the wrapper of the CUDA kernel
``csrc/topn_cull.cu`` and its plain PyTorch version.

Counterpart of :func:`elfi_tpu.ops.topk.merge_core_culled` (XLA in the JAX
package, not Pallas).  :func:`topn_cull` launches the kernel for CUDA
tensors and raises if it cannot; it runs the plain version only for CPU
tensors.  ``topn_cull.launches`` counts the kernel launches (one host call
a merge), so a run can show it went through the kernel.

Both return ``(out, idx, n_accepted)``: the merged buffers (``"__key"``
and every column of the batch), the index map (entry i is buffer row
``idx[i]`` if ``idx[i] < n``, else batch row ``idx[i] - n``: the index
into the flat merge's concatenation) and the acceptance count as a 0-d
int64 tensor on the batch's device.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from .. import topk
from . import _build

__all__ = ["topn_cull", "topn_cull_reference", "kernel_width",
           "MAX_WIDTH"]

_LIB = "topn_cull"
_SOURCES = ("topn_cull.cu",)
_P = ctypes.c_void_p
#: the kernel's widest chunk: 2^14 packed pairs fill 128 KiB of shared
#: memory
MAX_WIDTH = 1 << 14


@functools.cache
def _lib():
    """Build (at first use) and bind the kernel library."""
    lib = _build.load(_LIB, _SOURCES)
    lib.elfi_topn_cull.argtypes = [
        _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
        _P, ctypes.c_int, ctypes.c_float,
        _P, ctypes.c_int, ctypes.c_int,
        _P, _P, _P, _P, _P, ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, _P]
    lib.elfi_topn_cull.restype = ctypes.c_int
    lib.elfi_cuda_error_string.argtypes = [ctypes.c_int]
    lib.elfi_cuda_error_string.restype = ctypes.c_char_p
    return lib


def kernel_width(widths):
    """The kernel's chunk width for a ``small_k`` cascade: the power of two
    at or above its widest width, within [32, :data:`MAX_WIDTH`].  The
    kernel sorts each chunk at the power of two above its survivors, so it
    picks a narrower width per merge by itself."""
    w = max(widths)
    return min(MAX_WIDTH, max(32, 1 << max(0, int(w) - 1).bit_length()))


def _widths(small_k):
    widths = tuple(small_k) if isinstance(small_k, (tuple, list)) \
        else (small_k,)
    if sorted(widths) != list(widths) or len(set(widths)) != len(widths):
        raise ValueError(f"small_k cascade must be ascending: {small_k!r}")
    return widths


def _gather(buffers, batch, idx, n):
    """Every column at the index map: buffer rows where ``idx < n``, batch
    rows elsewhere (the JAX function's ``jnp.take`` pair)."""
    from_buf = idx < n
    bidx = idx.clamp(max=n - 1)
    srow = (idx - n).clamp(min=0)
    out = {}
    for k, v in batch.items():
        bv = buffers[k]
        cond = from_buf.reshape((-1,) + (1,) * (bv.ndim - 1))
        out[k] = torch.where(cond, bv.index_select(0, bidx),
                             v.to(bv.dtype).index_select(0, srow))
    return out


def topn_cull_reference(buffers, batch, threshold, discrepancy_name,
                        small_k=1024):
    """Plain PyTorch version, line for line the JAX package's
    ``merge_core_culled`` past its small-batch rule: the candidates beating
    the buffer's N-th key are counted (a host read), the narrowest width of
    the cascade that holds them takes the first ``width`` of a stable sort
    of the masked keys, and the flat merge runs where none does."""
    widths = _widths(small_k)
    d = batch[discrepancy_name]
    ok = topk.accept_mask(d, threshold)
    keys_eff = torch.where(ok, topk.sort_key(d).to(torch.float32), math.inf)
    n = buffers["__key"].shape[0]
    kth = buffers["__key"][n - 1]
    beats = keys_eff < kth
    count = int(beats.sum())
    width = next((w for w in widths if count <= w), None)
    if width is None:
        cat = torch.cat([buffers["__key"], keys_eff])
        keys, idx = torch.sort(cat, stable=True)
        keys, idx = keys[:n], idx[:n]
    else:
        masked = torch.where(beats, keys_eff, math.inf)
        cand, cidx = torch.sort(masked, stable=True)
        cand, cidx = cand[:width], cidx[:width]
        keys, idx2 = torch.sort(torch.cat([buffers["__key"], cand]),
                                stable=True)
        keys, idx2 = keys[:n], idx2[:n]
        idx = torch.where(idx2 < n, idx2,
                          n + cidx.index_select(0, (idx2 - n).clamp(min=0)))
    out = {"__key": keys, **_gather(buffers, batch, idx, n)}
    return out, idx, ok.sum()


def _word(*values):
    """The widest copy unit (8, 4, 2 or 1 bytes) dividing every value."""
    for w in (8, 4, 2):
        if all(v % w == 0 for v in values):
            return w
    return 1


def _row_layout(v):
    """(row bytes, row stride in bytes) of a column whose rows are each
    contiguous, or None."""
    trail = tuple(v.shape[1:])
    expect = 1
    for size, stride in zip(reversed(trail), reversed(v.stride()[1:])):
        if size != 1 and stride != expect:
            return None
        expect *= size
    return expect * v.element_size(), v.stride(0) * v.element_size()


def topn_cull(buffers, batch, threshold, discrepancy_name, small_k=1024):
    """The culled merge of ``batch`` into the sorted ``buffers``; returns
    ``(out, idx, n_accepted)`` (module docstring).

    On CUDA one host call launches the kernel (no host read) with chunks
    of :func:`kernel_width` ``(small_k)``; on the CPU the plain version
    runs.  ``threshold`` is a number or a float32 tensor on the batch's
    device (one bound, or one per distance column)."""
    widths = _widths(small_k)
    d = batch[discrepancy_name]
    device = d.device
    if device.type == "cpu":
        return topn_cull_reference(buffers, batch, threshold,
                                   discrepancy_name, widths)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    bkeys = buffers["__key"]
    n, B = int(bkeys.shape[0]), int(d.shape[0])
    _build.check_tensor("buffers['__key']", bkeys, (n,), device)
    if n + B >= 0xFFFFFFFF:
        raise ValueError(f"buffer {n} + batch {B} rows exceed the kernel's "
                         "32-bit row index")

    # the distance and the threshold as the kernel reads them; any other
    # layout or dtype has its keys made here and compared against +inf
    n_acc = None
    thr_t = threshold if isinstance(threshold, torch.Tensor) else None
    thr_ok = (thr_t is None and isinstance(threshold, (int, float,
                                                       np.number))) or (
        thr_t is not None and thr_t.dtype == torch.float32
        and thr_t.device == device and thr_t.is_contiguous()
        and (thr_t.numel() == 1
             or (d.ndim == 2 and tuple(thr_t.shape) == (d.shape[1],))))
    if (d.dtype == torch.float32 and d.ndim in (1, 2) and thr_ok
            and (d.ndim == 1 or d.stride(1) == 1 or d.shape[1] == 1)):
        cols = 1 if d.ndim == 1 else int(d.shape[1])
        ld = int(d.stride(0))
        if thr_t is None:
            thr_len, thr_ptr = 0, None
            thr_scalar = float(np.float32(threshold))
        else:
            thr_len = 1 if thr_t.numel() == 1 else cols
            thr_ptr, thr_scalar = thr_t.data_ptr(), 0.0
        dk = d
    else:
        ok = topk.accept_mask(d, threshold)
        dk = torch.where(ok, topk.sort_key(d).to(torch.float32), math.inf)
        n_acc = ok.sum()
        cols, ld, thr_len, thr_ptr, thr_scalar = 1, 1, 0, None, math.inf

    names = list(batch)
    srcs, outs = [], {}
    for k in names:
        bv = buffers[k]
        v = batch[k]
        if v.dtype != bv.dtype:
            v = v.to(bv.dtype)
        if tuple(v.shape[1:]) != tuple(bv.shape[1:]) or v.shape[0] != B:
            raise ValueError(f"column {k!r}: batch {tuple(v.shape)} does "
                             f"not match buffer {tuple(bv.shape)}")
        if v.device != device or bv.device != device:
            raise ValueError(f"column {k!r} is not on {device}")
        if not bv.is_contiguous():
            bv = bv.contiguous()
        layout = _row_layout(v)
        if layout is None:
            v = v.contiguous()
            layout = _row_layout(v)
        outs[k] = torch.empty_like(bv)
        srcs.append((bv, v, layout))

    lib = _lib()
    small = torch.empty(2 + n, dtype=torch.int64, device=device)
    counters, out_idx = small[:2], small[2:]
    scratch = torch.empty(B + 2 * n, dtype=torch.int64, device=device)
    out_keys = torch.empty(n, dtype=torch.float32, device=device)
    nc = len(names)
    col_buf = (ctypes.c_void_p * max(nc, 1))(
        *(bv.data_ptr() for bv, _, _ in srcs))
    col_batch = (ctypes.c_void_p * max(nc, 1))(
        *(v.data_ptr() for _, v, _ in srcs))
    col_out = (ctypes.c_void_p * max(nc, 1))(
        *(outs[k].data_ptr() for k in names))
    row_bytes = (ctypes.c_longlong * max(nc, 1))(
        *(lay[0] for _, _, lay in srcs))
    strides = (ctypes.c_longlong * max(nc, 1))(
        *(lay[1] for _, _, lay in srcs))
    words = (ctypes.c_int * max(nc, 1))(
        *(_word(lay[0], lay[1], bv.data_ptr(), v.data_ptr())
          for bv, v, lay in srcs))
    rc = lib.elfi_topn_cull(
        dk.data_ptr(), B, cols, ld, thr_ptr, thr_len, thr_scalar,
        bkeys.data_ptr(), n, kernel_width(widths),
        counters.data_ptr(), scratch[2 * n:].data_ptr(), scratch.data_ptr(),
        out_keys.data_ptr(), out_idx.data_ptr(), nc,
        col_buf, col_batch, col_out, row_bytes, strides, words,
        device.index, torch.cuda.current_stream(device).cuda_stream)
    _build.raise_on(rc, lib, "elfi_topn_cull")
    topn_cull.launches += 1
    out = {"__key": out_keys, **outs}
    return out, out_idx, (counters[0] if n_acc is None else n_acc)


topn_cull.launches = 0

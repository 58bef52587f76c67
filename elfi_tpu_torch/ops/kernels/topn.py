"""Threshold-culled top-N merge: the wrapper of the CUDA kernel
``csrc/topn_cull.cu`` and its plain PyTorch version.

Counterpart of :func:`elfi_tpu.ops.topk.merge_core_culled` (XLA in the JAX
package, not Pallas).  :func:`topn_cull` launches the kernel for CUDA
tensors and raises if it cannot; it runs the plain version only for CPU
tensors.  ``topn_cull.launches`` counts the kernel's host calls (one a
merge, each launching a scan and a merge kernel), so a run can show it
went through the kernel; ``captured`` and ``graph_launches`` count the
calls recorded into CUDA graphs and launched by their replays
(:mod:`elfi_tpu_torch.utils.capture`).  A plan whose call a graph captured
lives as long as that graph.

Both return ``(out, idx, n_accepted)``: the merged buffers (``"__key"``
and every column of the batch), the index map (entry i is buffer row
``idx[i]`` if ``idx[i] < n``, else batch row ``idx[i] - n``: the index
into the flat merge's concatenation) and the acceptance count as a 0-d
int64 tensor on the batch's device.

The host's part of a merge is kept lean: a plan, cached by everything that
fixes the kernel's arguments but the data (device, stream, batch size,
buffer size, the distance's and the columns' dtypes, shapes and layouts,
the threshold's kind), holds the argument block the kernel reads, the
column tables and the scratch the kernel reuses on its stream.  A call
sets the data pointers, allocates what it returns (one tensor per dtype
and trailing shape of the keys and columns, split into rows, and one for
the index map and the acceptance count) and makes one ctypes call.
"""

from __future__ import annotations

import ctypes
import functools
import math
import numbers

import torch

from ...utils import capture
from .. import topk
from . import _build

__all__ = ["topn_cull", "topn_cull_reference", "CLUSTER_BLOCKS", "TILE",
           "CAPACITY", "COUNT_SORT", "LOCAL_TILES", "KEY_STAGE"]

_LIB = "topn_cull"
_SOURCES = ("topn_cull.cu",)
_P = ctypes.c_void_p
_I = ctypes.c_longlong

# The kernel's constants (csrc/topn_cull.cu; a CPU test holds them equal).
#: blocks of the merge kernel's cluster
CLUSTER_BLOCKS = 8
#: candidates a block sorts in one pass
TILE = 4096
#: candidates the merge takes in one pass; a larger count takes more
CAPACITY = CLUSTER_BLOCKS * TILE
#: a block's share of a pass sorted by counting (bitonic above)
COUNT_SORT = 512
#: the candidates of a pass up to which every block holds a copy of every
#: tile (above, the tiles are searched through distributed shared memory)
LOCAL_TILES = 16384
#: the buffer's keys staged in shared memory (a larger buffer is searched
#: in device memory)
KEY_STAGE = 8192
#: plans kept per process; the oldest is dropped first
MAX_PLANS = 16


class _CullCall(ctypes.Structure):
    """``CullCall`` of ``csrc/topn_cull.cu``, field for field (each 8
    bytes wide, so no padding can differ)."""
    _fields_ = [("d", _P), ("batch", _I), ("cols", _I), ("ld", _I),
                ("thr_vec", _P), ("thr_len", _I),
                ("thr_scalar", ctypes.c_double), ("buf_keys", _P),
                ("n", _I), ("scratch", _P),
                ("out_keys", _P), ("out_idx", _P), ("out_acc", _P),
                ("n_columns", _I), ("col_buf", _P), ("col_batch", _P),
                ("col_out", _P), ("row_bytes", _P), ("batch_stride", _P),
                ("device", _I), ("stream", _P)]


@functools.cache
def _lib():
    """Build (at first use) and bind the kernel library."""
    lib = _build.load(_LIB, _SOURCES)
    lib.elfi_topn_cull.argtypes = [ctypes.POINTER(_CullCall)]
    lib.elfi_topn_cull.restype = ctypes.c_int
    lib.elfi_cuda_error_string.argtypes = [ctypes.c_int]
    lib.elfi_cuda_error_string.restype = ctypes.c_char_p
    return lib


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


def _reference(buffers, batch, threshold, discrepancy_name, widths):
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


def topn_cull_reference(buffers, batch, threshold, discrepancy_name,
                        small_k=1024):
    """Plain PyTorch version, line for line the JAX package's
    ``merge_core_culled`` past its small-batch rule: the candidates beating
    the buffer's N-th key are counted (a host read), the narrowest width of
    the cascade that holds them takes the first ``width`` of a stable sort
    of the masked keys, and the flat merge runs where none does."""
    return _reference(buffers, batch, threshold, discrepancy_name,
                      _widths(small_k))


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


def _raw_stream(index):
    """The current stream of CUDA device ``index`` as a ``cudaStream_t``
    (an int): PyTorch's own accessor for generated kernels, a few
    microseconds cheaper a call than ``torch.cuda.current_stream``."""
    return torch._C._cuda_getCurrentRawStream(index)


def _threshold_kind(threshold):
    if isinstance(threshold, torch.Tensor):
        return (threshold.dtype, threshold.shape, threshold.get_device(),
                threshold.is_contiguous())
    return type(threshold)


def _plan_key(buffers, batch, threshold, discrepancy_name, stream):
    """Everything that fixes the kernel's arguments but the data."""
    d = batch[discrepancy_name]
    bkeys = buffers["__key"]
    cols = []
    for k, v in batch.items():
        bv = buffers[k]
        cols.append((k, v.dtype, v.shape, v.stride(), v.get_device(),
                     bv.dtype, bv.shape, bv.is_contiguous(),
                     bv.get_device()))
    return (discrepancy_name, d.get_device(), stream, d.dtype, d.shape,
            d.stride(), bkeys.dtype, bkeys.shape, bkeys.is_contiguous(),
            bkeys.get_device(), _threshold_kind(threshold), tuple(cols))


class _Plan:
    """The kernel's arguments for one plan key (module docstring), checked
    once; :meth:`__call__` runs one merge."""

    def __init__(self, key, buffers, batch, threshold, discrepancy_name,
                 device, stream):
        d = batch[discrepancy_name]
        bkeys = buffers["__key"]
        n, B = int(bkeys.shape[0]), int(d.shape[0])
        _build.check_tensor("buffers['__key']", bkeys, (n,), device)
        if n + B >= 0xFFFFFFFF:
            raise ValueError(f"buffer {n} + batch {B} rows exceed the "
                             "kernel's 32-bit row index")
        self.key, self.device, self.name = key, device, discrepancy_name
        self.n = n

        # the distance and the threshold as the kernel reads them; any
        # other layout or dtype has its keys made here, compared with +inf
        thr_t = threshold if isinstance(threshold, torch.Tensor) else None
        thr_ok = (thr_t is None and isinstance(threshold, numbers.Real)) or (
            thr_t is not None and thr_t.dtype == torch.float32
            and thr_t.device == device and thr_t.is_contiguous()
            and (thr_t.numel() == 1
                 or (d.ndim == 2 and tuple(thr_t.shape) == (d.shape[1],))))
        self.direct = (d.dtype == torch.float32 and d.ndim in (1, 2)
                       and thr_ok and (d.ndim == 1 or d.stride(1) == 1
                                       or d.shape[1] == 1))
        call = _CullCall(batch=B, n=n, device=device.index, stream=stream)
        if self.direct:
            call.cols = 1 if d.ndim == 1 else int(d.shape[1])
            call.ld = int(d.stride(0))
            call.thr_len = 0 if thr_t is None else (
                1 if thr_t.numel() == 1 else call.cols)
        else:
            call.cols, call.ld, call.thr_len = 1, 1, 0
            call.thr_scalar = math.inf
        self.thr_tensor = thr_t is not None and self.direct

        # columns: the buffer's rows contiguous, the batch's each contiguous
        # and of the buffer's dtype, or made so per call
        self.names = list(batch)
        self.fix_buf, self.fix_batch = [], []
        nc = len(self.names)
        self.col_buf = (_P * max(nc, 1))()
        self.col_batch = (_P * max(nc, 1))()
        self.col_out = (_P * max(nc, 1))()
        self.row_bytes = (_I * max(nc, 1))()
        self.batch_stride = (_I * max(nc, 1))()
        # what a call returns: the keys and the columns in one tensor per
        # (dtype, trailing shape), split into its rows; the index map and
        # the acceptance count in one int64 tensor of n + 1
        groups = {(torch.float32, ()): [-1]}            # -1: "__key"
        for i, k in enumerate(self.names):
            bv, v = buffers[k], batch[k]
            if tuple(v.shape[1:]) != tuple(bv.shape[1:]) or v.shape[0] != B:
                raise ValueError(f"column {k!r}: batch {tuple(v.shape)} does "
                                 f"not match buffer {tuple(bv.shape)}")
            if v.device != device or bv.device != device:
                raise ValueError(f"column {k!r} is not on {device}")
            convert = v.dtype != bv.dtype
            layout = None if convert else _row_layout(v)
            self.fix_batch.append(convert or layout is None)
            self.fix_buf.append(not bv.is_contiguous())
            row = math.prod(bv.shape[1:]) * bv.element_size()
            self.row_bytes[i] = row
            self.batch_stride[i] = layout[1] if layout else row
            groups.setdefault((bv.dtype, tuple(bv.shape[1:])), []).append(i)
        # (dtype, shape, bytes a member, [column index, -1 for the keys])
        self.groups = [(dtype, (len(members), n) + trail,
                        n * math.prod(trail) * torch.empty(
                            (), dtype=dtype).element_size(), members)
                       for (dtype, trail), members in groups.items()]
        call.n_columns = nc
        for field in ("col_buf", "col_batch", "col_out", "row_bytes",
                      "batch_stride"):
            setattr(call, field, ctypes.cast(getattr(self, field), _P))
        # scratch on the stream: two counters (zero; the kernel leaves them
        # zero), the candidates, two run buffers, a pass's sorted candidates
        self.scratch = torch.empty(2 + B + 2 * n + CAPACITY,
                                   dtype=torch.int64, device=device)
        self.scratch[:2].zero_()
        call.scratch = self.scratch.data_ptr()
        self.call = call
        self.call_ptr = ctypes.pointer(call)

    def __call__(self, buffers, batch, threshold, lib):
        call = self.call
        d = batch[self.name]
        n_acc = None
        if self.direct:
            call.d = d.data_ptr()
            if self.thr_tensor:
                call.thr_vec = threshold.data_ptr()
            else:
                call.thr_scalar = float(threshold)
        else:
            ok = topk.accept_mask(d, threshold)
            dk = torch.where(ok, topk.sort_key(d).to(torch.float32),
                             math.inf)
            n_acc = ok.sum()
            call.d = dk.data_ptr()
        call.buf_keys = buffers["__key"].data_ptr()
        keep = []       # converted columns, alive until the launch
        for i, k in enumerate(self.names):
            bv, v = buffers[k], batch[k]
            if self.fix_buf[i]:
                bv = bv.contiguous()
                keep.append(bv)
            if self.fix_batch[i]:
                v = v.to(bv.dtype).contiguous()
                keep.append(v)
            self.col_buf[i] = bv.data_ptr()
            self.col_batch[i] = v.data_ptr()

        parts = [None] * (len(self.names) + 1)      # the keys last
        for dtype, shape, nbytes, members in self.groups:
            rows = torch.empty(shape, dtype=dtype, device=self.device)
            base = rows.data_ptr()
            for j, (i, part) in enumerate(zip(members, rows.unbind(0))):
                parts[i] = part
                if i == -1:
                    call.out_keys = base + j * nbytes
                else:
                    self.col_out[i] = base + j * nbytes
        idx_acc = torch.empty(self.n + 1, dtype=torch.int64,
                              device=self.device)
        call.out_idx = idx_acc.data_ptr()
        call.out_acc = call.out_idx + 8 * self.n
        rc = lib.elfi_topn_cull(self.call_ptr)
        if rc != 0:
            # the scratch's counters may be left non-zero
            _plans.pop(self.key, None)
            _build.raise_on(rc, lib, "elfi_topn_cull")
        capture.count(topn_cull)
        # a graph that captured this call keeps the plan's scratch
        capture.hold(self)
        if n_acc is None:
            n_acc = idx_acc[self.n]
        out = {"__key": parts[-1]}
        out.update(zip(self.names, parts))
        return out, idx_acc[:self.n], n_acc


#: plan key -> _Plan, oldest first
_plans = {}


def _cull(buffers, batch, threshold, discrepancy_name, widths):
    """:func:`topn_cull` with the cascade already checked."""
    d = batch[discrepancy_name]
    if not d.is_cuda:
        if d.device.type == "cpu":
            return _reference(buffers, batch, threshold, discrepancy_name,
                              widths)
        raise ValueError(f"unsupported device {d.device}")
    lib = _lib()
    stream = _raw_stream(d.get_device())
    key = _plan_key(buffers, batch, threshold, discrepancy_name, stream)
    plan = _plans.get(key)
    if plan is None:
        plan = _Plan(key, buffers, batch, threshold, discrepancy_name,
                     d.device, stream)
        if len(_plans) >= MAX_PLANS:
            _plans.pop(next(iter(_plans)))
        _plans[key] = plan
    return plan(buffers, batch, threshold, lib)


def topn_cull(buffers, batch, threshold, discrepancy_name, small_k=1024):
    """The culled merge of ``batch`` into the sorted ``buffers``; returns
    ``(out, idx, n_accepted)`` (module docstring).

    On CUDA one host call launches the kernel's scan and merge (no host
    read, no memset), exact for any candidate count: ``small_k`` is
    checked but the kernel needs no width.  On the CPU the plain version
    runs the cascade.  ``threshold`` is a number or a float32 tensor on the
    batch's device (one bound, or one per distance column)."""
    return _cull(buffers, batch, threshold, discrepancy_name,
                 _widths(small_k))


capture.counted(topn_cull)

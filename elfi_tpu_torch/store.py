"""Output pools: store and replay per-batch node outputs (counterpart of
:mod:`elfi_tpu.store`; the stores are numpy, as there).

Pools serve two purposes:

1. persistence of simulations (every stored node's outputs, per batch
   index);
2. replay: when an inference runs a batch index whose outputs are pooled,
   :class:`~elfi_tpu_torch.parallel.batches.BatchHandler` hands the stored
   values to the program as overrides, copied onto its device, instead of
   simulating again.

``add_batch`` copies each pooled output off the card explicitly (a CUDA
tensor has no ``__array__``), once a batch and for the pooled names only.
A ``.npy`` file written by :class:`NpyArray` is a standard version 1.0
file: ``np.load`` and the JAX package's ``NpyArray`` open it.
"""

from __future__ import annotations

import io
import os
import pickle
import shutil

import numpy as np
import torch

from .utils import to_numpy

__all__ = ["OutputPool", "ArrayPool", "ArrayStore", "NpyStore", "NpyArray"]


def _host_copy(x):
    """A batch output as a numpy array the pool owns: a tensor is copied
    to the host once (off the card, or out of a CPU tensor's buffer)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x)


class OutputPool:
    """Dict of stores keyed by node name."""

    _pkl_name = "_outputpool.pkl"

    def __init__(self, outputs=None, name=None, prefix=None):
        if outputs is None:
            stores = {}
        elif isinstance(outputs, dict):
            stores = outputs
        else:
            stores = dict.fromkeys(outputs)
        self.stores = stores
        self.batch_size = None
        self.seed = None
        self.name = name
        self.prefix = prefix or "pools"

    # -- context binding ------------------------------------------------------
    @property
    def has_context(self):
        return self.seed is not None and self.batch_size is not None

    def set_context(self, context):
        """Bind to a ComputationContext; a pool is only valid for a single
        (seed, batch_size) pair."""
        if self.has_context:
            if (self.batch_size != context.batch_size
                    or self.seed != context.seed):
                raise ValueError(
                    "Pool is already bound to a different context "
                    f"(batch_size={self.batch_size}, seed={self.seed})")
            return
        self.batch_size = context.batch_size
        self.seed = context.seed

    # -- batch access ------------------------------------------------------------
    @property
    def output_names(self):
        return list(self.stores)

    def get_batch(self, batch_index, outputs=None):
        outputs = outputs or self.output_names
        batch = {}
        for name in outputs:
            store = self.stores.get(name)
            if store is not None and batch_index in store:
                batch[name] = store[batch_index]
        return batch

    def add_batch(self, batch, batch_index):
        """Store the pooled names of ``batch``; tensors are copied to the
        host here, and only for a batch index not stored yet."""
        for name, store in self.stores.items():
            if store is None:
                store = self._make_store_for(name)
                self.stores[name] = store
            if name in batch and batch_index not in store:
                store[batch_index] = _host_copy(batch[name])

    def remove_batch(self, batch_index):
        for store in self.stores.values():
            if store is not None and batch_index in store:
                del store[batch_index]

    def __contains__(self, batch_index):
        return all(store is not None and batch_index in store
                   for store in self.stores.values())

    def __len__(self):
        """Number of completed batches (min over stores)."""
        lens = [len(s) for s in self.stores.values() if s is not None]
        return min(lens) if lens else 0

    # -- store access ----------------------------------------------------------------
    def __getitem__(self, node):
        return self.stores[node]

    def __setitem__(self, node, store):
        self.stores[node] = store

    def get_store(self, node):
        return self.stores[node]

    def add_store(self, node, store=None):
        if node in self.stores and self.stores[node] is not None:
            raise ValueError(f"Store for {node!r} already exists")
        self.stores[node] = store if store is not None \
            else self._make_store_for(node)

    def remove_store(self, node):
        store = self.stores.pop(node)
        return store

    def clear(self):
        for store in self.stores.values():
            if store is not None and hasattr(store, "clear"):
                store.clear()

    def _make_store_for(self, name):
        return {}

    # -- persistence -----------------------------------------------------------------
    @property
    def path(self):
        if self.name is None:
            return None
        return os.path.join(self.prefix, self.name)

    def save(self):
        """Pickle the pool under ``prefix/name``."""
        if self.name is None:
            raise ValueError("Pool must have a name to be saved")
        os.makedirs(self.path, exist_ok=True)
        for store in self.stores.values():
            if hasattr(store, "flush"):
                store.flush()
        with open(os.path.join(self.path, self._pkl_name), "wb") as f:
            pickle.dump(self, f)

    def flush(self):
        for store in self.stores.values():
            if hasattr(store, "flush"):
                store.flush()

    def close(self):
        self.flush()
        for store in self.stores.values():
            if hasattr(store, "close"):
                store.close()

    @classmethod
    def open(cls, name, prefix=None):
        path = os.path.join(prefix or "pools", name, cls._pkl_name)
        with open(path, "rb") as f:
            return pickle.load(f)

    def delete(self):
        if self.path and os.path.isdir(self.path):
            self.close()
            shutil.rmtree(self.path)


class ArrayPool(OutputPool):
    """OutputPool whose default store is an appendable ``.npy`` file per
    node."""

    def __init__(self, outputs=None, name=None, prefix=None):
        super().__init__(outputs, name, prefix)
        if self.name is None:
            self.name = f"arraypool_{np.random.randint(10**9)}"

    def _make_store_for(self, name):
        if self.batch_size is None:
            raise ValueError("Pool needs a context (set by inference) "
                             "before stores can be created")
        os.makedirs(self.path, exist_ok=True)
        npy = NpyArray(os.path.join(self.path, f"{name}.npy"))
        return NpyStore(npy, batch_size=self.batch_size)


class ArrayStore:
    """Map batch_index -> slice of a contiguous array."""

    def __init__(self, array, batch_size, n_batches=0):
        self.array = array
        self.batch_size = batch_size
        self.n_batches = n_batches

    def __getitem__(self, batch_index):
        if batch_index not in self:
            raise KeyError(batch_index)
        sl = slice(batch_index * self.batch_size,
                   (batch_index + 1) * self.batch_size)
        return self.array[sl]

    def __setitem__(self, batch_index, data):
        if batch_index > self.n_batches:
            raise IndexError("Appending further than the end of the store")
        sl = slice(batch_index * self.batch_size,
                   (batch_index + 1) * self.batch_size)
        if sl.stop > len(self.array):
            if hasattr(self.array, "append") and batch_index == self.n_batches:
                self.array.append(np.asarray(to_numpy(data)))
            else:
                raise IndexError("Store is full")
        else:
            self.array[sl] = to_numpy(data)
        self.n_batches = max(self.n_batches, batch_index + 1)

    def __delitem__(self, batch_index):
        if batch_index not in self:
            raise KeyError(batch_index)
        if batch_index != self.n_batches - 1:
            raise IndexError("Only the last batch can be removed")
        self.n_batches -= 1
        if hasattr(self.array, "truncate"):
            self.array.truncate(self.n_batches * self.batch_size)

    def __contains__(self, batch_index):
        return 0 <= batch_index < self.n_batches

    def __len__(self):
        return self.n_batches

    def clear(self):
        self.n_batches = 0
        if hasattr(self.array, "truncate"):
            self.array.truncate(0)

    def flush(self):
        if hasattr(self.array, "flush"):
            self.array.flush()

    def close(self):
        if hasattr(self.array, "close"):
            self.array.close()


class NpyStore(ArrayStore):
    """ArrayStore over an appendable ``.npy`` file."""

    def __init__(self, file, batch_size):
        array = file if isinstance(file, NpyArray) else NpyArray(file)
        n_batches = len(array) // batch_size if array.initialized else 0
        super().__init__(array, batch_size, n_batches)


class NpyArray:
    """Appendable numpy ``.npy`` (format v1.0) file: the header is padded
    so the shape entry can be rewritten in place as rows are appended;
    reads go through ``np.memmap``.  Only the leading axis grows.  The
    layout is the JAX package's, byte for byte."""

    MAGIC = b"\x93NUMPY\x01\x00"
    HEADER_SPACE = 246  # header body budget; total preamble = 256 bytes

    def __init__(self, filename, array=None):
        self.filename = filename
        self.fs = None
        self.shape = None
        self.dtype = None
        self.row_size = None  # bytes per leading-axis row
        if os.path.exists(filename) and os.path.getsize(filename) > 0:
            self._open_existing()
        if array is not None:
            self.append(array)

    # -- properties --------------------------------------------------------------
    @property
    def initialized(self):
        return self.shape is not None

    def __len__(self):
        return self.shape[0] if self.initialized else 0

    @property
    def size(self):
        return int(np.prod(self.shape)) if self.initialized else 0

    # -- io ----------------------------------------------------------------------
    def _header_bytes(self, shape):
        d = {"descr": np.lib.format.dtype_to_descr(self.dtype),
             "fortran_order": False, "shape": tuple(shape)}
        body = repr(d).encode("latin1")
        pad = self.HEADER_SPACE - len(body) - 1
        if pad < 0:
            raise ValueError("Header does not fit in reserved space")
        return body + b" " * pad + b"\n"

    def _write_header(self, shape):
        self.fs.seek(0)
        self.fs.write(self.MAGIC)
        self.fs.write(np.uint16(self.HEADER_SPACE).tobytes())
        self.fs.write(self._header_bytes(shape))

    def _open_existing(self):
        with open(self.filename, "rb") as f:
            np.lib.format.read_magic(f)
            shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
        self.shape = list(shape)
        self.dtype = dtype
        self.row_size = int(np.prod(shape[1:])) * dtype.itemsize
        self.fs = open(self.filename, "r+b")

    def _init_from(self, data):
        self.dtype = data.dtype
        self.shape = [0] + list(data.shape[1:])
        self.row_size = int(np.prod(data.shape[1:])) * data.dtype.itemsize
        os.makedirs(os.path.dirname(self.filename) or ".", exist_ok=True)
        self.fs = open(self.filename, "w+b")
        self._write_header(self.shape)

    @property
    def _data_start(self):
        return len(self.MAGIC) + 2 + self.HEADER_SPACE

    def append(self, data):
        data = np.asarray(to_numpy(data))
        if not self.initialized:
            self._init_from(data)
        if list(data.shape[1:]) != self.shape[1:]:
            raise ValueError(
                f"Appended data shape {data.shape[1:]} does not match "
                f"stored shape {tuple(self.shape[1:])}")
        data = np.ascontiguousarray(data, dtype=self.dtype)
        self.fs.seek(self._data_start + self.shape[0] * self.row_size)
        self.fs.write(data.tobytes())
        self.shape[0] += data.shape[0]
        self._write_header(self.shape)
        self.fs.flush()

    def truncate(self, length):
        if not self.initialized:
            return
        self.shape[0] = int(length)
        self._write_header(self.shape)
        self.fs.truncate(self._data_start + self.shape[0] * self.row_size)
        self.fs.flush()

    def _memmap(self):
        return np.memmap(self.filename, dtype=self.dtype, mode="r",
                         offset=self._data_start, shape=tuple(self.shape))

    def __getitem__(self, sl):
        if not self.initialized:
            raise IndexError("Empty array")
        return np.array(self._memmap()[sl])

    def __setitem__(self, sl, value):
        mm = np.memmap(self.filename, dtype=self.dtype, mode="r+",
                       offset=self._data_start, shape=tuple(self.shape))
        mm[sl] = value
        mm.flush()

    def __array__(self, dtype=None):
        arr = self[:]
        return arr.astype(dtype) if dtype else arr

    def flush(self):
        if self.fs:
            self.fs.flush()

    def close(self):
        if self.fs:
            self.fs.close()
            self.fs = None

    def delete(self):
        self.close()
        if os.path.exists(self.filename):
            os.remove(self.filename)
        self.shape = None

    # pickled by filename
    def __getstate__(self):
        return {"filename": self.filename}

    def __setstate__(self, state):
        self.__init__(state["filename"])

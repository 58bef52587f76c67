"""Operation tools: vectorization helpers and external (native) simulators
(counterpart of :mod:`elfi_tpu.model.tools`).

Two vectorization paths:

- :func:`vectorize_traced` wraps a per-realization torch function with
  ``torch.func.vmap``, so the whole batch runs as batched tensor ops on the
  program's device.
- :func:`vectorize` is a host loop for numpy scalar simulators; the op it
  returns is host-only, so its graph runs through the host executor.

:func:`external_operation` wraps any shell command as a node op (the
file-handshake bridge that keeps native simulators first-class, e.g. the
C++ BDM simulator of :mod:`elfi_tpu_torch.models.bdm`).
"""

from __future__ import annotations

import subprocess
from functools import partial

import numpy as np
import torch

from ..utils import get_sub_seed, is_array

__all__ = ["vectorize", "vectorize_traced", "run_vectorized",
           "external_operation", "run_external", "stdout_to_array",
           "unpack_meta", "prepare_seed", "mark_host", "is_host_op"]


def mark_host(fn):
    """Mark an operation as host-only (numpy in, numpy out); the node DSL
    reads the mark and routes the graph through the host executor."""
    fn._elfi_host = True
    return fn


def is_host_op(fn):
    return getattr(fn, "_elfi_host", False)


# ---------------------------------------------------------------------------
# vectorization with torch.func.vmap
# ---------------------------------------------------------------------------

def vectorize_traced(operation, constants=None):
    """Vectorize a per-realization torch function over the batch with
    ``torch.func.vmap``.

    ``operation(*single_inputs)`` works on one realization and draws its
    noise from torch's default generator (``torch.randn`` and the like,
    with no ``generator=``); the returned op has the simulator signature
    ``(*batch_inputs, batch_size, generator)``.

    ``vmap`` has no per-row ``torch.Generator``, so the op runs the map
    with ``randomness="different"`` (each member its own draws) inside
    ``torch.random.fork_rng`` on the node's device, with the default
    generator seeded from ``generator.initial_seed()``, the node's stream
    seed.  A draw is therefore a function of (seed, batch, node), as every
    other node's, and the caller's default generator is left as it was.
    """
    return _VmappedOp(operation, constants)


class _VmappedOp:
    """The op :func:`vectorize_traced` returns: a class rather than a
    closure, so that a model holding it pickles (``Model.save``)."""

    def __init__(self, operation, constants=None):
        self.operation = operation
        self.constants = set(constants or ())

    def __call__(self, *inputs, batch_size, generator):
        operation, constants = self.operation, self.constants
        in_dims = tuple(0 if i not in constants and isinstance(
            x, torch.Tensor) and x.ndim > 0 else None
            for i, x in enumerate(inputs))
        device = generator.device
        if all(d is None for d in in_dims):
            # nothing to map over: map the batch index instead
            fixed = inputs

            def single(_):
                return operation(*fixed)
            inputs = (torch.arange(batch_size, device=device),)
            in_dims = (0,)
        else:
            single = operation
        fork = [] if device.type != "cuda" else [
            device.index if device.index is not None
            else torch.cuda.current_device()]
        with torch.random.fork_rng(devices=fork, device_type=device.type):
            if device.type == "cuda":
                torch.cuda.manual_seed(generator.initial_seed())
            else:
                torch.manual_seed(generator.initial_seed())
            return torch.func.vmap(single, in_dims=in_dims,
                                   randomness="different")(*inputs)


# ---------------------------------------------------------------------------
# host-loop vectorization
# ---------------------------------------------------------------------------

def run_vectorized(operation, *inputs, constants=None, dtype=None,
                   batch_size=None, **kwargs):
    """Run ``operation`` once per batch member (host loop)."""
    constants = [] if constants is None else list(constants)
    for i, inpt in enumerate(inputs):
        if i in constants:
            continue
        if is_array(inpt):
            length = len(inpt)
            if batch_size is None:
                batch_size = length
            elif batch_size != length:
                raise ValueError(
                    f"Batch size {batch_size} does not match input {i} "
                    f"length {length}; check the `constants` mask.")
        else:
            constants.append(i)
    if batch_size is None:
        batch_size = 1

    runs = np.empty(batch_size, dtype=object) if dtype is False else []
    for index_in_batch in range(batch_size):
        inputs_i = [inpt if i in constants else inpt[index_in_batch]
                    for i, inpt in enumerate(inputs)]
        if "meta" in kwargs:
            kwargs["meta"]["index_in_batch"] = index_in_batch
        output = operation(*inputs_i, **kwargs)
        if dtype is False:
            runs[index_in_batch] = output
        else:
            runs.append(output)
    if dtype is not False:
        runs = np.array(runs, dtype=dtype)
    return runs


def vectorize(operation, constants=None, dtype=None):
    """Loop-vectorize a scalar host operation; the op is host-only."""
    return mark_host(partial(run_vectorized, operation, constants=constants,
                             dtype=dtype))


# ---------------------------------------------------------------------------
# external operations
# ---------------------------------------------------------------------------

def unpack_meta(*inputs, **kwinputs):
    """Lift the ``meta`` dict entries into keyword inputs."""
    if "meta" in kwinputs:
        new_kwinputs = kwinputs["meta"].copy()
        new_kwinputs.update(kwinputs)
        kwinputs = new_kwinputs
    return inputs, kwinputs


def prepare_seed(*inputs, **kwinputs):
    """Derive an integer ``seed`` for the external process from the numpy
    ``random_state`` (and the member's ``index_in_batch``)."""
    if "random_state" in kwinputs:
        seed = kwinputs["random_state"].get_state()[1][0]
        sub_seed_index = kwinputs.get("index_in_batch") or 0
        kwinputs["seed"] = get_sub_seed(int(seed), sub_seed_index)
    return inputs, kwinputs


def stdout_to_array(stdout, *inputs, sep=" ", dtype=None, **kwinputs):
    """Parse one whitespace/sep-separated row of stdout into an array."""
    if isinstance(stdout, bytes):
        stdout = stdout.decode()
    parts = stdout.split() if sep == " " else stdout.split(sep)
    return np.array([p for p in parts if p != ""],
                    dtype=dtype or np.float64)


def run_external(command, *inputs, process_result=None, prepare_inputs=None,
                 stdout=True, subprocess_kwargs=None, **kwinputs):
    """Run a shell command once: format args, execute, process result."""
    inputs, kwinputs = unpack_meta(*inputs, **kwinputs)
    inputs, kwinputs = prepare_seed(*inputs, **kwinputs)
    if prepare_inputs:
        inputs, kwinputs = prepare_inputs(*inputs, **kwinputs)
    try:
        command = command.format(*inputs, **kwinputs)
    except KeyError as e:
        raise KeyError(f"The requested keyword {e} was not passed to the "
                       f'external operation: "{command}"') from None
    subprocess_kwargs_ = dict(shell=True, check=True)
    subprocess_kwargs_.update(subprocess_kwargs or {})
    completed = subprocess.run(command, **subprocess_kwargs_)
    result = completed.stdout if stdout else completed
    return process_result(result, *inputs, **kwinputs)


def external_operation(command, process_result=None, prepare_inputs=None,
                       sep=" ", stdout=True, subprocess_kwargs=None):
    """Wrap a shell command as a (host) operation.

    Format-string placeholders (``{0}``, ``{batch_size}``, ``{seed}``, ...)
    are filled from the node inputs and meta; stdout is parsed to a numpy
    array by default.
    """
    if process_result is None or isinstance(process_result, (str, np.dtype)):
        kwargs = dict(sep=sep)
        if isinstance(process_result, (str, np.dtype)):
            kwargs["dtype"] = str(process_result)
        process_result = partial(stdout_to_array, **kwargs)
        stdout = True
    if stdout is True:
        subprocess_kwargs = subprocess_kwargs or {}
        subprocess_kwargs["stdout"] = subprocess.PIPE
    return mark_host(partial(run_external, command,
                             process_result=process_result,
                             prepare_inputs=prepare_inputs, stdout=stdout,
                             subprocess_kwargs=subprocess_kwargs))

"""Birth-Death-Mutation model (Lintusaari et al. 2016) driven by the native
C++ simulator through the external-operation bridge (counterpart of
:mod:`elfi_tpu.models.bdm`).

The C++ source and its Makefile are in ``elfi_tpu_torch/models/cpp/``; no
binary is shipped.  :func:`ensure_executable` builds ``bdm`` with ``g++``
into the directory the caller names, and the simulator runs ``./bdm`` in
the working directory.  The simulator is an external process, so the
model graph runs through the host executor."""

from __future__ import annotations

import os
import subprocess
import warnings

import numpy as np

from ..model.model import Distance, Model, Prior, Simulator, Summary
from ..model.tools import external_operation

__all__ = ["BDM", "T1", "T2", "get_model", "get_sources_path",
           "ensure_executable"]


def prepare_inputs(*inputs, **kwinputs):
    """Write one parameter row per batch member to a unique input file."""
    alpha, delta, tau, N = inputs
    meta = kwinputs["meta"]
    rows = np.array([(a, d, t, n) for (a, d, t, n)
                     in np.broadcast(alpha, delta, tau, N)])
    filename = "{model_name}_{batch_index}_{submission_index}.txt".format(
        **meta)
    np.savetxt(filename, rows, fmt="%.4f %.4f %.4f %d")
    kwinputs["filename"] = filename
    kwinputs["output_filename"] = filename[:-4] + "_out.txt"
    return inputs, kwinputs


def process_result(completed_process, *inputs, **kwinputs):
    """Read back the simulated cluster-size rows and clean up."""
    output_filename = kwinputs["output_filename"]
    simulations = np.loadtxt(output_filename, dtype="int16")
    os.remove(kwinputs["filename"])
    os.remove(output_filename)
    return simulations


BDM = external_operation(
    "./bdm {filename} --seed {seed} --mode 1 > {output_filename}",
    prepare_inputs=prepare_inputs,
    process_result=process_result,
    stdout=False)


def T1(clusters):
    """Fraction of distinct genotypes."""
    clusters = np.atleast_2d(clusters)
    return np.sum(clusters > 0, axis=1) / np.sum(clusters, axis=1)


def T2(clusters, n=20):
    """Genetic diversity summary."""
    clusters = np.atleast_2d(clusters)
    return 1 - np.sum((clusters / n) ** 2, axis=1)


def get_sources_path():
    return os.path.join(os.path.dirname(os.path.realpath(__file__)), "cpp")


def ensure_executable(directory="."):
    """Build the ``bdm`` binary from the package's C++ source into
    ``directory`` (never into the package) unless it is there; returns its
    path, or None when ``g++`` fails."""
    exe = os.path.join(directory, "bdm")
    if os.path.isfile(exe):
        return exe
    src = os.path.join(get_sources_path(), "bdm.cpp")
    try:
        subprocess.run(["g++", "-std=c++17", "-O2", "-o", exe, src],
                       check=True, capture_output=True)
        return exe
    except (OSError, subprocess.CalledProcessError):
        return None


def get_model(alpha=0.2, delta=0, tau=0.198, N=20, seed_obs=None):
    """BDM inference model for alpha with the summary T1."""
    if seed_obs is None and N == 20:
        y = np.zeros(N, dtype="int16")
        data = np.array([6, 3, 2, 2, 1, 1, 1, 1, 1, 1, 1], dtype="int16")
        y[:len(data)] = data
    else:
        y = BDM(alpha, delta, tau, N,
                meta={"model_name": "bdm_obs", "batch_index": 0,
                      "submission_index": 0},
                random_state=np.random.RandomState(seed_obs))

    m = Model(name="bdm")
    Prior("uniform", .005, 2, model=m, name="alpha")
    sim = Simulator(BDM, m["alpha"], delta, tau, N, observed=y, model=m,
                    name="BDM")
    Summary(T1, m["BDM"], model=m, name="T1", host=True)
    Distance("minkowski", m["T1"], p=1, model=m, name="d")
    sim.uses_meta = True

    if not os.path.isfile("bdm") and not os.path.isfile("bdm.exe"):
        warnings.warn(
            "This model uses an external C++ simulator `bdm` that must be "
            f"compiled and available in the working directory. Sources: "
            f"{get_sources_path()} (or call "
            "elfi_tpu_torch.models.bdm.ensure_executable()).",
            RuntimeWarning)
    return m

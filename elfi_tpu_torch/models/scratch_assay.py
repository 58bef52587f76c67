"""Scratch assay cell-migration model (Johnston et al. 2014, Price et al.
2018; counterpart of :mod:`elfi_tpu.models.scratch_assay`).

The simulator is a sequential lattice process (each motility or
proliferation attempt sees the earlier moves of the same step), so it is
numpy on the host, one realization per batch member through
:func:`~elfi_tpu_torch.model.tools.vectorize`: a host model, run by the
host executor.  With the same ``RandomState``, :func:`cell_sim` draws the
same lattice as the JAX package's, so the observed data for ``seed_obs``
are the JAX package's without being stored."""

from __future__ import annotations

from functools import partial

import numpy as np

from ..model.model import Distance, Model, Prior, Simulator, Summary
from ..model.tools import vectorize

__all__ = ["cell_sim", "cell_summaries", "get_model"]


def _random_init(nrows, ncols, ncell, nrows_init, random_state=None):
    random_state = random_state or np.random
    init = np.zeros(nrows * ncols)
    init[:ncell] = 1.0
    init[:nrows_init * ncols] = random_state.permutation(
        init[:nrows_init * ncols])
    return init.reshape(nrows, ncols)


_MOVES = np.array([(1, 0), (-1, 0), (0, 1), (0, -1)])


def _random_move(coords, nrows, ncols, random_state):
    prop = np.asarray(coords) + _MOVES[random_state.choice(4)]
    return np.minimum(np.maximum(prop, 0), [nrows - 1, ncols - 1])


def cell_sim(pm, pp, init_arr=None, init_params=None, obs_period=12,
             obs_interval=1 / 12, tau=1 / 24, random_state=None):
    """One realization of the lattice process; (nrows, ncols, num_obs+1)."""
    random_state = random_state or np.random
    if init_arr is None:
        init_params = init_params or [27, 36, 100, 10]
        cell_arr = _random_init(*init_params, random_state=random_state)
    else:
        cell_arr = np.copy(init_arr)
    nrows, ncols = cell_arr.shape
    num_iter = int(obs_period / tau)
    obs_every = int(obs_interval / tau)
    num_obs = int(num_iter / obs_every)
    obs_arr = np.ones((num_obs + 1, nrows, ncols))
    obs_arr[0] = np.copy(cell_arr)

    for iteration in range(num_iter):
        num_cells = int(np.sum(cell_arr))
        coords = np.transpose(np.array(np.where(cell_arr)))
        if num_cells < nrows * ncols:
            # motility attempts (with replacement)
            cand = random_state.choice(num_cells, size=num_cells)
            cand = cand[random_state.uniform(size=num_cells) < pm]
            for cell in cand:
                new = _random_move(coords[cell], nrows, ncols, random_state)
                if cell_arr[new[0], new[1]] == 0:
                    cell_arr[coords[cell][0], coords[cell][1]] = 0
                    cell_arr[new[0], new[1]] = 1
                    coords[cell] = new
            # proliferation attempts
            cand = random_state.choice(num_cells, size=num_cells)
            cand = cand[random_state.uniform(size=num_cells) < pp]
            for cell in cand:
                new = _random_move(coords[cell], nrows, ncols, random_state)
                cell_arr[new[0], new[1]] = 1
        if (iteration + 1) % obs_every == 0:
            obs_arr[(iteration + 1) // obs_every] = np.copy(cell_arr)
    return np.transpose(obs_arr, (1, 2, 0))


def cell_summaries(x):
    """Consecutive-frame mismatches and the final count; (batch,
    num_obs+1)."""
    x = np.asarray(x)
    ds = np.sum(np.abs(x[:, :, :, :-1] - x[:, :, :, 1:]), axis=(1, 2))
    count = np.sum(x[:, :, :, -1], axis=(1, 2))[:, None]
    return np.concatenate((ds, count), axis=1)


def get_model(true_params=None, init_arr=None, init_params=None,
              seed_obs=None, obs_period=12, obs_interval=1 / 12, tau=1 / 24):
    """Scratch assay inference model."""
    if true_params is None:
        true_params = [0.25, 0.002]
    single = partial(cell_sim, init_arr=init_arr, init_params=init_params,
                     obs_period=obs_period, obs_interval=obs_interval,
                     tau=tau)
    y_obs = single(*true_params,
                   random_state=np.random.RandomState(seed_obs))
    m = Model(name="scratch_assay")
    Prior("uniform", 0, 1, model=m, name="pm")
    Prior("uniform", 0, 1, model=m, name="pp")
    Simulator(vectorize(single), m["pm"], m["pp"], observed=y_obs, model=m,
              name="sim")
    Summary(cell_summaries, m["sim"], model=m, name="S", host=True)
    Distance("euclidean", m["S"], model=m, name="d")
    return m

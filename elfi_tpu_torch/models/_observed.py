"""Observed data: the inputs of a model's draw at ``batch_size=1``, and
the JAX package's arrays, committed beside the port's models, that the
generator is held to.

Each model's ``observed_data`` draws its noise from
:mod:`elfi_tpu_torch.utils.threefry` under ``key(seed_obs or 0)``, along
the JAX simulator's key tree, and passes it to the port's transform.  The
``.npz`` files hold the JAX package's draws for a few settings; no model
reads them, the tests and ``chip_smoke.py`` compare the generator with
them (:func:`load_observed`, :func:`load_observed_setting`).  A setting
is drawn once a process on each device (:func:`memoised`): an event
loop at batch 1 takes seconds on the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..parallel.backends import resolve_device
from ..utils import threefry

__all__ = ["load_observed", "load_observed_setting", "setting_key",
           "observed_key", "true_values", "first_row", "memoised"]

_MEMO = {}


def _frozen(v):
    """``v`` as a hashable value: arrays by dtype, shape and bytes,
    sequences and mappings element by element."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    if isinstance(v, np.ndarray):
        return ("array", v.dtype.str, v.shape, v.tobytes())
    if isinstance(v, (list, tuple)):
        return tuple(_frozen(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _frozen(x)) for k, x in v.items()))
    return v.item() if isinstance(v, np.generic) else v


def memoised(observed_data):
    """``observed_data`` drawn once a process for each setting and device
    (None: the global backend's, resolved at the call), kept in memory
    only; each call returns a copy of the array."""
    @functools.wraps(observed_data)
    def draw(*args, device=None, **kwargs):
        device = resolve_device(device)
        key = (observed_data.__module__, observed_data.__qualname__,
               _frozen(args), _frozen(kwargs), str(device))
        if key not in _MEMO:
            _MEMO[key] = observed_data(*args, device=device, **kwargs)
        return _MEMO[key].copy()
    return draw


def observed_key(seed_obs, device=None):
    """The key the JAX package draws a model's observed data from,
    ``key(seed_obs or 0)``, on ``device`` (None: the global backend's)."""
    return threefry.key(seed_obs or 0, device)


def true_values(true_params, device):
    """Each true parameter as a (1,) float32 tensor on ``device``,
    as the JAX package's ``jnp.asarray([p], jnp.float32)``."""
    return [torch.tensor([float(p)], dtype=torch.float32, device=device)
            for p in true_params]


def first_row(y):
    """The draw's only row as a numpy array, as the JAX package's
    ``np.asarray(...)[0]``."""
    return y[0].cpu().numpy()


def load_observed(path, n_obs, stored_n_obs, true_params, stored_params,
                  seed_obs, prefix=""):
    """The JAX package's array stored under ``<prefix>seed_<seed_obs>``
    (None means 0) in the ``.npz`` at ``path``; raises ``ValueError`` for
    any setting that was not stored."""
    if n_obs != stored_n_obs or (true_params is not None and
                                 list(true_params) != list(stored_params)):
        raise ValueError(f"only n_obs={stored_n_obs} at true_params "
                         f"{tuple(stored_params)} is stored for the PyTorch "
                         "port")
    with np.load(path) as data:
        key = f"{prefix}seed_{seed_obs or 0}"
        if key not in data:
            stored = sorted(int(k.rsplit("_", 1)[1]) for k in data.files
                            if k.startswith(f"{prefix}seed_"))
            raise ValueError(f"no stored observed data for seed_obs="
                             f"{seed_obs}; stored: {stored}")
        return data[key]


def setting_key(**setting):
    """The ``.npz`` key of a model's observed data: every size argument
    and the true parameters (as floats), sorted by name, with
    ``seed_obs`` None read as 0."""
    setting["seed_obs"] = setting.get("seed_obs") or 0
    if setting.get("true_params") is not None:
        setting["true_params"] = [float(v) for v in setting["true_params"]]
    return ";".join(f"{k}={setting[k]!r}" for k in sorted(setting))


def load_observed_setting(path, **setting):
    """The JAX package's array stored for ``setting`` (:func:`setting_key`)
    in the ``.npz`` at ``path``; raises ``ValueError`` for any setting
    that was not stored, naming those that were."""
    key = setting_key(**setting)
    with np.load(path) as data:
        if key not in data.files:
            raise ValueError(
                f"no stored observed data for {key}; "
                f"stored: {sorted(data.files)}")
        return data[key]

"""Model comparison from prerun ABC samples (counterpart of
:mod:`elfi_tpu.methods.model_selection`; numpy, on the samples' host
arrays)."""

from __future__ import annotations

import numpy as np

__all__ = ["compare_models"]


def compare_models(sample_objs, model_priors=None):
    """Posterior model probabilities from the pooled sorted discrepancies,
    adjusted by simulation counts and optional model priors."""
    n_models = len(sample_objs)
    n_min = min(s.n_samples for s in sample_objs)

    discrepancies = [s.discrepancies for s in sample_objs]
    if any(d is None for d in discrepancies):
        raise ValueError("All Sample objects must include valid "
                         "discrepancies")
    pooled = np.concatenate([np.asarray(d) for d in discrepancies])
    inds = np.argsort(pooled)[:n_min]

    p_models = np.empty(n_models)
    up = 0
    for i in range(n_models):
        low, up = up, up + sample_objs[i].n_samples
        p_models[i] = np.logical_and(inds >= low, inds < up).sum()
        p_models[i] /= sample_objs[i].n_sim
        if model_priors is not None:
            p_models[i] *= model_priors[i]
    return p_models / p_models.sum()

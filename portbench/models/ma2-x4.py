"""The MA(2) deployment over the four cards of one host: ``ma2``'s kernel
graph (``elfi_tpu_torch.models.ma2_kernel.get_model``: priors -> the
fused distance kernel K1, node ``d``), declared as :mod:`.ma2` declares
it, at the configuration's ``n_obs``, ``true_params`` and ``seed_obs``.
The device list is the call's (``portbench/calls/rejection_x4.py``), not
the model's.
"""

from __future__ import annotations

from portbench.models import ma2


def build(config, graph):
    """(model, name of the distance node) of the kernel graph."""
    if graph != "kernel":
        raise ValueError(f"the four-card MA(2) deployment runs the kernel "
                         f"graph, not {graph!r}")
    return ma2.build(config, graph)

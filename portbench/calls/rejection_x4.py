"""Rejection calls over the cell's cards, as an ELFI user farms batches
over the devices of one host: ``elfi_tpu_torch.set_client("sharded",
devices=[cuda:0, ..., cuda:<chips - 1>])``, then
``Rejection(node, batch_size, seed).sample(n_samples, n_sim=n_sim)`` on
the fused path, one sampler a call, driven as :mod:`.rejection` drives
it (batch ``i`` runs whole on card ``i % chips``).

Traffic keys: those of :mod:`.rejection`.

The check is :mod:`.rejection`'s: each chosen call recomputed with the
plain reference, every simulation of it, batch by batch from the call's
seed, its best rows kept and compared with the returned sample; the
reference's batches are dealt over the same cards (batch ``b`` on card
``b % chips``, one host thread a card), each card keeps its best rows,
and the first merges them.
On the CPU (the tests) the list names the CPU ``chips`` times.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import torch

from ..reference import select
from . import rejection


def cards(cell, device):
    """The device list of a cell on ``device``'s kind: its ``chips`` CUDA
    devices, or ``device`` named ``chips`` times."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(cell.chips)]
    return [device] * cell.chips


class Driver(rejection.Driver):
    def __init__(self, cell, device):
        import elfi_tpu_torch as et
        self.cards = cards(cell, device)
        et.set_client("sharded", devices=self.cards)
        super().__init__(cell, device)
        self.device = self.cards[0]

    def release(self):
        super().release()
        self.et.reset_client()


def reference_rows(cell, seed, device, dtype=torch.float32, keep=None):
    """The reference's best rows of the call with ``seed``, every batch of
    the call simulated on the card that ran it, on the first card.  One
    host thread a card queues its batches: the 2**31 simulations of the
    cell took four H100s 62 s from one thread and 27 s from four (a batch
    is about 2,400 launches, so one thread waits on one card's full
    launch queue while the others idle)."""
    t = cell.traffic
    ref = cell.reference()
    devs = cards(cell, device)
    n_batches = -(-t["n_sim"] // t["batch_size"])
    k = keep or t["n_samples"] + select.MARGIN

    def card_rows(c):
        top = select.TopRows(k)
        with torch.no_grad():
            for b in range(c, n_batches, len(devs)):
                theta, d = ref.simulate(cell.config, t["graph"], seed, b,
                                        t["batch_size"], devs[c], dtype)
                top.add(theta, d)
        return top

    with ThreadPoolExecutor(len(devs)) as pool:
        tops = list(pool.map(card_rows, range(len(devs))))
    top = select.TopRows(k)
    with torch.no_grad():
        for part in tops:
            if part.d is not None:
                top.add(part.theta.to(devs[0]), part.d.to(devs[0]))
    return top


def compare_call(cell, seed, theta, d, device):
    ref = reference_rows(cell, seed, device)
    return select.compare(theta, d, ref, cell.traffic["n_samples"],
                          cell.reference().SCALES)


def check(cell, records, seed, device):
    """The numbers of each checked call (a list of dicts)."""
    return [compare_call(cell, records[i].seed, records[i].out["theta"],
                         records[i].out["d"], device)
            for i in rejection.checked(records, seed,
                                       cell.traffic["check_calls"])]


def control(cell, seed, device, dtype=torch.bfloat16):
    """The numbers of the control: the reference computed in ``dtype``
    put in the program's place for the call with ``seed``."""
    low = reference_rows(cell, seed, device, dtype,
                         keep=cell.traffic["n_samples"])
    return compare_call(cell, seed, low.theta, low.d, device)

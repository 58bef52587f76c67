"""Sampling-based ABC inference: Rejection, SMC, AdaptiveDistanceSMC and
AdaptiveThresholdSMC (counterpart of :mod:`elfi_tpu.methods.samplers`).

The running top-N sample buffer lives on the device and is maintained by
:mod:`elfi_tpu_torch.ops.topk`.  ``Rejection.sample`` runs a FUSED path
when nothing host-side is needed (no adaptive distance): a host loop that
queues every batch's program and merge on the device without reading
anything back, except, in threshold mode, one acceptance count per chunk
of batches.  The fused and the batch-at-a-time paths call the same
per-batch function with the same stream seeds and the same merge, so they
give identical samples for a seed.

SMC runs each round as such a rejection run.  Rounds >= 1 draw their
parameters from a Gaussian mixture over the previous population; one
function builds a batch's proposals for both paths, from a generator
seeded on the host by (round seed, batch index), so fused and
batch-at-a-time rounds propose the same parameters.  Batch indices run on
across rounds, so every round simulates with fresh noise.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import operator
from math import ceil, inf

import numpy as np
import torch

from ..compile.compiler import compile_program
from ..model.extensions import ModelPrior
from ..model.model import AdaptiveDistance
from ..ops import topk
from ..parallel.backends import NativeBackend, ShardedBackend
from ..utils import capture, get_sub_seed
from ..utils.profiling import annotate
from ..utils.rng import batch_generator, fold_in
from .base import Sampler, _ProgressBar
from .results import Sample, SmcSample
from .utils import (GMDistribution, PreparedGM, batch_to_arr2d,
                    weighted_sample_quantile, weighted_var)

__all__ = ["Rejection", "SMC", "AdaptiveDistanceSMC", "AdaptiveThresholdSMC"]

logger = logging.getLogger(__name__)

#: batches queued between progress updates and between the host reads of
#: the acceptance count in threshold mode, and batches a captured chunk
#: holds.  scripts/torch_capture_ab.py on an NVIDIA H100 80GB HBM3 at
#: 700.00 W, best of three walls, captured at 16 / 32 / 64 (eager at 16):
#: MA2 rejection, 2**28 simulations, plain graph at 2**17 0.965 / 0.963 /
#: 0.966 s (1.097), kernel graph at 2**21 48.3 / 48.6 / 49.1 ms (51.1);
#: gauss2d SMC at 16384 26.8 / 44.7 / 80.1 ms (49.8), since a threshold
#: round stops at a chunk's end.  16 stays (the JAX package's is 64).
_FUSED_CHUNK = 16

#: Merge unroll: the number of consecutive batches (of one device) whose
#: outputs are CONCATENATED into one top-N merge in the fused loop.  None =
#: auto (:func:`_fused_unroll`); an int forces the factor.  Bit-identity
#: with one merge a batch: the merge breaks ties toward the lower
#: concatenation index, and buffer -> batch_j -> batch_{j+1} is the order
#: those rows hold across sequential merges.  A chunk of batches ends with
#: every batch merged (a shorter concatenation for the remainder), so the
#: acceptance count read per chunk is unchanged.
#:
#: scripts/torch_merge_ab.py on an NVIDIA H100 80GB HBM3 at 700.00 W (MA2,
#: 2**28 simulations, culled merge at width 4096, best of three walls;
#: device ms a batch from one profiled run), with the cull redesigned for
#: Hopper: the plain graph at 2**16 goes 0.97e8 (u = 1) -> 1.14e8, 1.31e8,
#: 1.40e8, 1.57e8 sims/s (u = 2, 4, 8, 16; 0.275 -> 0.261 device ms), at
#: 2**17 1.88e8 -> 2.32e8, 2.23e8, 2.22e8, 2.40e8 (walls spread up to 2x;
#: 0.485 -> 0.473 device ms at u = 16), at 2**18 2.85e8 -> 2.89e8 (u = 8);
#: the kernel graph at 2**20 2.84e9 (u = 1) against 2.50e9 (u = 2), 0.207
#: against 0.213 device ms: with a cheaper cull the unroll's concatenation
#: costs the card more than the merges it saves, so the batch-size guard
#: is the JAX package's 2**18 again (it was 2**20, for +10-23 % at u = 2
#: with the first cull).  Each merge costs the host its launches, so
#: merging fewer times pays wherever the host bounds the loop; the cap of
#: 2**21 rows a merge stands.
FUSED_UNROLL = None
_UNROLL_CAND_CAP = 1 << 21   # max concatenated rows per merge
_UNROLL_MAX = 16
_UNROLL_MAX_BATCH = 1 << 18  # no unroll above this batch size
_UNROLL_BYTES_CAP = 256      # no unroll for wide outputs (not measured)
_MAX_BATCHES = 100_000
#: folded into a round's seed to key its proposal streams (the JAX
#: package's constant)
_PROPOSAL_SALT = 0x9E3779B9
#: the masked prior-support redraw rounds that a captured SMC proposal
#: chunk holds (:meth:`.utils.GMDistribution.rvs_masked`) are learned per
#: proposal program from its eager proposal chunks: 0 until an eager
#: batch takes more, then the most one took plus this headroom; a batch
#: that needs more than its graph holds flags its chunk, which runs again
#: eagerly and raises the count.  scripts/torch_capture_ab.py on an
#: NVIDIA H100 80GB HBM3 at 700.00 W, MA2 SMC at batch 10000 (1000
#: samples, thresholds 0.7, 0.2, 0.05): the eager loop took 2-6 rounds a
#: batch (512 batches); a held round that ran on every batch cost a run
#: 2.9 ms of wall (32 batches in two graphs; walls at headrooms 0, 8, 16:
#: counts 7, 12, 20), a rise of the count 0.3-0.4 s once (a redone chunk,
#: a graph recorded and captured).  With CUDA-graph conditional nodes
#: (the CUDA 12.4 runtime or later) a batch runs only the rounds it needs
#: and skips the rest of its held rounds on the card: holding 6, 12 or 20
#: rounds ran 29.3, 29.2 and 29.3 ms a run (every held round run: 35.6 and
#: 52.2 ms at 6 and 12).
#: Over 3 windows of 400 runs from a fresh model, headrooms 0, 1, 2 rose
#: 5, 4 and 2 times and ran 41.8, 43.6 and 42.7 ms a run, a difference
#: the windows' spread (7 %) does not resolve; but at 0 the rises come in
#: a process's first runs (2 in the 35 runs after the benchmark's
#: warm-up), each run that rises taking 0.25-0.8 s, and 2 keeps them out.
_REDRAW_HEADROOM = 2
#: the most redraw rounds a graph holds; a batch that needs more keeps
#: its chunk's eager redo.  At MA2 SMC's batch 10000, 32 rounds run on
#: every batch cost a run 93 ms (without conditional nodes), less
#: than the eager fallback of its two proposal chunks (123 ms a run: 165
#: against 42 ms, the same card), and twice the most a batch took in the
#: runs measured (16, MA2 SMC at batch 2000).
_REDRAW_CAP = 32


def _fused_unroll(batch_size, shapes):
    """The merge-unroll factor of a fused run: :data:`FUSED_UNROLL` if set;
    else 1 above :data:`_UNROLL_MAX_BATCH` or for outputs wider than
    :data:`_UNROLL_BYTES_CAP` bytes a simulation, and otherwise as many
    batches as fit :data:`_UNROLL_CAND_CAP` rows, at most
    :data:`_UNROLL_MAX`.  ``shapes`` maps each output to an object with
    ``.shape`` (batch first) and ``.dtype.itemsize``: a batch's tensors."""
    if FUSED_UNROLL is not None:
        return max(1, int(FUSED_UNROLL))
    if batch_size > _UNROLL_MAX_BATCH:
        return 1
    bytes_per_sim = sum(
        int(np.prod(tuple(v.shape[1:]), dtype=np.int64)) * v.dtype.itemsize
        for v in shapes.values())
    if bytes_per_sim > _UNROLL_BYTES_CAP:
        return 1
    return int(max(1, min(_UNROLL_MAX, _UNROLL_CAND_CAP // batch_size)))


class _ChunkLoop:
    """The chunks of one fused rejection run (:meth:`Rejection._run_fused`)
    over the run's device list, one device a list of one: each chunk
    queues its batches' programs and the merges of their outputs into the
    running top-N of each position, a position's share after another.
    Position ``k`` takes the batches ``i`` with ``i % D == k`` and merges
    them into its own buffer; over several devices (``D > 1``) each share
    is one span ``elfi.card``, and its rows carry their global simulation
    index (``__pos``) for the last merge across positions.

    Where every device is CUDA and the program is capturable, a share is a
    CUDA graph on its card (the counterpart of the JAX package's
    ``chunk_fn``), kept with the card's program (``prog.on(card).replays``,
    on one device ``prog.replays``), so a later run of any sampler replays
    it.  A share's key holds its position, the chunk's first batch modulo
    ``D``, and its merges of the chunk's merge schedule (which merges take
    how many batches, and which merge flat because the buffer has not
    taken ``n`` rows yet: a host decision), so the first chunks, which
    merge flat, and the steady state are separate graphs; a card named at
    several positions keeps a graph a position, under a cap raised to
    ``capture.CAP`` times the positions naming it.  Each key's first chunk
    runs eagerly and recorded, its second captures the graph, later ones
    replay it, on the card's side stream; the host queues the shares'
    replays one after another and waits for none.  The first chunk
    allocates the buffers inside its graph.  A remainder chunk shorter
    than ``_FUSED_CHUNK``, and the very first run's first chunk (which
    learns the merge unroll from the outputs' shapes), run eagerly.  The
    threshold, an SMC round's mixture and, over several devices, each
    position's first batch of the chunk (which ``__pos`` counts from) are
    device tensors kept with the graphs, rewritten each chunk or run, so
    one graph serves any threshold, every round and every chunk.

    SMC proposals on one device draw a learned number of masked
    prior-support redraw rounds inside the graph
    (:meth:`.utils.GMDistribution.rvs_masked`, each round in an IF node
    that skips it once every row is inside), kept with the graphs
    (``memo``) and part of the key: an eager proposal chunk raises it to
    the most rounds one of its batches took plus ``_REDRAW_HEADROOM``, at
    most ``_REDRAW_CAP``.  Every share returns one stat vector: the rows
    it accepted, then, where its proposals are masked, its flag that a
    batch needed more rounds than the graph held and the rounds its
    batches ran.  The host reads the vectors once a chunk, in threshold
    mode or where proposals are masked; a flagged share runs again
    eagerly from the state it started from, which the graph saves, with
    the eager redraw loop, the run's later chunks run eagerly, and the
    next run (the next round) takes the graph of the raised count.  SMC
    proposals over several devices stay eager.  Every path gives the
    eager loop's rows, bit for bit.

    :attr:`counts` holds the run's counters (:meth:`Rejection._run_fused`
    copies them into the sampler's state)."""

    def __init__(self, prog, devices, batch_size, seed, start_index, n,
                 disc, threshold, overrides_spec):
        self.devices, self.D, self.B = devices, len(devices), batch_size
        self.seed, self.start_index, self.n, self.disc = (
            seed, start_index, n, disc)
        progs = [prog.on(dev) for dev in devices]
        self.fns = [p.traceable(batch_size) for p in progs]
        self.spec = overrides_spec
        self.captured = (all(capture.enabled(d) for d in devices)
                         and prog.capturable
                         and (overrides_spec is None
                              or self.D == 1
                              and hasattr(overrides_spec, "masked")))
        #: each position's graphs: its card's program's
        self.graphs = [p.replays for p in progs]
        self.counts = dict(
            #: chunk shares run again eagerly for a proposal's redraw
            redone_chunks=0,
            #: the most redraw rounds a graph of this run held
            redraw_rounds=0,
            #: the proposal batches this run's graphs drew with masked
            #: rounds, and the rounds those ran
            masked_batches=0, redraw_rounds_run=0,
            #: each position's batches, and its shares run from its graph
            card_batches=[0] * self.D, card_replays=[0] * self.D,
            #: the nodes of the graphs those shares replayed
            graph_nodes=0)
        #: set by a redone chunk: this run's later chunks run eagerly
        #: (scripts/torch_capture_ab.py, MA2 SMC at batch 2000 from a
        #: fresh model: 12.2 s against 12.9 s for the four-run turns with
        #: a redo, where the later chunks took the raised count's graph)
        self.eager_proposals = False
        self.parts = [None] * self.D
        self.merged = [0] * self.D
        self.unroll = self.graphs[0].memo.get(("unroll", self.fns[0])) \
            if self.captured else None
        if self.captured:
            if overrides_spec is not None:
                # the graphs read the mixture from buffers kept with them
                self.spec = overrides_spec.on_buffers(self.graphs[0])
                self.rounds_key = ("redraw_rounds", self.spec.graph_key)
            shape = threshold.shape if isinstance(threshold,
                                                  torch.Tensor) else ()
            self.thrs = []
            for graphs, dev in zip(self.graphs, devices):
                thr = graphs.buffer(("threshold", tuple(shape)), shape,
                                    torch.float32, dev)
                if isinstance(threshold, torch.Tensor):
                    thr.copy_(threshold)
                else:
                    thr.fill_(threshold)
                self.thrs.append(thr)
            for graphs, m in collections.Counter(self.graphs).items():
                graphs.cap = max(graphs.cap, m * capture.CAP)
            if self.D > 1:
                #: each position's first batch of the chunk its graph runs
                self.firsts = [graphs.buffer(("first_batch", k), (),
                                             torch.int64, dev)
                               for k, (graphs, dev) in enumerate(
                                   zip(self.graphs, devices))]
                #: each card's row indices 0 .. B - 1, made once: a graph's
                #: ``__pos`` is one addition to them (at 2**24 rows an
                #: arange and the addition took the card 0.25 ms a batch,
                #: the addition 0.09 ms; NVIDIA H100 80GB HBM3, 700 W)
                self.rows = [self._rows(graphs, dev)
                             for graphs, dev in zip(self.graphs, devices)]
        else:
            self.thrs = [threshold.to(dev) if isinstance(
                threshold, torch.Tensor) else threshold for dev in devices]

    def _rows(self, graphs, dev):
        """The row indices 0 .. B - 1 on ``dev``, kept with ``graphs``."""
        made = ("rows", self.B) in graphs.buffers
        rows = graphs.buffer(("rows", self.B), (self.B,), torch.int64, dev)
        if not made:
            torch.arange(self.B, out=rows)
        return rows

    @contextlib.contextmanager
    def stream(self):
        """Where the chunks run: each card's capture stream when they are
        graphs."""
        with contextlib.ExitStack() as stack:
            if self.captured:
                for dev in dict.fromkeys(self.devices):
                    stack.enter_context(capture.on_side_stream(dev))
            yield

    def _plan(self, i0, length):
        """((device, batches, fresh) of each merge of the chunk at batch
        ``i0``, in order; the rows each device has merged after it)."""
        merged, pending, plan = list(self.merged), [0] * self.D, []

        def close(k):
            plan.append((k, pending[k], merged[k] < self.n))
            merged[k] += self.B * pending[k]
            pending[k] = 0

        for i in range(i0, i0 + length):
            k = i % self.D
            pending[k] += 1
            if pending[k] == self.unroll:
                close(k)
        for k in range(self.D):
            if pending[k]:
                close(k)
        return tuple(plan), merged

    def _rounds(self):
        """The redraw rounds a graph of these proposals holds now."""
        return self.graphs[0].memo.get(self.rounds_key, 0)

    def _learn(self):
        """Raise the learned redraw rounds to cover the most that a batch
        of this run's eager proposals took, plus the headroom, at most the
        cap."""
        most = self.spec.most_rounds
        if most > self._rounds():
            self.graphs[0].memo[self.rounds_key] = min(
                _REDRAW_CAP, most + _REDRAW_HEADROOM)

    def _body(self, part, i0, length, rounds, card, ran=None, first=None):
        """Queue position ``card``'s batches of the chunk at batch ``i0``
        and their merges into its buffers ``part``, the proposals drawn
        with ``rounds`` masked redraw rounds (None: the eager redraw
        loop), each round that runs adding 1 to ``ran``; returns (the new
        buffers, the merges' acceptance counts, each masked proposal's
        flag that its rows are in the prior's support).  ``first``: a
        device scalar holding ``i0`` that ``__pos`` counts from (a
        graph's, with ``rows``), else ``i0`` itself."""
        dev, fn, thr = self.devices[card], self.fns[card], self.thrs[card]
        pending, accs, oks = [], [], []
        merges = None

        def merge(part):
            _, _, fresh = next(merges)
            cat = pending[0] if len(pending) == 1 else {
                name: torch.cat([o[name] for o in pending])
                for name in pending[0]}
            pending.clear()
            part, acc = topk.merge_scan(part, cat, thr, self.disc,
                                        fresh=fresh)
            accs.append(acc)
            return part

        for i in range(i0 + (card - i0) % self.D, i0 + length, self.D):
            ov = {}
            if self.spec is not None and rounds is not None:
                ov, ok = self.spec.masked(i, rounds, ran)
                oks.append(ok)
            elif self.spec is not None:
                ov = self.spec(i)
            out = fn(self.seed, i,
                     {name: v.to(dev) for name, v in ov.items()})
            if self.unroll is None:
                self.unroll = _fused_unroll(self.B, out)
                if self.captured:
                    self.graphs[0].memo[("unroll", self.fns[0])] = \
                        self.unroll
            if merges is None:
                merges = iter([m for m in self._plan(i0, length)[0]
                               if m[0] == card])
            if self.D > 1:      # the global simulation index of each row
                out = dict(out, __pos=torch.arange(
                    i * self.B, (i + 1) * self.B, device=dev)
                    if first is None else self.rows[card]
                    + (first + (i - i0)) * self.B)
            if part is None:
                part = topk.init_buffers(self.n, out, self.disc)
                if self.D > 1:
                    part["__pos"].fill_(-1)
            pending.append(out)
            if len(pending) == self.unroll:
                part = merge(part)
        if pending:             # the remainder: the chunk ends merged
            part = merge(part)
        return part, accs, oks

    def chunk(self, start, length, read):
        """Queue this run's batches ``start .. start + length - 1`` and
        their merges, each position's share in turn; with ``read``, return
        the rows they accepted (a host read), else 0."""
        with annotate("elfi.chunk"):
            i0 = self.start_index + start
            plan, merged = self._plan(i0, length)
            graph = (self.captured and self.unroll is not None
                     and length == _FUSED_CHUNK and not self.eager_proposals)
            rounds = self._rounds() if graph and self.spec is not None \
                else None
            shares = []
            for k, dev in enumerate(self.devices):
                card = annotate("elfi.card") if self.D > 1 \
                    else contextlib.nullcontext()
                with card, capture.on_device(dev):
                    shares.append(self._share(k, i0, length,
                                              plan if graph else None,
                                              rounds, read))
            if not graph and self.captured and self.spec is not None:
                self._learn()
            accepted = 0
            if read or rounds is not None:
                with annotate("elfi.host_read"):
                    stats = [[0] if s is None else s.tolist()
                             for s, _ in shares]
                if rounds is not None:
                    self.counts["redraw_rounds"] = max(
                        self.counts["redraw_rounds"], rounds)
                    self.counts["masked_batches"] += length
                for k, (acc, *masked) in enumerate(stats):
                    if masked:
                        flagged, ran = masked
                        self.counts["redraw_rounds_run"] += ran
                        if flagged:
                            acc = self._redo(k, i0, length, shares[k][1])
                    accepted += acc
            self.merged = merged
            # a position's rows merged are its batches'
            self.counts["card_batches"] = [m // self.B for m in merged]
            return accepted if read else 0

    def _share(self, k, i0, length, plan, rounds, read):
        """Position ``k``'s share of the chunk at batch ``i0``: eagerly
        without a ``plan``, else through its card's graphs, keyed by its
        merges of ``plan`` and by the masked redraw ``rounds`` of its
        proposals (None: none masked); returns (its stat vector, None for
        an eager share that is not ``read``; where its proposals are
        masked, the state it started from)."""
        if plan is None:
            self.parts[k], accs, _ = self._body(self.parts[k], i0, length,
                                                None, k)
            return (_stat(accs) if read and accs else None), None
        graphs, dev = self.graphs[k], self.devices[k]
        masked = rounds is not None
        first = self.firsts[k] if self.D > 1 else None
        # the first chunk allocates the buffers inside its graph
        state = self.parts[k] or {}
        key = ("chunk", k, i0 % self.D, self.fns[k], self.B, self.n,
               self.disc, tuple(m for m in plan if m[0] == k),
               tuple(self.thrs[k].shape),
               (self.spec.graph_key, rounds) if masked else None,
               tuple((name, tuple(v.shape), v.dtype)
                     for name, v in state.items()))

        def fn(state, i0):
            ran = torch.zeros((), dtype=torch.int64, device=dev) \
                if masked else None
            part, accs, oks = self._body(state or None, i0, length, rounds,
                                         k, ran, first)
            if not masked:
                return part, _stat(accs)
            return part, _stat(accs, (~torch.stack(oks)).sum(), ran)

        bases = {"node": self.seed}
        if masked:
            bases["batch"] = self.spec.key
        if first is not None:
            first.fill_(i0)
        before = graphs.replays
        self.parts[k], extra = graphs(key, state, fn, bases, i0, dev,
                                      snapshot=masked)
        if graphs.replays > before:
            self.counts["card_replays"][k] += 1
            self.counts["graph_nodes"] += graphs.entries[key][1].nodes
        return extra if masked else (extra, None)

    def _redo(self, k, i0, length, before):
        """Position ``k``'s share of the chunk at batch ``i0`` again,
        eagerly, from the state it started from, ``before``: a proposal
        needed more redraw rounds than the graph holds.  The rows merged
        before the chunk set its merges as they set the graph's (merged
        after it, a first chunk's flat merges would be culled ones).
        Returns the rows it accepted (a host read)."""
        with annotate("elfi.chunk.redo"):
            self.parts[k], accs, _ = self._body(dict(before) or None, i0,
                                                length, None, k)
            self.counts["redone_chunks"] += 1
            self.eager_proposals = True
            self._learn()
            with annotate("elfi.host_read"):
                return int(torch.stack(accs).sum())

    def final_parts(self):
        """The buffers of every device; a graph's static buffers are
        copied, since its next replay overwrites them."""
        parts = [p for p in self.parts if p is not None]
        if self.captured:
            parts = [{k: v.clone() for k, v in p.items()} for p in parts]
        return parts


def _stat(accs, *masked):
    """A share's stat vector, from its merges' acceptance counts: the rows
    it accepted, then ``masked`` (its flag and the redraw rounds run)."""
    if not masked:
        return torch.stack(accs).sum(0, keepdim=True)
    return torch.stack([torch.stack(accs).sum(), *masked])


def _float32_threshold(t, device):
    """A threshold as the JAX package compares it (``jnp.asarray(t,
    jnp.float32)``): ``inf`` for None, a float32 value for a scalar, and a
    float32 tensor on ``device`` for a vector (one bound per distance
    column)."""
    if t is None:
        return inf
    t = np.asarray(t, np.float32)
    return float(t) if t.ndim == 0 else torch.as_tensor(t, device=device)


class Rejection(Sampler):
    """Parallel ABC rejection sampler."""

    def __init__(self, model, discrepancy_name=None, output_names=None,
                 **kwargs):
        model, discrepancy_name = self._resolve_model(model, discrepancy_name)
        output_names = [discrepancy_name] + model.parameter_names \
            + (output_names or [])
        self.adaptive = isinstance(model[discrepancy_name], AdaptiveDistance)
        if self.adaptive:
            model[discrepancy_name].init_adaptation_round()
            self.sums = [s.name for s in model[discrepancy_name].parents]
            for k in self.sums:
                if k not in output_names:
                    output_names.append(k)
        super().__init__(model, output_names, **kwargs)
        self.discrepancy_name = discrepancy_name
        self._merge = topk.make_merge_fn(discrepancy_name)

    # -- objective ---------------------------------------------------------
    def set_objective(self, n_samples, threshold=None, quantile=None,
                      n_sim=None):
        if quantile is None and threshold is None and n_sim is None:
            quantile = .01
        self.state = dict(samples=None, threshold=np.inf, n_sim=0,
                          accept_rate=1, n_batches=0, n_accepted=0)
        if quantile:
            n_sim = ceil(n_samples / quantile)
        if n_sim:
            n_batches = ceil(n_sim / self.batch_size)
        else:
            n_batches = self.max_parallel_batches
        self.objective = dict(n_samples=n_samples, threshold=threshold,
                              n_batches=n_batches)
        self._threshold = _float32_threshold(threshold, self.device)
        self.batches.reset()

    # -- batch-at-a-time path ------------------------------------------------
    def update(self, batch, batch_index):
        super().update(batch, batch_index)
        if self.state["samples"] is None:
            self.state["samples"] = topk.init_buffers(
                self.objective["n_samples"], batch, self.discrepancy_name)
        if self.adaptive:
            self.model[self.discrepancy_name].add_data(
                *(batch[s].cpu().numpy() for s in self.sums))
        self.state["samples"], acc = self._merge(self.state["samples"],
                                                 batch,
                                                 self._merge_threshold())
        if self.objective.get("threshold") is not None:
            self.state["n_accepted"] += int(acc)
            self._update_objective_n_batches()
        else:
            self.state["n_accepted"] += self.batch_size

    def _merge_threshold(self):
        """The objective's threshold as :func:`_float32_threshold` gives it,
        made once per objective (a vector's copy to the device waits for
        the device)."""
        return self._threshold

    def _update_objective_n_batches(self):
        """Re-estimate the batches needed under a fixed threshold."""
        s = self.state
        n_samples = self.objective["n_samples"]
        n_acceptable = s["n_accepted"]
        if n_acceptable == 0:
            n_batches = self.objective["n_batches"] + 1
        else:
            accept_rate_t = n_acceptable / s["n_sim"]
            margin = .2 * self.batch_size * int(n_acceptable < n_samples)
            n_batches = ceil((n_samples / accept_rate_t + margin)
                             / self.batch_size)
        self.objective["n_batches"] = max(n_batches, s["n_batches"])

    # -- result ------------------------------------------------------------------
    def extract_result(self):
        if self.state["samples"] is None:
            raise ValueError("Nothing to extract")
        if self.adaptive:
            self._update_distances()
        with annotate("elfi.host_read"):
            outputs = {k: v.cpu().numpy() for k, v in
                       self.state["samples"].items() if k != "__key"}
        self._update_state_meta(outputs)
        return Sample(outputs=outputs, **self._extract_result_kwargs())

    def _update_state_meta(self, outputs):
        n = self.objective["n_samples"]
        d = np.asarray(outputs[self.discrepancy_name])
        self.state["threshold"] = d[n - 1]
        self.state["accept_rate"] = min(1, n / max(self.state["n_sim"], 1))

    def _update_distances(self):
        """Adaptive distance: freeze the new scale, recompute the kept
        rows' distances under it and re-sort them (reference
        ``samplers.py:279-299``).  The order is numpy's ``argsort`` of the
        new distances, as in the JAX package."""
        node = self.model[self.discrepancy_name]
        node.update_distance()
        nums = self.objective["n_samples"]
        samples = self.state["samples"]
        data = {s: samples[s][:nums] for s in self.sums}
        prog = compile_program(self.model, (self.discrepancy_name,),
                               override_names=tuple(sorted(data)),
                               device=self.device)
        ds = prog.run(self.seed, 0, data,
                      batch_size=nums)[self.discrepancy_name]
        sort_distance = ds if ds.ndim == 1 else ds[:, -1]
        order = torch.as_tensor(np.argsort(sort_distance.cpu().numpy()),
                                device=sort_distance.device)
        new = {k: v.index_select(0, order) for k, v in samples.items()
               if k not in (self.discrepancy_name, "__key")}
        new[self.discrepancy_name] = new["__key"] = \
            sort_distance.index_select(0, order)
        self.state["samples"] = new

    # -- fused path -----------------------------------------------------------------
    def sample(self, n_samples, threshold=None, quantile=None, n_sim=None,
               fused=None, bar=True, **kwargs):
        """Sample from the approximate posterior.

        ``fused=True`` (default when eligible) queues the whole rejection
        loop on the device from one host loop.  An adaptive distance needs
        the host between batches, and a pool stores and replays batch by
        batch, so either runs batch at a time.
        """
        with annotate("elfi.sample"):
            self.bar = bar
            eligible = (self.pool is None and not self.adaptive
                        and isinstance(self.client, (NativeBackend,
                                                     ShardedBackend))
                        and not kwargs)
            if fused is None:
                fused = eligible
            if fused and not eligible:
                raise ValueError("fused=True requires: no pool, no adaptive "
                                 "distance, native or sharded backend")
            self.set_objective(n_samples, threshold=threshold,
                               quantile=quantile, n_sim=n_sim)
            prog = compile_program(self.model, tuple(self.output_names),
                                   device=self.device)
            if fused and prog.host:
                fused = False
            if not fused:
                return self.infer(n_samples, threshold=threshold,
                                  quantile=quantile, n_sim=n_sim, bar=bar,
                                  **kwargs)
            self._run_fused(prog, threshold)
            self.batches.reset()
            return self.extract_result()

    def _run_fused(self, prog, threshold, seed=None, start_index=0,
                   overrides_spec=None):
        """Queue batches ``start_index, start_index + 1, ...`` and their
        merges on the device, ``_FUSED_CHUNK`` batches a chunk.  Without a
        threshold the host never waits for the device here; with one it
        reads the acceptance count once a chunk.

        ``overrides_spec`` (fused SMC rounds) is a per-batch builder
        ``fn(batch_index) -> {node: tensor}`` whose values replace those
        nodes; ``prog`` must declare them as overrides.
        ``state["n_batches"]`` counts this run's batches only.

        The outputs of :func:`_fused_unroll` consecutive batches of one
        device go into one :func:`~elfi_tpu_torch.ops.topk.merge_scan`,
        which takes the culled merge once that device's buffer has taken
        ``n`` rows.

        Under a :class:`ShardedBackend` batch ``i`` runs whole on device
        ``i % n_devices`` (its overrides copied there), each device merges
        its own batches into its own top-N, and the last merge
        (:func:`~elfi_tpu_torch.ops.topk.merge_parts`) keeps the rows and
        the order of the one-device run: every batch is the native batch,
        and ties go to the earlier simulation.  One device is a list of
        one.  On CUDA cards a capturable program's chunk is one graph a
        card, its share of the chunk (:class:`_ChunkLoop`), kept with the
        card's program for every sampler that runs it, bit for bit the
        eager chunk; SMC's proposals over several devices run eagerly.

        Returns the loop's counters (:attr:`_ChunkLoop.counts`), also
        copied into the state: ``state["card_batches"]`` and
        ``state["card_replays"]`` list, a device of the list each, the
        batches it ran and the chunk shares it ran from a graph;
        ``state["redraw_rounds"]`` is the most masked redraw rounds a graph
        of the run held, ``state["masked_batches"]`` the proposal batches
        its graphs drew with them, ``state["redraw_rounds_run"]`` the
        rounds of those that ran (the others were skipped: every row was
        inside), ``state["redone_chunks"]`` the shares run again
        eagerly, and ``state["graph_nodes"]`` the nodes of the graphs its
        shares replayed, one graph's each replay."""
        if seed is None:
            seed = self.seed
        devices = getattr(self.client, "mesh", None) or [self.device]
        loop = _ChunkLoop(prog, devices, self.batch_size, seed, start_index,
                          self.objective["n_samples"],
                          self.discrepancy_name, self._merge_threshold(),
                          overrides_spec)
        n = self.objective["n_samples"]
        pb = _ProgressBar() if self.bar else None
        with loop.stream():
            if threshold is None:
                n_batches = self.objective["n_batches"]
                done = 0
                while done < n_batches:
                    length = min(_FUSED_CHUNK, n_batches - done)
                    loop.chunk(done, length, read=False)
                    done += length
                    if pb:
                        pb.update(done, n_batches)
                self.state["n_accepted"] = done * self.batch_size
            else:
                done, accepted = 0, 0
                while accepted < n and done < _MAX_BATCHES:
                    accepted += loop.chunk(done, _FUSED_CHUNK, read=True)
                    done += _FUSED_CHUNK
                    if pb:
                        pb.update(min(accepted, n), n)
                self.state["n_accepted"] = accepted
                if accepted < n:
                    logger.warning(
                        "Threshold %s unattainable within %d batches: only "
                        "%d of %d requested samples were accepted; the "
                        "remaining rows of the returned sample are "
                        "+inf-discrepancy padding.",
                        threshold, _MAX_BATCHES, accepted, n)
            parts = loop.final_parts()
        if pb:
            pb.finish()
        self.state["n_batches"] = done
        self.state["n_sim"] = done * self.batch_size
        self.state.update(loop.counts)
        self.state["samples"] = topk.merge_parts(parts, n, self.device)
        self.objective["n_batches"] = done
        return loop.counts

    def plot_state(self, **options):
        """The current top-N sample's parameters (copied off the card)."""
        from ..visualization import plot_sample
        samples = {k: v.cpu().numpy()
                   for k, v in self.state["samples"].items()}
        plot_sample(samples, nodes=self.parameter_names,
                    n=self.objective["n_samples"], **options)


class _RoundSchedule:
    """Acceptance schedule for a run of SMC rounds.

    Global round ``r`` is driven either by an explicit distance threshold
    or by a selection quantile that gets RESOLVED into a threshold against
    round ``r-1``'s population when the round begins.  Continuation
    (calling ``sample`` again) appends rounds after the existing ones, so
    global round numbering survives across calls.  AdaptiveThresholdSMC
    fills its quantile slots between rounds from the density-ratio fit.
    """

    def __init__(self):
        self.thresholds = []
        self.quantiles = []

    @property
    def n_rounds(self):
        return len(self.thresholds)

    def extend(self, n, thresholds=None, quantiles=None):
        for i in range(n):
            self.thresholds.append(
                None if thresholds is None else thresholds[i])
            self.quantiles.append(
                None if quantiles is None else quantiles[i])


class _GMProposals:
    """Per-batch proposal builder of an SMC round >= 1 (the JAX package's
    ``_gm_overrides_fn``): ``fn(batch_index) -> {parameter: (batch_size,)
    tensor}``.

    ``proposal`` is the round's :class:`~.utils.PreparedGM`.  Batch ``i``
    draws, prior-support redraws included, from a generator on the
    mixture's device seeded with ``fold_in(fold_in(round_seed,
    0x9E3779B9), i)`` (:func:`~elfi_tpu_torch.utils.rng.batch_generator`),
    computed on the host.  The draws depend on nothing else, so the
    batch-at-a-time path (:meth:`SMC.prepare_new_batch`) and the fused
    path, which both call such a builder, propose the same tensors for a
    batch.  :meth:`masked` is the draw of a captured chunk: the same
    tensors whenever the eager redraw loop stops within ``rounds``."""

    def __init__(self, parameter_names, batch_size, prior_logpdf, proposal,
                 round_seed, key=None):
        self.pnames = tuple(parameter_names)
        self.batch_size = batch_size
        self.prior_logpdf = prior_logpdf
        self.proposal = proposal
        self.key = fold_in(round_seed, _PROPOSAL_SALT) if key is None \
            else key
        self.device = proposal.means.device
        #: what a graph of these draws reads: the mixture's tensors
        self.graph_key = (batch_size, self.pnames) + tuple(
            (t.data_ptr(), tuple(t.shape)) for t in proposal)
        #: the most redraw rounds a batch of :meth:`__call__` took
        self.most_rounds = 0

    def on_buffers(self, replays):
        """These proposals drawn from the mixture copied into buffers kept
        with ``replays`` (a captured chunk reads those, whatever round or
        sampler replays it)."""
        kept = PreparedGM(*(
            replays.buffer(("mixture", i, tuple(t.shape), t.dtype),
                           t.shape, t.dtype, t.device)
            for i, t in enumerate(self.proposal)))
        for k, t in zip(kept, self.proposal):
            k.copy_(t)
        return _GMProposals(self.pnames, self.batch_size, self.prior_logpdf,
                            kept, None, key=self.key)

    def _columns(self, params):
        return {p: params[:, j] for j, p in enumerate(self.pnames)}

    def __call__(self, batch_index):
        with annotate("elfi.proposal"):
            params, rounds = GMDistribution.rvs_counted(
                self.proposal, self.batch_size, self.prior_logpdf,
                batch_generator(self.key, batch_index, self.device))
            self.most_rounds = max(self.most_rounds, rounds)
            return self._columns(params)

    def masked(self, batch_index, rounds, counter=None):
        """(the proposals, a 0-d flag that every row is in the prior's
        support after at most ``rounds`` masked redraw rounds), with no
        host read in a graph; each round that runs adds 1 to
        ``counter``."""
        params, ok = GMDistribution.rvs_masked(
            self.proposal, self.batch_size, self.prior_logpdf,
            batch_generator(self.key, batch_index, self.device), rounds,
            counter)
        return self._columns(params), ok


class SMC(Sampler):
    """Sequential Monte Carlo ABC (reference ``samplers.py:320-559``)."""

    def __init__(self, model, discrepancy_name=None, output_names=None,
                 **kwargs):
        model, discrepancy_name = self._resolve_model(model, discrepancy_name)
        output_names = [discrepancy_name] + model.parameter_names \
            + (output_names or [])
        super().__init__(model, output_names, **kwargs)
        self._prior = ModelPrior(self.model, device=self.device)
        # with a host (scipy) prior, through numpy
        self._prior_logpdf = self._prior.tensor_logpdf()
        self.discrepancy_name = discrepancy_name
        self.state["round"] = 0
        self._populations = []
        self._rejection = None
        self._round_seed = None
        self._proposal = None
        self._propose = None
        self.schedule = _RoundSchedule()

    def sample(self, n_samples, thresholds=None, quantiles=None, fused=None,
               bar=True, **kwargs):
        """Sample from the SMC posterior.

        ``fused=True`` (default when eligible) queues each round's
        simulate -> distance -> top-k loop on the device from one host
        loop, with the Gaussian-mixture proposal draws of the batch-at-a-time
        path.  Proposals and merges are bit-identical to the batch-at-a-time
        path; only the stopping point of threshold rounds differs (the
        fused loop stops at chunk granularity once ``n_samples`` are
        accepted, the other at its dynamic batch estimate).
        """
        with annotate("elfi.sample"):
            self.bar = bar
            fused, prog = self._resolve_fused(fused, kwargs)
            if not fused:
                return super().sample(n_samples, thresholds=thresholds,
                                      quantiles=quantiles, bar=bar, **kwargs)
            return self._sample_fused(
                n_samples, dict(thresholds=thresholds, quantiles=quantiles),
                prog)

    # adaptive DISTANCES need per-batch host updates (never fused);
    # adaptive thresholds only do host work BETWEEN rounds (fusable)
    _fused_capable = True

    def _resolve_fused(self, fused, kwargs):
        eligible = (self._fused_capable and self.pool is None
                    and isinstance(self.client, (NativeBackend,
                                                 ShardedBackend))
                    and not kwargs)
        prog = None
        if eligible:
            prog = compile_program(self.model, tuple(self.output_names),
                                   device=self.device)
            eligible = not prog.host
        if fused is None:
            fused = eligible
        if fused and not eligible:
            raise ValueError("fused=True requires: no adaptive distance, "
                             "no pool, native or sharded backend, no host "
                             "nodes")
        return fused, prog

    def _fused_advance_round(self):
        """Round transition for the fused driver; returns False when the
        run is complete (mirrors the unfused ``update`` logic)."""
        if self.state["round"] < self.objective["round"]:
            self._advance_round()
            return True
        return False

    def _sample_fused(self, n_samples, objective_kwargs, prog):
        self.set_objective(n_samples, **objective_kwargs)
        # rounds > 0 feed the parameter nodes as declared overrides
        prog_prop = compile_program(
            self.model, tuple(self.output_names),
            override_names=tuple(sorted(self.parameter_names)),
            device=self.device)
        start = self.state.get("_next_batch_index", 0)
        pb = _ProgressBar() if self.bar else None
        while True:
            rej = self._rejection
            rej.bar = False
            rnd = self.state["round"]
            with annotate("elfi.smc.round"):
                counts = rej._run_fused(
                    prog if rnd == 0 else prog_prop,
                    rej.objective.get("threshold"), seed=self.seed,
                    start_index=start,
                    overrides_spec=self._propose if rnd else None)
            start += rej.state["n_batches"]
            for k, v in counts.items():
                if not isinstance(v, list):     # not a run's per device
                    fold = max if k == "redraw_rounds" else operator.add
                    self.state[k] = fold(self.state.get(k, 0), v)
            self.state["n_sim"] += rej.state["n_sim"]
            self.state["n_batches"] += rej.state["n_batches"]
            if pb:
                pb.update(rnd + 1, self.objective["round"] + 1)
            if not self._fused_advance_round():
                break
        if pb:
            pb.finish()
        self.state["_next_batch_index"] = start
        return self.extract_result()

    def set_objective(self, n_samples, thresholds=None, quantiles=None):
        if thresholds is None and quantiles is None:
            raise ValueError("Either thresholds or quantiles is required")
        # continuation: new rounds append after the stored populations
        self.state["round"] = len(self._populations)
        given = thresholds if thresholds is not None else quantiles
        self.schedule.extend(len(given), thresholds=thresholds,
                             quantiles=quantiles)
        self.objective.update(dict(n_samples=n_samples,
                                   n_batches=self.max_parallel_batches,
                                   round=self.schedule.n_rounds - 1))
        self._begin_round()
        self._update_objective()

    def extract_result(self):
        pop = self._extract_population()
        self._populations.append(pop)
        return SmcSample(outputs=pop.outputs,
                         populations=self._populations.copy(),
                         weights=pop.weights, threshold=pop.meta["threshold"],
                         **self._extract_result_kwargs())

    def update(self, batch, batch_index):
        super().update(batch, batch_index)
        self._rejection.update(batch, batch_index)
        if self._rejection.finished:
            self.batches.cancel_pending()
            self._advance_round()
        self._update_objective()

    def _advance_round(self):
        if self.state["round"] < self.objective["round"]:
            self._populations.append(self._extract_population())
            self.state["round"] += 1
            self._begin_round()

    def prepare_new_batch(self, batch_index):
        if self.state["round"] == 0:
            return None
        return self._propose(batch_index)

    def _begin_round(self):
        """Enter round ``state['round']``: build its internal Rejection and
        give it the round's acceptance rule (resolving a scheduled quantile
        into a concrete threshold against the previous population)."""
        with annotate("elfi.smc.next_round"):
            r = self.state["round"]
            self._spawn_round_rejection(r)
            q = self.schedule.quantiles[r]
            if r == 0 and q is not None:
                # no population to take a quantile of yet
                self._rejection.set_objective(self.objective["n_samples"],
                                              quantile=q)
                return
            if q is not None:
                self.schedule.thresholds[r] = self._quantile_threshold(r, q)
            self._rejection.set_objective(
                self.objective["n_samples"],
                threshold=self.current_population_threshold)

    def _quantile_threshold(self, r, q):
        """Threshold for round ``r`` = weighted q-quantile of round
        ``r-1``'s accepted discrepancies."""
        prev = self._populations[r - 1]
        return weighted_sample_quantile(x=prev.discrepancies, alpha=q,
                                        weights=prev.weights)

    def _spawn_round_rejection(self, r):
        # Batch indices keep increasing GLOBALLY across rounds (fresh
        # simulator noise every round) because this SMC instance owns the
        # BatchHandler; the per-round Rejection only consumes batches, and
        # its sub-seed scopes the round bookkeeping.  The round's mixture
        # goes to the device once, here; the proposals and the weighing of
        # the round's population both use it.
        seed = self.seed if r == 0 else get_sub_seed(self.seed, r)
        self._round_seed = seed
        self._proposal = None if r == 0 else GMDistribution.prepare(
            *self._gm_params, device=self.device)
        self._propose = None if r == 0 else _GMProposals(
            self.parameter_names, self.batch_size, self._prior_logpdf,
            self._proposal, seed)
        self._rejection = Rejection(
            self.model, discrepancy_name=self.discrepancy_name,
            output_names=self.output_names, batch_size=self.batch_size,
            seed=seed, max_parallel_batches=self.max_parallel_batches,
            device=self.device)

    def _extract_population(self):
        with annotate("elfi.smc.population"):
            sample = self._rejection.extract_result()
            sample.method_name = "Rejection within SMC-ABC"
            theta, w, cov = self._weigh_population(sample)
            sample.means = theta
            sample.weights = w
            sample.meta["cov"] = cov
            return sample

    def _weigh_population(self, pop):
        """Importance weights, parameter matrix and perturbation covariance
        for an accepted population.

        Draws came from the round's Gaussian-mixture proposal q over the
        previous population (round 0: the prior itself), so ``w =
        prior(theta) / q(theta)``, both log-densities taken in float32 on
        the device; the next round perturbs with the component-wise kernel
        ``cov = 2 Var_w(theta)`` (Beaumont et al. 2009).  Every proposal
        passed the prior-support check of :meth:`GMDistribution.rvs`, which
        raises rather than let an out-of-support draw through."""
        theta = batch_to_arr2d(pop.outputs, self.parameter_names)
        if self._proposal is None:
            w = np.ones(pop.n_samples)
        else:
            x = torch.as_tensor(theta, device=self.device)
            log_w = self._prior_logpdf(x) - GMDistribution.logpdf(
                x, self._proposal)
            with annotate("elfi.host_read"):
                log_w = log_w.cpu().numpy()
            w = np.exp(log_w)
        if not np.any(w > 0):
            raise RuntimeError(
                "Every importance weight is zero — with a bounded-support "
                "prior this usually means the population is too small.")
        cov = 2.0 * np.diag(weighted_var(theta, w))
        if not np.all(np.isfinite(cov)):
            cov = np.eye(theta.shape[1])
        return theta.copy(), w, cov

    def _update_objective(self):
        done = sum(pop.meta["n_batches"] for pop in self._populations)
        self.objective["n_batches"] = done + \
            self._rejection.objective["n_batches"]

    @property
    def _gm_params(self):
        sample = self._populations[-1]
        return sample.means, sample.meta["cov"], sample.weights

    @property
    def current_population_threshold(self):
        return self.schedule.thresholds[self.state["round"]]

    def _extract_result_kwargs(self):
        kwargs = super()._extract_result_kwargs()
        kwargs.pop("threshold", None)
        return kwargs


class AdaptiveDistanceSMC(SMC):
    """SMC-ABC with adaptive distance (Prangle 2017 Algorithm 5; reference
    ``samplers.py:562-659``)."""

    def __init__(self, model, discrepancy_name=None, output_names=None,
                 **kwargs):
        model, discrepancy_name = self._resolve_model(model, discrepancy_name)
        if not isinstance(model[discrepancy_name], AdaptiveDistance):
            raise TypeError("This method requires an adaptive distance node")
        model[discrepancy_name].init_state()
        sums = [s.name for s in model[discrepancy_name].parents]
        if output_names is None:
            output_names = sums
        else:
            output_names = output_names + [k for k in sums
                                           if k not in output_names]
        super().__init__(model, discrepancy_name, output_names=output_names,
                         **kwargs)

    _fused_capable = False  # per-batch Welford scale updates are host-side

    def sample(self, n_samples, rounds, quantile=0.5, bar=True, **kwargs):
        return Sampler.sample(self, n_samples, rounds=rounds,
                              quantile=quantile, bar=bar, **kwargs)

    def set_objective(self, n_samples, rounds, quantile=0.5):
        super().set_objective(ceil(n_samples / quantile),
                              quantiles=[1] * rounds)
        self.population_size = n_samples
        self.quantile = quantile

    def _extract_population(self):
        rejection_sample = self._rejection.extract_result()
        outputs = {k: rejection_sample.outputs[k][:self.population_size]
                   for k in self.output_names}
        meta = dict(rejection_sample.meta)
        node = self.model[self.discrepancy_name]
        meta["adaptive_distance_w"] = node.adaptive_state["w"][-1]
        d = outputs[self.discrepancy_name]
        meta["threshold"] = float(np.max(d if d.ndim == 1 else d[:, -1]))
        meta["accept_rate"] = self.population_size / meta["n_sim"]
        sample = Sample("Rejection within adaptive distance SMC-ABC",
                        outputs, self.parameter_names,
                        discrepancy_name=self.discrepancy_name, **meta)
        theta, w, cov = self._weigh_population(sample)
        sample.means = theta
        sample.weights = w
        sample.meta["cov"] = cov
        return sample

    def _extract_result_kwargs(self):
        kwargs = super()._extract_result_kwargs()
        kwargs["adaptive_distance_w"] = [pop.meta["adaptive_distance_w"]
                                         for pop in self._populations]
        return kwargs

    def _quantile_threshold(self, r, q):
        # the distance functions change every round, so the next round's
        # bound is the previous population's max distance, not a quantile
        return self._populations[r - 1].meta["threshold"]

    @property
    def current_population_threshold(self):
        """Vector threshold: one bound per accumulated distance function."""
        return np.asarray(
            [np.inf] + [pop.meta["threshold"] for pop in self._populations],
            dtype=np.float32)


class AdaptiveThresholdSMC(SMC):
    """ABC-SMC with adaptive threshold selection via density-ratio
    estimation (Simola et al. 2021; reference ``samplers.py:662-841``).
    The density-ratio fit runs on the sampler's device: the default
    estimator is made there, and a given one must be on it."""

    def __init__(self, model, discrepancy_name=None, output_names=None,
                 initial_quantile=0.20, q_threshold=0.99,
                 densratio_estimation=None, **kwargs):
        super().__init__(model, discrepancy_name,
                         output_names=output_names, **kwargs)
        self.q_threshold = q_threshold
        self.initial_quantile = initial_quantile
        from .density_ratio_estimation import DensityRatioEstimation
        if densratio_estimation is None:
            densratio_estimation = DensityRatioEstimation(
                n=100, epsilon=0.001, max_iter=200, abs_tol=0.01, fold=5,
                optimize=False, device=self.device)
        elif densratio_estimation.device != self.device:
            raise ValueError(
                f"densratio_estimation is on {densratio_estimation.device}, "
                f"the sampler on {self.device}: give the estimator "
                f"device={self.device!r}")
        self.densratio = densratio_estimation

    def sample(self, n_samples, max_iter=10, fused=None, bar=True, **kwargs):
        """Sample with adaptive threshold selection.  Rounds run fused on
        the device by default (eligibility as for :meth:`SMC.sample`); the
        density-ratio quantile selection happens between rounds."""
        with annotate("elfi.sample"):
            self.bar = bar
            fused, prog = self._resolve_fused(fused, kwargs)
            if not fused:
                return Sampler.sample(self, n_samples, max_iter=max_iter,
                                      bar=bar, **kwargs)
            return self._sample_fused(n_samples, dict(max_iter=max_iter),
                                      prog)

    def _fused_advance_round(self):
        """Mirrors the unfused ``update``: fit the density ratio, stop when
        the next quantile exceeds ``q_threshold`` or rounds run out."""
        self._new_population = self._extract_population()
        if self.state["round"] >= self.objective["round"]:
            return False
        if self._set_adaptive_quantile() >= self.q_threshold:
            return False
        self._populations.append(self._new_population)
        self.state["round"] += 1
        self._begin_round()
        return True

    def set_objective(self, n_samples, max_iter=10):
        self.state["round"] = len(self._populations)
        # quantile slots beyond round 0 stay empty until the density-ratio
        # fit fills them between rounds
        self.schedule.extend(max_iter,
                             quantiles=[self.initial_quantile]
                             + [None] * (max_iter - 1))
        self.objective.update(dict(n_samples=n_samples,
                                   n_batches=self.max_parallel_batches,
                                   round=self.schedule.n_rounds - 1))
        self._begin_round()
        self._update_objective()

    def update(self, batch, batch_index):
        Sampler.update(self, batch, batch_index)
        self._rejection.update(batch, batch_index)
        if self._rejection.finished:
            self.batches.cancel_pending()
            self._new_population = self._extract_population()
            if self.state["round"] < self.objective["round"] and \
                    self._set_adaptive_quantile() < self.q_threshold:
                self._populations.append(self._new_population)
                self.state["round"] += 1
                self._begin_round()
        self._update_objective()

    def _set_adaptive_quantile(self):
        """Fill the NEXT round's quantile slot with
        ``max(1 / max-density-ratio, 0.05)`` and return it (reference
        ``samplers.py:791-813``)."""
        from .density_ratio_estimation import calculate_densratio_basis_sigma
        cur = self._resolve_sample(0)
        prev = self._resolve_sample(-1)
        if self.densratio.optimize:
            sigma = list(10.0 ** np.arange(-1, 6))
        else:
            sigma = calculate_densratio_basis_sigma(cur["sigma_max"],
                                                    prev["sigma_max"])
        self.densratio.fit(x=cur["samples"], y=prev["samples"],
                           weights_x=cur["weights"], weights_y=prev["weights"],
                           sigma=sigma)
        max_value = max(self.densratio.max_ratio(), 1.0)
        q = max(1 / max_value, 0.05)
        self.schedule.quantiles[self.state["round"] + 1] = q
        return q

    def _resolve_sample(self, backwards_index):
        if self.state["round"] + backwards_index < 0:
            return self._densityratio_initial_sample()
        sample = self._new_population if backwards_index == 0 \
            else self._populations[backwards_index]
        weights = sample.weights
        samples = sample.samples_array
        sigma_max = float(np.min(np.sqrt(np.diag(sample.meta["cov"]))))
        return dict(samples=samples, weights=weights, sigma_max=sigma_max)

    def _densityratio_initial_sample(self):
        n_samples = self._new_population.weights.shape[0]
        samples = self._prior.rvs(
            size=n_samples, seed=fold_in(self._round_seed, _PROPOSAL_SALT))
        weights = np.ones(n_samples)
        cov = np.atleast_2d(np.cov(samples.reshape(n_samples, -1),
                                   rowvar=False))
        return dict(samples=samples, weights=weights,
                    sigma_max=float(np.min(np.sqrt(np.diag(cov)))))

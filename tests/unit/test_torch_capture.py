"""The port's compiled program and its captured loops, rehearsed on the
CPU: ``CompiledProgram.jitted`` against ``traceable`` and the JAX package's
``jitted``; the bodies that the rejection, SMC and BSL graphs capture, run
through the capture machinery with a CPU stand-in for the CUDA graph (a
replay runs the captured function again with every stream seeded as a
replay seeds it), against the eager loops bit for bit; the masked
prior-support redraw against the eager redraw loop; and the host-side key
packing against ``stream_seed``.  The CUDA graphs themselves run in
``test_torch_capture_cuda.py``."""

import contextlib
import types
from functools import partial

import numpy as np
import pytest
import torch

import jax

import elfi_tpu_torch as et
from elfi_tpu.compile.compiler import compile_program as jax_compile_program
from elfi_tpu.models import ma2 as jax_ma2
from elfi_tpu_torch.compile.compiler import compile_program
from elfi_tpu_torch.methods import samplers
from elfi_tpu_torch.methods.bsl import method as bsl_method
from elfi_tpu_torch.methods.utils import GMDistribution, PreparedGM
from elfi_tpu_torch.model.model import node_uid
from elfi_tpu_torch.models import gauss, ma2, ma2_kernel
from elfi_tpu_torch.ops import topk
from elfi_tpu_torch.utils import capture, profiling, rng

from test_torch_spans import inside, spans_of

torch.set_num_threads(1)

# the JAX comparison: float32 sums in another order
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


class _SlotSource:
    """The streams of one replay of an :class:`_EagerGraph`."""

    def __init__(self, graph, seeds):
        self.graph, self.seeds, self.i = graph, seeds, 0

    def request(self, family, base, batch_index, uid, device):
        g = self.graph
        assert g.slots[self.i] == (family, batch_index - g.start, uid)
        gen = rng.generator(self.seeds[self.i], device)
        self.i += 1
        return gen

    def key(self, generator):
        return None


class _EagerGraph:
    """``capture.Graph`` on the CPU: capture records nothing, and a replay
    runs the captured function again with each recorded stream seeded as a
    graph replay seeds its generator (``Graph.seeds``).  Persistent
    generators advance as the function draws from them, as they do across
    replays."""

    made = []

    def __init__(self, fn, recorder, start, device, persistent=()):
        self.fn, self.slots, self.start = fn, list(recorder.slots), start
        self.replays = 0
        _EagerGraph.made.append(self)

    seeds = capture.Graph.seeds

    def replay(self, bases, start):
        src = _SlotSource(self, self.seeds(bases, start))
        with rng.stream_source(src):
            out = self.fn()
        assert src.i == len(self.slots)
        self.replays += 1
        return out


@pytest.fixture
def cpu_capture(monkeypatch):
    """The capture path with :class:`_EagerGraph` for the CUDA graph;
    ``state["on"] = False`` takes the eager loops."""
    state = {"on": True}
    _EagerGraph.made = []
    monkeypatch.setattr(capture, "enabled", lambda device: state["on"])
    monkeypatch.setattr(capture, "on_side_stream",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(capture, "Graph", _EagerGraph)
    return state


def _equal(a, b):
    return a.dtype == b.dtype and np.array_equal(
        np.asarray(a), np.asarray(b), equal_nan=True)


# -- CompiledProgram.jitted ----------------------------------------------------

def _ma2_overrides(b, seed=0):
    g = np.random.default_rng(seed)
    return {"t1": g.uniform(-1, 1, b).astype(np.float32),
            "t2": g.uniform(-0.5, 0.5, b).astype(np.float32),
            "MA2": g.standard_normal((b, 100)).astype(np.float32)}


def test_jitted_on_the_cpu_is_traceable_and_equals_jax():
    b = 128
    ov = _ma2_overrides(b)
    outs = ("S1", "S2", "d")
    pt = compile_program(ma2.get_model(seed_obs=4), outs,
                         override_names=tuple(ov), device="cpu")
    assert pt.jitted(b) is pt.traceable(b)
    pj = jax_compile_program(jax_ma2.get_model(seed_obs=4), outs,
                             override_names=tuple(ov))
    oj = pj.jitted(b)(jax.random.key(0), np.uint32(3), ov)
    ot = pt.jitted(b)(0, 3, ov)
    tr = pt.traceable(b)(0, 3, ov)
    for k in outs:
        assert torch.equal(ot[k], tr[k])
        np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("model", [ma2, ma2_kernel])
def test_jitted_replays_equal_traceable(cpu_capture, model):
    """Every call after the first two replays the graph; each equals the
    eager call at its (seed, batch), new seeds and overrides included."""
    m = model.get_model(seed_obs=4)
    prog = compile_program(m, ("t1", "t2", "d"), device="cpu")
    fn = prog.jitted(64)
    assert fn is not prog.traceable(64)
    calls = [(0, 0), (0, 1), (0, 2), (5, 9), (7, 2**40), (0, 1)]
    for seed, b in calls:
        got = prog.run(seed, b, batch_size=64)
        want = prog.traceable(64)(seed, b, {})
        for k in want:
            assert _equal(got[k], want[k]), (seed, b, k)
    assert len(_EagerGraph.made) == 1
    assert _EagerGraph.made[0].replays == len(calls) - 1

    prog_ov = compile_program(m, ("d",), override_names=("t1", "t2"),
                              device="cpu")
    for b in range(4):
        ov = {k: torch.as_tensor(v) for k, v in
              list(_ma2_overrides(64, seed=b).items())[:2]}
        got = prog_ov.run(3, b, ov, batch_size=64)["d"]
        assert _equal(got, prog_ov.traceable(64)(3, b, ov)["d"])


def test_programs_that_cannot_be_captured(cpu_capture):
    from elfi_tpu_torch.models import daycare, lotka_volterra
    m = ma2.get_model(seed_obs=4)
    assert compile_program(m, ("d",), device="cpu").capturable
    et.Operation(lambda d, meta: d, m["d"], uses_meta=True, model=m,
                 name="meta_d")
    prog = compile_program(m, ("meta_d",), device="cpu")
    assert not prog.capturable
    with pytest.raises(ValueError, match="cannot be captured"):
        prog.jitted(8)
    # run() takes the eager function for it
    assert _equal(prog.run(1, 2, batch_size=8)["meta_d"],
                  prog.traceable(8)(1, 2, {})["meta_d"])
    # capture is opt-in: the zoo's simulators are not marked
    for mod in (daycare, lotka_volterra):
        lm = mod.get_model()
        sim = next(n for n in lm.dag.nodes
                   if lm.dag.get_state(n)["kind"] == "simulator")
        assert not compile_program(lm, (sim,), device="cpu").capturable


def test_capture_is_opt_in(cpu_capture):
    """A user's op, a prior of a user's distribution and a
    ``vectorize_traced`` op (it seeds the default generator from
    ``generator.initial_seed()``) keep a program eager; marking the op
    ``capturable = True`` opts it in."""
    from elfi_tpu_torch.model.tools import vectorize_traced

    def build(op=None, prior=None):
        m = ma2.get_model(seed_obs=4)
        if op is not None:
            m.update_node("MA2", op=op)
        if prior is not None:
            m.update_node("t1", distribution=prior)
        return compile_program(m, ("d",), device="cpu")

    sim_op = ma2.get_model(seed_obs=4)["MA2"].state["op"]

    def user_sim(*args, **kwargs):
        return sim_op(*args, **kwargs)

    class UserPrior(ma2.CustomPrior1):
        capturable = False

    assert build().capturable
    assert not build(op=user_sim).capturable
    assert not build(prior=UserPrior).capturable
    assert not build(op=partial(user_sim)).capturable
    vmapped = vectorize_traced(lambda t1, t2: ma2.MA2(t1, t2)[0])
    assert not build(op=vmapped).capturable
    user_sim.capturable = True
    assert build(op=user_sim).capturable
    assert build(op=partial(user_sim)).capturable
    # an unmarked program runs eagerly through run()
    prog = build(op=vmapped)
    with pytest.raises(ValueError, match="cannot be captured"):
        prog.jitted(8)
    assert _equal(prog.run(1, 2, batch_size=8)["d"],
                  prog.traceable(8)(1, 2, {})["d"])


# -- the rejection chunk graph -------------------------------------------------

def _old_loop(prog, batch_size, seed, n, disc, threshold, n_batches,
              spec=None, start=0):
    """The fused loop as the port ran it before its chunks were graphs:
    one program call and one flat merge a batch (every merge schedule of
    the fused loop gives these rows)."""
    fn = prog.traceable(batch_size)
    buf = None
    for i in range(start, start + n_batches):
        out = fn(seed, i, spec(i) if spec else {})
        if buf is None:
            buf = topk.init_buffers(n, out, disc)
        buf, _ = topk.merge_core(buf, out, threshold, disc)
    return buf


@pytest.fixture
def small_chunks(monkeypatch):
    """Chunks of 4 batches, and the culled merge (the kernel's plain
    version) from batches of 64 rows."""
    monkeypatch.setattr(samplers, "_FUSED_CHUNK", 4)
    monkeypatch.setattr(topk, "CULL_MIN_BATCH", 64)
    monkeypatch.setattr(topk, "CULL_SMALL_K", 8)


@pytest.mark.parametrize("model", [ma2, ma2_kernel])
@pytest.mark.parametrize("threshold", [None, 0.2])
def test_rejection_chunk_graph_equals_eager_and_old_loop(
        cpu_capture, small_chunks, model, threshold):
    m = model.get_model(seed_obs=4)
    kw = dict(n_sim=64 * 22) if threshold is None else dict(
        threshold=threshold)

    def run():
        rej = et.Rejection(m["d"], batch_size=64, seed=5)
        return rej, rej.sample(40, bar=False, **kw)

    cpu_capture["on"] = False
    _, eager = run()
    cpu_capture["on"] = True
    rej, got = run()
    for k in ("d", "t1", "t2"):
        assert _equal(got.outputs[k], eager.outputs[k]), k
    assert got.n_sim == eager.n_sim
    # the program keeps the chunk graphs: each key recorded, captured,
    # replayed
    prog = compile_program(m, tuple(rej.output_names), device="cpu")
    assert prog.replays.captures >= 1 and prog.replays.replays >= 1
    # a second sampler replays them from its first chunk, equal again
    before = prog.replays.captures
    _, again = run()
    for k in ("d", "t1", "t2"):
        assert _equal(again.outputs[k], eager.outputs[k]), k
    assert prog.replays.captures <= before + 1
    thr = samplers._float32_threshold(threshold, "cpu")
    old = _old_loop(prog, 64, 5, 40, "d", thr, got.n_sim // 64)
    for k in ("d", "t1", "t2"):
        assert _equal(got.outputs[k], old[k].numpy()), k


# -- SMC rounds: the proposal chunk graph ------------------------------------

def _smc(model, rounds_kw, seed=3):
    smc = et.SMC(model["d"], batch_size=64, seed=seed)
    return smc, smc.sample(100, bar=False, **rounds_kw)


def _round_graphs(smc):
    """The chunk graphs of an SMC's rounds >= 1 (its proposal program's)."""
    return compile_program(
        smc.model, tuple(smc.output_names),
        override_names=tuple(sorted(smc.parameter_names)),
        device="cpu").replays


def _learned_rounds(graphs):
    """The redraw rounds learned for the proposal graphs in ``graphs``."""
    learned = [v for k, v in graphs.memo.items() if k[0] == "redraw_rounds"]
    assert len(learned) <= 1
    return learned[0] if learned else 0


def _same_populations(got, want, names):
    assert len(got.populations) == len(want.populations)
    for pg, pe in zip(got.populations, want.populations):
        for k in names:
            assert _equal(pg.outputs[k], pe.outputs[k]), k
        np.testing.assert_array_equal(pg.weights, pe.weights)


@pytest.mark.parametrize("warm", [False, True])
def test_smc_rounds_replayed_equal_eager(cpu_capture, small_chunks, warm):
    """Rounds >= 1 replay one graph a merge schedule.  A cold run learns
    the redraw rounds from its eager proposal chunks (MA2's proposals
    leave the triangle prior's support): its first proposal chunk runs
    eagerly and a chunk whose batch needed more than its graph held runs
    again eagerly; a warm run replays every chunk, none run again, and
    both give the eager run's populations."""
    m = ma2.get_model(seed_obs=4)
    kw = dict(quantiles=[0.5, 0.05, 0.05])
    cpu_capture["on"] = False
    _, eager = _smc(m, kw)
    cpu_capture["on"] = True
    smc, got = _smc(m, kw)
    _same_populations(got, eager, ("d", "t1", "t2"))
    graphs = _round_graphs(smc)
    learned = _learned_rounds(graphs)
    assert learned > 0
    assert smc.state["redraw_rounds"] == learned
    assert smc.state["redone_chunks"] > 0
    if warm:
        replays = graphs.replays
        smc, got = _smc(m, kw)
        _same_populations(got, eager, ("d", "t1", "t2"))
        assert smc.state["redone_chunks"] == 0
        assert smc.state["redraw_rounds"] == _learned_rounds(graphs) \
            == learned
        batches = sum(p.meta["n_batches"] for p in got.populations[1:])
        assert graphs.replays - replays == batches // samplers._FUSED_CHUNK
    # one graph a merge schedule and count serves every round >= 1
    assert len([g for g in graphs.entries.values()
                if isinstance(g, tuple)]) <= 3


def test_gauss2d_smc_rounds_replayed_equal_eager(cpu_capture, small_chunks):
    """The bench's gauss2d SMC (batch 16384, wide uniform priors): no
    proposal leaves the support, so the learned redraw rounds stay 0, the
    graph's key holds 0, and every chunk of a warm run replays."""
    m = gauss.get_model(n_obs=50, true_params=[4.0, 2.0], nd_mean=True,
                        cov_matrix=np.eye(2))

    def run():
        smc = et.SMC(m["d"], batch_size=16384, seed=4)
        return smc, smc.sample(2000, thresholds=[2.0, 1.0, 0.5, 0.3],
                               bar=False)

    cpu_capture["on"] = False
    _, eager = run()
    cpu_capture["on"] = True
    run()
    smc, got = run()
    _same_populations(got, eager, ("d", "mu_0", "mu_1"))
    graphs = _round_graphs(smc)
    assert graphs.replays > 0
    assert _learned_rounds(graphs) == 0
    assert smc.state["redraw_rounds"] == smc.state["redone_chunks"] == 0
    keys = [k for k in graphs.entries if k[0] == "chunk"]
    assert keys and all(k[7][1] == 0 for k in keys)


def test_smc_proposal_chunk_equals_old_loop(cpu_capture, small_chunks):
    """A round >= 1 run through the chunk graphs against the old loop on
    the same round's proposals."""
    m = ma2.get_model(seed_obs=4)
    smc = et.SMC(m["d"], batch_size=64, seed=3)
    smc.sample(40, quantiles=[0.5], bar=False)
    # the next round, fused through the graphs
    smc.set_objective(40, quantiles=[0.5])
    rej = smc._rejection
    prog = compile_program(m, tuple(smc.output_names),
                           override_names=tuple(sorted(smc.parameter_names)),
                           device="cpu")
    thr = rej._merge_threshold()
    start = smc.state["_next_batch_index"]
    rej._run_fused(prog, rej.objective["threshold"], seed=3,
                   start_index=start, overrides_spec=smc._propose)
    got = rej.state["samples"]
    old = _old_loop(prog, 64, 3, 40, "d", thr, rej.state["n_batches"],
                    spec=smc._propose, start=start)
    for k in ("d", "t1", "t2"):
        assert _equal(got[k], old[k]), k


# -- spans -------------------------------------------------------------------

def test_a_graph_cache_call_is_one_span_named_by_its_branch(cpu_capture):
    """A key's first call records, its second captures and replays, later
    ones replay; another key records again."""
    replays = capture.Replays()

    def fn(state, start):
        return {"x": state["x"] + start}, state["x"].sum()

    with profiling.recorded() as prof:
        for key in ("a", "a", "a", "a", "b"):
            replays(key, {"x": torch.zeros(3)}, fn, {}, 1, "cpu")
    assert [s[0] for s in spans_of(prof)] == [
        "elfi.graph.record", "elfi.graph.capture", "elfi.graph.replay",
        "elfi.graph.replay", "elfi.graph.record"]


@pytest.mark.parametrize("warm", [False, True])
def test_smc_chunks_hold_their_graph_and_redo_spans(cpu_capture,
                                                    small_chunks, warm):
    """An SMC run's chunks: each graph call's span lies in its chunk's.
    In a cold run a chunk whose proposals needed more redraw rounds than
    its graph held runs again eagerly inside an ``elfi.chunk.redo``, after
    its graph call; in a warm run every chunk replays its graph and none
    runs again."""
    m = ma2.get_model(seed_obs=4)
    kw = dict(quantiles=[0.5, 0.05, 0.05])
    for _ in range(3 if warm else 0):
        _smc(m, kw)             # learns the rounds, records, captures
    with profiling.recorded() as prof:
        smc, _ = _smc(m, kw)
    spans = spans_of(prof)
    chunks = [s for s in spans if s[0] == "elfi.chunk"]
    graph = [s for s in spans if s[0].startswith("elfi.graph.")]
    redos = [s for s in spans if s[0] == "elfi.chunk.redo"]
    held = [[s for s in graph + redos if inside(s, c)] for c in chunks]
    assert sum(len(h) for h in held) == len(graph) + len(redos)
    kinds = [tuple(s[0] for s in h) for h in held]
    assert len(redos) == smc.state["redone_chunks"]
    if warm:
        assert not redos
        assert graph and {s[0] for s in graph} == {"elfi.graph.replay"}
        assert kinds == [("elfi.graph.replay",)] * len(chunks)
    else:
        assert redos
        redone = [k for k in kinds if "elfi.chunk.redo" in k]
        assert len(redone) == len(redos)
        assert all(len(k) == 2 and k[0].startswith("elfi.graph.")
                   and k[1] == "elfi.chunk.redo" for k in redone)
        assert () in kinds      # the first proposal chunk runs eagerly


# -- the masked redraw -------------------------------------------------------

def _mixture_and_box(seed=0):
    """A mixture much wider than a box prior: most rows leave the
    support, so the eager loop takes many redraw rounds."""
    g = np.random.default_rng(seed)
    prep = GMDistribution.prepare(g.uniform(-0.2, 0.2, (5, 2)), 0.5,
                                  g.uniform(0.5, 1, 5))
    calls = []

    def box_logpdf(x):
        calls.append(1)
        inside = (x.abs() < 0.4).all(dim=1)
        return torch.where(inside, 0.0, -np.inf)

    return prep, box_logpdf, calls


@pytest.mark.parametrize("size", [1, 16, 64])
def test_masked_redraw_equals_eager_redraw_loop(size):
    prep, logpdf, calls = _mixture_and_box(size)
    eager = GMDistribution.rvs(prep, size=size, prior_logpdf=logpdf,
                               generator=rng.generator(11, "cpu"))
    rounds = len(calls) - 1       # redraw rounds the eager loop took
    assert size < 16 or rounds > 3
    for k in (0, rounds - 1, rounds, rounds + 5):
        if k < 0:
            continue
        out, ok = GMDistribution.rvs_masked(prep, size, logpdf,
                                            rng.generator(11, "cpu"), k)
        assert bool(ok) == (k >= rounds), k
        if k >= rounds:
            assert _equal(out, eager), k
        else:
            # the eager redo from the same stream
            redo = GMDistribution.rvs(prep, size=size, prior_logpdf=logpdf,
                                      generator=rng.generator(11, "cpu"))
            assert _equal(redo, eager)


@pytest.mark.parametrize("cap", [None, 3])
def test_proposals_beyond_the_learned_rounds_fall_back_to_the_eager_redo(
        cpu_capture, small_chunks, monkeypatch, cap):
    """A run whose mixture needs more redraw rounds than its proposal
    graph learned from a narrower mixture of the same shapes (so the same
    graphs and count): its flagged chunk runs again eagerly and its later
    chunks eagerly, with the eager loop's rows, and the count rises to
    cover the most a batch took, or to the cap.  The count never falls: the
    narrow mixture again replays a graph with no chunk run again."""
    if cap is not None:
        monkeypatch.setattr(samplers, "_REDRAW_CAP", cap)
    m = ma2.get_model(seed_obs=4)
    prep, box, _ = _mixture_and_box(1)
    wide, narrow = (PreparedGM(prep.means, prep.L * f, prep.weights)
                    for f in (0.5, 0.1))
    prog = compile_program(m, ("d", "t1", "t2"),
                           override_names=("t1", "t2"), device="cpu")

    def run(prep):
        rej = et.Rejection(m["d"], batch_size=64, seed=3)
        rej.set_objective(40, n_sim=64 * 12)
        spec = samplers._GMProposals(("t1", "t2"), 64, box, prep, 7)
        rej._run_fused(prog, None, start_index=5, overrides_spec=spec)
        rows = {k: v.clone() for k, v in rej.state["samples"].items()}
        return rej.state, rows

    def learned_from(prep):
        """The count that the most redraw rounds a batch of the run took
        eagerly gives."""
        spec = samplers._GMProposals(("t1", "t2"), 64, box, prep, 7)
        for i in range(5, 5 + 12):
            spec(i)
        return min(spec.most_rounds + samplers._REDRAW_HEADROOM,
                   samplers._REDRAW_CAP)

    cpu_capture["on"] = False
    want = {"narrow": run(narrow)[1], "wide": run(wide)[1]}
    cpu_capture["on"] = True
    for _ in range(3):                  # learns, records, captures
        state, rows = run(narrow)
    learned = _learned_rounds(prog.replays)
    assert state["redone_chunks"] == 0
    assert state["redraw_rounds"] == learned < 3
    replays = prog.replays.replays
    state, rows = run(wide)
    for k in rows:
        assert _equal(rows[k], want["wide"][k]), k
    assert prog.replays.replays > replays     # the first chunk's graph
    assert state["redone_chunks"] == 1      # the later chunks ran eagerly
    assert state["redraw_rounds"] == learned
    rose = _learned_rounds(prog.replays)
    assert rose > learned
    assert rose == (cap if cap is not None else learned_from(wide))
    for _ in range(2):
        state, rows = run(narrow)
        for k in rows:
            assert _equal(rows[k], want["narrow"][k]), k
    assert _learned_rounds(prog.replays) == rose
    assert state["redone_chunks"] == 0
    assert state["redraw_rounds"] == rose


def test_later_redraw_rounds_leave_earlier_draws_unchanged():
    """Each round draws from the generator's next offsets: the first draw
    and the rows a round fixes are the same whatever rounds follow."""
    prep, logpdf, _ = _mixture_and_box(3)
    first = GMDistribution._draw(prep, 64, rng.generator(5, "cpu"))
    out0, _ = GMDistribution.rvs_masked(prep, 64, logpdf,
                                        rng.generator(5, "cpu"), 0)
    assert _equal(out0, first)
    outs = [GMDistribution.rvs_masked(prep, 64, logpdf,
                                      rng.generator(5, "cpu"), k)[0]
            for k in range(6)]
    for k in range(1, 6):
        inside = (outs[k - 1].abs() < 0.4).all(dim=1)
        assert _equal(outs[k][inside], outs[k - 1][inside]), k


# -- keys --------------------------------------------------------------------

def test_key_packing_gives_stream_seeds():
    uids = [node_uid(n) for n in ("t1", "t2", "d")]
    for seed in (0, 3, 2**63 + 5, 2**64 - 1):
        rel = [("node", j, u) for j in range(16) for u in uids] + [
            ("batch", j, None) for j in range(16)]
        g = types.SimpleNamespace(slots=rel)
        for start in (0, 1, 2**40, 2**63):
            seeds = capture.Graph.seeds(g, {"node": seed, "batch": seed ^ 7},
                                        start)
            want = [rng.stream_seed(seed, start + j, u)
                    for j in range(16) for u in uids] + [
                rng.fold_in(seed ^ 7, start + j) for j in range(16)]
            assert seeds == want
            packed = capture.pack_keys(seeds)
            assert packed.dtype == np.int64
            assert packed.view(np.uint64).tolist() == want
    assert any(s >= 2**63 for s in want)     # high bits set


def test_capture_refuses_other_streams():
    rec = capture.Recorder(start=4)
    rec.request("node", 1, 4, 7, "cpu")
    rec.request("node", 1, 5, 7, "cpu")
    g = types.SimpleNamespace(slots=rec.slots, gens=[object(), object()],
                              bases={}, keys=None, need_keys=False)
    src = capture._Replayer(g, 10)
    src.request("node", 2, 10, 7, "cpu")
    with pytest.raises(RuntimeError, match="asked for stream"):
        src.request("node", 2, 12, 7, "cpu")
    src = capture._Replayer(g, 10)
    src.request("node", 2, 10, 7, "cpu")
    with pytest.raises(RuntimeError, match="two"):
        src.request("node", 3, 11, 7, "cpu")
    with pytest.raises(RuntimeError, match="not one of the graph"):
        src.key(torch.Generator())


# -- the BSL chain -----------------------------------------------------------

def _old_fused_chain(self, n_samples, fn, loglik_t, observed, Lprop, theta0,
                     logit, capturable=False):
    """``BSL._fused_chain`` as it was before its steps were graphs."""
    dev = theta0.device
    d = theta0.shape[0]
    B = self.batch_size
    pnames = list(self.parameter_names)
    feats = list(self.feature_names)
    seed = self.seed
    prior_logpdf = self.prior.traceable_logpdf()
    to_tilde, back, jac = logit
    gen = rng.generator(rng.fold_in(seed, bsl_method._CHAIN_SALT), dev)

    def loglik_of(theta, i):
        out = fn(seed, i, {p: theta[j].expand(B)
                           for j, p in enumerate(pnames)})
        sx = torch.column_stack([out[f].reshape(B, -1) for f in feats])
        ll = loglik_t(sx, observed)
        return torch.where(torch.isfinite(sx).all(), ll, -np.inf)

    thetas = torch.empty((n_samples, d), dtype=torch.float32, device=dev)
    posts = torch.empty((n_samples,), dtype=torch.float32, device=dev)
    n_acc = torch.zeros((), dtype=torch.int64, device=dev)
    theta = theta0
    logpost = loglik_of(theta0, 0) + prior_logpdf(theta0[None, :])[0]
    thetas[0] = theta
    posts[0] = logpost
    for i in range(1, n_samples):
        z = torch.randn((d,), generator=gen, device=dev)
        prop = back(to_tilde(theta) + Lprop @ z)
        post = loglik_of(prop, i) + prior_logpdf(prop[None, :])[0]
        ratio = post - logpost + jac(prop) - jac(theta)
        u = torch.rand((), generator=gen, device=dev)
        accept = (torch.log(u) < torch.clamp(ratio, -700, 700)) \
            & torch.isfinite(post)
        theta = torch.where(accept, prop, theta)
        logpost = torch.where(accept, post, logpost)
        if i >= self.burn_in:
            n_acc += accept
        thetas[i] = theta
        posts[i] = logpost
    return thetas, posts, n_acc


@pytest.mark.parametrize("logit", [False, True])
def test_bsl_step_blocks_replayed_equal_eager_and_old_chain(
        cpu_capture, monkeypatch, logit):
    monkeypatch.setattr(bsl_method, "_CHAIN_BLOCK", 4)
    m = ma2.get_model(seed_obs=4)
    kw = dict(sigma_proposals=np.diag([.05, .05]), params0=[[.6, .2]],
              burn_in=5)
    if logit:
        kw["logit_transform_bound"] = np.array([[-2, 2], [-1, 1]])

    def run():
        b = et.BSL(m, n_sim_round=50, seed=4)
        return b, b.sample(23, bar=False, **kw)

    cpu_capture["on"] = False
    eager = run()
    cpu_capture["on"] = True
    got = run()
    # steps 1 .. 22 in blocks of 4: 1-4 recorded, 5-8 captured, 5-20
    # replayed, 21-22 eager
    assert got[0]._chain_replays.captures == 1
    assert got[0]._chain_replays.replays == 4
    monkeypatch.setattr(bsl_method.BSL, "_fused_chain", _old_fused_chain)
    cpu_capture["on"] = False
    old = run()
    for b, res in (eager, old):
        for k in ("t1", "t2"):
            assert _equal(got[1].samples_all[k], res.samples_all[k]), k
        assert got[0].num_accepted == b.num_accepted

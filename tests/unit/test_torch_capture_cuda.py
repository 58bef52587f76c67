"""The port's CUDA graphs on the card (``utils/capture.py``): every captured
path against the same path run eagerly (``capture._ENABLED = False``), bit
for bit -- ``CompiledProgram.jitted``, a ``vectorize_traced`` simulator
(not captured: capture is opt-in), MA2 rejection on both graphs with and
without a threshold, g-and-k on the kernel graph, Lorenz-96's graph,
SMC on gauss2d and on
MA2 (its redraw rounds in conditional nodes, and without them), the BSL
chain (under ``torch.cuda.set_sync_debug_mode("error")``) --
the kernels K1 and K2 keyed from device memory against their value path,
and the cull captured in a graph against the cull launched eagerly.

Every test needs a CUDA device and skips without one.  The file does not
import JAX, so on a machine with a card

    python -m pytest --noconftest -m cuda tests/unit/test_torch_capture_cuda.py

runs it alone.
"""

import numpy as np
import pytest
import torch

import elfi_tpu_torch as et
from elfi_tpu_torch.compile.compiler import compile_program
from elfi_tpu_torch.methods import samplers
from elfi_tpu_torch.methods.bsl import method as bsl_method
from elfi_tpu_torch.methods.utils import GMDistribution
from elfi_tpu_torch.models import gauss, gnk_kernel, ma2, ma2_kernel
from elfi_tpu_torch.ops import topk
from elfi_tpu_torch.ops.kernels import gnk as k2
from elfi_tpu_torch.ops.kernels import ma2 as k1
from elfi_tpu_torch.ops.kernels import topn
from elfi_tpu_torch.utils import capture

from chunk_keys import chunk_keys

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend, and put their own work on the
    card."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def eager(monkeypatch):
    """``eager(fn)``: ``fn()`` with the loops and programs run eagerly."""
    def run(fn):
        monkeypatch.setattr(capture, "_ENABLED", False)
        try:
            return fn()
        finally:
            monkeypatch.setattr(capture, "_ENABLED", True)
    return run


def _bits_equal(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


def _same_sample(a, b, names):
    for k in names:
        assert _bits_equal(a.outputs[k], b.outputs[k]), k


def _counts(fn):
    return fn.launches, fn.captured, fn.graph_launches


@pytest.mark.cuda
@pytest.mark.parametrize("model", [ma2, ma2_kernel])
def test_jitted_equals_traceable(cuda, model):
    prog = compile_program(model.get_model(seed_obs=4), ("t1", "t2", "d"),
                           device=cuda)
    fn = prog.jitted(4096)
    before = _counts(k1.ma2_distance)
    for seed, b in [(0, 0), (0, 1), (0, 2), (5, 9), (7, 2**40), (0, 1)]:
        got = {k: v.clone() for k, v in fn(seed, b, {}).items()}
        want = prog.traceable(4096)(seed, b, {})
        for k in want:
            assert torch.equal(got[k], want[k]), (seed, b, k)
    launches, captured, graph = (a - b for a, b in
                                 zip(_counts(k1.ma2_distance), before))
    if model is ma2_kernel:
        # one recorded call, one capture, five replays; six eager calls
        assert (launches, captured, graph) == (7, 1, 5)
    out = prog.run(3, 4, batch_size=4096)
    assert out["d"].data_ptr() != fn(3, 4, {})["d"].data_ptr()


@pytest.mark.cuda
def test_vectorize_traced_runs_eagerly_and_equals_eager(cuda, eager):
    """A ``vectorize_traced`` simulator seeds the default CUDA generator
    from ``generator.initial_seed()``: capture is opt-in and it is not
    marked, so its fused run and ``program.run`` make no graph and equal
    the eager runs bit for bit, with each batch's noise its own."""
    from elfi_tpu_torch.model.tools import vectorize_traced
    m = ma2.get_model(seed_obs=4)

    def one(t1, t2):
        w = torch.randn(102, device=t1.device)
        return w[2:] + t1 * w[1:-1] + t2 * w[:-2]

    m.update_node("MA2", op=vectorize_traced(one))
    prog = compile_program(m, ("d", "t1", "t2"), device=cuda)
    assert not prog.capturable

    def run():
        return et.Rejection(m["d"], batch_size=2**12, seed=2,
                            device=cuda).sample(200, n_sim=2**12 * 40,
                                                bar=False)

    ref = eager(run)
    got = run()
    _same_sample(got, ref, ("d", "t1", "t2"))
    assert prog.replays.captures == prog.replays.replays == 0
    a = prog.run(3, 0, batch_size=256)
    b = prog.run(3, 1, batch_size=256)
    assert torch.equal(a["d"], prog.traceable(256)(3, 0, {})["d"])
    assert not torch.equal(a["d"], b["d"])


@pytest.mark.cuda
@pytest.mark.parametrize("graph", ["plain", "kernel"])
@pytest.mark.parametrize("threshold", [None, 0.1])
def test_ma2_rejection_captured_equals_eager(cuda, eager, graph, threshold):
    m = (ma2 if graph == "plain" else ma2_kernel).get_model(seed_obs=4)
    bs = 2**16
    kw = dict(n_sim=bs * 80) if threshold is None else dict(
        threshold=threshold)

    def run():
        return et.Rejection(m["d"], batch_size=bs, seed=2,
                            device=cuda).sample(1000, bar=False, **kw)

    ref = eager(run)
    # the first run learns the merge unroll and records a steady chunk,
    # the second records its first chunk; later samplers replay them
    earlier = [run(), run()]
    c0 = _counts(topn.topn_cull)
    k0 = _counts(k1.ma2_distance)
    got = run()
    for res in (*earlier, got):
        _same_sample(res, ref, ("d", "t1", "t2"))
        assert res.n_sim == ref.n_sim
    cull = [a - b for a, b in zip(_counts(topn.topn_cull), c0)]
    if got.n_batches > 16:       # a chunk after the first merges culled
        assert cull[2] > 0      # the cull inside the graphs
    if graph == "kernel":
        kern = [a - b for a, b in zip(_counts(k1.ma2_distance), k0)]
        assert kern[0] + kern[2] == got.n_batches
        assert kern[2] > 0


@pytest.mark.cuda
def test_gnk_kernel_rejection_captured_equals_eager(cuda, eager):
    m = gnk_kernel.get_model(n_obs=50, seed_obs=1)

    def run():
        return et.Rejection(m["d"], batch_size=2**16, seed=3,
                            device=cuda).sample(1000, n_sim=2**16 * 64,
                                                bar=False)

    ref = eager(run)
    k0 = _counts(k2.gnk_distance)
    got = run()
    _same_sample(got, ref, ("d", "A", "B", "g", "k"))
    kern = [a - b for a, b in zip(_counts(k2.gnk_distance), k0)]
    assert kern[0] + kern[2] == 64 and kern[2] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("batches", [16, 20])
def test_lorenz_rejection_captured_equals_eager(cuda, eager, batches):
    """ELFI's Lorenz-96 graph, captured: a run of 16 batches is one chunk,
    which the program's first captured run runs eagerly while it learns
    the merge unroll, its second records, its third captures and replays
    and its fourth replays; 20 batches add a remainder of 4 that runs
    eagerly.  Each run's parameters and distances are the eager run's bit
    for bit, and the replayed graph holds a node at least for each RK4
    step's launches."""
    from elfi_tpu_torch.models import lorenz
    m = lorenz.get_model()
    assert compile_program(m, ("d",), device=cuda).capturable

    def run():
        rej = et.Rejection(m["d"], batch_size=2**12, seed=2, device=cuda)
        return rej, rej.sample(100, n_sim=2**12 * batches, bar=False)

    _, ref = eager(run)
    for _ in range(4):
        rej, got = run()
        _same_sample(got, ref, ("d", "theta1", "theta2"))
        assert got.n_sim == ref.n_sim
    assert rej.state["card_replays"] == [1]
    assert rej.state["graph_nodes"] >= 16 * 159 * 60


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["gauss2d", "ma2", "ma2_kernel",
                                   "ma2_cell", "ma2_cell_unconditional"])
def test_smc_captured_equals_eager(cuda, eager, monkeypatch, which):
    """``ma2_cell``: the benchmark's ``ma2-smc`` shapes (batch 10,000,
    1,000 samples, thresholds 0.7, 0.2, 0.05, ``seed_obs=271``), each
    masked redraw round of a proposal graph in an IF node: the rounds run
    are the eager loop's.  ``ma2_cell_unconditional``: the same where torch
    has no conditional nodes (every held round runs), the same rows."""
    if which == "ma2_cell_unconditional":
        monkeypatch.setattr(capture, "_IF_NODES", False)
    if which == "gauss2d":
        m = gauss.get_model(n_obs=50, true_params=[4.0, 2.0], nd_mean=True,
                            cov_matrix=np.eye(2))
        names = ("d", "mu_0", "mu_1")
        kw = dict(thresholds=[2.0, 1.0, 0.5, 0.3])
        bs, n = 16384, 1000
    elif which.startswith("ma2_cell"):
        m = ma2.get_model(seed_obs=271)
        names = ("d", "t1", "t2")
        kw = dict(thresholds=[0.7, 0.2, 0.05])
        bs, n = 10000, 1000
    else:
        m = (ma2 if which == "ma2" else ma2_kernel).get_model(seed_obs=4)
        names = ("d", "t1", "t2")
        kw = dict(quantiles=[0.5, 0.2, 0.2])
        bs, n = 4096, 1000
    names = tuple(n for n in names if n in m.dag)

    def run():
        smc = et.SMC(m["d"], batch_size=bs, seed=4, device=cuda)
        return smc, smc.sample(n, bar=False, **kw)

    # the redraw rounds the eager loop takes on each proposal batch
    took = []
    counted = GMDistribution.rvs_counted

    def noted(cls, *args):
        out, rounds = counted(*args)
        took.append(rounds)
        return out, rounds

    with monkeypatch.context() as patch:
        patch.setattr(GMDistribution, "rvs_counted", classmethod(noted))
        _, ref = eager(run)
    # learns the redraw rounds, records and captures the rounds' chunks
    warm, _ = run()
    smc, got = run()
    assert len(got.populations) == len(ref.populations)
    for pg, pr in zip(got.populations, ref.populations):
        _same_sample(pg, pr, names)
        assert _bits_equal(pg.weights, pr.weights)
    graphs = compile_program(
        m, tuple(smc.output_names),
        override_names=tuple(sorted(smc.parameter_names)),
        device=cuda).replays
    assert graphs.replays > 0
    # the warm-up's proposals again: every batch within the learned rounds
    assert smc.state["redone_chunks"] == 0
    if which == "gauss2d":      # no proposal leaves its wide prior
        assert warm.state["redone_chunks"] == 0
        assert smc.state["redraw_rounds"] == 0
    else:   # MA2's leave the triangle: the graphs hold redraw rounds
        assert smc.state["redraw_rounds"] > 0
    if not which.startswith("ma2_cell"):
        return
    held = smc.state["redraw_rounds"]
    assert smc.state["masked_batches"] == len(took)
    conditional = which == "ma2_cell"
    assert smc.state["redraw_rounds_run"] == (
        sum(took) if conditional else held * len(took))
    # a graph of proposals holds an IF node a round a batch
    masked = [(key.proposals[1], graphs.entries[k][1])
              for k, key in chunk_keys(graphs).items()
              if isinstance(graphs.entries[k], tuple)
              and key.proposals is not None]
    assert masked and all(rounds == held for rounds, _ in masked)
    for rounds, graph in masked:
        assert graph.conditionals == (
            samplers._FUSED_CHUNK * rounds if conditional else 0)


def _sync_guarded(fn):
    def run(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return run


@pytest.mark.cuda
def test_bsl_captured_equals_eager(cuda, eager, monkeypatch):
    m = ma2.get_model(seed_obs=4)

    def run():
        b = et.BSL(m, n_sim_round=500, seed=4, device=cuda)
        return b, b.sample(300, sigma_proposals=np.diag([.05, .05]),
                           params0=[[.6, .2]], burn_in=50, bar=False)

    _, ref = eager(run)
    monkeypatch.setattr(bsl_method.BSL, "_fused_chain",
                        _sync_guarded(bsl_method.BSL._fused_chain))
    b, got = run()
    for k in ("t1", "t2"):
        assert _bits_equal(got.samples_all[k], ref.samples_all[k]), k
    assert b._chain_replays.captures == 1
    assert b._chain_replays.replays > 0


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 12345, 2**63 + 99, 2**64 - 1])
def test_kernels_keyed_from_device_memory(cuda, seed):
    g = torch.Generator(device=cuda).manual_seed(7)
    n = 2**16 + 3
    t1 = torch.rand(n, generator=g, device=cuda) * 2 - 1
    t2 = torch.rand(n, generator=g, device=cuda) - 0.5
    obs = torch.tensor([0.5, 0.1], device=cuda)
    key = torch.tensor(capture.pack_keys([seed]), device=cuda)
    for n_obs in (100, 7):
        a = k1.ma2_distance(t1, t2, obs, n_obs=n_obs, batch_size=n, key=seed)
        b = k1.ma2_distance(t1, t2, obs, n_obs=n_obs, batch_size=n, key=key)
        assert torch.equal(a, b)
    A, B, gg, k = (torch.rand(n, generator=g, device=cuda) * s
                   for s in (10, 5, 2, 1))
    for n_obs in (50, 17):
        obs = torch.sort(torch.randn(n_obs, generator=g,
                                     device=cuda)).values
        a = k2.gnk_distance(A, B, gg, k, obs, n_obs=n_obs, batch_size=n,
                            key=seed)
        b = k2.gnk_distance(A, B, gg, k, obs, n_obs=n_obs, batch_size=n,
                            key=key)
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cull_in_a_graph_equals_eager(cuda):
    """The cull captured on the capture stream and replayed on new data,
    against the eager cull on the same data."""
    B, n = 2**17, 5000
    g = torch.Generator(device=cuda).manual_seed(3)

    def data():
        buf = {"d": torch.rand(n, generator=g, device=cuda).sort().values,
               "x": torch.randn(n, generator=g, device=cuda)}
        buf["__key"] = buf["d"].clone()
        batch = {"d": torch.rand(B, generator=g, device=cuda) * 2,
                 "x": torch.randn(B, generator=g, device=cuda)}
        return buf, batch

    thr = torch.full((), 1.5, device=cuda)
    buf0, batch0 = data()
    sbuf = {k: v.clone() for k, v in buf0.items()}
    sbatch = {k: v.clone() for k, v in batch0.items()}
    with capture.on_side_stream(cuda):
        topk.merge_core_culled(sbuf, sbatch, thr, "d", small_k=4096)
        c0 = _counts(topn.topn_cull)
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin()
        out, acc = topk.merge_core_culled(sbuf, sbatch, thr, "d",
                                          small_k=4096)
        graph.capture_end()
    assert topn.topn_cull.captured - c0[1] == 1
    for _ in range(3):
        buf, batch = data()
        for k in sbuf:
            sbuf[k].copy_(buf[k])
        for k in sbatch:
            sbatch[k].copy_(batch[k])
        graph.replay()
        want, want_acc = topk.merge_core_culled(buf, batch, thr, "d",
                                                small_k=4096)
        flat, _ = topk.merge_core(buf, batch, thr, "d")
        for k in want:
            assert torch.equal(out[k], want[k]), k
            assert torch.equal(out[k], flat[k]), k
        assert int(acc) == int(want_acc)


@pytest.mark.cuda
def test_run_if_nests_skips_and_keeps_its_pool(cuda):
    """``capture.run_if`` 32 deep in one graph: each replay runs the levels
    down to the first whose flag is false, drawing into the graph's pool
    inside every body; the pool outlives ``empty_cache`` while the graph
    lives (the memory freed then, filled, stays as filled), and a dropped
    graph leaves no memory reserved."""
    import gc
    depth = 32
    count = torch.zeros((), dtype=torch.int64, device=cuda)
    total = torch.zeros((), device=cuda)
    flags = torch.ones(depth, dtype=torch.bool, device=cuda)

    def make():
        def level(k):
            count.add_(1)
            total.add_(torch.randn(10000, 2, device=cuda).abs().sum())
            if k + 1 < depth:
                capture.run_if(lambda: flags[k + 1], lambda: level(k + 1))

        def fn():
            capture.run_if(lambda: flags[0], lambda: level(0))
        with capture.on_side_stream(cuda):
            return capture.Graph(fn, capture.Recorder(0), 0, cuda)

    graph = make()
    assert graph.conditionals == (depth if capture._IF_NODES else 0)
    gc.collect()
    torch.cuda.empty_cache()
    filled = torch.full((2**26,), 7.0, device=cuda)
    for stop in (depth, 0, 5, 17, 1, depth):
        flags.fill_(True)
        if stop < depth:
            flags[stop] = False
        count.zero_()
        with capture.on_side_stream(cuda):
            graph.replay({}, 0)
        torch.cuda.synchronize()
        assert int(count) == (stop if capture._IF_NODES else depth), stop
    assert bool(filled.eq(7.0).all())
    del graph, filled
    gc.collect()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(cuda)
    for _ in range(3):
        graph = make()
        with capture.on_side_stream(cuda):
            graph.replay({}, 0)
        torch.cuda.synchronize()
        del graph
        gc.collect()
        torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved(cuda) == reserved

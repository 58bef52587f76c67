"""The PyTorch port's per-batch program against the JAX package's: the same
overridden inputs give the same summaries and distances, the override guard
holds, and the per-node streams keep the JAX package's invariants."""

import numpy as np
import pytest
import torch

import jax

import elfi_tpu_torch as et
from elfi_tpu.compile.compiler import compile_program as jax_compile_program
from elfi_tpu.models import ma2 as jax_ma2
from elfi_tpu_torch.compile.compiler import compile_program
from elfi_tpu_torch.models import ma2
from elfi_tpu_torch.utils.rng import _mix, fold_in, generator, stream_seed

torch.set_num_threads(1)

# float32 sums are taken in another order by the two frameworks
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


def _ma2_overrides(b, seed=0):
    rng = np.random.default_rng(seed)
    return {"t1": rng.uniform(-1, 1, b).astype(np.float32),
            "t2": rng.uniform(-0.5, 0.5, b).astype(np.float32),
            "MA2": rng.standard_normal((b, 100)).astype(np.float32)}


@pytest.mark.parametrize("seed_obs", [4, 271])
def test_overridden_ma2_equals_jax(seed_obs):
    b = 256
    ov = _ma2_overrides(b, seed=seed_obs)
    outs = ("S1", "S2", "d")
    pj = jax_compile_program(jax_ma2.get_model(seed_obs=seed_obs), outs,
                             override_names=tuple(ov))
    pt = compile_program(ma2.get_model(seed_obs=seed_obs), outs,
                         override_names=tuple(ov), device="cpu")
    oj = pj.run(jax.random.key(0), 0, ov, batch_size=b)
    ot = pt.run(0, 0, ov, batch_size=b)
    for k in outs:
        assert ot[k].dtype == torch.float32
        np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    for k in ("S1", "S2"):
        np.testing.assert_allclose(pt.observed_value(k).numpy(),
                                   np.asarray(pj.observed_value(k)),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_scalar_override_broadcasts_over_batch():
    prog = compile_program(ma2.get_model(seed_obs=4), ("MA2",),
                           override_names=("t1", "t2"), device="cpu")
    out = prog.run(1, 0, {"t1": 0.6, "t2": np.float32(0.2)}, batch_size=5)
    assert out["MA2"].shape == (5, 100)


def test_undeclared_override_raises():
    m = ma2.get_model(seed_obs=4)
    prog = compile_program(m, ("d",), override_names=("t1",), device="cpu")
    with pytest.raises(ValueError, match="not declared"):
        prog.run(0, 0, {"t2": np.zeros(4, np.float32)}, batch_size=4)
    with pytest.raises(ValueError, match="not declared"):
        prog.traceable(4)(0, 0, {"t2": np.zeros(4, np.float32)})
    with pytest.raises(ValueError, match="Unknown override"):
        compile_program(m, ("d",), override_names=("nope",), device="cpu")
    with pytest.raises(ValueError, match="Unknown output"):
        compile_program(m, ("nope",), device="cpu")


def test_reduce_to_needed_nodes_as_jax():
    mt, mj = ma2.get_model(seed_obs=4), jax_ma2.get_model(seed_obs=4)
    for outs, ov in ((("S1",), ()), (("d",), ("S1", "S2")),
                     (("d",), ("MA2",))):
        assert compile_program(mt, outs, ov, device="cpu").order == \
            jax_compile_program(mj, outs, ov).order


def test_program_cache():
    m = ma2.get_model(seed_obs=4)
    p1 = compile_program(m, ("d",), device="cpu")
    assert compile_program(m, ("d",), device="cpu") is p1
    assert compile_program(m.copy(), ("d",), device="cpu") is p1
    assert p1.observed_value("S1") is p1.observed_value("S1")
    m.update_node("d", dummy=1)
    assert compile_program(m, ("d",), device="cpu") is not p1


def test_unrelated_node_leaves_streams_unchanged():
    m = ma2.get_model(seed_obs=4)
    outs = ("t1", "t2", "MA2", "d")
    before = compile_program(m, outs, device="cpu").run(7, 3, batch_size=64)
    et.Prior("norm", 0, 1, model=m, name="unrelated")
    et.Operation(lambda x: x * 2, m["unrelated"], model=m, name="twice")
    after = compile_program(m, outs + ("twice",), device="cpu").run(
        7, 3, batch_size=64)
    for k in outs:
        assert torch.equal(before[k], after[k]), k


def test_same_seed_same_outputs_and_streams_differ():
    m = ma2.get_model(seed_obs=4)
    prog = compile_program(m, ("t1", "MA2", "d"), device="cpu")
    a = prog.run(5, 0, batch_size=32)
    b = prog.run(5, 0, batch_size=32)
    c = prog.run(5, 1, batch_size=32)
    d = prog.run(6, 0, batch_size=32)
    for k in a:
        assert torch.equal(a[k], b[k]), k
        assert not torch.equal(a[k], c[k]), k
        assert not torch.equal(a[k], d[k]), k


def test_generate_is_seeded():
    m = ma2.get_model(seed_obs=4)
    a = m.generate(batch_size=8, outputs="d", seed=11)
    b = m["d"].generate(batch_size=8, seed=11)
    np.testing.assert_array_equal(a["d"], b)


def test_stream_seed_structure():
    # one (seed, batch, node) -> one 64-bit seed; every coordinate matters
    s = {stream_seed(seed, b, uid) for seed in range(4) for b in range(4)
         for uid in (1, 2, 3)}
    assert len(s) == 48
    assert all(0 <= x < 2**64 for x in s)
    # the master seed and the batch index are not interchangeable
    assert stream_seed(1, 2, 3) != stream_seed(2, 1, 3)
    # the JAX package's fold_in(fold_in(key(seed), batch), uid) structure
    assert stream_seed(1, 2, 3) == fold_in(fold_in(_mix(1), 2), 3)
    g = generator(stream_seed(1, 2, 3), "cpu")
    assert g.initial_seed() == stream_seed(1, 2, 3)


def test_meta_and_batch_size_injection():
    m = et.Model()
    et.Prior("uniform", 0, 1, model=m, name="p")

    def op(p, meta, batch_size):
        assert batch_size == 3
        return p + 0.0 * meta["batch_index"]

    et.Operation(op, m["p"], uses_meta=True, uses_batch_size=True, model=m,
                 name="with_meta")
    out = m.generate(batch_size=3, outputs=["with_meta"])
    assert out["with_meta"].shape == (3,)


def test_host_graphs_not_ported_yet():
    # the host executor is ported now: a host simulator gets numpy and a
    # RandomState, and its output comes back as a tensor on the device
    m = et.Model()
    et.Prior("uniform", 0, 1, model=m, name="p")

    def sim(p, batch_size, random_state):
        assert isinstance(p, np.ndarray)
        assert isinstance(random_state, np.random.RandomState)
        return p

    et.Simulator(sim, m["p"], host=True, observed=np.zeros(1), model=m,
                 name="sim")
    prog = compile_program(m, ("sim",), device="cpu")
    assert prog.host
    out = prog.run(0, 0, batch_size=2)["sim"]
    assert isinstance(out, torch.Tensor) and out.shape == (2,)

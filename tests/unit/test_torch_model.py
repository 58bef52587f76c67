"""The PyTorch port's model DSL against the JAX package's: the same
declarations give the same graph, node ids and sub-seeds, and importing the
port pulls in no JAX."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import elfi_tpu as elfi
import elfi_tpu_torch as et
from elfi_tpu.model.model import node_uid as jax_node_uid
from elfi_tpu.models import ma2 as jax_ma2
from elfi_tpu.models import ma2_pallas as jax_ma2_pallas
from elfi_tpu.utils import get_sub_seed as jax_get_sub_seed
from elfi_tpu_torch.model.model import node_uid
from elfi_tpu_torch.models import ma2, ma2_kernel
from elfi_tpu_torch.utils import get_sub_seed

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _native_cpu_client():
    """The port runs on the card unless asked for the CPU: these tests ask
    for it through the global backend."""
    et.set_client("native", device="cpu")
    yield
    et.reset_client()


def _graph(m):
    dag = m.dag
    return {
        "nodes": list(dag.nodes),
        "order": dag.topological_order(),
        "parents": {n: dag.parents(n) for n in dag.nodes},
        "kinds": {n: dag.get_state(n)["kind"] for n in dag.nodes},
        "parameters": m.parameter_names,
        "observed": m.observed_node_names,
    }


@pytest.mark.parametrize("seed_obs", [4, 271])
def test_ma2_graph_equals_jax(seed_obs):
    assert _graph(ma2.get_model(seed_obs=seed_obs)) == \
        _graph(jax_ma2.get_model(seed_obs=seed_obs))


def test_ma2_kernel_graph_equals_jax():
    assert _graph(ma2_kernel.get_model(seed_obs=271)) == \
        _graph(jax_ma2_pallas.get_model(seed_obs=271))


def test_simple_model_graph_equals_jax(simple_model):
    m = et.Model(name="simple")
    et.Constant(10, model=m, name="tau")
    et.Prior("uniform", 0, m["tau"], model=m, name="k1")
    et.Prior("norm", m["k1"], size=(3,), model=m, name="k2")
    assert _graph(m) == _graph(simple_model)
    for n in ("k1", "k2"):
        assert m.dag.topological_order([n]) == \
            simple_model.dag.topological_order([n])


def test_auto_naming_and_implicit_constants_match_jax():
    def declare(pkg):
        m = pkg.Model(name="auto")
        mu = pkg.Prior("norm", 0, 1, model=m)
        pkg.Prior("uniform", mu, 2, model=m, name="u")
        return m, mu.name

    mj, nj = declare(elfi)
    mt, nt = declare(et)
    assert nt == nj == "mu"
    assert _graph(mt) == _graph(mj)


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**31 - 1])
def test_get_sub_seed_equals_jax(seed):
    for i in range(20):
        assert get_sub_seed(seed, i) == jax_get_sub_seed(seed, i)
    assert get_sub_seed(seed, 3, high=97) == jax_get_sub_seed(seed, 3,
                                                              high=97)


def test_node_uid_equals_jax():
    for name in ("t1", "t2", "MA2", "S1", "S2", "d", "a" * 100):
        assert node_uid(name) == jax_node_uid(name)


def test_flat_namespace_is_the_slice():
    names = {"Model", "Prior", "Simulator", "Summary", "Distance",
             "AdaptiveDistance", "Operation", "Constant", "Distribution", "Rejection", "Sample",
             "NativeBackend", "get_client", "set_client", "reset_client",
             "SMC", "AdaptiveDistanceSMC", "AdaptiveThresholdSMC",
             "SmcSample", "ModelPrior", "Discrepancy", "BSL", "BslSample",
             "BOLFI", "BayesianOptimization", "GPRegression", "BolfiSample",
             "OptimizationResult", "BOLFIRE", "BolfireSample", "ROMC",
             "NDimBoundingBox", "OptimisationProblem", "RomcPosterior",
             "RomcSample", "ComputationContext", "NodeReference",
             "RandomVariable", "get_default_model", "new_model",
             "set_default_model", "load_model", "BatchHandler",
             "ParameterInference", "OutputPool", "ArrayPool", "draw",
             "nx_draw", "plot_params_vs_node", "plot_predicted_summaries",
             "LinearAdjustment", "adjust_posterior", "TwoStageSelection",
             "compare_models", "Testbench", "TestbenchMethod",
             "GPyRegression"}
    public = {n for n in dir(et) if not n.startswith("_")}
    assert names <= public
    for name in names:
        assert getattr(et, name) is not None
    # the backends beyond one device, as the JAX package's namespace has
    for name in ("ClusterBackend", "MultiprocessingBackend",
                 "ShardedBackend"):
        assert getattr(et, name) is getattr(et.parallel, name)
    for name in ("LogisticRegression", "GPClassifier", "MaxVar", "RandMaxVar",
                 "ExpIntVar", "BolfirePosterior", "BolfireSample", "BOLFIRE",
                 "ROMC", "NDimBoundingBox", "OptimisationProblem",
                 "RomcPosterior", "RomcSample"):
        assert getattr(et.methods, name) is not None


def test_import_leaves_jax_out():
    code = ("import sys, elfi_tpu_torch, elfi_tpu_torch.models.ma2, "
            "elfi_tpu_torch.models.ma2_kernel, elfi_tpu_torch.interop, "
            "elfi_tpu_torch.models.gnk, elfi_tpu_torch.models.gnk_kernel, "
            "elfi_tpu_torch.models.bignk, elfi_tpu_torch.models.gauss, "
            "elfi_tpu_torch.model.extensions, "
            "elfi_tpu_torch.methods.density_ratio_estimation, "
            "elfi_tpu_torch.models.ricker, elfi_tpu_torch.methods.bolfi, "
            "elfi_tpu_torch.methods.posteriors, elfi_tpu_torch.ops.special, "
            "elfi_tpu_torch.methods.bolfire, "
            "elfi_tpu_torch.methods.classifier, "
            "elfi_tpu_torch.methods.romc, elfi_tpu_torch.worker, "
            "elfi_tpu_torch.parallel.cluster, "
            "elfi_tpu_torch.parallel.multihost, "
            "elfi_tpu_torch.parallel.dask_client, "
            "elfi_tpu_torch.parallel.ipyparallel_client, "
            "elfi_tpu_torch.ops.kernels.topn; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'elfi_tpu.', 'jaxlib')) or "
            "m == 'elfi_tpu']; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_copy_shares_program_cache_and_revision():
    m = ma2.get_model(seed_obs=4)
    c = m.copy()
    assert c.revision == m.revision
    assert c.__dict__["_program_cache"] is m.__dict__["_program_cache"]
    c.update_node("d", dummy=1)
    assert c.revision != m.revision


def test_parameterless_model_rejected():
    m = et.Model()
    et.Constant(1.0, model=m, name="c")
    with pytest.raises(ValueError, match="no parameters"):
        et.Rejection(m, "c")


def test_adaptive_not_ported_yet():
    """``Rejection.adaptive`` is a bool: False on MA2's euclidean node,
    True on an ``AdaptiveDistance`` node, as in the JAX package."""
    m = ma2.get_model(seed_obs=4)
    assert et.Rejection(m["d"], batch_size=4).adaptive is False
    et.AdaptiveDistance(m["S1"], m["S2"], model=m, name="ad")
    assert et.Rejection(m["ad"], batch_size=4).adaptive is True


def test_generate_shapes_match_jax():
    mj, mt = jax_ma2.get_model(seed_obs=4), ma2.get_model(seed_obs=4)
    oj = mj.generate(batch_size=7, seed=3)
    ot = mt.generate(batch_size=7, seed=3)
    assert sorted(oj) == sorted(ot)
    for k in oj:
        assert np.shape(oj[k]) == np.shape(ot[k]), k
        if mt.dag.get_state(k)["kind"] != "constant":
            # a constant is the Python value in the port, a jitted int32
            # array in the JAX package
            assert np.asarray(oj[k]).dtype == ot[k].dtype, k

"""elfi_tpu_torch -- the PyTorch / CUDA port of ``elfi_tpu``.

The port mirrors the JAX package's module layout and public names; its
code is plain PyTorch on tensors with an explicit device and explicit
``torch.Generator`` streams, plus hand-written CUDA kernels where the JAX
package had Pallas kernels.  It never imports JAX or ``elfi_tpu``.

So far it covers rejection and SMC ABC, Bayesian synthetic likelihood,
BOLFI and BOLFIRE: the model DSL, the per-batch program, the native backend,
``Rejection`` with its fused loop and the adaptive distance, ``SMC``,
``AdaptiveDistanceSMC`` and ``AdaptiveThresholdSMC`` with the joint prior
``ModelPrior``, the Gaussian-mixture proposal and the density-ratio
estimator, ``BSL`` (``ModelBased``; the host Metropolis-Hastings chain and
a fused chain queued on the device; the synthetic-likelihood estimators
and pre-sampling tools in ``methods.bsl``; ESS and R-hat in
``methods.mcmc``), ``BayesianOptimization`` and ``BOLFI`` (the GP
surrogate ``GPRegression``, the LCBSC acquisition, the fused BO loop, the
``BolfiPosterior`` and batched NUTS and Metropolis chains in
``methods.mcmc``; the variance acquisitions ``MaxVar``, ``RandMaxVar`` and
``ExpIntVar``), ``BOLFIRE`` (the ratio classifiers ``LogisticRegression``
and ``GPClassifier``, the fused classifier rounds, ``BolfirePosterior``),
``ROMC`` (frozen-noise objectives as rows of one program, batched Adam
solves, Hessians, line-search regions, ``RomcPosterior``), the top-N
merge, the distance metrics, the host executor for graphs with
``host=True`` nodes (scipy priors, numpy simulators, external commands
through ``tools``), the model zoo (MA2, g-and-k, Gaussian, Ricker, AR(1),
ARCH, M/G/1, stochastic volatility, Lorenz-96, toad, Lotka-Volterra,
daycare, scratch assay and BDM), the fused MA2 and g-and-k distance
kernels, output pools and their replay (``OutputPool``, ``ArrayPool``),
model persistence (``Model.save``, ``load_model``), regression adjustment,
model comparison, summary selection, the testbench, profiling
(``utils.profiling``), plotting (``visualization``, which imports
matplotlib only when it draws) and the backends beyond one device: the
device list (``ShardedBackend``), the process pool
(``MultiprocessingBackend``), the elastic cluster (``ClusterBackend`` and
``python -m elfi_tpu_torch.worker``), the dask and ipyparallel adapters
and ``torch.distributed`` farming (``parallel.multihost``).
"""

from .model import (AdaptiveDistance, ComputationContext,  # noqa: F401
                    Constant, Discrepancy, Distance, Model, ModelPrior,
                    NodeReference, Operation, Prior, RandomVariable,
                    Simulator, Summary, get_default_model, new_model,
                    set_default_model)
from .model.model import load_model  # noqa: F401
from .ops.distributions import Distribution  # noqa: F401
from .parallel import (BatchHandler, ClusterBackend,  # noqa: F401
                       MultiprocessingBackend, NativeBackend, ShardedBackend,
                       get_client, reset_client, set_client)
from .methods import (AdaptiveDistanceSMC,  # noqa: F401
                      AdaptiveThresholdSMC, BayesianOptimization, BOLFI,
                      BOLFIRE, BolfireSample, BolfiSample, BSL, BslSample,
                      GPRegression, ModelBased, NDimBoundingBox,
                      OptimisationProblem, OptimizationResult,
                      ParameterInference, Rejection, ROMC, RomcPosterior,
                      RomcSample, Sample, SMC, SmcSample)
from .methods import mcmc  # noqa: F401
from .store import ArrayPool, OutputPool  # noqa: F401
from .visualization import (draw, nx_draw, plot_params_vs_node,  # noqa: F401
                            plot_predicted_summaries)
from .model import tools  # noqa: F401
from .methods import (LinearAdjustment, TwoStageSelection,  # noqa: F401
                      adjust_posterior, compare_models)
from .testbench import Testbench, TestbenchMethod  # noqa: F401

# the reference's names for the model container and the GP surrogate
ElfiModel = Model
GPyRegression = GPRegression

__version__ = "0.1.0"

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
daycare, scratch assay and BDM), and the fused MA2 and g-and-k distance
kernels.
"""

from .model import (AdaptiveDistance, Constant, Discrepancy,  # noqa: F401
                    Distance, Model, ModelPrior, Operation, Prior, Simulator,
                    Summary)
from .ops.distributions import Distribution  # noqa: F401
from .parallel import (NativeBackend, get_client, reset_client,  # noqa: F401
                       set_client)
from .methods import (AdaptiveDistanceSMC,  # noqa: F401
                      AdaptiveThresholdSMC, BayesianOptimization, BOLFI,
                      BOLFIRE, BolfireSample, BolfiSample, BSL, BslSample,
                      GPRegression, ModelBased, NDimBoundingBox,
                      OptimisationProblem, OptimizationResult, Rejection,
                      ROMC, RomcPosterior, RomcSample, Sample, SMC,
                      SmcSample)
from .methods import mcmc  # noqa: F401
from .model import tools  # noqa: F401

# the reference's name for the model container
ElfiModel = Model

__version__ = "0.1.0"

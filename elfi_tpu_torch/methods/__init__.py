from .base import ModelBased, ParameterInference, Sampler  # noqa: F401
from .results import (BolfireSample, BolfiSample, BslSample,  # noqa: F401
                      OptimizationResult, ParameterInferenceResult,
                      RomcSample, Sample, SmcSample)
from .samplers import (AdaptiveDistanceSMC,  # noqa: F401
                       AdaptiveThresholdSMC, Rejection, SMC)
from . import mcmc  # noqa: F401
from .bsl import BSL  # noqa: F401
from .bolfi import BayesianOptimization, BOLFI  # noqa: F401
from .posteriors import BolfiPosterior, BolfirePosterior  # noqa: F401
from .bo.gp import GPRegression  # noqa: F401
from .bo.acquisition import (LCBSC, ExpIntVar, MaxVar,  # noqa: F401
                             RandMaxVar, UniformAcquisition)
from .bolfire import BOLFIRE  # noqa: F401
from .classifier import GPClassifier, LogisticRegression  # noqa: F401
from .romc import (ROMC, NDimBoundingBox,  # noqa: F401
                   OptimisationProblem, RomcPosterior)
from .post_processing import LinearAdjustment, adjust_posterior  # noqa: F401
from .model_selection import compare_models  # noqa: F401
from .diagnostics import TwoStageSelection  # noqa: F401

from .base import ModelBased, ParameterInference, Sampler  # noqa: F401
from .results import (BolfiSample, BslSample,  # noqa: F401
                      OptimizationResult, ParameterInferenceResult, Sample,
                      SmcSample)
from .samplers import (AdaptiveDistanceSMC,  # noqa: F401
                       AdaptiveThresholdSMC, Rejection, SMC)
from . import mcmc  # noqa: F401
from .bsl import BSL  # noqa: F401
from .bolfi import BayesianOptimization, BOLFI  # noqa: F401
from .posteriors import BolfiPosterior  # noqa: F401
from .bo.gp import GPRegression  # noqa: F401
from .bo.acquisition import LCBSC, UniformAcquisition  # noqa: F401

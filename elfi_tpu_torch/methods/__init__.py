from .base import ModelBased, ParameterInference, Sampler  # noqa: F401
from .results import (BslSample, ParameterInferenceResult,  # noqa: F401
                      Sample, SmcSample)
from .samplers import (AdaptiveDistanceSMC,  # noqa: F401
                       AdaptiveThresholdSMC, Rejection, SMC)
from . import mcmc  # noqa: F401
from .bsl import BSL  # noqa: F401

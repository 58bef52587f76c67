from .base import ParameterInference, Sampler  # noqa: F401
from .results import ParameterInferenceResult, Sample, SmcSample  # noqa: F401
from .samplers import (AdaptiveDistanceSMC,  # noqa: F401
                       AdaptiveThresholdSMC, Rejection, SMC)

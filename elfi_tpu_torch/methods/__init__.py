from .base import ParameterInference, Sampler  # noqa: F401
from .results import ParameterInferenceResult, Sample  # noqa: F401
from .samplers import Rejection  # noqa: F401

from .model import (AdaptiveDistance, ComputationContext,  # noqa: F401
                    Constant, Discrepancy, Distance, Model, NodeReference,
                    Operation, Prior, RandomVariable, Simulator, Summary,
                    get_default_model, new_model, node_uid,
                    set_default_model)
from .extensions import ModelPrior, ScipyLikeDistribution  # noqa: F401

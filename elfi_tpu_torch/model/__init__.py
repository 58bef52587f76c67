from .model import (ComputationContext, Constant, Discrepancy,  # noqa: F401
                    Distance, Model, NodeReference, Operation, Prior,
                    RandomVariable, Simulator, Summary, get_default_model,
                    new_model, node_uid, set_default_model)

from crdmodel_tpu_torch.models.base import (ReactionModel, get_model,
                                            register_model)
from crdmodel_tpu_torch.models import fhn  # noqa: F401  (registers the model)

__all__ = ["ReactionModel", "get_model", "register_model"]

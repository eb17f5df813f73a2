from crdmodel_tpu_torch.models.base import (ReactionModel, get_model,
                                            register_model)
# importing a model module registers it
from crdmodel_tpu_torch.models import (aliev_panfilov, fhn,  # noqa: F401
                                       goldbeter)

__all__ = ["ReactionModel", "get_model", "register_model"]

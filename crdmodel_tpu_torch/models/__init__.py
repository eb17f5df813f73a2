from crdmodel_tpu_torch.models.base import (ReactionModel, get_model,
                                            register_model)
# importing a model module registers it
from crdmodel_tpu_torch.models import (aliev_panfilov, barkley,  # noqa: F401
                                       brusselator, fhn, goldbeter,
                                       grayscott, lambdaomega, oregonator,
                                       sir)

__all__ = ["ReactionModel", "get_model", "register_model"]

from multipathnet_tpu_torch.models.multipath import (  # noqa: F401
    MultiPathNet, build_model)

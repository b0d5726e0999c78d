"""Backbone registry — port of multipathnet_tpu/models/backbones/__init__.py.

Every backbone maps NHWC images to the {"c3", "c4", "c5"} maps (strides
4/8/16), NHWC, and carries `feature_strides`, `feature_channels` and
`frozen_prefixes(n)`, the parameter-name prefixes of its first n stages.
"""

from multipathnet_tpu_torch.models.backbones.resnet import (ResNet18,
                                                            ResNet50,
                                                            ResNet101)
from multipathnet_tpu_torch.models.backbones.small import AlexNetLike, TinyNet
from multipathnet_tpu_torch.models.backbones.vgg import VGG16

REGISTRY = {
    "vgg16": VGG16,
    "resnet18": ResNet18,
    "resnet50": ResNet50,
    "resnet101": ResNet101,
    "alexnet": AlexNetLike,
    "tinynet": TinyNet,
}


def get_backbone(name: str, dtype, device=None, freeze_stages: int = 0,
                 param_dtype=None):
    try:
        cls = REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown backbone {name!r}; have {sorted(REGISTRY)}")
    return cls(dtype=dtype, device=device, freeze_stages=freeze_stages,
               param_dtype=param_dtype)

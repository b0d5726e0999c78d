"""Backbone registry — port of multipathnet_tpu/models/backbones/__init__.py.

Every backbone maps NHWC images to the {"c3", "c4", "c5"} maps (strides
4/8/16), NHWC, and carries `feature_strides` and `feature_channels`.
"""

from multipathnet_tpu_torch.models.backbones.small import TinyNet
from multipathnet_tpu_torch.models.backbones.vgg import VGG16

REGISTRY = {
    "vgg16": VGG16,
    "tinynet": TinyNet,
}

# Backbones of the reference that the port does not run yet.
_NOT_PORTED = {
    "resnet18": "ROADMAP A13",
    "resnet50": "ROADMAP A13",
    "resnet101": "ROADMAP A13",
    "alexnet": "ROADMAP A13",
}


def get_backbone(name: str, dtype, device=None):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"backbone {name!r} is not ported yet ({_NOT_PORTED[name]})")
    try:
        cls = REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown backbone {name!r}; have {sorted(REGISTRY)}")
    return cls(dtype=dtype, device=device)

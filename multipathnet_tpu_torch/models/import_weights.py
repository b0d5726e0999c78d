"""Pretrained-weight import — port of multipathnet_tpu/models/
import_weights.py, mapping torch/torchvision-layout arrays straight to the
port's state dict (the reference maps them to a flax tree).

Torch already stores conv kernels (O, I, kH, kW) and linear weights
(O, I), so a trunk maps by name alone:
  - VGG-16: torchvision's `features.N` indices -> backbone.conv{b}_{c};
  - ResNet-18/50/101: conv1/bn1 -> backbone.stem/stem_bn, layer{1,2,3}.{i}
    -> backbone.stage{2,3,4}_block{i}, conv{k}/bn{k} -> Conv_{k-1}/
    BatchNorm_{k-1}, downsample.0/.1 -> the next free index (Conv_2 in a
    basic block, Conv_3 in a bottleneck); BN weight, bias, running_mean
    and running_var keep their names. layer4 (/32) and fc are not read.

The MultiPath head contract (a converted whole-model checkpoint):
  reduce.weight (D, sum_l C_l, 1, 1), reduce.bias (D,)   the 1x1 reduce
      after the skip-level concat, input channels in `skip_channels` order
  fc6.{i}.weight (fc, G*G*D), fc6.{i}.bias               per foveal view;
      input flattened NCHW: (D, G, G)
  fc7.{i}.weight (fc, fc), fc7.{i}.bias
  classifier.{k}.weight (classes, F*fc), .bias           K integral heads
      over the foveal concat, branch i at columns [i*fc, (i+1)*fc)
  bbox.weight (4*classes, F*fc), bbox.bias
It keeps the reference's three conversions: fc6's rows are permuted from
torch's c*G*G + y*G + x flatten to the port's (y, x, c); the concat
reduce is split per level into reduce_{l} (its bias becomes the head's
skip_bias); the K classifiers and the bbox regressor fuse into cls_bbox,
their input columns permuted by `foveal_order` where a checkpoint
concatenated its branches in another order.

Every function returns {port state-dict name: float32 tensor}; feed it to
`install_params`, which checks names and shapes and copies into a model.
"""

from __future__ import annotations

import numpy as np
import torch

# torchvision vgg16: nn.Sequential 'features' indices of the 13 convs
VGG16_TORCH_INDICES = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
VGG16_NAMES = (
    "conv1_1", "conv1_2", "conv2_1", "conv2_2",
    "conv3_1", "conv3_2", "conv3_3",
    "conv4_1", "conv4_2", "conv4_3",
    "conv5_1", "conv5_2", "conv5_3",
)
RESNET_STAGES = {"resnet18": (2, 2, 2), "resnet50": (3, 4, 6),
                 "resnet101": (3, 4, 23)}
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def _t(a) -> torch.Tensor:
    """An array as a float32 CPU tensor that owns its memory."""
    return torch.from_numpy(np.array(a, np.float32))


def vgg16_params_from_state_dict(state: dict) -> dict:
    """torchvision vgg16 (features.N.weight/.bias) -> backbone.conv*."""
    out = {}
    for idx, name in zip(VGG16_TORCH_INDICES, VGG16_NAMES):
        out[f"backbone.{name}.weight"] = _t(state[f"features.{idx}.weight"])
        out[f"backbone.{name}.bias"] = _t(state[f"features.{idx}.bias"])
    return out


def _bn(out: dict, state: dict, src: str, dst: str) -> None:
    for leaf in _BN_LEAVES:
        out[f"{dst}.{leaf}"] = _t(state[f"{src}.{leaf}"])


def _resnet_params_from_state_dict(state: dict, stage_sizes) -> dict:
    """torchvision resnet (basic or bottleneck blocks) -> backbone.*,
    parameters and BN running statistics."""
    out = {"backbone.stem.weight": _t(state["conv1.weight"])}
    _bn(out, state, "bn1", "backbone.stem_bn")
    for layer, n_blocks in zip((1, 2, 3), stage_sizes):
        for blk in range(n_blocks):
            src = f"layer{layer}.{blk}"
            dst = f"backbone.stage{layer + 1}_block{blk}"
            k = 0
            while f"{src}.conv{k + 1}.weight" in state:
                out[f"{dst}.Conv_{k}.weight"] = _t(
                    state[f"{src}.conv{k + 1}.weight"])
                _bn(out, state, f"{src}.bn{k + 1}", f"{dst}.BatchNorm_{k}")
                k += 1
            if f"{src}.downsample.0.weight" in state:
                out[f"{dst}.Conv_{k}.weight"] = _t(
                    state[f"{src}.downsample.0.weight"])
                _bn(out, state, f"{src}.downsample.1",
                    f"{dst}.BatchNorm_{k}")
    return out


def resnet18_params_from_state_dict(state: dict) -> dict:
    return _resnet_params_from_state_dict(state, RESNET_STAGES["resnet18"])


def resnet50_params_from_state_dict(state: dict) -> dict:
    return _resnet_params_from_state_dict(state, RESNET_STAGES["resnet50"])


def resnet101_params_from_state_dict(state: dict) -> dict:
    return _resnet_params_from_state_dict(state, RESNET_STAGES["resnet101"])


def multipath_head_params_from_state_dict(
        state: dict, *, skip_channels: "dict[str, int]",
        roi_output_size: int = 7,
        foveal_order: "tuple[int, ...] | None" = None) -> dict:
    """The head contract above -> reduce_{l}.weight and head.* entries.
    skip_channels: ORDERED {level: C_l}, the reduce conv's input-channel
    concat order (e.g. {"c3": 256, "c4": 512, "c5": 512})."""
    g = roi_output_size
    out = {}
    rw = np.asarray(state["reduce.weight"])
    d, sum_c = rw.shape[:2]
    if sum_c != sum(skip_channels.values()):
        raise ValueError(f"reduce in-channels {sum_c} != sum(skip_channels) "
                         f"{sum(skip_channels.values())}")
    lo = 0
    for lvl, c_l in skip_channels.items():
        out[f"reduce_{lvl}.weight"] = _t(rw[:, lo:lo + c_l])
        lo += c_l
    out["head.skip_bias"] = _t(state["reduce.bias"])

    # the port flattens (y, x, c); torch's row for that position is
    # c*G*G + y*G + x
    yy, xx, cc = np.meshgrid(np.arange(g), np.arange(g), np.arange(d),
                             indexing="ij")
    perm = (cc * g * g + yy * g + xx).reshape(-1)
    n_f = 0
    while f"fc6.{n_f}.weight" in state:
        n_f += 1
    if n_f == 0:
        raise ValueError("state dict has no fc6.* branches")
    order = tuple(range(n_f)) if foveal_order is None else tuple(foveal_order)
    if sorted(order) != list(range(n_f)):
        raise ValueError(f"foveal_order {order} is not a permutation of "
                         f"the {n_f} branches")
    for i, src in enumerate(order):
        w6 = np.asarray(state[f"fc6.{src}.weight"])
        if w6.shape[1] != g * g * d:
            raise ValueError(f"fc6.{src}.weight {w6.shape} does not read "
                             f"G*G*D = {g * g * d} inputs")
        out[f"head.fc6_f{i}.weight"] = _t(w6[:, perm])
        out[f"head.fc6_f{i}.bias"] = _t(state[f"fc6.{src}.bias"])
        out[f"head.fc7_f{i}.weight"] = _t(state[f"fc7.{src}.weight"])
        out[f"head.fc7_f{i}.bias"] = _t(state[f"fc7.{src}.bias"])

    # K integral classifiers + the bbox regressor -> one cls_bbox; their
    # input columns (the foveal concat) follow the branch order
    fc_dim = np.asarray(state["fc7.0.weight"]).shape[0]
    col_perm = np.concatenate(
        [np.arange(src * fc_dim, (src + 1) * fc_dim) for src in order])
    n_k = 0
    while f"classifier.{n_k}.weight" in state:
        n_k += 1
    if n_k == 0:
        raise ValueError("state dict has no classifier.* heads")
    names = [f"classifier.{k}" for k in range(n_k)] + ["bbox"]
    out["head.cls_bbox.weight"] = _t(np.concatenate(
        [np.asarray(state[f"{n}.weight"])[:, col_perm] for n in names]))
    out["head.cls_bbox.bias"] = _t(np.concatenate(
        [np.asarray(state[f"{n}.bias"]) for n in names]))
    return out


def _npz(path: str) -> dict:
    z = np.load(path)
    return {k: z[k] for k in z.files}


def load_vgg16_npz(path: str) -> dict:
    return vgg16_params_from_state_dict(_npz(path))


def load_resnet18_npz(path: str) -> dict:
    return resnet18_params_from_state_dict(_npz(path))


def load_resnet50_npz(path: str) -> dict:
    return resnet50_params_from_state_dict(_npz(path))


def load_resnet101_npz(path: str) -> dict:
    return resnet101_params_from_state_dict(_npz(path))


def load_t7(path: str, long_size: int = 8) -> dict:
    """Torch7 `.t7` checkpoint -> flattened {dotted.path: ndarray} through
    the port's reader (data/t7.py): the fallback for graphs that
    models/t7_import.import_model_t7's structural walk rejects; the caller
    maps the nn-module paths (modules.N....) onto the contracts above."""
    from multipathnet_tpu_torch.data import t7

    return t7.state_dict(t7.load(path, long_size=long_size))


@torch.no_grad()
def install_params(model: torch.nn.Module, state: dict) -> torch.nn.Module:
    """Copy imported entries into `model`: every name must be one of the
    model's parameters or buffers with the same shape; each keeps its own
    dtype and device. Entries the import does not carry (a trunk-only
    import leaves the head) are left as they are."""
    own = model.state_dict(keep_vars=True)
    for name, value in state.items():
        if name not in own:
            raise KeyError(f"imported {name!r} is not in the model")
        if tuple(own[name].shape) != tuple(value.shape):
            raise ValueError(f"{name}: model {tuple(own[name].shape)} vs "
                             f"import {tuple(value.shape)}")
        own[name].copy_(value)
    return model

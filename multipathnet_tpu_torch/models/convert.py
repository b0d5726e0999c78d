"""Weight bridge between the JAX package's flax parameter tree and this
port's state dict, both ways.

It inverts multipathnet_tpu/models/import_weights.conv_to_flax and
linear_to_flax: a conv kernel (kH, kW, I, O) becomes (O, I, kH, kW), a dense
kernel (I, O) becomes (O, I). Module paths map one to one — backbone/conv*,
reduce_c{3,4,5}, head/skip_bias, head/fc6_f{i}, head/fc7_f{i},
head/cls_bbox — because the port names its modules after the flax tree.
fc6's input rows stay in the reference's (G, G, C) channel-last flatten
order, which is the order MultiPathHead flattens in.

Frozen BatchNorm (the ResNet trunks) carries across in both collections:
the flax `params` leaf `scale` is the BN module's `weight` (`bias` is
`bias`), and the `batch_stats` collection's `mean`/`var` are its
`running_mean`/`running_var` buffers. A collection other than `params`
and `batch_stats` raises rather than being dropped.

The serving layouts carry across too. The reference's Int8Dense {kernel_i8
(K, N) int8, kernel_scale (N,), bias} is Int8Linear's {weight_i8 (N, K),
weight_scale, bias}; a low-rank factor fc6_f{i}_u {kernel (K, t)} is a
bias-free Linear like any other.

Takes and gives numpy arrays (np.asarray of each jax leaf), so this module
needs no jax. state_dict_from_flax also takes torch leaves, which stay on
their device (a tree made or transformed on the card loads without a round
trip through the host).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

# flax leaf name -> state-dict name; kernels transpose, the rest do not
_LEAF_NAMES = {"kernel": "weight", "kernel_i8": "weight_i8",
               "kernel_scale": "weight_scale", "scale": "weight"}
_FLAX_NAMES = {"weight": "kernel", "weight_i8": "kernel_i8",
               "weight_scale": "kernel_scale"}
# the batch_stats collection: flax leaf name -> BN buffer name
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}
_FLAX_STATS = {v: k for k, v in _STAT_NAMES.items()}
COLLECTIONS = ("params", "batch_stats")


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def as_tensor(value) -> torch.Tensor:
    """A leaf as a tensor: floats in float32, integers (int8 codes) kept."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        return t.float() if t.is_floating_point() else t
    a = np.asarray(value)
    return torch.from_numpy(a.astype(a.dtype if a.dtype.kind in "iub"
                                     else np.float32))  # a writable copy


def _flip(t: torch.Tensor, to_torch: bool) -> torch.Tensor:
    """A kernel between flax's layout and torch's: HWIO <-> OIHW, (in, out)
    <-> (out, in)."""
    if t.dim() == 4:
        return t.permute((3, 2, 0, 1) if to_torch else (2, 3, 1, 0))
    if t.dim() == 2:
        return t.t()
    raise ValueError(f"unexpected kernel rank: {tuple(t.shape)}")


def state_dict_from_flax(params) -> dict:
    """flax variables ({"params": {...}, "batch_stats": {...}?}) or the
    inner params dict, numpy or torch leaves -> {torch state-dict name:
    tensor} (float32, or int8 codes). Raises ValueError on a collection
    other than params and batch_stats."""
    if "params" in params:
        unknown = sorted(set(params) - set(COLLECTIONS))
        if unknown:
            raise ValueError(f"unknown flax collection(s) {unknown}; the "
                             f"port carries {list(COLLECTIONS)}")
        stats = params.get("batch_stats", {})
        params = params["params"]
    else:
        stats = {}
    out = {}
    for path, value in _leaves(params):
        t = as_tensor(value)
        *mods, leaf = path
        if leaf in ("kernel", "kernel_i8"):
            try:
                t = _flip(t, to_torch=True)
            except ValueError as e:
                raise ValueError(f"{e} at {path}") from None
        out[".".join([*mods, _LEAF_NAMES.get(leaf, leaf)])] = t.contiguous()
    for path, value in _leaves(stats):
        *mods, leaf = path
        if leaf not in _STAT_NAMES:
            raise ValueError(f"unknown batch_stats leaf at {path}")
        out[".".join([*mods, _STAT_NAMES[leaf]])] = \
            as_tensor(value).contiguous()
    return out


def load_flax_params(model: torch.nn.Module, params) -> torch.nn.Module:
    """Copy a flax tree into `model` (every name must match); each
    parameter and buffer keeps its own dtype (float32 in a training model,
    the compute dtype in an eval model) and device."""
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return model


def flax_from_state_dict(state_dict, host: bool = True) -> dict:
    """The inverse of state_dict_from_flax: {name: tensor} -> {"params":
    nested dict of numpy arrays (float32, or int8 codes)}, kernels back in
    HWIO / (in, out) layout, and, where the model has frozen BatchNorm,
    "batch_stats" with its running statistics (a BN module's 1-D `weight`
    is its flax `scale`). The arrays are copies, so a later step that
    updates the model in place leaves them as they were. host=False keeps
    the leaves as tensors on their device (views where no layout change
    or cast was needed)."""
    tree, stats = {}, {}
    for name, t in state_dict.items():
        t = as_tensor(t.cpu() if host else t)
        *mods, leaf = name.split(".")
        node = tree
        if leaf in _FLAX_STATS:
            node, leaf = stats, _FLAX_STATS[leaf]
        elif leaf == "weight" and t.dim() == 1:
            leaf = "scale"
        elif leaf in _FLAX_NAMES:
            if leaf != "weight_scale":
                t = _flip(t, to_torch=False)
            leaf = _FLAX_NAMES[leaf]
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.array(t.numpy(), order="C") if host else t.contiguous()
    return {"params": tree, **({"batch_stats": stats} if stats else {})}

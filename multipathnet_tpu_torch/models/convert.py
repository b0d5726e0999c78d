"""Weight bridge between the JAX package's flax parameter tree and this
port's state dict, both ways.

It inverts multipathnet_tpu/models/import_weights.conv_to_flax and
linear_to_flax: a conv kernel (kH, kW, I, O) becomes (O, I, kH, kW), a dense
kernel (I, O) becomes (O, I). Module paths map one to one — backbone/conv*,
reduce_c{3,4,5}, head/skip_bias, head/fc6_f{i}, head/fc7_f{i},
head/cls_bbox — because the port names its modules after the flax tree.
fc6's input rows stay in the reference's (G, G, C) channel-last flatten
order, which is the order MultiPathHead flattens in.

Takes and gives numpy arrays (np.asarray of each jax leaf), so this module
needs no jax.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def state_dict_from_flax(params) -> dict:
    """flax params ({"params": {...}} or the inner dict), numpy leaves ->
    {torch state-dict name: float32 tensor}."""
    if "params" in params:
        params = params["params"]
    out = {}
    for path, value in _leaves(params):
        a = np.asarray(value, dtype=np.float32)
        *mods, leaf = path
        if leaf == "kernel":
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)   # HWIO -> OIHW
            elif a.ndim == 2:
                a = a.T                       # (in, out) -> (out, in)
            else:
                raise ValueError(f"unexpected kernel rank at {path}: "
                                 f"{a.shape}")
            leaf = "weight"
        out[".".join([*mods, leaf])] = torch.from_numpy(
            np.ascontiguousarray(a))
    return out


def load_flax_params(model: torch.nn.Module, params) -> torch.nn.Module:
    """Copy a flax tree into `model` (every name must match); each
    parameter keeps its own dtype (float32 in a training model, the compute
    dtype in an eval model) and device."""
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return model


def flax_from_state_dict(state_dict) -> dict:
    """The inverse of state_dict_from_flax: {name: tensor} -> {"params":
    nested dict of float32 numpy arrays}, kernels back in HWIO / (in,
    out) layout."""
    tree = {}
    for name, t in state_dict.items():
        a = t.detach().float().cpu().numpy()
        *mods, leaf = name.split(".")
        if leaf == "weight":
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T  # -> HWIO
            leaf = "kernel"
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(a)
    return {"params": tree}

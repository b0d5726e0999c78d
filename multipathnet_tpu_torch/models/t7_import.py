"""`.t7` nn-container graph -> the port's weights — port of
multipathnet_tpu/models/t7_import.py.

The reference's released checkpoints are whole nn-module graphs
(Sequential/ParallelTable/ConcatTable assembly saved with torch.save).
data/t7.py deserializes them; this module walks the container STRUCTURE
and maps it onto the import contract of models/import_weights.py:

  - spatial convolutions in depth-first traversal order: the 3x3 convs are
    the VGG-16 trunk (mapped positionally onto the torchvision feature
    indices), the single 1x1 conv is the skip reduce;
  - a parallel container whose every child subtree holds exactly two
    chained Linears is the foveal bank (branch order = container order:
    fc6.{i}/fc7.{i});
  - the remaining Linears all consume the foveal concat (same in_features):
    the group sharing an out_features is the K integral classifiers
    (traversal order = threshold order), and the single Linear with
    4x that out_features is the class-specific bbox regressor.

Weight-layout quirks handled: nn.SpatialConvolutionMM stores its kernel
flattened (O, I*kH*kW) with kW/kH/nInputPlane fields, reshaped here;
nn.DataParallelTable replicates its child per GPU, and only replica 1 is
read; cudnn.* classes alias their nn.* layouts (the class name's last
component is what is matched).

`import_model_t7` is the one-call entry: path -> the port's state dict,
or a model with the weights installed.
"""

from __future__ import annotations

import numpy as np

import torch

from multipathnet_tpu_torch.data import t7
from multipathnet_tpu_torch.data.t7 import T7Object
from multipathnet_tpu_torch.models import import_weights as IW

_PARALLEL = ("ParallelTable", "ConcatTable", "Concat", "Parallel")


def _classname(node) -> str:
    return node.name.rsplit(".", 1)[-1] if isinstance(node, T7Object) else ""


def _children(node) -> list:
    """Container children in Lua array order. DataParallelTable keeps one
    replica per device — replica 1 is the master copy."""
    mods = node.get("modules")
    if mods is None:
        return []
    kids = t7.as_list(mods)
    if _classname(node) == "DataParallelTable" and kids:
        kids = kids[:1]
    return kids


def _walk(node):
    """Depth-first module traversal (containers yield before children)."""
    if not isinstance(node, T7Object):
        return
    yield node
    for child in _children(node):
        yield from _walk(child)


def _conv_weight(m: T7Object) -> np.ndarray:
    """nn.SpatialConvolution(MM) weight as (O, I, kH, kW) float array."""
    w = np.asarray(m["weight"], np.float32)
    if w.ndim == 2:  # SpatialConvolutionMM: (O, I*kH*kW)
        o = int(m.get("nOutputPlane", w.shape[0]))
        i = int(m["nInputPlane"])
        kh, kw = int(m["kH"]), int(m["kW"])
        assert w.shape == (o, i * kh * kw), (w.shape, o, i, kh, kw)
        return w.reshape(o, i, kh, kw)
    assert w.ndim == 4, w.shape
    return w


def _linear_shape(m: T7Object):
    w = np.asarray(m["weight"])
    return int(w.shape[0]), int(w.shape[1])  # (out, in)


def _is_conv(m) -> bool:
    return "SpatialConvolution" in _classname(m) and "weight" in m


def _is_linear(m) -> bool:
    return _classname(m) == "Linear" and "weight" in m


def map_multipath_nn_graph(obj: T7Object):
    """nn-module graph -> (trunk_state, head_state, skip_channels).

    trunk_state follows the torchvision `features.N.weight/bias` contract
    (feed to IW.vgg16_params_from_state_dict); head_state follows the
    MultiPath head contract (feed to
    IW.multipath_head_params_from_state_dict with the returned ORDERED
    skip_channels). Raises ValueError with a structural diagnosis when the
    graph doesn't look like a MultiPath/Fast R-CNN head."""
    mods = list(_walk(obj))

    # --- trunk: 3x3 convs in traversal order; reduce: the single 1x1 ------
    convs3, convs1 = [], []
    for m in mods:
        if not _is_conv(m):
            continue
        w = _conv_weight(m)
        (convs3 if w.shape[2] == w.shape[3] == 3 else
         convs1 if w.shape[2] == w.shape[3] == 1 else []).append((m, w))
    if len(convs3) != len(IW.VGG16_TORCH_INDICES):
        raise ValueError(
            f"expected the {len(IW.VGG16_TORCH_INDICES)} 3x3 convs of a "
            f"VGG-16 trunk, found {len(convs3)} (ResNet-family .t7 graphs "
            "need the explicit resnet*_params_from_state_dict contract)")
    if len(convs1) != 1:
        raise ValueError(f"expected exactly one 1x1 reduce conv, "
                         f"found {len(convs1)}")
    trunk_state = {}
    for (m, w), idx in zip(convs3, IW.VGG16_TORCH_INDICES):
        trunk_state[f"features.{idx}.weight"] = w
        trunk_state[f"features.{idx}.bias"] = np.asarray(m["bias"],
                                                         np.float32)
    reduce_m, reduce_w = convs1[0]
    head_state = {"reduce.weight": reduce_w,
                  "reduce.bias": np.asarray(reduce_m["bias"], np.float32)}

    # --- skip_channels: reduce in-channels must match a SUFFIX of the VGG
    # block tails (c3=conv3_3.O, c4=conv4_3.O, c5=conv5_3.O) --------------
    tails = {"c3": int(convs3[6][1].shape[0]),
             "c4": int(convs3[9][1].shape[0]),
             "c5": int(convs3[12][1].shape[0])}
    sum_c = int(reduce_w.shape[1])
    skip_channels = None
    for lo in range(3):
        levels = list(tails)[lo:]
        if sum(tails[l] for l in levels) == sum_c:
            skip_channels = {l: tails[l] for l in levels}
            break
    if skip_channels is None:
        raise ValueError(
            f"reduce in-channels {sum_c} match no suffix of the trunk "
            f"block channels {tails}")

    # --- foveal bank: parallel container, each child = 2 chained Linears --
    def branch_linears(child):
        lins = [m for m in _walk(child) if _is_linear(m)]
        if len(lins) != 2:
            return None
        (o6, i6), (o7, i7) = _linear_shape(lins[0]), _linear_shape(lins[1])
        # Only the CHAIN condition (fc6.out feeds fc7.in) defines a branch;
        # requiring a square fc7 would wrongly reject valid non-square
        # heads.
        return lins if o6 == i7 else None

    foveal = None
    for m in mods:
        if _classname(m) not in _PARALLEL:
            continue
        kids = _children(m)
        if len(kids) < 1:
            continue
        banks = [branch_linears(c) for c in kids]
        if all(b is not None for b in banks):
            foveal = banks
            break
    if foveal is None:
        raise ValueError("no parallel container of fc6->fc7 branches found "
                         "(foveal bank)")
    # The concat the classifier consumes is built from fc7 OUTPUTS — derive
    # fc_dim from fc7, not fc6 (they only coincide when fc7 is square).
    fc_dim = _linear_shape(foveal[0][1])[0]
    for i, (l6, l7) in enumerate(foveal):
        head_state[f"fc6.{i}.weight"] = np.asarray(l6["weight"], np.float32)
        head_state[f"fc6.{i}.bias"] = np.asarray(l6["bias"], np.float32)
        head_state[f"fc7.{i}.weight"] = np.asarray(l7["weight"], np.float32)
        head_state[f"fc7.{i}.bias"] = np.asarray(l7["bias"], np.float32)

    # --- classifiers + bbox: Linears over the foveal concat ---------------
    fov_ids = {id(l) for bank in foveal for l in bank}
    cat_in = len(foveal) * fc_dim
    rest = [m for m in mods
            if _is_linear(m) and id(m) not in fov_ids
            and _linear_shape(m)[1] == cat_in]
    if not rest:
        raise ValueError(
            f"no classifier/bbox Linears consume the foveal concat "
            f"(in_features {cat_in})")
    by_out: dict = {}
    for m in rest:
        by_out.setdefault(_linear_shape(m)[0], []).append(m)
    cls_out = None
    for out, group in by_out.items():
        if 4 * out in by_out and len(by_out[4 * out]) == 1:
            cls_out = out
            break
    if cls_out is None:
        if len(by_out) == 1 and len(next(iter(by_out.values()))) >= 1:
            raise ValueError(
                "found classifier-like Linears but no 4x-wide bbox "
                f"regressor (out_features seen: {sorted(by_out)})")
        raise ValueError(
            f"cannot pair classifier heads with a 4x bbox regressor "
            f"(out_features seen: {sorted(by_out)})")
    for k, m in enumerate(by_out[cls_out]):  # traversal order = head order
        head_state[f"classifier.{k}.weight"] = np.asarray(m["weight"],
                                                          np.float32)
        head_state[f"classifier.{k}.bias"] = np.asarray(m["bias"],
                                                        np.float32)
    bbox = by_out[4 * cls_out][0]
    head_state["bbox.weight"] = np.asarray(bbox["weight"], np.float32)
    head_state["bbox.bias"] = np.asarray(bbox["bias"], np.float32)
    return trunk_state, head_state, skip_channels


def import_model_t7(path_or_obj, model: torch.nn.Module | None = None, *,
                    roi_output_size: int = 7, foveal_order=None,
                    long_size: int = 8):
    """One-call import: a `.t7` whole-model checkpoint (a path, bytes, or
    an already-read T7Object) -> the port's state dict of the trunk, the
    per-level reduces and the head (float32 tensors), mapped structurally
    (map_multipath_nn_graph). With `model`, the entries are installed in
    it (import_weights.install_params: names and shapes checked) and the
    model is returned."""
    if isinstance(path_or_obj, T7Object):
        obj = path_or_obj
    elif isinstance(path_or_obj, (bytes, bytearray)):
        obj = t7.loads(bytes(path_or_obj), long_size=long_size)
    else:
        obj = t7.load(path_or_obj, long_size=long_size)
    trunk_state, head_state, skip_channels = map_multipath_nn_graph(obj)
    state = {**IW.vgg16_params_from_state_dict(trunk_state),
             **IW.multipath_head_params_from_state_dict(
                 head_state, skip_channels=skip_channels,
                 roi_output_size=roi_output_size,
                 foveal_order=foveal_order)}
    return state if model is None else IW.install_params(model, state)

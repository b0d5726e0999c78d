"""Serving bundles — port of multipathnet_tpu/eval/serving.py.

A bundle is a directory that a Detector loads with no load-time transform:

    bundle/
      config.json  # the whole Config tree (Config.to_json)
      params.pt    # torch.save of the flax-layout tree in SERVING form
                   # (factored when the config has fc ranks, int8 when
                   # head_quant="int8"), leaves as CPU tensors

The reference stores the tree as flax msgpack (params.msgpack). This port
runs where there is no flax and no msgpack, so its bundle holds the same
tree through torch.save instead, and the two bundle formats do not load
into each other's package; the tree itself carries across through
models/convert.py. Export applies the reference's transforms in its order
(eval/detect.serving_params): factorize before quantizing, check the ranks
of a tree that is already factored, and refuse int8 weights under
head_quant="none".
"""

from __future__ import annotations

import dataclasses
import os
from collections.abc import Mapping

import torch

from multipathnet_tpu_torch.core.config import Config
from multipathnet_tpu_torch.eval.detect import Detector, serving_params
from multipathnet_tpu_torch.models.convert import as_tensor
from multipathnet_tpu_torch.models.multipath import build_model


def _to_cpu_tensors(tree):
    return {k: _to_cpu_tensors(v) if isinstance(v, Mapping)
            else as_tensor(v).cpu() for k, v in tree.items()}


def save_bundle(path: str, cfg: Config, params, quant: str = "keep",
                svd_report: dict | None = None) -> None:
    """Write a serving bundle of `params`, a flax-layout tree (numpy or
    torch leaves; float unless cfg already carries a quantized head).
    quant: "keep" honors cfg.model.head_quant; "int8"/"none" override it
    and the exported config says so. `svd_report`, if a dict, receives each
    factorized kernel's relative truncation error."""
    if quant != "keep":
        if quant not in ("int8", "none"):
            raise ValueError(f"quant must be 'keep', 'int8' or 'none', got "
                             f"{quant!r}")
        cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                    head_quant=quant))
    params = serving_params(params, cfg.model, svd_report)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        f.write(cfg.to_json())
    torch.save(_to_cpu_tensors(params), os.path.join(path, "params.pt"))


def load_bundle(path: str, device=None):
    """-> (cfg, model, params): the config, the model built for it on
    `device` (the card unless the caller names another), and the
    serving-form tree (CPU tensors)."""
    with open(os.path.join(path, "config.json")) as f:
        cfg = Config.from_json(f.read())
    params = torch.load(os.path.join(path, "params.pt"), map_location="cpu",
                        weights_only=True)
    return cfg, build_model(cfg.model, device=device), params


def load_detector(path: str, device=None, mesh=None) -> Detector:
    """One-call serving entry: bundle directory -> a ready Detector, over
    `mesh` when one is given (eval/detect.Detector), on its device."""
    if mesh is not None:
        device = mesh.device
    cfg, model, params = load_bundle(path, device)
    return Detector(model, cfg, params=params, mesh=mesh)

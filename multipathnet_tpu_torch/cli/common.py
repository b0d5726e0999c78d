"""Shared CLI plumbing — port of multipathnet_tpu/cli/common.py: preset
selection + dataclass field overrides + data resolution (opts.lua +
config.lua analog, SURVEY.md §2.1). `--device` names the device the
entry points run on (core/device.resolve_device): the CUDA card unless the
caller asks for the CPU. Under torchrun (`launched_mesh`) each rank runs
on its own card, or on the CPU with gloo, over the reference's data mesh
(core/mesh.largest_data_mesh)."""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

from multipathnet_tpu_torch.core.config import Config, PRESETS, preset


def add_config_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="run on the CUDA card (default) or the CPU")
    p.add_argument("--preset", default="default", choices=PRESETS,
                   help="named config preset (BASELINE.json configs)")
    p.add_argument("--set", action="append", default=[], metavar="K=V",
                   help="override config fields, e.g. --set train.lr=0.002 "
                        "--set data.max_proposals=300")
    p.add_argument("--dataset-root", default="",
                   help="dataset root (COCO layout, or VOCdevkit for --dataset voc)")
    p.add_argument("--dataset", default="coco", choices=("coco", "voc"),
                   help="annotation format: COCO JSON or PASCAL VOC XML")
    p.add_argument("--voc-year", default="2007")
    p.add_argument("--split", default="synthetic")
    p.add_argument("--annotations", default="",
                   help="instances JSON (defaults under dataset root)")
    p.add_argument("--proposals", default="",
                   help="proposals .npz (defaults under dataset root)")
    p.add_argument("--synthetic", action="store_true",
                   help="generate a synthetic dataset under --dataset-root "
                        "(or a temp dir) and use it")


def _parse_value(raw: str, old):
    t = type(old)
    if t is bool:
        return raw.lower() in ("1", "true", "yes")
    if t is tuple:
        elems = [v for v in raw.strip("()").split(",") if v]
        et = type(old[0]) if old else float
        return tuple(et(v) for v in elems)
    return t(raw)


def apply_overrides(cfg: Config, pairs: list[str]) -> Config:
    for pair in pairs:
        key, _, raw = pair.partition("=")
        if not raw:
            raise SystemExit(f"--set expects K=V, got {pair!r}")
        section, _, field = key.partition(".")
        sub = getattr(cfg, section, None)
        if sub is None or not hasattr(sub, field):
            raise SystemExit(f"unknown config field {key!r}")
        old = getattr(sub, field)
        sub = dataclasses.replace(sub, **{field: _parse_value(raw, old)})
        cfg = dataclasses.replace(cfg, **{section: sub})
    return cfg


def build_config(args) -> Config:
    return apply_overrides(preset(args.preset), args.set)


def resolve_data(args, cfg: Config, mesh=None):
    """Returns (loader, proposal_store). Generates synthetic data on demand
    (on a mesh the first rank writes it under the shared --dataset-root
    while the others wait)."""
    from multipathnet_tpu_torch.data import synthetic
    from multipathnet_tpu_torch.data.coco import CocoLoader, make_split
    from multipathnet_tpu_torch.data.proposals import ProposalStore

    root = args.dataset_root
    if args.synthetic and mesh is not None and not root:
        raise SystemExit("--synthetic on several ranks needs a shared "
                         "--dataset-root")
    if getattr(args, "dataset", "coco") == "voc":
        from multipathnet_tpu_torch.data.voc import VocLoader

        split = args.split if args.split != "synthetic" else "test"
        year = getattr(args, "voc_year", "2007")
        if args.synthetic:
            if not root:
                import tempfile

                root = tempfile.mkdtemp(prefix="mpnet_voc_")
            marker = os.path.join(root, f"VOC{year}", "ImageSets", "Main",
                                  f"{split}.txt")
            if not os.path.exists(marker) and is_first(mesh):
                size = max(cfg.data.image_size)
                synthetic.generate_voc(
                    root, num_images=16, image_size=min(size, 256),
                    num_classes=min(cfg.model.num_classes - 1, 20),
                    proposals_per_image=min(cfg.data.max_proposals, 64),
                    split=split, year=year, seed=cfg.train.seed)
            _wait_for_first(mesh)
        if not root:
            raise SystemExit("--dataset-root required (or use --synthetic)")
        loader = VocLoader(root, split=split, year=year)
        prop_path = args.proposals or os.path.join(
            root, f"proposals_voc_{split}.npz")
        return loader, ProposalStore.load(prop_path)

    if args.synthetic:
        if not root:
            import tempfile

            root = tempfile.mkdtemp(prefix="mpnet_synth_")
        marker = os.path.join(root, "annotations",
                              f"instances_{args.split}.json")
        if not os.path.exists(marker) and is_first(mesh):
            size = max(cfg.data.image_size)
            synthetic.generate(
                root, num_images=16, image_size=min(size, 256),
                num_classes=cfg.model.num_classes - 1,
                proposals_per_image=min(cfg.data.max_proposals, 64),
                split=args.split, seed=cfg.train.seed)
        _wait_for_first(mesh)
        loader = CocoLoader(marker, os.path.join(root, args.split))
        prop_path = args.proposals or os.path.join(
            root, f"proposals_{args.split}.npz")
        return loader, ProposalStore.load(prop_path)

    if not root:
        raise SystemExit("--dataset-root required (or use --synthetic)")
    if args.annotations:
        loader = CocoLoader(args.annotations,
                            os.path.join(root, args.split))
    else:
        loader = make_split(root, args.split)
    prop_path = args.proposals or os.path.join(
        root, f"proposals_{args.split}.npz")
    return loader, ProposalStore.load(prop_path)


def launched_mesh(device: str, batch_size: int):
    """-> (launched, mesh): whether torchrun started this process as one
    of several ranks (WORLD_SIZE > 1), and then this rank's place in the
    widest data mesh whose width divides batch_size (joined here: NCCL on
    the card, one per rank; gloo on the CPU), None for a rank past it,
    which has nothing to do. Not launched: (False, None), one device."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False, None
    from multipathnet_tpu_torch.core import mesh as mesh_lib

    mesh_lib.init_from_env(device)
    return True, mesh_lib.largest_data_mesh(
        batch_size, device=None if device == "cuda" else device)


def is_first(mesh) -> bool:
    """Whether this rank writes and prints: the mesh's first, or the one
    process."""
    return mesh is None or mesh.rank == 0


def _wait_for_first(mesh) -> None:
    from multipathnet_tpu_torch.core.mesh import barrier

    barrier(mesh)


def _serving(cfg: Config) -> bool:
    """Whether cfg asks for a serving transform (int8 head, truncated-SVD
    ranks), which checkpoints never hold."""
    return bool(cfg.model.head_quant != "none" or cfg.model.fc6_rank
                or cfg.model.fc7_rank)


def restore_float_state(cfg: Config, checkpoint_dir: str = "",
                        strict: bool = True, device=None, mesh=None):
    """Shared CLI restore contract: checkpoints are FLOAT, so restore
    against a float-head Trainer on `device` even when the requested config
    is an int8 or truncated-SVD serving one — the transforms happen at the
    consumer (Detector at load).

    -> (trainer, state). strict: a checkpoint_dir with no checkpoint raises
    SystemExit; strict=False keeps the random init. `mesh`: the trainer's
    (data) mesh, whose first rank reports."""
    from multipathnet_tpu_torch.train.loop import Trainer

    float_cfg = cfg
    if _serving(cfg):
        float_cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, head_quant="none", fc6_rank=0, fc7_rank=0))
    trainer = Trainer(float_cfg, device=device, mesh=mesh)
    state = trainer.init_state()
    if checkpoint_dir:
        from multipathnet_tpu_torch.train.checkpoint import Checkpointer

        ckpt = Checkpointer(os.path.join(checkpoint_dir, "ckpt"))
        restored = ckpt.restore_latest(trainer, state)
        if restored is None:
            if strict:
                raise SystemExit(f"no checkpoint under {checkpoint_dir}")
        else:
            state = restored
            if is_first(mesh):
                print(f"restored step {state.step}", file=sys.stderr)
    return trainer, state


def restore_proposal_state(cfg, checkpoint_dir: str = "", strict=True,
                           device=None):
    """-> (ProposalTrainer on `device`, state): the random init, or the
    latest checkpoint under checkpoint_dir. strict: a directory with no
    checkpoint raises SystemExit; strict=False keeps the random init."""
    from multipathnet_tpu_torch.train.checkpoint import Checkpointer
    from multipathnet_tpu_torch.train.proposal import ProposalTrainer

    trainer = ProposalTrainer(cfg, device=device)
    state = trainer.init_state()
    if checkpoint_dir:
        restored = Checkpointer(os.path.join(
            checkpoint_dir, "ckpt")).restore_latest(trainer, state)
        if restored is None:
            if strict:
                raise SystemExit(f"no checkpoint under {checkpoint_dir}")
        else:
            state = restored
            print(f"proposal net: restored step {state.step}",
                  file=sys.stderr)
    return trainer, state


def eval_model_for(cfg: Config, trainer):
    """The model to EVALUATE with, and the tree Detector loads into it:
    (trainer.model, None) — the float model serves the weights it holds —
    or, when cfg requests a serving transform (int8 head and/or
    truncated-SVD ranks), a freshly built serving model and the restored
    float weights as a flax-layout tree, which Detector factorizes and
    quantizes at load. The condition mirrors restore_float_state's strip
    condition: trainer.model was built from the rank-stripped float config,
    so returning it for a ranked config would evaluate the FULL-RANK
    model."""
    if not _serving(cfg):
        return trainer.model, None
    from multipathnet_tpu_torch.models import convert
    from multipathnet_tpu_torch.models.multipath import build_model

    parts = []
    if cfg.model.head_quant != "none":
        parts.append(f"head_quant={cfg.model.head_quant}")
    if cfg.model.fc6_rank or cfg.model.fc7_rank:
        parts.append(f"svd ranks fc6={cfg.model.fc6_rank} "
                     f"fc7={cfg.model.fc7_rank}")
    print(f"serving transforms ({', '.join(parts)}) applied to restored "
          f"checkpoint at load", file=sys.stderr)
    tree = convert.flax_from_state_dict(trainer.model.state_dict(),
                                        host=False)
    return build_model(cfg.model, device=trainer.device), tree

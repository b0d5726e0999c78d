"""Convert a checkpoint of the JAX package (orbax) into the PyTorch port's
layout, so a training run carries across.

    python tools/convert_orbax_checkpoint.py RUN OUT [--step N]

RUN is the `train.checkpoint_dir` of a JAX `cli.train` run: its
`config.json` and its orbax checkpoints under `RUN/ckpt/<step>/`. OUT gets
the same `config.json` and `OUT/ckpt/step_<N>.pt`, the file the port's
`train/checkpoint.Checkpointer` writes and restores, so

    python -m multipathnet_tpu_torch.cli.train ... --resume \
        --set train.checkpoint_dir=OUT
    python -m multipathnet_tpu_torch.cli.eval ... --checkpoint-dir OUT

go on from the converted step. It needs both orbax (with jax) and torch,
and runs on the host's CPU: a checkpoint is host data, and the converted
file restores on the card or the CPU alike. orbax is read with a raw
restore, with no template and nothing of the JAX package imported. What
is carried, through the port's `models/convert.state_dict_from_flax` (the
weight bridge: kernels transposed to torch's layout):

- the `params` collection into the parameters, `batch_stats` (frozen BN
  statistics) into the buffers;
- the momentum `trace` of the optax chain's `sgd` into each trainable
  parameter's SGD momentum buffer, transposed as its parameter. Frozen
  stages are not in the port's optimizer, so their trace is dropped (the
  reference masks their updates, so it never moves them either);
- the schedule's `count` into the optimizer's count, and the `step`.

The reference's PRNG key (threefry `key_data`) has no torch counterpart:
the port's step generator is seeded from a hash of the key data, the same
seed for the same key, on whichever device restores it. Draws after a
converted resume (flips, ROI samples, dropout) are therefore not the ones
the reference would have made.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from multipathnet_tpu_torch.core.config import Config  # noqa: E402
from multipathnet_tpu_torch.models import convert  # noqa: E402
from multipathnet_tpu_torch.train.loop import Trainer  # noqa: E402


def _numpy(tree):
    """The restored tree with every array leaf as a numpy array."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    return None if tree is None else np.asarray(tree)


def _find(tree, key):
    """Every value stored under `key` in a nest of dicts and lists (the
    optax chain's states, restored without a template as dicts and
    lists; masked or empty states restore as None or {})."""
    if isinstance(tree, dict):
        found = [tree[key]] if key in tree else []
        return found + [v for k, sub in tree.items() if k != key
                        for v in _find(sub, key)]
    if isinstance(tree, list):
        return [v for sub in tree for v in _find(sub, key)]
    return []


def read_orbax(ckpt_dir: str, step: int | None = None):
    """-> (step, the raw restored tree as numpy) of the checkpoint at
    `step`, or the latest one, under an orbax CheckpointManager
    directory."""
    import orbax.checkpoint as ocp

    mgr = ocp.CheckpointManager(os.path.abspath(ckpt_dir))
    step = mgr.latest_step() if step is None else step
    if step is None:
        raise SystemExit(f"no orbax checkpoint under {ckpt_dir}")
    return step, _numpy(mgr.restore(step,
                                    args=ocp.args.StandardRestore()))


def generator_seed(key_data) -> int:
    """A torch seed (63 bits) from the reference's PRNG key data."""
    raw = np.ascontiguousarray(key_data, np.uint32).tobytes()
    return int.from_bytes(hashlib.sha256(raw).digest()[:8], "little") >> 1


def port_payload(cfg: Config, raw: dict) -> dict:
    """The port's checkpoint contents (train/checkpoint.py) of a raw
    restored reference checkpoint whose run had config `cfg`."""
    (trace,) = _find(raw["opt_state"], "trace")
    (count,) = _find(raw["opt_state"], "count")
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state()
    model, opt = trainer.model, state.optimizer
    sd = convert.state_dict_from_flax(raw["params"])
    missing = set(model.state_dict()) ^ set(sd)
    if missing:
        raise SystemExit(f"the checkpoint does not fit config.json's model: "
                         f"{sorted(missing)[:8]}")
    model.load_state_dict(sd, strict=True)
    momentum = convert.state_dict_from_flax({"params": trace["params"]})
    names = {id(p): n for n, p in model.named_parameters()}
    for p in opt.params:
        opt.sgd.state[p]["momentum_buffer"] = momentum[names[id(p)]].clone()
    return {
        "step": int(raw["step"]),
        "params": {n: p.detach().clone()
                   for n, p in model.named_parameters()},
        "buffers": {n: b.detach().clone() for n, b in model.named_buffers()},
        "sgd": opt.sgd.state_dict(),
        "count": int(count),
        # a seed, not a generator state: restore_train_state seeds the
        # restoring device's generator with it
        "generator": generator_seed(raw["key_data"]),
    }


def convert_run(run_dir: str, out_dir: str, step: int | None = None) -> str:
    """Convert RUN's checkpoint at `step` (default: the latest) into OUT;
    returns the written file's path."""
    with open(os.path.join(run_dir, "config.json")) as f:
        cfg = Config.from_json(f.read())
    step, raw = read_orbax(os.path.join(run_dir, "ckpt"), step)
    payload = port_payload(cfg, raw)
    if payload["step"] != step:
        raise SystemExit(f"checkpoint {step} holds step {payload['step']}")
    ckpt = os.path.join(out_dir, "ckpt")
    os.makedirs(ckpt, exist_ok=True)
    shutil.copyfile(os.path.join(run_dir, "config.json"),
                    os.path.join(out_dir, "config.json"))
    path = os.path.join(ckpt, f"step_{step}.pt")
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("run", help="the JAX run's train.checkpoint_dir")
    p.add_argument("out", help="the port's train.checkpoint_dir to write")
    p.add_argument("--step", type=int, default=None,
                   help="the step to convert (default: the latest)")
    args = p.parse_args(argv)
    print(convert_run(args.run, args.out, args.step))


if __name__ == "__main__":
    main()

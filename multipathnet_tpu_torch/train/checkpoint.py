"""Checkpoint/resume — port of multipathnet_tpu/train/checkpoint.py through
torch.save in place of orbax.

A checkpoint holds what a train step reads and changes, as
train/loop.snapshot_train_state does: every float32 parameter of the model
(frozen ones included) and every buffer (frozen BN statistics), the SGD
momentum buffers and the optimizer's count, the step and the state of the
step's generator, so `restore_latest` resumes exactly. `trainer` is the
detector's Trainer or the proposal network's ProposalTrainer
(train/proposal.py): both keep their parameters in `.model` and their
step's state in a TrainState. Files are <directory>/step_<N>.pt. `save`
copies the state to host memory at once
(the train loop goes on changing the parameters) and writes it on a
background thread, to a temporary file first and then into place by
os.replace, so a run killed mid-write leaves no torn checkpoint; `wait`
joins the write. The port does not read the reference's orbax checkpoints
(ROADMAP §C).

On a mesh (the trainer's `.mesh`) a checkpoint holds whole tensors, as one
process's does: `save` gathers each tensor-parallel parameter and its
momentum over the model axis (every rank calls it), the mesh's first rank
writes at once, and every rank waits for the write; whether the step is
already saved, and which step a restore reads, are the first rank's
decisions. `restore_latest` cuts the whole tensors to the restoring
trainer's mesh, so a checkpoint saved
on any mesh restores on any other, as the reference's does.
"""

from __future__ import annotations

import os
import re
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import torch

from multipathnet_tpu_torch.core.mesh import barrier, broadcast_object
from multipathnet_tpu_torch.train.loop import (TrainState,
                                               gather_state_dict,
                                               restore_train_state,
                                               shard_state_dict)

_NAME = re.compile(r"step_(\d+)\.pt")


def _to_host(x):
    """A copy of every tensor in a nested dict/list, on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_to_host(v) for v in x]
    return x


def _momentum_names(trainer, opt) -> list:
    """The parameter name of each optimizer slot, in slot order."""
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    return [names[id(p)] for p in opt.params]


def _map_momentum(sgd: dict, names: list, fn) -> dict:
    """A copy of an SGD state dict with each momentum buffer t of the
    parameter called name replaced by fn(name, t)."""
    state = {i: {**st, "momentum_buffer": fn(names[i],
                                              st["momentum_buffer"])}
             if st.get("momentum_buffer") is not None else st
             for i, st in sgd["state"].items()}
    return {**sgd, "state": state}


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._writer = ThreadPoolExecutor(max_workers=1,
                                          thread_name_prefix="checkpoint")
        self._pending = None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for m in map(
            _NAME.fullmatch, os.listdir(self.directory)) if m)

    def save(self, trainer, state: TrainState) -> None:
        """Checkpoint `state` (with the parameters `trainer.model` holds);
        a step already saved is not written again (the periodic and the
        final save can hit the same step). On a mesh the first rank, which
        writes, decides that for every rank."""
        self.wait()
        dims, mesh = getattr(trainer, "tp_dims", {}), trainer.mesh
        group = None if mesh is None else mesh.group
        # every rank takes the first rank's branch around the collectives,
        # whatever it sees on disk itself
        if broadcast_object(state.step in self.all_steps(), group):
            return
        names = _momentum_names(trainer, state.optimizer)
        payload = {  # the gathers are collective: every rank makes them
            "step": state.step,
            "params": gather_state_dict(
                dict(trainer.model.named_parameters()), dims, mesh),
            "buffers": dict(trainer.model.named_buffers()),
            "sgd": _map_momentum(
                state.optimizer.sgd.state_dict(), names,
                lambda n, t: gather_state_dict({n: t}, dims, mesh)[n]),
            "count": state.optimizer.count,
            "generator": state.generator.get_state(),
        }
        if mesh is None or mesh.size == 1:
            self._pending = self._writer.submit(self._write, state.step,
                                                _to_host(payload))
            return
        if mesh.rank == 0:
            self._write(state.step, _to_host(payload))
        barrier(mesh)

    def _write(self, step: int, payload: dict) -> None:
        path = self._path(step)
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def wait(self) -> None:
        """Wait for the write in flight; raises what it raised."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def latest_step(self) -> Optional[int]:
        self.wait()
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore_latest(self, trainer,
                       template: TrainState) -> Optional[TrainState]:
        """Load the latest checkpoint into trainer.model and template's
        optimizer; returns the state to step from, or None if there is no
        checkpoint."""
        step = self.latest_step()
        mesh = trainer.mesh
        step = broadcast_object(step, None if mesh is None else mesh.group)
        if step is None:
            return None
        saved = torch.load(self._path(step), map_location="cpu",
                           weights_only=True)
        dims = getattr(trainer, "tp_dims", {})
        if dims:
            names = _momentum_names(trainer, template.optimizer)
            saved["params"] = shard_state_dict(saved["params"], dims,
                                               trainer.mesh)
            saved["sgd"] = _map_momentum(
                saved["sgd"], names,
                lambda n, t: shard_state_dict({n: t}, dims, trainer.mesh)[n])
        return restore_train_state(
            trainer, {**saved, "optimizer": template.optimizer})

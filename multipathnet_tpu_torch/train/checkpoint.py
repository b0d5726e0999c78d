"""Checkpoint/resume — port of multipathnet_tpu/train/checkpoint.py through
torch.save in place of orbax.

A checkpoint holds what a train step reads and changes, as
train/loop.snapshot_train_state does: every float32 parameter of the model
(frozen ones included), the SGD momentum buffers and the optimizer's count,
the step and the state of the step's generator, so `restore_latest` resumes
exactly. Files are <directory>/step_<N>.pt. `save` copies the state to host
memory at once (the train loop goes on changing the parameters) and writes
it on a background thread, to a temporary file first and then into place by
os.replace, so a run killed mid-write leaves no torn checkpoint; `wait`
joins the write. The port does not read the reference's orbax checkpoints
(ROADMAP §C).
"""

from __future__ import annotations

import os
import re
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import torch

from multipathnet_tpu_torch.train.loop import (Trainer, TrainState,
                                               restore_train_state)

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

    def save(self, trainer: Trainer, state: TrainState) -> None:
        """Checkpoint `state` (with the parameters `trainer.model` holds);
        a step already saved is not written again (the periodic and the
        final save can hit the same step)."""
        self.wait()
        if state.step in self.all_steps():
            return
        payload = _to_host({
            "step": state.step,
            "params": dict(trainer.model.named_parameters()),
            "sgd": state.optimizer.sgd.state_dict(),
            "count": state.optimizer.count,
            "generator": state.generator.get_state(),
        })
        self._pending = self._writer.submit(self._write, state.step, payload)

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

    def restore_latest(self, trainer: Trainer,
                       template: TrainState) -> Optional[TrainState]:
        """Load the latest checkpoint into trainer.model and template's
        optimizer; returns the state to step from, or None if there is no
        checkpoint."""
        step = self.latest_step()
        if step is None:
            return None
        saved = torch.load(self._path(step), map_location="cpu",
                           weights_only=True)
        return restore_train_state(
            trainer, {**saved, "optimizer": template.optimizer})

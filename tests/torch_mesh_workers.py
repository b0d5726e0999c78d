"""Rank bodies that only the mesh tests run (tests/test_torch_mesh.py,
test_torch_dp.py, test_torch_tp.py), in a module of their own because
spawned ranks import the module of their function and the test files
import jax: this one imports only numpy, torch and the port. The bodies
that chip_smoke.py shares with the tests are in
multipathnet_tpu_torch/tools/mesh_runs.py."""

import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from multipathnet_tpu_torch.core import mesh as mesh_lib
from multipathnet_tpu_torch.data import sampler as sampler_lib
from multipathnet_tpu_torch.data.coco import CocoLoader
from multipathnet_tpu_torch.data.proposals import ProposalStore
from multipathnet_tpu_torch.eval.tester import Tester
from multipathnet_tpu_torch.models.heads import MultiPathHead
from multipathnet_tpu_torch.models.multipath import build_model
from multipathnet_tpu_torch.tools import mesh_runs
from multipathnet_tpu_torch.train.checkpoint import Checkpointer
from multipathnet_tpu_torch.train.loop import Trainer


def fail_on_rank(bad: int, message: str):
    import torch.distributed as dist

    if dist.get_rank() == bad:
        raise ValueError(message)
    return dist.get_rank()


def sleep(seconds: float):
    time.sleep(seconds)


def collectives(shape, n_spare_shape):
    """The mesh's coordinates, a narrower mesh's (None past it), and a
    column-parallel then row-parallel pair of layers with a column gather
    on this rank's parts, forward and backward, beside the same layers
    unsharded (every rank draws the same weights and input)."""
    mesh = mesh_lib.make_mesh(*shape, device="cpu")
    narrow = mesh_lib.make_mesh(*n_spare_shape, device="cpu")
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(6, 8, generator=gen)
    w1 = torch.randn(12, 8, generator=gen)
    w2 = torch.randn(4, 12, generator=gen)
    w3 = torch.randn(12, 4, generator=gen)

    def run(sharded: bool):
        xs = x.clone().requires_grad_(True)
        a, b, c = (w.clone().requires_grad_(True) for w in (w1, w2, w3))
        g = mesh.model_group
        if sharded:
            cols = mesh.cols(12)
            h = F.linear(mesh_lib.copy_to_model(xs, g), a[cols])
            y = mesh_lib.reduce_from_model(F.linear(h.relu(), b[:, cols]), g)
            z = mesh_lib.gather_cols(
                F.linear(mesh_lib.copy_to_model(y, g), c[cols]), g)
            z2 = F.linear(mesh_lib.split_cols(z, g), b[:, cols])
            z2 = mesh_lib.reduce_from_model(z2, g)
        else:
            z = F.linear(F.linear(F.linear(xs, a).relu(), b), c)
            z2 = F.linear(z, b)
        loss = (z * z).sum() + z2.sum()
        loss.backward()
        return loss.detach(), xs.grad, a.grad, b.grad, c.grad

    got, want = run(True), run(False)
    cols = mesh.cols(12)
    got_w = (got[2][cols], got[3][:, cols], got[4][cols])
    want_w = (want[2][cols], want[3][:, cols], want[4][cols])
    return {"coord": (mesh.data_rank, mesh.model_rank),
            "narrow": None if narrow is None else (narrow.data_rank,
                                                   narrow.model_rank),
            "loss": (float(got[0]), float(want[0])),
            "max_err": max(float((u - v).abs().max()) for u, v in
                           zip((got[1],) + got_w, (want[1],) + want_w)),
            "sum": float(mesh_lib.all_sum(torch.tensor(1.0),
                                          mesh.group)),
            "max": float(mesh_lib.all_max(torch.tensor(float(mesh.rank)),
                                          mesh.data_group))}


def jobs_then_modules(jobs):
    """tools/mesh_runs.run_jobs(jobs) on this rank, then the modules of
    jax, flax, optax or the JAX package that the rank has imported."""
    import sys

    mesh_runs.run_jobs(jobs)
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                         "multipathnet_tpu"))


def train_with_sample(cfg, shape, batch, sample, **kwargs):
    """mesh_runs.train_run with the step's ROI sample replaced by `sample`
    (a whole batch's RoiSample fields as numpy arrays; each rank takes its
    rows) and dropout off."""
    def fixed(generator, proposals, *_, shard=None, **__):
        index, count = shard or (0, 1)
        return sampler_lib.RoiSample(*(
            torch.from_numpy(np.array(np.split(v, count)[index])).to(
                proposals.device) for v in sample.values()))

    drawn, rate = sampler_lib.sample_batch, MultiPathHead.dropout_rate
    sampler_lib.sample_batch, MultiPathHead.dropout_rate = fixed, 0.0
    try:
        return mesh_runs.train_run(cfg, shape, batch, **kwargs)
    finally:
        sampler_lib.sample_batch, MultiPathHead.dropout_rate = drawn, rate


def save_twice(cfg, base):
    """A (2, 1) trainer checkpoints one step twice, each rank into a
    directory of its own, so that after the first save only the first
    rank sees the file: every rank must take the first rank's branch
    (skip the step already saved), or the second rank waits at the write's
    barrier for a first rank that has moved on. -> the steps on disk in
    this rank's directory."""
    mesh = mesh_lib.make_mesh(2, 1, device="cpu")
    trainer = Trainer(cfg, mesh=mesh)
    state = trainer.init_state(0)
    own = Checkpointer(os.path.join(base, f"rank_{mesh.rank}"))
    for _ in range(2):
        own.save(trainer, state)
    return own.all_steps()


def tester_on_trainer_model(cfg, shape, split, tree):
    """A Trainer on a `shape` mesh holding `tree`, whose model (its head
    already sharded) goes to Tester(..., mesh=trainer.mesh), as cli.train
    evaluates mid-run, beside an unsharded one-process Tester on the same
    tree. -> the head's local shapes before and after the Tester, and
    both Testers' detections (the first rank's; [] elsewhere); None off
    the mesh."""
    mesh = mesh_lib.make_mesh(*shape, device="cpu")
    if mesh is None:
        return None
    trainer = Trainer(cfg, mesh=mesh)
    trainer.init_state(0)
    mesh_runs.set_weights(trainer, 0, 0.0, tree)

    def shapes():
        return {n: tuple(p.shape)
                for n, p in trainer.model.head.named_parameters()}

    before = shapes()
    loader = CocoLoader(split[0], split[1])
    props = ProposalStore.load(split[2])
    meshed = Tester(trainer.model, cfg, loader, props, batch_size=4,
                    mesh=trainer.mesh).collect_detections()
    after = shapes()
    one = Tester(build_model(cfg.model, device="cpu"), cfg, loader, props,
                 params=tree, device="cpu",
                 batch_size=4).collect_detections()
    return {"before": before, "after": after, "detections": meshed,
            "unsharded": one, "roles": dict(trainer.model.head.tp_roles)}

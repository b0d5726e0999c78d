"""Rank bodies that drive the port's paths on a mesh, for core/mesh.spawn.

Each function is what one rank runs: it builds its mesh from a (data,
model) shape (ranks past the mesh return None), drives one path through
the entry points a user calls (Trainer, ProposalTrainer, Detector, Tester,
Checkpointer) and returns what a comparison needs as host values: metrics
as floats, tensors as numpy arrays, the kernels' launch counts of the run.
chip_smoke.py (phase 19, `parallel`) runs them on the card at full width
and tests/test_torch_{mesh,dp,tp}.py on the CPU at `tiny`. Each runs on
the rank's card unless it is given `device="cpu"`, and raises without a
card, as `spawn` does; ranks on the CPU take device="cpu" in both places:

    from multipathnet_tpu_torch.core.mesh import spawn
    from multipathnet_tpu_torch.tools import mesh_runs
    results = spawn(mesh_runs.train_run, 2, args=(cfg, (2, 1), batch),
                    kwargs=dict(device="cpu"), device="cpu")

`run_jobs` runs several of them in order on one set of ranks, each on its
own mesh, so one launch serves meshes of several shapes (here on the
card, ranks and bodies alike):

    spawn(mesh_runs.run_jobs, 2, args=([
        (mesh_runs.train_run, (cfg, (2, 1), batch), {}),
        (mesh_runs.detect_run, (cfg, (1, 2), inputs), {})],))

cuDNN's algorithms are chosen per run: `train_run(deterministic=)` sets
them; the other runs take cuDNN's defaults.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from multipathnet_tpu_torch.core.mesh import make_mesh
from multipathnet_tpu_torch.data.coco import CocoLoader
from multipathnet_tpu_torch.data.proposals import ProposalStore
from multipathnet_tpu_torch.eval.detect import Detector, score_batch
from multipathnet_tpu_torch.eval.tester import Tester
from multipathnet_tpu_torch.models import convert
from multipathnet_tpu_torch.models.multipath import build_model
from multipathnet_tpu_torch.train.checkpoint import Checkpointer
from multipathnet_tpu_torch.train.loop import (Trainer, restore_train_state,
                                               snapshot_train_state)
from multipathnet_tpu_torch.train.proposal import ProposalTrainer
from multipathnet_tpu_torch.utils import profiling


@torch.no_grad()
def seeded_normal_(model, seed: int, std: float = 0.02) -> int:
    """bench.py's weights: every parameter normal * std, drawn on the
    model's device from one seeded generator, in parameter order."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    for p in model.parameters():
        p.copy_(torch.randn(p.shape, generator=gen, device=dev) * std)
    return sum(p.numel() for p in model.parameters())


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak_gib(device) -> float:
    if device.type != "cuda":
        return 0.0
    return torch.cuda.max_memory_allocated(device) / 2**30


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def run_jobs(jobs):
    """[(a rank body, args, kwargs), ...] -> their results, run in order
    on this rank."""
    return [fn(*args, **kwargs) for fn, args, kwargs in jobs]


def _grads(trainer) -> dict:
    return {n: p.grad.detach().clone()
            for n, p in trainer.model.named_parameters()
            if p.grad is not None}


def _params(trainer) -> dict:
    return {n: p.detach().clone()
            for n, p in trainer.model.named_parameters()}


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def set_weights(trainer, seed: int, std: float, tree) -> None:
    """seeded_normal_ (or the flax-layout `tree`) over the whole model,
    cut to this rank's head."""
    full = trainer.build_whole_model() if trainer.tp_dims else trainer.model
    if tree is not None:
        convert.load_flax_params(full, tree)
    else:
        seeded_normal_(full, seed, std)
    if full is not trainer.model:
        trainer.load_full_state_dict(full.state_dict())


def train_run(cfg, shape, batch, *, device=None, seed=0, steps=1,
              normal_std=0.0, tree=None, repeat=False, timed=0,
              compare_plain=False, save_dir=None, restore_dir=None,
              return_params=True, dump_file=None, diff_file=None,
              deterministic=False):
    """Trainer(cfg, mesh) on this rank: init_state(seed) (then, with
    normal_std, bench.py's normal weights; with `tree`, a flax-layout
    tree's), `steps` steps on the global `batch`. Options: `repeat` steps
    twice from the state before the first step and says whether loss,
    gradients and parameters are equal; `timed` steps timed after
    everything else; `compare_plain` (a 1 x 1 mesh) runs a plain Trainer
    from the same state and says whether it is equal bit for bit;
    `save_dir` checkpoints after the steps, `restore_dir` restores before
    them; `return_params` returns the whole parameters after the steps,
    `dump_file` saves them (first rank), `diff_file` reads such a file and
    returns the largest difference from it; `deterministic` sets
    cudnn.deterministic for the run. Returns a dict, or None off the
    mesh."""
    mesh = make_mesh(*shape, device=device)
    if mesh is None:
        return None
    torch.backends.cudnn.deterministic = deterministic
    dev = mesh.device
    trainer = Trainer(cfg, mesh=mesh)
    state = trainer.init_state(seed)
    if normal_std or tree is not None:
        set_weights(trainer, seed, normal_std, tree)
    if restore_dir:
        state = Checkpointer(restore_dir).restore_latest(trainer, state)
    saved = snapshot_train_state(trainer, state) if (
        repeat or compare_plain) else None
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    before = profiling.counters()
    t0 = time.perf_counter()
    history = []
    for _ in range(steps):
        state, m = trainer.step(state, batch)
        history.append({k: float(v) for k, v in m.items()})
    _sync(dev)
    out = {"coord": (mesh.data_rank, mesh.model_rank),
           "metrics": history, "launches": profiling.kernel_launches(before),
           "first_s": time.perf_counter() - t0, "step": state.step,
           "tp_roles": dict(trainer.model.head.tp_roles),
           "head_shapes": {n: tuple(p.shape) for n, p in
                           trainer.model.head.named_parameters()}}
    if return_params or dump_file or diff_file:
        full = trainer.full_state_dict()
        if return_params:
            out["params"] = _host(full)
        if dump_file and mesh.rank == 0:
            torch.save({n: t.cpu() for n, t in full.items()}, dump_file)
        if diff_file:
            other = torch.load(diff_file, map_location="cpu",
                               weights_only=True)
            out["max_param_diff"] = max(
                float((t.cpu().float() - other[n].float()).abs().max())
                for n, t in full.items())
            del other
        del full
    if compare_plain:
        if steps != 1 or mesh.size != 1:
            raise ValueError("compare_plain takes one step on a 1 x 1 mesh")
        plain = Trainer(cfg, device=dev)
        pstate = restore_train_state(plain, {
            **saved, "optimizer": plain.init_state(seed).optimizer})
        _, pm = plain.step(pstate, batch)
        out["plain_equal"] = {
            "loss": float(pm["loss"]) == history[0]["loss"],
            "params": _equal(_params(trainer), _params(plain)),
            "grads": _equal(_grads(trainer), _grads(plain))}
        del plain, pstate
    if repeat:
        _, m = trainer.step(restore_train_state(trainer, saved), batch)
        first = (m["loss"].clone(), _params(trainer), _grads(trainer))
        _, m = trainer.step(restore_train_state(trainer, saved), batch)
        live = {n: p.detach() for n, p in trainer.model.named_parameters()}
        out["repeat_equal"] = bool(torch.equal(first[0], m["loss"])) and \
            _equal(first[1], live) and _equal(first[2], {
                n: p.grad for n, p in trainer.model.named_parameters()
                if p.grad is not None})
        del first, live
        state = restore_train_state(trainer, saved)
        for _ in range(steps):
            state, _ = trainer.step(state, batch)
    if save_dir:
        ckpt = Checkpointer(save_dir)
        ckpt.save(trainer, state)
        ckpt.wait()
    if timed:
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(timed):
            state, m = trainer.step(state, batch)
        _sync(dev)
        out["ms_per_step"] = 1e3 * (time.perf_counter() - t0) / timed
        out["timed_loss"] = float(m["loss"])
    out["peak_gib"] = _peak_gib(dev)
    return out


def detect_run(cfg, shape, inputs, *, device=None, tree=None,
               normal_seed=None, compare_unsharded=False, timed=0):
    """Detector(model, cfg, params=tree, mesh) on this rank (with
    `normal_seed`, bench.py's weights drawn into the model instead: for an
    int8 config in the float32 layout, quantized at load), on the global
    batch `inputs` (images, src_hws, proposals, prop_mask). Returns the
    detections, score_batch's boxes and probabilities, the launches of one
    detection and the rank's local head shapes; with `compare_unsharded`
    also an unsharded Detector's outputs on the same weights; with `timed`
    the ms per batch of that many more detections."""
    mesh = make_mesh(*shape, device=device)
    if mesh is None:
        return None
    dev = mesh.device
    torch.backends.cudnn.deterministic = False

    def build():
        m = cfg.model
        if normal_seed is None:
            return build_model(m, device=dev), tree
        if m.head_quant == "none":
            model = build_model(m, device=dev)
            seeded_normal_(model, normal_seed)
            return model, None
        fm = build_model(dataclasses.replace(m, head_quant="none"),
                         param_dtype=torch.float32, device=dev)
        seeded_normal_(fm, normal_seed)
        t = convert.flax_from_state_dict(fm.state_dict(), host=False)
        return build_model(m, device=dev), t

    def run(det):
        """-> (detections of the batch, score_batch of this rank's rows,
        the launches of the detection)."""
        before = profiling.counters()
        res = det(*inputs)
        launches = profiling.kernel_launches(before)
        rows = slice(None)
        if det.mesh is not None and det.mesh.n_data > 1:
            rows = det.mesh.rows(len(inputs[0]))
        boxes, probs = score_batch(det.model, cfg, *(
            torch.as_tensor(np.asarray(x)[rows], device=dev)
            for x in inputs[:3]))
        return res, _host({"boxes": boxes, "probs": probs}), launches

    model, params = build()
    det = Detector(model, cfg, params=params, mesh=mesh)
    res, scores, launches = run(det)
    out = {"coord": (mesh.data_rank, mesh.model_rank), "detections": res,
           "scores": scores, "launches": launches,
           "tp_roles": dict(det.model.head.tp_roles),
           "head_state_shapes": {n: tuple(t.shape) for n, t in
                                 det.model.head.state_dict().items()}}
    if timed:
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(timed):
            det(*inputs)
        _sync(dev)
        out["ms_per_batch"] = 1e3 * (time.perf_counter() - t0) / timed
    if compare_unsharded:
        model, params = build()
        plain = Detector(model, cfg, params=params)
        pres, pscores, _ = run(plain)
        out["unsharded"] = {"detections": pres, "scores": pscores}
    out["peak_gib"] = _peak_gib(dev)
    return out


def tester_run(cfg, shape, split, *, device=None, tree=None,
               normal_seed=None, batch_size=None, collect=False):
    """Tester(model, cfg, loader, proposals, mesh) on this rank over a
    COCO split on disk (`split`: annotations file, image directory,
    proposals file). Returns the metrics, the images this rank decoded and
    the launches of Tester.test; with `collect` the first rank's
    detections too."""
    mesh = make_mesh(*shape, device=device)
    if mesh is None:
        return None
    torch.backends.cudnn.deterministic = False
    model = build_model(cfg.model, device=mesh.device)
    if normal_seed is not None:
        seeded_normal_(model, normal_seed)
    loader = CocoLoader(split[0], split[1])
    tester = Tester(model, cfg, loader, ProposalStore.load(split[2]),
                    params=tree, batch_size=batch_size, mesh=mesh)
    before = profiling.counters()
    t0 = time.perf_counter()
    metrics = tester.test()
    seconds = time.perf_counter() - t0
    out = {"coord": (mesh.data_rank, mesh.model_rank), "metrics": metrics,
           "decoded": tester.pipeline.examples_decoded,
           "launches": profiling.kernel_launches(before), "seconds": seconds}
    if collect:
        out["detections"] = tester.collect_detections()
    return out


def proposal_run(cfg, shape, batch, *, device=None, seed=0, steps=1):
    """ProposalTrainer(cfg, mesh) on this rank: init_state(seed), `steps`
    steps on the global `batch` (with gt_masks). Returns the metrics of
    each step and the parameters after them."""
    mesh = make_mesh(*shape, device=device)
    if mesh is None:
        return None
    trainer = ProposalTrainer(cfg, mesh=mesh)
    state = trainer.init_state(seed)
    history = []
    for _ in range(steps):
        state, m = trainer.step(state, batch)
        history.append({k: float(v) for k, v in m.items()})
    return {"coord": (mesh.data_rank, mesh.model_rank), "metrics": history,
            "params": _host(_params(trainer))}

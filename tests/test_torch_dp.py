"""Port parity, data parallelism at `tiny` in float32: the train step,
the proposal step, the Tester and the int8 Detector on data meshes of
gloo ranks on the CPU, against one process and against the reference's
meshes on the conftest's 8 virtual devices; and a Tester on a trainer's
tensor-parallel model. The rank bodies
(multipathnet_tpu_torch/tools/mesh_runs.py, tests/torch_mesh_workers.py)
run in one launch for the module through core/mesh.spawn.

Every random draw of a step is made at the global batch's shape on every
rank, so a data mesh draws what one process draws: the loss is the
reference's width-invariant one (tests/test_sharding.py) at its bar, rel
1e-5, and the parameters after a step agree within 1e-6."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_mesh_workers as workers
from multipathnet_tpu_torch.core.config import preset
from multipathnet_tpu_torch.core.mesh import spawn
from multipathnet_tpu_torch.data import synthetic
from multipathnet_tpu_torch.data.coco import CocoLoader
from multipathnet_tpu_torch.data.pipeline import DetectionPipeline
from multipathnet_tpu_torch.data.proposals import ProposalStore
from multipathnet_tpu_torch.eval.detect import Detector
from multipathnet_tpu_torch.eval.tester import Tester
from multipathnet_tpu_torch.models import convert
from multipathnet_tpu_torch.models.multipath import build_model
from multipathnet_tpu_torch.tools import mesh_runs
from multipathnet_tpu_torch.train.loop import Trainer
from multipathnet_tpu_torch.train.proposal import ProposalTrainer

TIMEOUT = 300  # seconds the module's launch may take before it fails


def _cfg(make_preset, **model):
    """The reference's sharding fixture's config (tiny, 5 classes, batch
    4) in float32, warmup off so the step moves the weights; the
    reference's windowed (Pallas) pool route, the one the port's kernels
    compute."""
    cfg = make_preset("tiny")
    model = {"roi_impl": "pallas", "train_roi_impl": "pallas", **model}
    return cfg.replace(
        model=dataclasses.replace(cfg.model, num_classes=5, dtype="float32",
                                  **model),
        train=dataclasses.replace(cfg.train, batch_size=4, warmup_steps=0))


def _no_flip(cfg):
    return cfg.replace(data=dataclasses.replace(cfg.data, hflip_prob=0.0))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The reference's tests/test_sharding.py data: 8 synthetic images,
    the first batch of 4; and the split's paths."""
    fx = synthetic.generate(str(tmp_path_factory.mktemp("dp_ds")),
                            num_images=8, image_size=64, num_classes=4,
                            proposals_per_image=16, seed=31)
    cfg = _cfg(preset)
    loader = CocoLoader(fx["annotations"], fx["images"])
    props = ProposalStore.load(fx["proposals"])
    batch = next(DetectionPipeline(loader, props, cfg.data, batch_size=4,
                                   seed=0).epoch(0))
    masked = next(DetectionPipeline(loader, props, cfg.data, batch_size=4,
                                    seed=0, with_masks=True).epoch(0))
    return cfg, batch, masked, loader, props, fx


@pytest.fixture(scope="module")
def fitted(data):
    """A tree the port's Trainer fitted to the split for 15 epochs (so
    AP is far from 0), flax layout."""
    cfg, _, _, loader, props, _ = data
    torch.manual_seed(0)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(0)
    pipe = DetectionPipeline(loader, props, cfg.data, batch_size=4, seed=0)
    for ep in range(15):
        for batch in pipe.epoch(ep):
            state, _ = trainer.step(state, batch)
    return convert.flax_from_state_dict(trainer.model.state_dict())


def _reference_sample_and_step(cfg_ref, batch):
    """The reference's sample of the batch (key 9) and its
    Trainer(mesh=make_mesh(n_data=2)) step on it, dropout off: -> (sample
    as numpy, initial params, reference loss)."""
    import flax.linen as fnn

    from multipathnet_tpu.core.config import preset as jpreset
    from multipathnet_tpu.core.mesh import make_mesh
    from multipathnet_tpu.data import sampler as jsampler
    from multipathnet_tpu.data import transforms as jtf
    from multipathnet_tpu.models.multipath import build_model as jbuild
    from multipathnet_tpu.train import loop as jloop

    jcfg = _no_flip(_cfg(jpreset))
    d, m = jcfg.data, jcfg.model
    canvases, scales = jax.jit(lambda im, hw: jtf.batch_resize_to_canvas(
        im, d.image_size, hw))(batch.images, batch.src_hws)
    s = np.asarray(scales)[:, None, None]
    sample = jax.jit(lambda *a: jsampler.sample_batch(
        jax.random.key(9), *a, rois_per_image=d.rois_per_image,
        fg_fraction=d.fg_fraction, fg_iou_threshold=d.fg_iou_threshold,
        bg_iou_range=d.bg_iou_range, bbox_reg_means=m.bbox_reg_means,
        bbox_reg_stds=m.bbox_reg_stds))(
        batch.proposals * s, batch.prop_mask, batch.gt_boxes * s,
        batch.gt_classes, batch.gt_mask)
    mp = pytest.MonkeyPatch()
    mp.setattr(jsampler, "sample_batch", lambda *a, **k: sample)
    mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    try:
        trainer = jloop.Trainer(jcfg, mesh=make_mesh(n_data=2))
        # off the TPU the reference's Trainer trains through its exact
        # "direct" roi_align; put back the windowed route the port's
        # kernels compute (Pallas in interpret mode), as
        # tests/test_torch_train.py's step does
        trainer.cfg = jcfg
        trainer.model = jbuild(jcfg.model,
                               freeze_stages=jcfg.train.freeze_backbone_stages)
        trainer._step_fn = jloop.make_train_step(trainer.model, jcfg,
                                                 trainer.tx)
        state = trainer.init_state(0)
        params = jax.tree.map(np.asarray, state.params)
        _, metrics = trainer.step(state, jloop.Batch(*batch))
        loss = float(metrics["loss"])
    finally:
        mp.undo()
    return ({k: np.asarray(v) for k, v in sample._asdict().items()},
            params, loss)


@pytest.fixture(scope="module")
def runs(data, fitted, tmp_path_factory):
    """Every data-parallel run of the module, in one launch of 4 ranks:
    -> (rank results by job, the reference's (2, 1) loss, its initial
    params)."""
    cfg, batch, masked, _, _, fx = data
    sample, ref_params, ref_loss = _reference_sample_and_step(cfg, batch)
    pcfg = cfg.replace(train=dataclasses.replace(cfg.train, lr=5e-3))
    qcfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                 head_quant="int8"))
    images = (batch.images, batch.src_hws, batch.proposals, batch.prop_mask)
    split = (fx["annotations"], fx["images"], fx["proposals"])
    cpu = dict(device="cpu")
    jobs = [(mesh_runs.train_run, (cfg, (2, 1), batch), cpu),
            (mesh_runs.train_run, (cfg, (4, 1), batch), cpu),
            (workers.train_with_sample,
             (_no_flip(cfg), (2, 1), batch, sample),
             dict(tree=ref_params, return_params=False)),
            (mesh_runs.proposal_run, (pcfg, (2, 1), masked), cpu),
            (mesh_runs.tester_run, (cfg, (2, 1), split),
             dict(cpu, tree=fitted, batch_size=4, collect=True)),
            (mesh_runs.detect_run, (qcfg, (2, 1), images),
             dict(cpu, tree=fitted, compare_unsharded=True)),
            (workers.tester_on_trainer_model, (cfg, (1, 2), split, fitted),
             {})]
    res = spawn(mesh_runs.run_jobs, 4, args=(jobs,), device="cpu",
                timeout_s=TIMEOUT,
                workdir=str(tmp_path_factory.mktemp("dp_ranks")))
    return list(zip(*res)), ref_loss


def _one_process_step(cfg, batch):
    trainer = Trainer(cfg, device="cpu")
    _, metrics = trainer.step(trainer.init_state(0), batch)
    return metrics, {k: v.numpy() for k, v in
                     trainer.model.state_dict().items()}


@pytest.mark.parametrize("job,width", [(0, 2), (1, 4)])
def test_train_step_is_width_invariant(data, runs, job, width):
    """One step, flips and dropout on, on 1, 2 and 4 data ranks: every
    metric within rel 1e-5 of one process's (and equal on every rank),
    every parameter after it within 1e-6."""
    cfg, batch = data[:2]
    want_m, want_p = _one_process_step(cfg, batch)
    ranks = runs[0][job]
    assert [r["coord"] for r in ranks[:width]] == [(i, 0)
                                                    for i in range(width)]
    assert all(r is None for r in ranks[width:])
    for r in ranks[:width]:
        assert r["metrics"] == ranks[0]["metrics"]
    got = ranks[0]["metrics"][0]
    assert set(got) == set(want_m)
    for name, want in want_m.items():
        np.testing.assert_allclose(got[name], float(want), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    assert got["num_fg"] > 0
    for name, want in want_p.items():
        np.testing.assert_allclose(ranks[0]["params"][name], want,
                                   atol=1e-6, rtol=0, err_msg=name)


def test_train_step_matches_reference_data_mesh(runs):
    """(2, 1) against the reference's Trainer(mesh=make_mesh(n_data=2))
    on its windowed pool route, its initial weights and its ROI sample
    handed to the port, dropout and flips off: the loss within rel
    1e-5."""
    ranks, ref_loss = runs[0][2], runs[1]
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    np.testing.assert_allclose(ranks[0]["metrics"][0]["loss"], ref_loss,
                               rtol=1e-5)


def test_proposal_step_is_width_invariant(data, runs):
    """ProposalTrainer at (2, 1) against one process: every metric within
    rel 1e-5, the parameters after the step within 1e-6."""
    cfg, _, masked = data[:3]
    pcfg = cfg.replace(train=dataclasses.replace(cfg.train, lr=5e-3))
    trainer = ProposalTrainer(pcfg, device="cpu")
    _, want = trainer.step(trainer.init_state(0), masked)
    ranks = runs[0][3]
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    got = ranks[0]["metrics"][0]
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], float(want[name]), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    for name, p in trainer.model.named_parameters():
        np.testing.assert_allclose(ranks[0]["params"][name],
                                   p.detach().numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)


def test_tester_on_data_mesh_matches_one_process_and_reference(
        data, fitted, runs):
    """Tester at (2, 1): each rank decodes half of every batch, the first
    rank evaluates and every rank gets the metrics; AP and AR within 1e-6
    of one process's Tester and of the reference's
    Tester(mesh=make_mesh(n_data=2)) on the same tree (its "pyramid"
    route, the XLA oracle of the windowed kernels)."""
    from multipathnet_tpu.core.config import preset as jpreset
    from multipathnet_tpu.core.mesh import make_mesh
    from multipathnet_tpu.data import coco as jcoco
    from multipathnet_tpu.data import proposals as jprop
    from multipathnet_tpu.eval import tester as jtester
    from multipathnet_tpu.models.multipath import build_model as jbuild

    cfg, _, _, loader, props, fx = data
    ranks = runs[0][4]
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    assert [r["decoded"] for r in ranks[:2]] == [4, 4]
    one = Tester(build_model(cfg.model, device="cpu"), cfg, loader, props,
                 params=fitted, device="cpu", batch_size=4)
    # half batches run the float GEMMs at another M: the last bits move
    got_d, want_d = ranks[0]["detections"], one.collect_detections()
    assert [(d["image_id"], d["category_id"]) for d in got_d] == \
        [(d["image_id"], d["category_id"]) for d in want_d]
    for key in ("bbox", "score"):
        np.testing.assert_allclose([d[key] for d in got_d],
                                   [d[key] for d in want_d], rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    assert ranks[1]["detections"] == []
    want = one.test()
    # the kernel route's XLA oracle: a Pallas call takes no shard_map here
    jcfg = _cfg(jpreset, roi_impl="pyramid")
    ref = jtester.Tester(jbuild(jcfg.model), fitted, jcfg,
                         jcoco.CocoLoader(fx["annotations"], fx["images"]),
                         jprop.ProposalStore.load(fx["proposals"]),
                         batch_size=4, mesh=make_mesh(n_data=2)).test()
    got = ranks[0]["metrics"]
    assert set(got) == set(want) == set(ref)
    for other in (want, ref):
        diff = max(abs(got[k] - other[k]) for k in got)
        assert diff <= 1e-6, (got, other)
    assert want["AP50"] > 0.1


def test_int8_detector_on_data_mesh_equals_one_rank(runs):
    """The int8 serving Detector at (2, 1): each rank's half of the batch,
    all-gathered, equals the unsharded Detector's detections and pre-NMS
    scores bit for bit (nothing in the int8 path crosses the batch)."""
    ranks = runs[0][5]
    for r in ranks[:2]:
        got, want = r["detections"], r["unsharded"]["detections"]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        rows = slice(2 * r["coord"][0], 2 * r["coord"][0] + 2)
        for k in ("boxes", "probs"):
            np.testing.assert_array_equal(
                r["scores"][k], r["unsharded"]["scores"][k][rows],
                err_msg=k)
    assert ranks[0]["detections"]["valid"].any()


def test_tester_on_a_trainers_sharded_model(runs):
    """Tester(trainer.model, mesh=trainer.mesh) on a (1, 2) mesh, as
    cli.train evaluates mid-run: the trainer's head, already sharded, is
    not cut again, and the detections match a one-process Tester's on the
    same tree (float32 summation order apart)."""
    ranks = runs[0][6]
    assert all(r is None for r in ranks[2:])
    for r in ranks[:2]:
        assert r["roles"]["fc6_f0"] == "col"
        assert r["roles"]["fc7_f0"] == "row"
        assert r["after"] == r["before"]
    got_d, want_d = ranks[0]["detections"], ranks[0]["unsharded"]
    assert want_d and ranks[1]["detections"] == []
    assert [(d["image_id"], d["category_id"]) for d in got_d] == \
        [(d["image_id"], d["category_id"]) for d in want_d]
    for key in ("bbox", "score"):
        np.testing.assert_allclose([d[key] for d in got_d],
                                   [d[key] for d in want_d], rtol=1e-5,
                                   atol=1e-5, err_msg=key)


def test_detector_call_cuts_rows_and_gathers(data, fitted):
    """Detector on a 1 x 1 mesh is the plain Detector (no collective)."""
    from multipathnet_tpu_torch.core.mesh import make_mesh

    cfg, batch = data[:2]
    args = (batch.images, batch.src_hws, batch.proposals, batch.prop_mask)
    plain = Detector(build_model(cfg.model, device="cpu"), cfg,
                     params=fitted)(*args)
    meshed = Detector(build_model(cfg.model, device="cpu"), cfg,
                      params=fitted, mesh=make_mesh(device="cpu"))(*args)
    for k in plain:
        np.testing.assert_array_equal(meshed[k], plain[k], err_msg=k)


def _run(args, cwd, ranks=0):
    """A CLI of the port in a subprocess, under torchrun with `ranks` CPU
    processes (its standalone rendezvous on localhost) when ranks > 0."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    launch = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc_per_node={ranks}"] if ranks else [sys.executable])
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(filter(None, (
               str(root), os.environ.get("PYTHONPATH"))))}
    proc = subprocess.run(launch + ["-m", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc


def test_cli_train_and_eval_under_torchrun(tmp_path):
    """cli.train and cli.eval under torchrun on 2 CPU ranks (`tiny`, batch
    2, a 2-wide data mesh): the run writes its checkpoint and one metrics
    row per log step (the first rank alone), and cli.eval reports the
    mesh on stderr and prints the one-process cli.eval's metrics (AP
    within 1e-6) once."""
    import json

    common = ["--preset", "tiny", "--synthetic", "--dataset-root", "ds",
              "--device", "cpu"]
    _run(["multipathnet_tpu_torch.cli.train", *common, "--steps", "4",
          "--set", "train.checkpoint_dir=run",
          "--set", "train.warmup_steps=0"], tmp_path, ranks=2)
    assert sorted(p.name for p in (tmp_path / "run" / "ckpt").iterdir()) \
        == ["step_4.pt"]
    rows = (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(r)["step"] for r in rows] == [1, 4]
    ev = ["multipathnet_tpu_torch.cli.eval", *common, "--checkpoint-dir",
          "run", "--json"]
    meshed = _run(ev, tmp_path, ranks=2)
    assert "eval mesh: 2-wide data parallel" in meshed.stderr
    lines = [ln for ln in meshed.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1
    got, want = json.loads(lines[0]), json.loads(
        _run(ev, tmp_path).stdout.strip().splitlines()[-1])
    assert set(got) == set(want)
    assert max(abs(got[k] - want[k]) for k in want) <= 1e-6, (got, want)

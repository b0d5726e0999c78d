"""The data- and tensor-parallel paths on the card, at `tiny` in float32:
a one-rank NCCL mesh against the plain Trainer and Detector, two gloo
ranks sharing the card (the train step against one process, repeated bit
for bit, the kernels launched on each rank), tensor-parallel training
with a checkpoint restored on one device, and the data-parallel int8
Detector. Ranks come from core/mesh.spawn; their bodies are
multipathnet_tpu_torch/tools/mesh_runs.py's.

Marked `cuda`: each test skips where torch.cuda.is_available() is false
(decided inside the fixture, never at import). Run on a GPU machine with
    python -m pytest tests/test_torch_parallel_cuda.py --noconftest -m cuda -q
(tests/conftest.py imports jax, which a GPU machine need not have).
"""

import dataclasses

import numpy as np
import pytest
import torch

from multipathnet_tpu_torch.core.config import preset
from multipathnet_tpu_torch.core.mesh import spawn
from multipathnet_tpu_torch.data import synthetic
from multipathnet_tpu_torch.data.coco import CocoLoader
from multipathnet_tpu_torch.data.pipeline import DetectionPipeline
from multipathnet_tpu_torch.data.proposals import ProposalStore
from multipathnet_tpu_torch.tools import mesh_runs
from multipathnet_tpu_torch.train.checkpoint import Checkpointer
from multipathnet_tpu_torch.train.loop import Trainer

pytestmark = pytest.mark.cuda

TIMEOUT = 300  # seconds a launch may take before it fails


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _cfg(**model):
    cfg = preset("tiny")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, dtype="float32", **model),
        train=dataclasses.replace(cfg.train, batch_size=4, warmup_steps=0))


@pytest.fixture(scope="module")
def batch(tmp_path_factory):
    fx = synthetic.generate(str(tmp_path_factory.mktemp("cuda_ds")),
                            num_images=8, image_size=64, num_classes=4,
                            proposals_per_image=16, seed=31)
    loader = CocoLoader(fx["annotations"], fx["images"])
    return next(DetectionPipeline(loader, ProposalStore.load(
        fx["proposals"]), _cfg().data, batch_size=4, seed=0).epoch(0))


def _images(b):
    return b.images, b.src_hws, b.proposals, b.prop_mask


def test_one_rank_nccl_mesh_equals_plain_paths(cuda, batch, tmp_path):
    """A 1 x 1 mesh under NCCL: the train step's loss, gradients and
    parameters equal the plain Trainer's bit for bit (cudnn
    deterministic), and the Detector's detections the plain Detector's."""
    jobs = [(mesh_runs.train_run, (_cfg(), (1, 1), batch),
             dict(device="cuda", compare_plain=True, deterministic=True,
                  return_params=False)),
            (mesh_runs.detect_run, (_cfg(), (1, 1), _images(batch)),
             dict(device="cuda", normal_seed=0, compare_unsharded=True))]
    (train, det), = spawn(mesh_runs.run_jobs, 1, args=(jobs,),
                          backend="nccl", device="cuda", timeout_s=TIMEOUT,
                          workdir=str(tmp_path))
    assert train["plain_equal"] == {"loss": True, "params": True,
                                    "grads": True}
    for k, v in det["unsharded"]["detections"].items():
        np.testing.assert_array_equal(det["detections"][k], v, err_msg=k)


def test_two_gloo_ranks_on_one_card(cuda, batch, tmp_path):
    """Two ranks share the card through gloo on a (2, 1) mesh: the loss
    within rel 1e-5 of one process on the card, two steps from one state
    equal bit for bit, K1 and K3 launched on each rank (at `tiny` every
    level's backward goes to K3 on the card) and K2 and the placement
    GEMMs not."""
    cfg = _cfg()
    torch.backends.cudnn.deterministic = True
    try:
        trainer = Trainer(cfg, device="cuda")
        _, want = trainer.step(trainer.init_state(0), batch)
    finally:
        torch.backends.cudnn.deterministic = False
    res = spawn(mesh_runs.train_run, 2, args=(cfg, (2, 1), batch),
                kwargs=dict(device="cuda", repeat=True, deterministic=True,
                            return_params=False),
                backend="gloo", device="cuda", timeout_s=TIMEOUT,
                workdir=str(tmp_path))
    for r in res:
        assert r["metrics"][0]["loss"] == pytest.approx(
            float(want["loss"]), rel=1e-5)
        assert r["repeat_equal"]
        n = r["launches"]
        assert n["window_pool_multi"] > 0 and n["window_grad"] > 0, n
        assert n["resident_pool"] == 0 and n["placements"] == 0, n


def test_tp_training_and_checkpoint_on_the_card(cuda, batch, tmp_path):
    """(1, 2) against (2, 1) with two gloo ranks on the card: the loss
    within rel 1e-4; its checkpoint restores on one device to the whole
    parameters bit for bit, and a step runs from it."""
    cfg = _cfg()
    ckpt = str(tmp_path / "ckpt")
    jobs = [(mesh_runs.train_run, (cfg, (1, 2), batch),
             dict(device="cuda", save_dir=ckpt)),
            (mesh_runs.train_run, (cfg, (2, 1), batch),
             dict(device="cuda", return_params=False))]
    res = spawn(mesh_runs.run_jobs, 2, args=(jobs,), backend="gloo",
                device="cuda", timeout_s=TIMEOUT, workdir=str(tmp_path))
    tp, dp = res[0]
    assert tp["tp_roles"]["fc6_f0"] == "col"
    assert tp["metrics"][0]["loss"] == pytest.approx(
        dp["metrics"][0]["loss"], rel=1e-4)
    trainer = Trainer(cfg, device="cuda")
    state = Checkpointer(ckpt).restore_latest(trainer, trainer.init_state())
    for name, t in trainer.model.state_dict().items():
        np.testing.assert_array_equal(t.cpu().numpy(), tp["params"][name],
                                      err_msg=name)
    state, m = trainer.step(state, batch)
    assert np.isfinite(float(m["loss"])) and state.step == 2


def test_dp_int8_detector_on_the_card(cuda, batch, tmp_path):
    """The int8 Detector on a (2, 1) mesh of gloo ranks on the card: the
    gathered detections equal the unsharded Detector's bit for bit, and
    the quant K1 and K2 launched on each rank."""
    cfg = _cfg(head_quant="int8")
    res = spawn(mesh_runs.detect_run, 2, args=(cfg, (2, 1), _images(batch)),
                kwargs=dict(device="cuda", normal_seed=0,
                            compare_unsharded=True),
                backend="gloo", device="cuda", timeout_s=TIMEOUT,
                workdir=str(tmp_path))
    for r in res:
        for k, v in r["unsharded"]["detections"].items():
            np.testing.assert_array_equal(r["detections"][k], v, err_msg=k)
        n = r["launches"]
        assert n["window_pool_multi_quant"] > 0 \
            and n["resident_pool_quant"] > 0, n
